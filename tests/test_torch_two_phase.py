"""The two-phase exchange of the port (``parallel.exchange.
resolve_two_phase``/``start_exchange``/``finish_exchange`` and
``parallel.migrate.vrank_exchange_two_phase_fn``) against the JAX
package's on the CPU: every resolution reason and its journal event;
``bin_key``, ``issue`` (every plan leaf) and ``land`` (state, free stack,
free counts, drops, for the state and for the augmented state with a key
row) bit-equal to the reference's on the same seeded inputs, with every
mover granted and with the grants withholding some (backlog). The
reference lands through its XLA scatter on the CPU, the port through
kernel 2's plain version; targets are unique, so both write the same
words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.ops import pack as jpack
from mpi_grid_redistribute_tpu.parallel import exchange as jexchange
from mpi_grid_redistribute_tpu.parallel import migrate as jmig
from mpi_grid_redistribute_tpu.telemetry import StepRecorder as JRecorder
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import pack
from mpi_grid_redistribute_tpu_torch.parallel import exchange, migrate
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder

torch.set_num_threads(1)

# (kwargs, reason)
RESOLUTIONS = [
    (dict(chunk=1), "pipeline: chunk < 2 — sequential body"),
    (dict(chunk=4, planar_ok=False),
     "pipeline: payload not planar-eligible — sequential body"),
    (dict(chunk=4, ragged=True),
     "pipeline: ragged receive capacity — sequential body"),
    (dict(chunk=4, vranks=False, n_devices=8),
     "pipeline: multi-device topology — sequential body"),
    (dict(chunk=4, vranks=True, n_pods=2),
     "pipeline: hierarchical multi-pod topology — sequential body"),
    (dict(chunk=2, vranks=True, n_devices=8),
     "pipeline: armed (vranks planar two-phase)"),
    (dict(chunk=16), "pipeline: armed (vranks planar two-phase)"),
]


@pytest.mark.parametrize("kw,reason", RESOLUTIONS,
                         ids=[r.split(":")[1].split("—")[0].strip()
                              + f"-{i}" for i, (_, r) in
                              enumerate(RESOLUTIONS)])
def test_resolution_reason_and_journal_match_reference(kw, reason):
    built = []
    jrec, rec = JRecorder(), StepRecorder()
    want = jexchange.resolve_two_phase("auto", recorder=jrec,
                                       build=lambda: "bundle", **kw)
    got = exchange.resolve_two_phase(
        "auto", recorder=rec, build=lambda: built.append(1) or "bundle",
        **kw)
    assert got.reason == want.reason == reason
    assert got.armed == want.armed == reason.endswith("two-phase)")
    assert got.bundle == want.bundle
    assert len(built) == int(got.armed)  # built only when armed
    (je,), (e,) = jrec.events("engine_resolved"), rec.events(
        "engine_resolved")
    assert e.data == je.data


def test_resolution_refuses_unknown_engine_and_unarmed_dispatch():
    with pytest.raises(ValueError, match="engine must be one of"):
        exchange.resolve_two_phase("bogus", chunk=4)
    handle = exchange.resolve_two_phase("planar", chunk=1)
    with pytest.raises(TypeError, match="not armed"):
        exchange.start_exchange(handle, None, None)
    with pytest.raises(TypeError, match="not armed"):
        exchange.finish_exchange(handle)


def _state(V, n, seed, fill, vel):
    """Planar int32 ``[7, V * n]`` (pos 3, vel 3, alive), each vrank's
    rows on its own cell of a (2, 2, 2) grid, drifted by ``vel`` so some
    leave."""
    grid = ProcessGrid((2, 2, 2))
    rng = np.random.default_rng(seed)
    pos = np.empty((3, V * n), np.float32)
    for v in range(V):
        c = np.asarray(grid.cell_of_rank(v), np.float32)
        pos[:, v * n:(v + 1) * n] = (
            c[:, None] + rng.random((3, n), dtype=np.float32)) / 2
    pos = np.mod(pos + rng.uniform(-vel, vel, pos.shape).astype(np.float32),
                 np.float32(1.0)).astype(np.float32)
    pos = np.where(pos >= 1, np.float32(0), pos)
    velr = rng.random((3, V * n), dtype=np.float32)
    alive = (rng.random(V * n) < fill).astype(np.int32)
    return np.concatenate([pos.view(np.int32), velr.view(np.int32),
                           alive[None]], axis=0)


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("case", ["granted", "backlog"])
def test_issue_and_land_bit_equal_to_reference(case):
    V, n = 8, 64
    fill, vel = (0.6, 0.3) if case == "granted" else (0.97, 0.5)
    fused = _state(V, n, seed=7, fill=fill, vel=vel)
    tp = migrate.vrank_exchange_two_phase_fn(
        Domain(0.0, 1.0, periodic=True), ProcessGrid((2, 2, 2)), n)
    jtp = jmig.vrank_exchange_two_phase_fn(
        JDomain(0.0, 1.0, periodic=True), JGrid((2, 2, 2)), n)
    assert (tp.vranks, tp.n_local) == (jtp.vranks, jtp.n_local) == (V, n)
    st = migrate.init_state(torch.from_numpy(fused), vranks=V, batched=True)
    jst = jmig.init_state(jnp.asarray(fused), vranks=V, batched=True)
    assert _bits(st.free_stack) == _bits(jst.free_stack)
    key = tp.bin_key(st.fused)
    jkey = jtp.bin_key(jst.fused)
    assert _bits(key) == _bits(jkey)
    plan = exchange.start_exchange(
        exchange.TwoPhaseExchange("auto", True, "", tp), key, st.n_free)
    jplan = jtp.issue(jkey, jst.n_free)
    for f in migrate.VrankPlan._fields:
        assert _bits(getattr(plan, f)) == _bits(getattr(jplan, f)), f
    backlog = int(plan.backlog.sum())
    assert (backlog > 0) == (case == "backlog"), backlog
    assert int(plan.n_sent.sum()) > 0
    arr = pack.gather_plan_cols(st.fused, plan.arr_plan)
    jarr = jpack.gather_plan_cols(jst.fused, jplan.arr_plan)
    assert _bits(arr) == _bits(jarr)
    # the state, then the augmented state with a key row riding along
    for aug in (False, True):
        f, a = st.fused.clone(), arr
        jf, ja = jst.fused, jarr
        if aug:
            f = torch.cat([f, key.reshape(1, -1)])
            a = torch.cat([a, key[None] + 1])
            jf = jnp.concatenate([jf, jkey.reshape(1, -1)])
            ja = jnp.concatenate([ja, jkey[None] + 1])
        got = exchange.finish_exchange(
            tp, f, st.free_stack.clone(), st.n_free, a, plan.vacated,
            plan.n_sent, plan.n_in)
        want = jtp.land(jf, jst.free_stack, jst.n_free, ja, jplan.vacated,
                        jplan.n_sent, jplan.n_in)
        for g, w, name in zip(got, want, ("fused", "free_stack", "n_free",
                                          "dropped")):
            assert _bits(g) == _bits(w), (aug, name)
        assert int(got[3].sum()) == 0
        # conservation: live rows after = before (movers moved, none lost)
        assert int((got[0][6] > 0).sum()) == int((st.fused[6] > 0).sum())

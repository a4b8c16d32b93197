"""Port row scatter (kernel 6's plain version, ``ops/scatter.py``) and
the migrate engine's landing routes against the JAX package.

``scatter_rows_plain`` is bit-equal to ``pallas_scatter.scatter_rows``
run in interpret mode (the TPU kernel's own logic) on the shapes of the
reference's tests, negative targets included, at K in {1, 7, 8}. The
reference's XLA fallback (``n_rows % 8192 != 0``) wraps a negative
target instead of dropping it (ROADMAP.md C3); the port drops it at every
shape, as the kernel does.

The engine's ``"rows"`` route on the legacy float32 state is bit-equal,
state and stats, to the JAX engine built with ``scatter_impl="rows"``
(which resolves to the XLA scatter on the CPU, the same function by the
kernel's contract), and to the port's ``"overlay"`` and ``"xla"`` routes.
Payloads are finite normal floats and NaN patterns: XLA-CPU flushes
float32 denormals and torch-CPU does not (the card test holds denormal
bit patterns against the plain version)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mpi_grid_redistribute_tpu import compat
from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.ops import pallas_scatter as ps
from mpi_grid_redistribute_tpu.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu.parallel import migrate as jmig
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.bench import common as tcommon
from mpi_grid_redistribute_tpu_torch.ops import scatter
from mpi_grid_redistribute_tpu_torch.parallel import migrate as tmig

torch.set_num_threads(1)

GRID = (2, 2, 2)


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def _case(r, n_rows, p, k, clustered=False):
    flat = r.random((n_rows, k)).astype(np.float32)
    hi = ps.BLOCK if clustered else n_rows + 99
    t = r.choice(hi, size=p, replace=False).astype(np.int32)
    t[: min(5, p)] = -np.arange(1, min(5, p) + 1)  # negatives: dropped
    rows = r.random((p, k)).astype(np.float32)
    if p > 8:
        rows[7, 0] = np.float32(np.nan)
        rows[8, :] = np.array([0x7FC01234], np.int32).view(np.float32)[0]
    return flat, t, rows


@pytest.mark.parametrize("k", [1, 7, 8])
@pytest.mark.parametrize("n_rows,p,clustered", [
    (ps.BLOCK * 2, 1000, False),  # sparse
    (ps.BLOCK * 4, 3 * ps.RMAX + 17, False),  # several chunks, odd count
    (ps.BLOCK, 1, False),  # one arrival
    (ps.BLOCK * 2, 2 * ps.RMAX, True),  # all inside one block
])
def test_plain_matches_jax_interpret(n_rows, p, clustered, k):
    r = np.random.default_rng(n_rows + p + k)
    flat, t, rows = _case(r, n_rows, p, k, clustered)
    want = ps.scatter_rows(jnp.asarray(flat), jnp.asarray(t),
                           jnp.asarray(rows), interpret=True)
    got = scatter.scatter_rows(torch.from_numpy(flat.copy()),
                               torch.from_numpy(t), torch.from_numpy(rows))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_negative_targets_dropped_at_every_shape():
    """The port drops target -1 at n_rows = 8200 too, where the
    reference's XLA fallback wraps it onto row n-1 (ROADMAP.md C3); at
    8192 (the kernel's shape) both drop it."""
    rows = np.full((2, 3), 7.0, np.float32)
    t = np.array([-1, 4], np.int32)
    for n_rows in (8192, 8200):
        flat = np.zeros((n_rows, 3), np.float32)
        got = scatter.scatter_rows(torch.from_numpy(flat.copy()),
                                   torch.from_numpy(t), torch.from_numpy(rows))
        want = flat.copy()
        want[4] = 7.0
        np.testing.assert_array_equal(got.numpy(), want)
        ref = np.asarray(ps.scatter_rows(jnp.asarray(flat), jnp.asarray(t),
                                         jnp.asarray(rows), interpret=True))
        if n_rows % ps.BLOCK == 0:
            np.testing.assert_array_equal(ref, want)
        else:
            assert (ref[-1] == 7.0).all()  # the reference's wrap


@pytest.mark.parametrize("dtype", [
    torch.float64, torch.int64, torch.int16, torch.uint8, torch.bool,
    torch.float16,
])
def test_plain_moves_raw_words_of_every_size(dtype):
    r = np.random.default_rng(3)
    n_rows, k, p = 50, 3, 12
    words = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
    w = words[torch.empty((), dtype=dtype).element_size()]
    flat_w = r.integers(0, 2, (n_rows, k)).astype(w) if dtype == torch.bool \
        else r.integers(-100, 100, (n_rows, k)).astype(w)
    rows_w = r.integers(0, 2, (p, k)).astype(w) if dtype == torch.bool \
        else r.integers(-100, 100, (p, k)).astype(w)
    t = r.choice(n_rows + 5, p, replace=False).astype(np.int32)
    t[0] = -3
    want = flat_w.copy()
    ok = (t >= 0) & (t < n_rows)
    want[t[ok]] = rows_w[ok]
    flat = torch.from_numpy(flat_w.copy()).view(dtype)
    rows = torch.from_numpy(rows_w).view(dtype)
    got = scatter.scatter_rows(flat, torch.from_numpy(t), rows)
    assert got is flat
    np.testing.assert_array_equal(got.view(torch.from_numpy(want).dtype).numpy(),
                                  want)


def test_scatter_rows_raises_on_bad_input():
    flat = torch.zeros((16, 3))
    t = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        scatter.scatter_rows(flat, t.long(), torch.zeros((2, 3)))
    with pytest.raises(TypeError):
        scatter.scatter_rows(flat, t, torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(TypeError):
        scatter.scatter_rows(flat, t, torch.zeros((2, 4)))
    with pytest.raises(TypeError):
        scatter.scatter_rows(torch.zeros(16), t, torch.zeros(2))
    with pytest.raises(TypeError):
        scatter.scatter_rows(torch.zeros((4, 2), dtype=torch.complex128),
                             t, torch.zeros((2, 2), dtype=torch.complex128))
    # P == 0 is a no-op
    assert scatter.scatter_rows(flat, t[:0], torch.zeros((0, 3))) is flat


@pytest.mark.parametrize("n_rows,p,k,bits", [
    (8388608, 196296, 7, 32),  # the rows route's shape
    (2**31 - 1, 10, 1, 32),  # n_rows * K at the int32 limit
    (2**28, 10, 8, 64),  # n_rows * K = 2**31: one past it
    (2**28 - 1, 10, 8, 32),
    (2**28, 10, 9, 64),
    (10, 2**31 - 1, 1, 32),  # P * K at the limit
    (10, 2**30, 2, 64),  # P * K = 2**31
    (1, 1, 2**31 - 1, 32),
    (1, 1, 2**31, 64),
])
def test_index_bits_boundary(n_rows, p, k, bits):
    """The kernel's index math is 32-bit while every word offset of flat
    and rows fits in an int32 (at most 2**31 - 1 words), 64-bit from 2**31
    words on."""
    assert scatter.index_bits(n_rows, p, k) == bits


@pytest.mark.parametrize("env,legacy,arg,want", [
    (None, None, None, "overlay"),
    ("overlay", None, None, "overlay"),
    ("xla", None, None, "xla"),
    ("rows", None, None, "rows"),
    (None, "1", None, "rows"),
    ("xla", "1", None, "xla"),  # the new variable wins
    ("rows", None, "overlay", "overlay"),  # an explicit value wins
    (None, None, True, "rows"),
    (None, None, False, "xla"),
    (None, None, "xla", "xla"),
    (None, None, "bogus", ValueError),
    ("bogus", None, None, ValueError),
])
def test_resolve_scatter_impl_table(monkeypatch, env, legacy, arg, want):
    for name, val in (("MPI_GRID_LAND_SCATTER", env),
                      ("MPI_GRID_PALLAS_SCATTER", legacy)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    if want is ValueError:
        with pytest.raises(ValueError, match="landing-scatter"):
            tmig._resolve_scatter_impl(arg)
        if arg is not None:  # the reference rejects the same names
            with pytest.raises(ValueError, match="landing-scatter"):
                jmig._resolve_scatter_impl(arg)
    else:
        assert tmig._resolve_scatter_impl(arg) == want


def _float_state(n_local, seed, nan_rows=True):
    """Legacy float32 fused state [7, V * n] (alive row 1.0/0.0), rows on
    their own slabs, pre-drifted so the first step has movers."""
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.8, 0.05)
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.8, np.random.default_rng(seed), vel_scale=3 * v
    )
    pos = np.mod(pos + vel, np.float32(1.0)).astype(np.float32)
    pos[pos >= 1.0] = 0.0
    if nan_rows:  # NaN payload patterns in the velocity rows ride along
        vel[::97, 1] = np.array([0x7FC0BEEF], np.int32).view(np.float32)[0]
    fused = np.concatenate(
        [pos.T, vel.T, alive.astype(np.float32)[None]], axis=0
    ).astype(np.float32)
    # the shift between steps uses the finite velocities only
    return fused, np.nan_to_num(vel.T, nan=0.0), cap, budget


def _jax_step(capacity, budget, scatter_impl):
    dev_grid = jdomain.ProcessGrid((1, 1, 1))
    mesh = mesh_lib.make_mesh(dev_grid, devices=jax.devices()[:1])
    axes = dev_grid.axis_names
    fn = jmig.shard_migrate_vranks_fn(
        jdomain.Domain(0.0, 1.0, periodic=True), dev_grid,
        jdomain.ProcessGrid(GRID), capacity, local_budget=budget,
        scatter_impl=scatter_impl,
    )

    def body(f, fs, nf):
        st, stats = fn(jmig.MigrateState(f, fs, nf))
        return tuple(st), stats

    specs = (P(None, axes), P(axes), P(axes))
    stats_spec = jmig.MigrateStats(
        *([P(axes)] * 5), flow=P(axes, None), fast_path=None
    )
    return jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=specs, out_specs=(specs, stats_spec),
    ))


def _port_step(capacity, budget, scatter_impl):
    return tmig.shard_migrate_vranks_fn(
        tdomain.Domain(0.0, 1.0, periodic=True),
        tdomain.ProcessGrid((1, 1, 1)), tdomain.ProcessGrid(GRID), capacity,
        local_budget=budget, scatter_impl=scatter_impl,
    )


def test_rows_route_float32_bit_equal_to_jax_and_other_routes():
    """Three engine steps on the legacy float32 layout; between steps the
    live rows shift, so every step has movers."""
    n_local = 512
    fused, vel_t, cap, budget = _float_state(n_local, 8)
    jstep = _jax_step(cap, budget, "rows")
    tsteps = {impl: _port_step(cap, budget, impl)
              for impl in ("rows", "overlay", "xla")}
    st = jmig.init_state(jnp.asarray(fused), vranks=8, batched=True)
    sent = 0
    for step in range(3):
        inputs = [np.asarray(x) for x in st]
        st, jstats = jstep(*st)
        want = [np.asarray(x) for x in st]
        for impl, tstep in tsteps.items():
            tstate = tmig.MigrateState(
                *[torch.from_numpy(x.copy()) for x in inputs]
            )
            out, tstats = tstep(tstate)
            assert out.fused.dtype == torch.float32
            for g, w in zip(out, want):
                np.testing.assert_array_equal(_bits(g), _bits(w), impl)
            for f in jmig.MigrateStats._fields[:-1]:
                np.testing.assert_array_equal(
                    _bits(getattr(tstats, f)),
                    _bits(getattr(jstats, f)), f"{impl} {f}",
                )
            assert tstats.fast_path is None
        sent += int(np.asarray(jstats.sent).sum())
        # shift the live rows for the next step (the same on both sides)
        f1 = want[0].copy()
        f1[:3] = np.mod(f1[:3] + np.float32(0.4) * vel_t, np.float32(1.0))
        f1[:3][f1[:3] >= 1.0] = 0.0
        st = (jnp.asarray(f1), st[1], st[2])
    assert sent > 0


def test_rows_on_int32_state_raises():
    fused, _, cap, budget = _float_state(64, 1, nan_rows=False)
    ints = torch.from_numpy(fused).view(torch.int32).clone()
    ints[-1] = torch.from_numpy(fused[-1].astype(np.int32))
    state = tmig.init_state(ints, vranks=8, batched=True)
    with pytest.raises(TypeError, match="float32-only"):
        _port_step(cap, budget, "rows")(state)


def test_env_rows_reaches_the_loop(monkeypatch):
    """No loop argument selects the route: the env does, through
    _resolve_scatter_impl(None), so the int32 loop refuses 'rows'."""
    from mpi_grid_redistribute_tpu_torch.models import nbody

    monkeypatch.setenv("MPI_GRID_LAND_SCATTER", "rows")
    v, cap, budget = tcommon.drift_sizing(GRID, 64, 0.9, 0.02)
    pos, vel, alive = tcommon.uniform_state(
        GRID, 64, 0.9, np.random.default_rng(2), vel_scale=v
    )
    cfg = nbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=1.0, capacity=cap,
        n_local=64, local_budget=budget, engine="planar",
    )
    loop = nbody.make_migrate_loop(cfg, 1, vgrid=tdomain.ProcessGrid(GRID),
                                   device="cpu")
    with pytest.raises(TypeError, match="float32-only"):
        loop(pos, vel, alive)


def test_float32_state_init_and_unfuse_match_jax():
    """The legacy float32 layout through init_state and unfuse_fields."""
    fused, _, _, _ = _float_state(64, 9)
    specs_j = (((3,), jnp.float32), ((3,), jnp.float32))
    specs_t = (((3,), torch.float32), ((3,), torch.float32))
    js = jmig.init_state(jnp.asarray(fused), vranks=8, batched=True)
    ts = tmig.init_state(torch.from_numpy(fused), vranks=8, batched=True)
    for g, w in zip(ts[1:], js[1:]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    (jp, jv), ja = jmig.unfuse_fields(jnp.asarray(fused), specs_j)
    (tp, tv), ta = tmig.unfuse_fields(torch.from_numpy(fused), specs_t)
    for g, w in ((tp, jp), (tv, jv), (ta, ja)):
        np.testing.assert_array_equal(_bits(g), _bits(w))

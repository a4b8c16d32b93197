"""The port's state-health probes (``ops/statehealth.py``,
``telemetry/probes.py``) against the JAX package's on the CPU, at every
tier: the in-chunk summary and its NumPy mirror on the reference's
hand-math fixtures and a seeded fuzz with NaN, ±Inf and out-of-bounds
values salted into live and dead rows; the journal bridge; the probed
sequential and pipelined macros' ``ys["probe"]`` against the
reference's; and tier ``off`` giving the unprobed macro's bits.

Tolerances: every counter and ``pos_min``/``pos_max`` bit-equal;
``vel_m2`` (a float32 sum, whose order differs between XLA's reduction
and PyTorch's) bit-equal on the dyadic fixture, where every partial sum
is exact, and within rtol 1e-5 on random data, the reference's own
tolerance between its graph and its host mirror."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.ops import statehealth as jsh
from mpi_grid_redistribute_tpu.service import pipeline as jpipeline
from mpi_grid_redistribute_tpu.service import resident as jresident
from mpi_grid_redistribute_tpu.telemetry import StepRecorder as JRecorder
from mpi_grid_redistribute_tpu.telemetry import probes as jprobes
from mpi_grid_redistribute_tpu_torch.ops import statehealth
from mpi_grid_redistribute_tpu_torch.parallel.exchange import (
    RedistributeStats,
)
from mpi_grid_redistribute_tpu_torch.service import (
    make_chunk_fn, make_pipelined_chunk_fn,
)
from mpi_grid_redistribute_tpu_torch.telemetry import (
    ProbeConfig, StepRecorder, record_probe_steps, summarize_host,
)
from test_torch_pipeline import (
    DT, GRID, _j, _rds, _t, assert_tree_bits, template_state,
)

torch.set_num_threads(1)

COUNTERS = ("live", "nan_pos", "nan_vel", "oob", "residual")


def _corrupt_fixture():
    """The reference's fixture: 2 shards x 4 rows, count [3, 2]: a clean
    row, a NaN position, a +Inf position (nan_pos and oob), a finite
    out-of-bounds row, a NaN velocity, and dead rows of garbage."""
    pos = np.array([
        [0.1, 0.2, 0.3], [np.nan, 0.5, 0.5], [np.inf, 0.5, 0.5],
        [np.nan, np.inf, -5.0], [1.5, 0.5, 0.5], [0.9, 0.0, 0.25],
        [2.5, np.nan, 0.5], [0.5, 0.5, 0.5],
    ], dtype=np.float32)
    vel = np.tile(np.array([0.5, -0.25, 1.0], dtype=np.float32), (8, 1))
    vel[3] = [np.inf, 0.0, 0.0]
    vel[5] = [np.nan, 0.0, 0.0]
    vel[6] = np.nan
    count = np.array([3, 2], dtype=np.int32)
    expect = {"live": 5, "nan_pos": 2, "nan_vel": 1, "oob": 2,
              "residual": 0}
    return pos, vel, count, expect


def _clean_fixture():
    """Dyadic values: the moments are exact in float32."""
    pos = np.array([[0.25, 0.5], [0.75, 0.125], [0.5, 0.875], [9.0, -9.0]],
                   dtype=np.float32)
    vel = np.array([[1.0, 2.0], [-2.0, 0.0], [0.5, 0.5], [100.0, 100.0]],
                   dtype=np.float32)
    count = np.array([2, 1], dtype=np.int32)
    expect = {"live": 3, "nan_pos": 0, "nan_vel": 0, "oob": 0, "residual": 0,
              "pos_min": [0.25, 0.125], "pos_max": [0.75, 0.875],
              "vel_m2": 9.5}
    return pos, vel, count, expect


def _port(pos, vel, count, initial, dropped, tier):
    out = statehealth.summarize(
        torch.from_numpy(pos), torch.from_numpy(vel),
        torch.from_numpy(count), torch.tensor(initial, dtype=torch.int32),
        torch.tensor(dropped, dtype=torch.int32), 0.0, 1.0, tier)
    return {k: v.numpy() for k, v in out.items()}


def _ref(pos, vel, count, initial, dropped, tier):
    out = jsh.summarize(jnp.asarray(pos), jnp.asarray(vel),
                        jnp.asarray(count), jnp.int32(initial),
                        jnp.int32(dropped), 0.0, 1.0, tier)
    return {k: np.asarray(v) for k, v in out.items()}


def _same(got, want, keys, path=""):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (path, k)
        assert g.tobytes() == w.tobytes(), (path, k, g, w)


@pytest.mark.parametrize("tier", ["counters", "moments"])
def test_corrupt_fixture_matches_reference(tier):
    pos, vel, count, expect = _corrupt_fixture()
    got = _port(pos, vel, count, 8, 3, tier)
    want = _ref(pos, vel, count, 8, 3, tier)
    _same(got, want, COUNTERS)
    assert {k: int(got[k]) for k in COUNTERS} == expect
    assert set(got) == set(want)
    if tier == "moments":
        np.testing.assert_array_equal(got["pos_min"], want["pos_min"])
        np.testing.assert_array_equal(got["pos_max"], want["pos_max"])
    host = summarize_host(pos, vel, count, 8, 3, ProbeConfig(tier))
    jhost = jprobes.summarize_host(pos, vel, count, 8, 3,
                                   jprobes.ProbeConfig(tier))
    assert {k: int(host[k]) for k in COUNTERS} == expect
    assert repr(host) == repr(jhost)


def test_residual_is_exact_and_signed():
    pos, vel, count, _ = _corrupt_fixture()
    assert int(_port(pos, vel, count, 8, 2, "counters")["residual"]) == -1
    assert int(_port(pos, vel, count, 8, 4, "counters")["residual"]) == 1


def test_moments_fixture_bit_equal_to_reference():
    pos, vel, count, expect = _clean_fixture()
    got = _port(pos, vel, count, 3, 0, "moments")
    want = _ref(pos, vel, count, 3, 0, "moments")
    _same(got, want, COUNTERS + ("pos_min", "pos_max", "vel_m2"))
    assert [float(x) for x in got["pos_min"]] == expect["pos_min"]
    assert float(got["vel_m2"]) == expect["vel_m2"]
    host = summarize_host(pos, vel, count, 3, 0, ProbeConfig("moments"))
    assert host == jprobes.summarize_host(pos, vel, count, 3, 0,
                                          jprobes.ProbeConfig("moments"))


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_matches_reference(trial):
    rng = np.random.default_rng(20 + trial)
    nranks, cap, ndim = 4, 16, 3
    n = nranks * cap
    pos = rng.uniform(0.0, 1.0, (n, ndim)).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (n, ndim)).astype(np.float32)
    for arr, vals in ((pos, (np.nan, np.inf, -np.inf, 1.5, -0.5)),
                      (vel, (np.nan, np.inf, -np.inf))):
        k = rng.integers(0, 12)
        arr[rng.integers(0, n, k), rng.integers(0, ndim, k)] = rng.choice(
            vals, k)
    count = rng.integers(0, cap + 1, nranks).astype(np.int32)
    initial = int(count.sum()) + int(rng.integers(-3, 4))
    dropped = int(rng.integers(0, 5))
    tier = ("counters", "moments")[trial % 2]
    got = _port(pos, vel, count, initial, dropped, tier)
    want = _ref(pos, vel, count, initial, dropped, tier)
    _same(got, want, COUNTERS, trial)
    host = summarize_host(pos, vel, count, initial, dropped,
                          ProbeConfig(tier))
    for k in COUNTERS:
        assert int(host[k]) == int(got[k]), k
    if tier == "moments":
        for k in ("pos_min", "pos_max"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["vel_m2"], want["vel_m2"], rtol=1e-5,
                                   equal_nan=True)


def test_live_mask_and_step_dropped_match_reference():
    count = np.array([3, 0, 5, 1], np.int32)
    got = statehealth.live_mask(24, 4, torch.from_numpy(count))
    want = jsh.live_mask(24, 4, jnp.asarray(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stats = RedistributeStats(
        torch.zeros((4, 4), dtype=torch.int32),
        torch.zeros((4, 4), dtype=torch.int32),
        torch.tensor([1, 0, 2, 0], dtype=torch.int32),
        torch.tensor([0, 3, 0, 1], dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32))
    assert int(statehealth.step_dropped(stats, pipelined=False)) == 7
    assert int(statehealth.step_dropped(stats, pipelined=True)) == 4
    with pytest.raises(ValueError, match="unknown probe tier"):
        statehealth.summarize_masked(
            torch.zeros((2, 3)), torch.zeros((2, 3)),
            torch.ones(2, dtype=torch.bool), 2, 2, 0, 0.0, 1.0, "off")


def test_probe_config_and_journal_bridge_match_reference():
    assert ProbeConfig().tier == "off" and not ProbeConfig().armed
    assert ProbeConfig("moments").moments and ProbeConfig("counters").armed
    with pytest.raises(ValueError, match="unknown probe tier"):
        ProbeConfig("verbose")
    with pytest.raises(ValueError, match="lo < hi"):
        ProbeConfig("counters", lo=1.0, hi=1.0)
    assert hash(ProbeConfig("counters")) == hash(ProbeConfig("counters"))
    probe = {
        "live": np.array([10, 9, 9]), "nan_pos": np.array([0, 2, 0]),
        "nan_vel": np.array([0, 0, 1]), "oob": np.array([0, 0, 3]),
        "residual": np.array([0, -1, 0]),
        "pos_min": np.zeros((3, 3), np.float32),
        "pos_max": np.ones((3, 3), np.float32),
        "vel_m2": np.array([1.0, 2.0, 3.0], np.float32),
    }
    for moments in (False, True):
        p = probe if moments else {k: probe[k] for k in COUNTERS}
        rec, jrec = StepRecorder(), JRecorder()
        assert record_probe_steps(rec, 5, p) == jprobes.record_probe_steps(
            jrec, 5, p) == 3
        assert ([e.data for e in rec.events("state_health")]
                == [e.data for e in jrec.events("state_health")])


def _macros(tier, pipelined, chunk=7):
    jrd, trd = _rds()
    state = template_state(GRID, 64)
    jbuild = (jpipeline.make_pipelined_chunk_fn if pipelined
              else jresident.make_chunk_fn)
    build = make_pipelined_chunk_fn if pipelined else make_chunk_fn
    jprobe = None if tier is None else jprobes.ProbeConfig(tier)
    probe = None if tier is None else ProbeConfig(tier)
    jm = jbuild(jrd, DT, chunk, *_j(state)[:3], probes=jprobe)[0]
    m = build(trd, DT, chunk, *_t(state)[:3], probes=probe)[0]
    return (jax.tree.map(np.asarray, jm(*_j(state))), m(*_t(state)),
            state)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
@pytest.mark.parametrize("tier", ["counters", "moments"])
def test_probed_macros_match_reference(tier, pipelined):
    want, got, _ = _macros(tier, pipelined)
    assert_tree_bits(got[0], tuple(want[0]), "state")
    probe, wprobe = got[1].pop("probe"), want[1].pop("probe")
    assert_tree_bits(got[1], want[1])
    _same({k: v.numpy() for k, v in probe.items()}, wprobe, COUNTERS)
    assert set(probe) == set(wprobe)
    assert probe["live"].shape == (7,)
    assert (probe["residual"] == 0).all() and (probe["nan_pos"] == 0).all()
    if tier == "moments":
        for k in ("pos_min", "pos_max"):
            np.testing.assert_array_equal(probe[k].numpy(), wprobe[k])
        np.testing.assert_allclose(probe["vel_m2"].numpy(), wprobe["vel_m2"],
                                   rtol=1e-5)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
def test_off_tier_is_the_unprobed_macro(pipelined):
    """Tier ``off`` runs exactly the unprobed ops: the same state and ys
    bits as ``probes=None``, and no ``"probe"`` key."""
    _, off, _ = _macros("off", pipelined)
    _, none, _ = _macros(None, pipelined)
    assert "probe" not in off[1]
    assert_tree_bits(off, none, "macro")

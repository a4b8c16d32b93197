"""Config 8, the service soak (``bench/config8_soak.py``), against the JAX
package's on the CPU.

``run(device="cpu")`` at 512 rows a vrank (cadence 4, legs of 12 steps,
min of 2) and the reference's ``run`` at the same knobs give the same
capture but for the wall times and the engine: the snapshot count, one
restart in the crash leg with a bit-identical resume, the elastic leg's
shrink to ``(1, 2, 2)`` with ``resharded`` 1 and the same particle set,
and the corruption leg's NaN step, one restart and recovery. The
reference runs its jax driver here (8 forced CPU devices), the port its
torch driver with the ranks as vranks. ``_soak_gate`` fails the same
clauses as the reference's; the 2% overhead budget is the card's to
measure, not a CPU test's (a wall-clock bound under a parallel run)."""

import pytest

from mpi_grid_redistribute_tpu.bench import config8_soak as jconfig8
from mpi_grid_redistribute_tpu_torch.bench import config8_soak

# the capture's wall-time keys, and the engine each package names
WALL_KEYS = {"value", "ms_per_step", "timing_spread", "snapshot_overhead"}


@pytest.fixture(scope="module")
def captures():
    mp = pytest.MonkeyPatch()
    mp.setenv("BENCH_SOAK_EVERY", "4")
    mp.setenv("BENCH_SOAK_STEPS", "12")
    try:
        got = config8_soak.run(n_local=512, reps=2, device="cpu")
        want = jconfig8.run(n_local=512, reps=2)
    finally:
        mp.undo()
    return got, want


def test_capture_equals_reference(captures):
    got, want = captures
    assert list(got) == list(want)
    assert got["engine"] == "torch" and want["engine"] == "jax"
    for k in set(got) - WALL_KEYS - {"engine"}:
        assert got[k] == want[k], k
    assert got["value"] > 0 and got["ms_per_step"] > 0
    assert got["timing_k"] == 2 and got["snapshots_written"] >= 1


def test_every_deterministic_clause_holds(captures):
    got, _ = captures
    assert got["restarts"] == 1 and got["bit_identical_resume"] is True
    assert got["elastic_restarts"] == 1 and got["resharded"] >= 1
    assert got["elastic_grid"] == [1, 2, 2]
    assert got["elastic_set_identical"] is True
    assert got["corruption_restarts"] == 1
    assert got["corruption_recovered"] is True
    assert got["corruption_step"] == 8
    # every clause but the budget passes at this size
    assert config8_soak._soak_gate(dict(got, snapshot_overhead=0.0)) == []


@pytest.mark.parametrize("bad", [
    dict(bit_identical_resume=False), dict(restarts=2),
    dict(snapshot_overhead=0.03), dict(snapshots_written=0),
    dict(elastic_set_identical=False), dict(elastic_restarts=0),
    dict(resharded=0), dict(corruption_recovered=False),
    dict(corruption_restarts=2),
])
def test_gate_fails_the_reference_clauses(captures, bad):
    got, _ = captures
    out = dict(got, snapshot_overhead=0.0)
    out.update(bad)
    assert len(config8_soak._soak_gate(out)) == len(
        jconfig8._soak_gate(out)) == 1

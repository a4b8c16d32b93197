"""The one-shot cell (a configuration's ``entry`` ``"redistribute"``) at a
tiny size: the public call agrees with the reference's receive order, the
reference's order is the oracle's, the API's ranks map onto the harness's
slabs through ``ProcessGrid``, the control and the faults a one-shot call
can have read ``correct: false``, and the loop's controls are refused."""

import numpy as np
import pytest
import torch

from benchmark import program, reference, spec, state, worker
from benchmark.tests.test_benchmark_cell import (DEVICES, _device, measure,
                                                 tiny_cell)

ONESHOT = ("oneshot_4x4x4", "file_order")


def oneshot_cell(slots=4096, grid=None):
    """At 4,096 slots a rank the library's default capacity is 128 a pair
    for ~58 rows; at 1,024 it would be 32 for ~14, which the edited
    inputs overflow now and then, and the deferred check raises."""
    cell = tiny_cell(*ONESHOT, slots=slots)
    if grid is None:
        return cell
    cfg = dict(cell.config, grid=list(grid), vgrid=list(grid))
    return spec.make_cell(cell.name, cfg, cell.traffic)


@pytest.mark.parametrize("device", DEVICES)
def test_oneshot_agrees_with_reference(device):
    cell = oneshot_cell()
    line = measure(cell, 2**31 + 7, _device(device))
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"count_gap", "misplaced_rows",
                                   "slabs_differing", "order_gap"}
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert set(line["metrics"]) == {"particles_per_s.rd", "call_ms_p95.rd",
                                    "peak_mem_gib", "setup_s"}
    assert line["attempted"] >= 1 and list(line)[-1] == "checks"


def test_traced_oneshot_reads_its_counter():
    line = measure(oneshot_cell(), 12, traced=1)
    assert line["correct"]
    # calibrated after the warm calls: no blocking read in the window
    assert line["metrics"]["blocking_reads.call.rd"]["value"] == 0.0
    # nothing runs on a device here: no device time, no roofline
    assert set(line["metrics"]) == {"blocking_reads.call.rd"}


def test_snapshots_from_seed():
    cell = oneshot_cell(slots=512)
    a = state.snapshots(cell, 2**40 + 3, "cpu")
    b = state.snapshots(cell, 2**40 + 3, "cpu")
    c = state.snapshots(cell, 2**40 + 4, "cpu")
    assert len(a) == 2 and not torch.equal(a[0][0], a[1][0])
    assert all(torch.equal(x, y) for s, t in zip(a, b) for x, y in zip(s, t))
    assert not torch.equal(a[0][0], c[0][0])
    pos, vel, count = a[0]
    R, n, live = cell.n_slabs, cell.n_local, cell.live_per_slab
    assert pos.shape == vel.shape == (R * n, 3)
    assert torch.equal(count, torch.full((R,), live, dtype=torch.int32))
    p = pos.view(R, n, 3)
    assert not p[:, live:].any() and not vel.view(R, n, 3)[:, live:].any()
    assert float(vel.abs().max()) <= 0.01
    # file order: a row lies on its own rank's cell one time in 64
    own = reference.owner_slab(cell, p[:, :live].reshape(-1, 3).T)
    home = torch.arange(R).repeat_interleave(live)
    share = float((own == home).double().mean())
    assert abs(share - 1 / 64) < 0.01


def test_edits_change_every_call_and_replay():
    """Before each call a few live rows of every rank of its snapshot are
    drawn anew; the inputs made again from the seed are the same, call by
    call, and no call's input is an earlier one's."""
    cell = oneshot_cell(slots=512)
    R, n, c = cell.n_slabs, cell.n_local, cell.live_per_slab
    k = int(cell.traffic["edit_rows"])
    base = [tuple(t.clone() for t in s)
            for s in state.snapshots(cell, 2**40 + 3, "cpu")]
    seen = []
    for (i, a), (_, b) in zip(state.inputs(cell, 2**40 + 3, "cpu", 6),
                              state.inputs(cell, 2**40 + 3, "cpu", 6)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not any(torch.equal(a[0], p) for p in seen)
        seen.append(a[0].clone())
        p0, p = base[i % 2][0].view(R, n, 3), a[0].view(R, n, 3)
        changed = (p != p0).any(2).any(0)
        assert not changed[c:].any() and int(changed.sum()) <= k * (i // 2 + 1)
        assert torch.equal(a[2], base[i % 2][2])
        assert not a[1].view(R, n, 3)[:, c:].any()
        assert float(a[1].abs().max()) <= 0.01


def test_rank_slabs_follow_process_grid():
    """The reference puts rank ``r`` on the slab of the grid cell whose
    row-major index is ``r`` (MPI's Cartesian order), and the port's
    ``ProcessGrid.cell_of_rank(r)`` is that cell, on a grid whose axes
    differ."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid

    for grid in ((4, 4, 4), (2, 3, 4)):
        cell = oneshot_cell(slots=256, grid=grid)
        slabs = reference.rank_slabs(cell)
        assert sorted(slabs) == list(range(cell.n_slabs))
        pg = ProcessGrid(grid)
        for r, s in enumerate(slabs):
            rowmajor = tuple(int(x) for x in np.unravel_index(r, grid))
            assert tuple(cell.slab_cells()[s]) == rowmajor
            assert pg.cell_of_rank(r) == rowmajor


@pytest.mark.parametrize("grid", [(4, 4, 4), (2, 3, 4)])
def test_receive_order_is_the_oracles(grid):
    """The reference's receive order against the port's padded oracle (MPI
    Alltoallv order) at a tiny size, row for row."""
    from mpi_grid_redistribute_tpu_torch import oracle
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid

    cell = oneshot_cell(slots=256, grid=grid)
    pos, vel, count = state.snapshots(cell, 31, "cpu")[1]
    count = count.clone()
    count[::3] -= 7  # ragged counts
    rp, rv, rc = reference.receive_order(cell, pos, vel, count)
    n, m = cell.n_local, 2 * cell.n_local  # m: no output clipped
    op, oc, of, _ = oracle.redistribute_oracle_padded(
        Domain(0.0, 1.0, periodic=True), ProcessGrid(grid), pos.numpy(),
        count.numpy(), [vel.numpy()], n, m, native_ok=False)
    start = np.concatenate([[0], np.cumsum(rc.numpy())])
    for r, s in enumerate(reference.rank_slabs(cell)):
        k = int(oc[r])
        assert k == int(rc[s])
        a, b = start[s], start[s] + k
        assert np.array_equal(op[r * m:r * m + k], rp[a:b].numpy())
        assert np.array_equal(of[0][r * m:r * m + k], rv[a:b].numpy())


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("seed", [3, 2**31 + 99, 4_000_000_017])
def test_bin_bf16_control_fails(device, seed):
    line = measure(oneshot_cell(), seed, _device(device), control="bin_bf16")
    c = line["checks"]
    assert not line["correct"]
    assert c["misplaced_rows"]["value"] > 0 and c["count_gap"]["value"] > 0
    assert line["failed"] == line["attempted"]


@pytest.mark.parametrize("cell,control", [
    (ONESHOT, "drift_bf16"), (ONESHOT, "deposit_f32"),
    (("uniform_2x2x2", "m2_s4"), "bin_bf16")])
def test_controls_of_the_other_entry_refused(cell, control):
    with pytest.raises(ValueError, match="control"):
        measure(tiny_cell(*cell), 1, control=control)


def _plant(monkeypatch, fault):
    """``fault(snapshot, result) -> result`` behind every call."""
    real = program.build_oneshot

    def build(cell, device):
        gr, call = real(cell, device)
        return gr, lambda snap: fault(snap, call(snap))

    monkeypatch.setattr(program, "build_oneshot", build)


def _unchanged(snap, out):
    return snap[0], (snap[1],), snap[2], out[3]


def _half_left_out(snap, out):
    return out[0], out[1], out[2] // 2, out[3]


def _two_rows_swapped(snap, out):
    pos, vel = out[0].clone(), out[1][0].clone()
    pos[[0, 1]], vel[[0, 1]] = pos[[1, 0]], vel[[1, 0]]
    return pos, (vel,), out[2], out[3]


def _velocity_bit_flipped(snap, out):
    vel = out[1][0].clone()
    vel.view(torch.int32)[0, 0] ^= 1
    return out[0], (vel,), out[2], out[3]


def _memoised():
    """A program that keeps the first result it made from each input
    buffer and returns it whenever that buffer comes again."""
    seen = {}

    def fault(snap, out):
        return seen.setdefault(snap[0].data_ptr(), out)

    return fault


@pytest.mark.parametrize("fault,failing", [
    (_unchanged, {"misplaced_rows", "slabs_differing", "order_gap"}),
    (_half_left_out, {"count_gap", "slabs_differing"}),
    (_two_rows_swapped, {"order_gap"}),
    (_velocity_bit_flipped, {"slabs_differing", "order_gap"}),
    (_memoised, {"slabs_differing", "order_gap"})])
def test_oneshot_fault_is_not_correct(monkeypatch, fault, failing):
    if fault is _memoised:
        fault = _memoised()
    _plant(monkeypatch, fault)
    line = measure(oneshot_cell(), 2**31 + 5)
    assert not line["correct"], (fault.__name__, line["checks"])
    assert failing <= {k for k, c in line["checks"].items() if c["value"]}
    if fault is _two_rows_swapped:  # 2 rows a judged call, nothing else
        got = {k: c["value"] for k, c in line["checks"].items()}
        assert got.pop("order_gap") in (2, 2 * (1 + worker.ONESHOT_SAMPLES))
        assert set(got.values()) == {0}


def test_oneshot_digest_and_judge_count_rows():
    """Two judged calls of one snapshot each: a row of the second moved to
    the next slab reads on every number."""
    cell = oneshot_cell(slots=4096)  # no slab receives past its slots
    slabs = list(range(cell.n_slabs))
    good, last = {}, None
    for c, snap in state.inputs(cell, 5, "cpu", 8):
        if c in (4, 7):
            last = worker._padded(cell, *reference.receive_order(cell, *snap))
            good[c] = worker.oneshot_digest(cell, last, slabs)
    checks = worker.judge_oneshot(cell, 5, "cpu", good)
    assert all(c["value"] == 0 for c in checks.values())
    # the edits count: call 7's output judged as call 5's input reads
    checks = worker.judge_oneshot(cell, 5, "cpu", {5: good[7]})
    assert checks["order_gap"]["value"] > 0
    pos, (vel,), count, _ = last
    n, k = cell.n_local, int(count[0])
    dst = n + int(count[1])  # slab 1's first hole
    pos[dst], vel[dst] = pos[k - 1], vel[k - 1]
    count[0] -= 1
    count[1] += 1
    bad = {4: good[4],
           7: worker.oneshot_digest(cell, (pos, (vel,), count), slabs)}
    checks = worker.judge_oneshot(cell, 5, "cpu", bad)
    assert {k: c["value"] for k, c in checks.items()} == {
        "count_gap": 2, "misplaced_rows": 1, "slabs_differing": 2,
        "order_gap": 1}

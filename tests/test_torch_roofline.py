"""The port's counted rooflines (``telemetry/roofline.py``,
``utils/costcount.py``, ``analysis/progcheck.py``) against the JAX
package's: the hand-math is the reference's on synthetic costs with the
peaks pinned; the count follows its stated rules; each kernel scope
counts its formula whatever its plain version did inside it; the
registry is the reference's 17 programs (J000 clean); the counted
collective bytes are the reference's J004 totals but for one pinned,
explained difference; the report journals one ``roofline`` event a row
and lights the gauge."""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.telemetry import roofline as jroof
from mpi_grid_redistribute_tpu_torch.analysis import progcheck
from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
    load_progprofile_baseline,
)
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import (
    dfscan, driftbin, overlay, scatter, segdep, tilecarry,
)
from mpi_grid_redistribute_tpu_torch.telemetry import metrics
from mpi_grid_redistribute_tpu_torch.telemetry import roofline as troof
from mpi_grid_redistribute_tpu_torch.telemetry.recorder import StepRecorder
from mpi_grid_redistribute_tpu_torch.utils import costcount, profiling
from torch_rank_cases import shared_world

PEAKS = dict(peak_flops_per_sec=1e12, peak_bytes_per_sec=1e9,
             collective_peak_bytes_per_sec=1e9)
PREDICT_CASES = [
    ({"flops": 2e9, "bytes_accessed": 1e6}, 2048),  # compute-bound
    ({"flops": 1e6, "bytes_accessed": 8e9}, 0),  # memory-bound
    ({"flops": 1e6, "bytes_accessed": 1e3}, 5_000_000_000),  # collective
    ({"flops": 0.0, "bytes_accessed": 0.0}, 0),  # ties break to compute
    (None, 4096),  # no cost: unknown
]


# ------------------------------------------------------------ hand-math


@pytest.mark.parametrize("cost,coll", PREDICT_CASES)
def test_predict_equals_reference(cost, coll):
    assert troof.predict(cost, coll, **PEAKS) == jroof.predict(cost, coll,
                                                               **PEAKS)


def test_predict_defaults_are_the_h100_roofs():
    row = troof.predict({"flops": 67e12, "bytes_accessed": 3.35e12}, 450e9)
    assert row["t_compute_s"] == row["t_memory_s"] == row[
        "t_collective_s"] == 1.0
    assert profiling.PEAK_FLOPS_PER_SEC == 67e12


@pytest.mark.parametrize("cost,prof,wire", [
    ({"flops": 1.0, "bytes_accessed": 4000.0},
     {"collective_bytes_total": 1000}, {"per_domain": {"ici": 600}}),
    ({"flops": 1.0, "bytes_accessed": 999.0},
     {"collective_bytes_total": 1000}, None),
    ({"flops": 1.0, "bytes_accessed": 5.0},
     {"collective_bytes_total": 0}, None),
    (None, {"collective_bytes_total": 1000}, None),
])
def test_cross_check_equals_reference(cost, prof, wire):
    assert troof.cross_check(cost, prof, wire) == jroof.cross_check(
        cost, prof, wire)


def test_cross_check_missing_profile_names_the_ports_command():
    t = troof.cross_check({"flops": 1.0, "bytes_accessed": 1.0}, None, None)
    j = jroof.cross_check({"flops": 1.0, "bytes_accessed": 1.0}, None, None)
    reason = t.pop("discrepancy_reason")
    j.pop("discrepancy_reason")
    assert t == j and t["discrepancy"]
    assert "J004 baseline" in reason
    assert "mpi_grid_redistribute_tpu_torch.analysis.progcheck" in reason


def test_format_roofline_table_equals_reference():
    report = {}
    for i, (cost, coll) in enumerate(PREDICT_CASES):
        row = jroof.predict(cost, coll, **PEAKS)
        row.update(jroof.cross_check(
            cost, {"collective_bytes_total": coll}, None))
        row["achieved_fraction"] = None if i % 2 else 0.25 * (i + 1)
        report[f"prog{i}"] = row
    assert troof.format_roofline_table(report) == \
        jroof.format_roofline_table(report)


# ------------------------------------------------------------- counting


@pytest.mark.parametrize("n", [1, 1000, 65536])
def test_count_of_an_f32_add(n):
    a, b = torch.ones(n), torch.ones(n)
    c = troof.count_cost(torch.add, (a, b))
    assert (c["bytes_accessed"], c["flops"], c["ops"]) == (12 * n, n, 1)


def test_count_rules():
    x = torch.ones(100)
    i = torch.arange(10)
    cases = [
        (lambda: x.view(10, 10), 0, 0),  # a view
        (lambda: x.add_(1.0), 800, 100),  # read and written
        (lambda: x.copy_(torch.zeros(100)), 400 + 400 + 400, 0),
        (lambda: x.sum(), 400 + 4, 100),  # a float reduction
        (lambda: i + 1, 160, 0),  # integer arithmetic
        (lambda: x > 0, 500, 0),  # a compare
        (lambda: x.to("meta"), 0, 0),  # a transfer off the device
        (lambda: x.index_add_(0, i, torch.ones(10)),
         40 + 80 + 40 + 2 * 40, 0),  # written where addressed, twice
        (lambda: torch.mm(torch.ones(4, 5), torch.ones(5, 6)),
         2 * 4 * 5 * 4 + 4 * 6 * 4 + 5 * 6 * 4 * 2, 2 * 4 * 5 * 6),
    ]
    for fn, nbytes, flops in cases:
        c = troof.count_cost(fn, ())
        assert (c["bytes_accessed"], c["flops"]) == (nbytes, flops), fn


def _kernel_calls():
    """Each kernel's public function and plain version on CPU tensors at
    small shapes, with its expected formula."""
    r = np.random.default_rng(5)
    V, n = 4, 64
    flat = torch.from_numpy(np.concatenate([
        r.random((6, V * n), dtype=np.float32).view(np.int32),
        (r.random((1, V * n)) < 0.9).astype(np.int32)]))
    dom, grid = Domain(0.0, 1.0, periodic=True), ProcessGrid((2, 2, 1))
    targets = torch.from_numpy(r.permutation(V * n + 40)[:90].astype(
        np.int32)) - 20
    cols = torch.from_numpy(r.integers(0, 9, (7, 90), dtype=np.int32))
    rows = torch.from_numpy(r.integers(0, 9, (90, 7), dtype=np.int32))
    n_ok = int(((targets >= 0) & (targets < V * n)).sum())
    keys = torch.from_numpy(np.sort(r.integers(0, 50, 300)).astype(np.int32))
    rel = torch.from_numpy(r.random((3, 300), dtype=np.float32) * 4)
    x = torch.from_numpy(r.random((5, 37), dtype=np.float32))
    pack = torch.from_numpy(r.random((4, 40), dtype=np.float32))
    return [
        ("drift_wrap_bin", driftbin.drift_wrap_bin,
         driftbin.drift_wrap_bin_plain, (flat, 1.0, dom, grid, V, V),
         (V * n * 4 * (7 + 4), V * n * 3 * 22)),
        ("overlay_scatter_planar", overlay.overlay_scatter_planar,
         overlay.overlay_scatter_planar_plain, (flat, targets, cols),
         (4 * 90 + 8 * 7 * n_ok, 0)),
        ("scatter_rows", scatter.scatter_rows, scatter.scatter_rows_plain,
         (flat.T.contiguous(), targets, rows), (4 * 90 + 8 * 7 * n_ok, 0)),
        ("segsum_sorted", segdep.segsum_sorted, segdep.segsum_sorted_plain,
         (keys, rel, None, 50, (4, 4, 4)),
         (4 * 300 * 4 + 4 * 8 * 50, 300 * (18 + 24 + 8))),
        ("tile_df_cumsum_rows", dfscan.tile_df_cumsum_rows,
         dfscan.tile_df_cumsum_rows_plain, (x,),
         (12 * 5 * 37, 2 * 11 * 6 * 5 * 37)),
        ("tile_carries", tilecarry.tile_carries,
         tilecarry.tile_carries_plain, (pack, 4),
         (4 * 4 * 10 + 4 * 4 * 11, 2 * 11 * 4 * 2 * 10)),
    ]


@pytest.mark.parametrize("route", ["public", "plain"])
@pytest.mark.parametrize("i", range(6))
def test_kernel_scope_counts_its_formula(i, route):
    name, public, plain, args, (nbytes, flops) = _kernel_calls()[i]
    fn = public if route == "public" else plain
    c = troof.count_cost(fn, tuple(a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args))
    # the plain version issued many aten ops inside the scope: none counts
    assert c["ops"] == 0
    assert (c["bytes_accessed"], c["flops"]) == (nbytes, flops)
    assert c["kernels"] == {name: {"calls": 1, "bytes": nbytes,
                                   "flops": flops}}
    mod = {"drift_wrap_bin": driftbin, "overlay_scatter_planar": overlay,
           "scatter_rows": scatter, "segsum_sorted": segdep,
           "tile_df_cumsum_rows": dfscan, "tile_carries": tilecarry}[name]
    assert mod.kernel_cost(*args) == (nbytes, flops)


def test_kernel_scope_is_free_when_nothing_counts():
    flat = torch.zeros((7, 8), dtype=torch.int32)
    out = overlay.overlay_scatter_planar(
        flat, torch.tensor([1, 9], dtype=torch.int32),
        torch.ones((7, 2), dtype=torch.int32))
    assert out[:, 1].tolist() == [1] * 7 and int(out.sum()) == 7


def test_counting_is_per_thread():
    import threading

    seen = []
    with costcount.counting() as c:
        t = threading.Thread(
            target=lambda: seen.append(torch.ones(50) + torch.ones(50)))
        t.start()
        t.join()
    assert seen and c.bytes_accessed == 0


# ------------------------------------------------------------- registry


def test_registry_is_the_references():
    from mpi_grid_redistribute_tpu.analysis import progcheck as jpc

    jp, tp = jpc.default_programs(), progcheck.default_programs()
    assert sorted(tp) == sorted(jp) and len(tp) == 17
    for name in tp:
        for field in ("engine", "topology", "resident", "fastpath", "tags",
                      "capacity", "mover_cap", "resident_rows"):
            assert getattr(tp[name], field) == getattr(jp[name], field), (
                name, field)


def test_j000_covers_the_ports_engines():
    programs = progcheck.default_programs()
    assert progcheck.registry_coverage(programs) == []
    for drop in ("canonical_neighbor_vranks", "pipelined_macro_step"):
        fewer = {k: v for k, v in programs.items() if k != drop}
        found = progcheck.registry_coverage(fewer)
        assert found and all(f.rule == "J000" for f in found)


@pytest.mark.parametrize("name", sorted(
    k for k, v in progcheck.default_programs().items()
    if v.topology == "vranks"))
def test_one_device_programs_run_and_count_the_same_twice(name):
    spec = progcheck.default_programs()[name]
    counts = []
    for _ in range(2):
        fn, args = spec.build(device="cpu")
        c = troof.count_cost(fn, args)
        c.pop("ops")  # zero-byte metadata ops differ on a first call
        counts.append(c)
    assert counts[0] == counts[1]
    assert counts[0]["bytes_accessed"] > 0
    assert counts[0]["collective_bytes_total"] == 0  # one device: none


def test_program_build_needs_a_device_or_the_gpu():
    spec = progcheck.default_programs()["canonical_planar_vranks"]
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.build()


# ---------------------------------------------- collective bytes (J004)

SHARDED = sorted(k for k, v in progcheck.default_programs().items()
                 if v.topology == "sharded")

# The one difference by design: the port's sharded engines gather the
# global stats tables onto every rank (``exchange.gather_stats``,
# ``migrate.gather_migrate_stats``: the API returns the reference's
# global [R, R]/[R] stats on each rank), where the reference's stats are
# global arrays sharded over its devices and gathered by no collective.
# These are those all_gathers' bytes a call on rank 0.
STATS_GATHER_BYTES = {
    "apply_assignment_oneshot": 80,
    "canonical_hierarchical_sharded": 84,
    "canonical_neighbor_sharded": 80,
    "canonical_planar_sharded": 76,
    "canonical_rowmajor_sharded": 76,
    "canonical_sparse_pods": 80,
    "canonical_sparse_sharded": 80,
    "migrate_planar_sharded": 156,  # 3 steps of 52
}


@pytest.fixture(scope="module")
def sharded_counts(tmp_path_factory):
    res = shared_world(
        tmp_path_factory, "roofline_sharded",
        "mpi_grid_redistribute_tpu_torch.analysis.progcheck:world_costs",
        progcheck.WORLD_SIZE, args=(SHARDED, None), timeout=300)
    return res


@pytest.mark.parametrize("name", SHARDED)
def test_collective_bytes_match_the_references_j004(sharded_counts, name):
    import json
    import os

    ref_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "mpi_grid_redistribute_tpu", "analysis", "progprofile_baseline.json")
    with open(ref_path) as f:
        ref = json.load(f)["profiles"][name]["collective_bytes"]
    got = dict(sharded_counts[0][name]["collective_bytes"])
    assert got.pop("all_gather", 0) - ref.get("all_gather", 0) == \
        STATS_GATHER_BYTES[name]
    ref = {k: v for k, v in ref.items() if k != "all_gather"}
    assert got == ref
    # every rank sends the same payloads
    assert all(r[name]["collective_bytes"] ==
               sharded_counts[0][name]["collective_bytes"]
               for r in sharded_counts)


def test_committed_profile_is_the_live_count(sharded_counts):
    committed = load_progprofile_baseline()
    assert sorted(committed) == sorted(progcheck.default_programs())
    live = progcheck.collective_profiles(sharded_counts[0])
    for name in SHARDED:
        # the committed profile also holds J004's peak live bytes
        assert {k: committed[name][k] for k in live[name]} == live[name]
    for name, prof in committed.items():
        if name not in SHARDED:
            assert prof["collective_bytes_total"] == 0


# ---------------------------------------------------------------- report


class _Spec:
    topology = "vranks"

    def build(self, device=None, n_local=None, mesh=None):
        return (lambda x: x * 2.0 + 1.0), (torch.ones(8),)


def test_roofline_report_journals_every_row_and_lights_the_gauge():
    programs = {k: v for k, v in progcheck.default_programs().items()
                if v.topology == "vranks"}
    programs["fake_prog"] = _Spec()
    costs = progcheck.program_costs(programs, device="cpu")
    assert costs["fake_prog"]["bytes_accessed"] == 2 * 64 and \
        costs["fake_prog"]["flops"] == 16
    measured = {k: 1e-3 for k in programs}
    rec = StepRecorder()
    report = troof.roofline_report(programs, measured, rec, costs=costs)
    events = rec.events("roofline")
    assert sorted(e.data["program"] for e in events) == sorted(programs)
    assert all(e.data["phase"] == "total" for e in events)
    # a program missing from the committed profile is a discrepancy,
    # journaled, not an error
    assert report["fake_prog"]["discrepancy"]
    assert "J004" in report["fake_prog"]["discrepancy_reason"]
    assert not any(report[k]["discrepancy"] for k in programs
                   if k != "fake_prog")
    for name, row in report.items():
        assert row["achieved_fraction"] == pytest.approx(
            row["t_predicted_s"] / 1e-3)
        assert row["bound_by"] == "memory"
    text = metrics.from_journal(rec).render_openmetrics()
    for name in programs:
        assert (f'grid_roofline_achieved_fraction{{program="{name}",'
                f'phase="total"}}') in text
    assert "fake_prog" in troof.format_roofline_table(report)


def test_measure_programs_times_one_device_programs():
    programs = progcheck.default_programs()
    few = {k: programs[k] for k in ("canonical_planar_vranks",
                                    "canonical_planar_sharded")}
    measured = troof.measure_programs(few, device="cpu")
    assert list(measured) == ["canonical_planar_vranks"]
    assert measured["canonical_planar_vranks"] > 0


def test_measure_programs_counts_on_the_build_it_times():
    """``costs=`` counts each timed program on the same build: the count
    is the one a separate build gives."""
    programs = progcheck.default_programs()
    few = {k: programs[k] for k in ("canonical_planar_vranks",
                                    "canonical_planar_sharded")}
    costs = {}
    troof.measure_programs(few, device="cpu", s2=2, reps=1, costs=costs)
    assert list(costs) == ["canonical_planar_vranks"]
    alone = progcheck.program_costs(
        {"canonical_planar_vranks": few["canonical_planar_vranks"]},
        device="cpu")
    assert costs == alone


def test_over_roof_names_shares_above_the_limit():
    report = {"a": {"achieved_fraction": 1.0501},
              "b": {"achieved_fraction": 1.05},
              "c": {"achieved_fraction": None},
              "d": {"achieved_fraction": 3.0}}
    assert troof.ACHIEVED_FRACTION_MAX == 1.05
    assert troof.over_roof(report) == ["a", "d"]
    assert troof.over_roof(report, limit=2.0) == ["d"]

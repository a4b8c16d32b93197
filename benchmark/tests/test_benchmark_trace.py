"""The per-layer readers on a canned profiler trace: known numbers out."""

import numpy as np
import pytest

from benchmark import costs, spec, trace
from benchmark.costs import ROW_BYTES

H100 = "NVIDIA H100 80GB HBM3"


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def canned():
    """A 1000 us window with two steps, a deposit and a collective."""
    ev = [
        _x("user_annotation", "bench:window", 0, 1000),
        _x("user_annotation", "bench:call", 0, 1000),
        _x("user_annotation", "mig:step", 100, 200),
        _x("user_annotation", "mig:select", 120, 50),
        _x("user_annotation", "mig:step", 400, 200),
        _x("user_annotation", "coll:all_to_all", 450, 20),
        _x("user_annotation", "dep:deposit", 700, 100),
        # launches and what they launched
        _x("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
        _x("kernel", "driftbin_kernel(int*, int*)", 150, 100, correlation=1),
        _x("cuda_driver", "cuLaunchKernel", 130, 5, correlation=2),
        _x("kernel", "overlay_kernel(int*)", 250, 40, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 410, 5, correlation=3),
        _x("kernel", "driftbin_kernel(int*, int*)", 420, 100, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 420, 5, correlation=4),
        _x("kernel", "overlay_kernel(int*)", 530, 60, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 455, 5, correlation=5),
        _x("kernel", "ncclDevKernel_SendRecv(x)", 600, 50, correlation=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 460, 5, correlation=6),
        _x("gpu_memcpy", "Memcpy DtoH", 650, 10, correlation=6),
        _x("cuda_runtime", "cudaLaunchKernel", 710, 5, correlation=7),
        _x("kernel", "void dfscan_kernel<8>(float*)", 720, 80,
           correlation=7),
        # launched outside any step; no launch found for correlation 9
        _x("kernel", "elementwise", 900, 20, correlation=9),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1, "id": 1},
    ]
    return trace.Trace.from_chrome({"traceEvents": ev})


def ctx_of(cell, tr, stats=None, rank=0, cards=None):
    return trace.Context(cell=cell, kind=H100, trace=tr, rank=rank,
                         stats=stats or {},
                         cards=[tr.busy_us()] if cards is None else cards)


@pytest.fixture
def metrics():
    return {m.NAME: m for m in trace.load_metrics()}


def test_trace_reduction():
    tr = canned()
    assert tr.window() == (0.0, 1000.0)
    assert tr.count("mig:step") == 2
    assert tr.host_us("mig:step") == 400.0
    # device busy: [150,290] [420,520] [530,590] [600,660] [720,800]
    # [900,920]
    busy, win = tr.busy_us()
    assert (busy, win) == (140 + 100 + 60 + 60 + 80 + 20, 1000.0)
    assert tr.device_us_in("mig:step") == 100 + 40 + 100 + 60 + 50 + 10
    assert tr.device_us_in("coll:", kernel="nccl") == 50
    assert tr.device_us_in("dep:deposit") == 80


def test_readers_known_numbers(metrics):
    tr = canned()
    cell = spec.load_cell("uniform_2x2x2.m2_s4")
    V = cell.V
    sent = np.array([[10] * V, [20] * V])
    flow = np.zeros((2, V, V), np.int64)
    flow[0, 0, 1] = 30  # vrank 1 takes 30 rows from its own card
    stats = {"sent": sent, "received": sent, "flow": flow}
    c = ctx_of(cell, tr, stats)
    got = {n: m.read(c) for n, m in metrics.items()}
    assert got["host_ms.step"] == pytest.approx(0.2)
    assert got["dev_ms.migrate"] == pytest.approx(360 / 2 / 1e3)
    assert got["dev_ms.collectives"] == pytest.approx(50 / 2 / 1e3)
    assert got["dev_ms.deposit"] == pytest.approx(80 / 1e3)
    assert got["idle_share"] == pytest.approx(100 * (1 - 460 / 1000))
    assert got["wire_mb.step"] is None  # one card: nothing on a wire
    b, f = costs.driftbin_cost(V * cell.n_local)
    bound = max(b / 3.35e12, f / 67e12)
    assert got["driftbin_roofline"] == pytest.approx(100 * bound / 100e-6)
    n_ok = [10 * (V - 1) + 30, 20 * V]
    nbytes = sum(costs.overlay_cost(costs.overlay_targets(cell), k)[0]
                 for k in n_ok)
    assert got["overlay_roofline"] == pytest.approx(
        100 * nbytes / 3.35e12 / 100e-6)
    assert got["dfscan_roofline"] is None  # no deposit in this cell


def test_readers_deposit_and_wire(metrics):
    tr = canned()
    cic = spec.load_cell("uniform_2x2x2_cic128.m2_s1")
    _, rows, tile = costs.dfscan_launches(cic)
    assert (rows * tile, tile) == (2 * 8 * 2**23, 256)
    b, f = costs.dfscan_cost(rows, tile)
    got = metrics["dfscan_roofline"].read(ctx_of(cic, tr))
    assert got == pytest.approx(100 * max(b / 3.35e12, f / 67e12) / 80e-6)
    four = spec.load_cell("uniform_2x2x2_4card.m2_s4")
    flow = np.zeros((2, 8, 8), np.int64)
    flow[:, 0, 1] = 1000  # same card: no wire
    flow[:, 0, 2] = 500   # card 0 -> card 1
    flow[1, 7, 0] = 100   # card 3 -> card 0
    stats = {"sent": np.zeros((2, 8)), "flow": flow}
    got = metrics["wire_mb.step"].read(ctx_of(four, tr, stats))
    assert got == pytest.approx((1000 + 100) * ROW_BYTES / 2 / 4 / 1e6)


def test_idle_share_over_the_cards(metrics):
    """Across cards the share is of the cards' summed windows, whatever
    this card's own trace reads."""
    four = spec.load_cell("uniform_2x2x2_4card.m2_s4")
    cards = [(460.0, 1000.0), (900.0, 1000.0), (0.0, 1000.0), (640.0, 1000.0)]
    got = metrics["idle_share"].read(ctx_of(four, canned(), cards=cards))
    assert got == pytest.approx(100 * (1 - 2000 / 4000))
    assert metrics["idle_share"].read(
        ctx_of(four, canned(), cards=[(0.0, 1000.0)] * 4)) is None


@pytest.mark.parametrize("workload,suffix", [
    ("uniform_2x2x2.m2_s4", ""), ("uniform_2x2x2_cic128.m2_s1", ".cic"),
    ("uniform_2x2x2_4card.m2_s4", ".4card")])
def test_read_all_names_with_the_cells_suffix(workload, suffix):
    cell = spec.load_cell(workload)
    assert cell.metric_suffix == suffix
    got = trace.read_all(ctx_of(cell, canned()))
    assert "host_ms.step" + suffix in got
    assert got["idle_share" + suffix]["value"] == pytest.approx(54.0)
    assert all(n.endswith(suffix) for n in got)


def test_oneshot_readers_known_numbers(metrics):
    """The one-shot call's readers: the device time inside ``bench:call``
    a call, its byte floor's share, the blocking reads a traced call; in a
    loop cell they read nothing."""
    tr = canned()
    cell = spec.load_cell("oneshot_4x4x4.file_order")
    stats = {"calls": 4, "blocking_fetches": 2}
    got = {n: m.read(ctx_of(cell, tr, stats)) for n, m in metrics.items()}
    # every launched operation of the window lies in the one bench:call
    assert got["dev_ms.call"] == pytest.approx(440 / 1e3)
    floor = 48 * 67_108_864
    assert costs.redistribute_floor_bytes(cell.live_total) == floor
    assert got["redistribute_roofline"] == pytest.approx(
        100 * floor / 3.35e12 / 440e-6)
    assert got["blocking_reads.call"] == 0.5
    loop = spec.load_cell("uniform_2x2x2.m2_s4")
    for name in ("dev_ms.call", "redistribute_roofline",
                 "blocking_reads.call"):
        assert metrics[name].read(ctx_of(loop, tr, stats)) is None, name


def test_reader_finds_nothing_returns_none(metrics):
    empty = trace.Trace.from_chrome({"traceEvents": []})
    cell = spec.load_cell("uniform_2x2x2.m2_s4")
    for name, m in metrics.items():
        assert m.read(ctx_of(cell, empty)) is None, name


def test_unknown_card_gives_no_roofline(metrics):
    tr = canned()
    cell = spec.load_cell("uniform_2x2x2.m2_s4")
    c = ctx_of(cell, tr)
    c.kind = "some other card"
    assert metrics["driftbin_roofline"].read(c) is None


def test_breakdown():
    bd = canned().breakdown()
    names = [n for n, _ in bd["device_ops"]]
    assert names[0].startswith("driftbin_kernel")
    assert dict(bd["device_ops"])[names[0]] == pytest.approx(200e-6)
    gaps = dict(bd["idle_gaps"])
    # idle [0,150) begins in bench:call, [290,420) in mig:step (the
    # first, open until 300), [520,530) and [590,600) in the second
    assert sum(gaps.values()) == pytest.approx(540e-6)
    assert gaps["mig:step"] == pytest.approx((130 + 10 + 10) * 1e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10

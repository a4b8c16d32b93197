"""The readers of the program's inner spans (``mig:init``, ``mig:grant``,
``sync:*`` and the scan deposit's ``dep:*`` phases) on a canned profiler
trace: known numbers out, and nothing read from a program without them."""

import pytest

from benchmark import spec, trace

H100 = "NVIDIA H100 80GB HBM3"
NEW = ("host_ms.grant", "wait_ms.sync", "syncs.step", "dev_ms.init",
       "dev_ms.dep_keys", "dev_ms.dep_sort", "dev_ms.dep_bounds",
       "dev_ms.dep_prefix", "dev_ms.dep_place")


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _launch(corr, at, kernel, start, dur):
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 2, correlation=corr),
            _x("kernel", kernel, start, dur, correlation=corr)]


def canned(inner: bool = True):
    """Two calls of one step in a 2000 us window, a deposit in the first.
    ``inner=False`` leaves out the inner spans, as a program without them
    traces (the same device work)."""
    ev = [
        _x("user_annotation", "bench:window", 0, 2000),
        _x("user_annotation", "bench:call", 0, 1000),
        _x("user_annotation", "bench:call", 1000, 1000),
        _x("user_annotation", "mig:step", 100, 300),
        _x("user_annotation", "dep:deposit", 450, 450),
        _x("user_annotation", "mig:step", 1100, 300),
    ]
    if inner:
        ev += [
            _x("user_annotation", "mig:init", 10, 50),
            _x("user_annotation", "mig:grant", 150, 100),
            _x("user_annotation", "sync:sparse_guard", 260, 40),
            _x("user_annotation", "dep:keys", 460, 20),
            _x("user_annotation", "dep:sort", 480, 40),
            _x("user_annotation", "dep:bounds", 520, 20),
            _x("user_annotation", "dep:prefix", 540, 30),
            _x("user_annotation", "dep:place", 570, 30),
            _x("user_annotation", "dep:prefix", 600, 20),
            _x("user_annotation", "dep:place", 620, 30),
            _x("user_annotation", "mig:init", 1010, 50),
            _x("user_annotation", "mig:grant", 1150, 80),
            _x("user_annotation", "sync:sparse_guard", 1260, 60),
        ]
    ev += (_launch(1, 20, "void at::native::cat(x)", 100, 40)
           + _launch(2, 30, "void cub::DeviceRadixSortOnesweep(x)", 140, 10)
           + _launch(3, 465, "elementwise", 470, 20)
           + _launch(4, 485, "sort", 490, 50)
           + _launch(5, 525, "bounds", 540, 30)
           + _launch(6, 545, "void dfscan_kernel<8>(float*)", 570, 70)
           + _launch(7, 575, "gather", 640, 10)
           + _launch(8, 605, "void dfscan_kernel<8>(float*)", 650, 60)
           + _launch(9, 630, "fill", 710, 25)
           + _launch(10, 1020, "void at::native::cat(x)", 1100, 60))
    # launched in the grant and in the guard's read
    ev += _launch(11, 160, "driftbin_kernel", 260, 20)
    ev += _launch(12, 1262, "overlay_kernel", 1330, 20)
    return trace.Trace.from_chrome({"traceEvents": ev})


def ctx_of(workload, tr):
    return trace.Context(cell=spec.load_cell(workload), kind=H100,
                         trace=tr, rank=0, stats={}, cards=[tr.busy_us()])


@pytest.fixture
def metrics():
    return {m.NAME: m for m in trace.load_metrics()}


def test_inner_span_readers_known_numbers(metrics):
    c = ctx_of("uniform_2x2x2_cic128.m2_s1", canned())
    got = {n: metrics[n].read(c) for n in NEW}
    assert got["host_ms.grant"] == pytest.approx((100 + 80) / 2 / 1e3)
    assert got["wait_ms.sync"] == pytest.approx((40 + 60) / 2 / 1e3)
    assert got["syncs.step"] == pytest.approx(1.0)
    assert got["dev_ms.init"] == pytest.approx((40 + 10 + 60) / 2 / 1e3)
    assert got["dev_ms.dep_keys"] == pytest.approx(0.020)
    assert got["dev_ms.dep_sort"] == pytest.approx(0.050)
    assert got["dev_ms.dep_bounds"] == pytest.approx(0.030)
    assert got["dev_ms.dep_prefix"] == pytest.approx(0.070 + 0.060)
    assert got["dev_ms.dep_place"] == pytest.approx(0.010 + 0.025)
    # the five phases hold every operation the deposit launched
    phases = sum(got[n] for n in NEW if n.startswith("dev_ms.dep_"))
    assert phases == pytest.approx(metrics["dev_ms.deposit"].read(c))


def test_inner_span_readers_named_with_the_cells_suffix():
    got = trace.read_all(ctx_of("uniform_2x2x2_cic128.m2_s1", canned()))
    assert {n + ".cic" for n in NEW} <= set(got)
    assert got["syncs.step.cic"] == {"value": 1.0, "unit": "reads"}


@pytest.mark.parametrize("workload", ["uniform_2x2x2.m2_s4",
                                      "uniform_2x2x2_cic128.m2_s1"])
def test_program_without_inner_spans_reads_nothing(metrics, workload):
    """A program that opens no inner span (the one before them) gives the
    new readers nothing to read; the readers it had still read."""
    c = ctx_of(workload, canned(inner=False))
    for name in NEW:
        assert metrics[name].read(c) is None, name
    assert metrics["host_ms.step"].read(c) == pytest.approx(0.3)
    assert metrics["dev_ms.deposit"].read(c) == pytest.approx(0.265)


def test_idle_gaps_labelled_by_the_inner_spans():
    """An idle gap goes to the innermost range open when it began: the
    device idles [150, 260) and [1160, 1330) from inside ``mig:grant``,
    [280, 470) from inside ``sync:sparse_guard``, which ``mig:step``
    held before the inner spans."""
    gaps = dict(canned().breakdown()["idle_gaps"])
    assert gaps["mig:grant"] == pytest.approx((110 + 170) * 1e-6)
    assert gaps["sync:sparse_guard"] == pytest.approx(190e-6)
    assert gaps["mig:step"] == pytest.approx(650e-6)  # [1350, 2000)
    before = dict(canned(inner=False).breakdown()["idle_gaps"])
    assert before["mig:step"] == pytest.approx((110 + 190 + 170 + 650)
                                               * 1e-6)

"""Config 10 (``bench/config10_service.py``), the chunked service
capture, on the CPU at a small size: the reference's keys, knobs and
gate, the chunk-vs-eager particle-set audit with a chunk that does not
divide the horizon, and every leg through the public driver."""

import ast
from pathlib import Path

import pytest

from mpi_grid_redistribute_tpu.bench import config10_service as jc10
from mpi_grid_redistribute_tpu_torch.bench import config10_service as c10

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"BENCH_SERVICE_K": "1", "BENCH_SERVICE_SEG": "8",
         "BENCH_SERVICE_CHUNKS": "4,8"}


def _reference_keys():
    """The keys of the reference's capture dict (its ``out = {...}``)."""
    src = (ROOT / "mpi_grid_redistribute_tpu" / "bench"
           / "config10_service.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "out"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no out = {...} in the reference's config 10")


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)


def test_capture_has_the_references_keys(small):
    out = c10.run(device="cpu")
    assert list(out) == _reference_keys()
    assert out["metric"] == "service_pps" and out["chunk"] == 8
    assert out["rows"] == 4096 and out["n_local_per_vrank"] == 512
    assert out["rows_live"] == 8 * int(0.8 * 512)
    assert out["engine"] == "neighbor" and out["grid"] == [1, 1, 8]
    assert out["bit_identical"] is True
    assert out["probe_events"] > 0 and out["probe_pairs"] == 9
    assert set(out["chunk_pps"]) == {"4", "8"}
    assert out["value"] > 0 and out["eager_pps"] > 0
    assert out["speedup_vs_eager"] == round(
        out["value"] / out["eager_pps"], 3)
    assert out["probe_cost_factor"] == round(1 + out["probe_overhead"], 4)


def test_knobs_are_the_references(monkeypatch):
    assert c10._knobs() == jc10._knobs()
    monkeypatch.setenv("BENCH_SERVICE_ROWS", "8388608")
    monkeypatch.setenv("BENCH_SERVICE_GRID", "2,2,2")
    monkeypatch.setenv("BENCH_SERVICE_CHUNKS", "16")
    kn = c10._knobs()
    assert kn == jc10._knobs()
    assert kn["n_local"] == 1 << 20


@pytest.mark.parametrize("rows,grid", [(4096, "1,1,8"), (8192, "2,2,2")])
def test_bit_identity_over_a_non_dividing_chunk(monkeypatch, rows, grid):
    monkeypatch.setenv("BENCH_SERVICE_ROWS", str(rows))
    monkeypatch.setenv("BENCH_SERVICE_GRID", grid)
    assert c10._bit_identity(c10._knobs(), "cpu") is True


def test_segment_must_be_a_multiple_of_the_chunk(monkeypatch):
    monkeypatch.setenv("BENCH_SERVICE_SEG", "12")
    with pytest.raises(ValueError, match="must be a multiple of chunk 8"):
        c10._measure_pps(c10._knobs(), 8, "cpu")


GOOD = dict(probe_overhead=0.01, probe_pairs=9, probe_events=10,
            speedup_vs_eager=2.0, chunk=64, pipeline_speedup=1.2,
            bit_identical=True, n_devices=1)


@pytest.mark.parametrize("change", [
    {}, dict(probe_overhead=0.03), dict(probe_events=0),
    dict(speedup_vs_eager=1.2), dict(pipeline_speedup=1.05),
    dict(bit_identical=False),
    dict(probe_overhead=0.5, speedup_vs_eager=0.9, pipeline_speedup=0.5),
])
def test_gate_is_the_references(change):
    out = dict(GOOD, **change)
    for floors in ((1.5, 1.1, 0.02), (3.0, 1.0, 0.5)):
        assert c10.service_gate(out, *floors) == jc10._service_gate(
            out, *floors)
    assert bool(c10.service_gate(out)) == bool(change)


def test_main_gate_exit_codes(small, monkeypatch, capsys):
    monkeypatch.setattr(c10, "run", lambda device=None: dict(GOOD))
    assert c10.main(["--gate", "--device", "cpu"]) == 0
    monkeypatch.setenv("SERVICE_SPEEDUP_MIN", "5")
    assert c10.main(["--gate"]) == 1
    assert c10.main([]) == 0
    assert '"speedup_vs_eager": 2.0' in capsys.readouterr().out

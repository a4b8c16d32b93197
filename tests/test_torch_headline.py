"""The port's headline bench (``bench/headline.py``), the twin of the
repository root's ``bench.py``: the same JSON keys (read from
``bench.py``'s source with ``ast``, never by running it), the same
population and sizing as ``bench.py``'s ``_initial_state`` and the JAX
package's ``drift_sizing``, and on the CPU a run at 2^12 rows a vrank
that drops nothing and ends bit-equal to the reference's loop
(``engine="planar"``: the reference's mover-sparse loop does not trace
on this jax, ROADMAP C1)."""

import ast
import functools
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.bench import common as jcommon
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu_torch.bench import (
    common,
    config4_drift,
    headline,
)
from mpi_grid_redistribute_tpu_torch.utils import native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_LOCAL = 2 ** 12


def _bench_py_keys():
    """The keys of the dict ``bench.py``'s ``main`` prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in bench.py's main")


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench_py",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines functions; main() is not run
    return mod


def test_key_set_is_bench_pys(monkeypatch):
    """``bench.py``'s 25 keys; config 7's stress (one small size here),
    config 4's hierarchical capture (the two-level byte split read off
    it), config 4's rebalance leg, config 10's service capture and
    config 8's soak filled (small sizes here); the TPU hashes null."""
    monkeypatch.setenv("BENCH_STRESS_N", str(1 << 12))
    for k, v in (("N_LOCAL", "512"), ("K", "1"), ("EVERY", "4"),
                 ("STEPS", "12")):
        monkeypatch.setenv(f"BENCH_SOAK_{k}", v)
    monkeypatch.setattr(config4_drift, "run_rebalance", functools.partial(
        config4_drift.run_rebalance, n_local=512, steps=48))
    for k, v in (("K", "1"), ("SEG", "4"), ("CHUNKS", "2,4")):
        monkeypatch.setenv(f"BENCH_SERVICE_{k}", v)
    line = headline.measure(n_local=N_LOCAL, device="cpu", s1=1, s2=3,
                            reps=1)
    keys = _bench_py_keys()
    assert len(keys) == 25
    assert list(line) == keys
    json.loads(json.dumps(line))
    for k in ("progprofile_hash", "attribution_hash"):
        assert line[k] is None, k
    soak = line["soak"]
    assert soak["metric"] == "soak_pps" and soak["value"] > 0
    assert soak["rows"] == 8 * int(0.8 * 512) and soak["timing_k"] == 1
    assert soak["bit_identical_resume"] and soak["elastic_set_identical"]
    assert soak["corruption_recovered"] and soak["resharded"] >= 1
    reb, svc = line["rebalance"], line["service"]
    assert reb["metric"] == "config4_rebalance_steady_ms"
    assert reb["rebalances_applied"] >= 1 and reb["bit_identical"]
    assert reb["dropped"] == 0 and reb["post_rebalance_imbalance"] <= 1.1
    assert svc["metric"] == "service_pps" and svc["bit_identical"]
    assert svc["chunk"] == 4 and svc["rows"] == 4096
    assert svc["probe_events"] > 0 and svc["value"] > 0
    stress, hier = line["stress"], line["hier"]
    assert stress["metric"] == "config7_stress_bw_util"
    assert stress["migration_fraction"] > 0.8
    assert stress["exchange_domain"] == "hbm" and stress["rows"] == 7368
    assert hier["engine"] == "hierarchical"
    assert line["exchange_dcn_bytes_per_step"] == hier["dcn_bytes_per_step"]
    assert line["exchange_ici_bytes_per_step"] == hier["ici_bytes_per_step"]
    assert hier["dcn_bytes_per_step"] > 0 and hier["ici_bytes_per_step"] > 0
    assert line["metric"] == "particles_per_sec_per_chip"
    assert line["exchange_domain"] == "hbm"
    assert line["baseline_n"] == 8 * N_LOCAL
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["timing_k"] == 1
    env = line["env"]
    assert env["torch"] == torch.__version__ and env["device"] == "cpu"
    assert env["host_cpu"]
    # the utilization is against the H100's HBM3 roof
    assert line["exchange_bw_util"] == pytest.approx(
        line["exchange_bytes_per_sec"] / 3.35e12, abs=1e-6)


def test_step_time_is_never_reported_non_positive(monkeypatch):
    """What made ``test_key_set_is_bench_pys`` unsteady: on a loaded
    host one short run (1 step, one rep) can read slower than the long
    one (3 steps), and the differenced step time came out negative, so
    the headline's ``value`` did. The differencing now times both
    lengths again until the long run reads slower (interference only adds
    time), and refuses to return a step time <= 0."""
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    def scripted(times):
        it = iter(times)
        monkeypatch.setattr(profiling, "_host_seconds",
                            lambda fn: (next(it), fn()))

    # the 1-step run hiccups (50 ms) and the 3-step run reads 30 ms; the
    # second round reads 10 ms and 30 ms: 10 ms a step
    scripted([0.050, 0.030, 0.010, 0.030])
    detail, _ = profiling.time_per_step_samples(
        lambda s: (lambda: s), s1=1, s2=3, reps=1, device="cpu")
    assert detail["min"] == pytest.approx(0.010) and detail["k"] == 2
    # never consistent: refused, never a negative time
    scripted([0.050, 0.030] * (profiling.MAX_EXTRA_ROUNDS + 1))
    with pytest.raises(RuntimeError, match="noise"):
        profiling.time_per_step_samples(
            lambda s: (lambda: s), s1=1, s2=3, reps=1, device="cpu")
    # a knockout's cut asks for its first readings as they are
    scripted([0.050, 0.030])
    detail, _ = profiling.time_per_step_samples(
        lambda s: (lambda: s), s1=1, s2=3, reps=1, device="cpu",
        require_positive=False)
    assert detail["min"] == pytest.approx(-0.010)


def test_population_and_sizing_are_bench_pys():
    bench = _bench_module()
    for n_local, mig in ((N_LOCAL, 0.02), (2 ** 20, 0.02), (5000, 0.1)):
        assert [np.asarray(x).tolist() if isinstance(x, np.ndarray) else x
                for x in common.drift_sizing(headline.GRID, n_local,
                                             headline.FILL, mig)] == [
            np.asarray(x).tolist() if isinstance(x, np.ndarray) else x
            for x in jcommon.drift_sizing(bench.GRID, n_local, bench.FILL,
                                          mig)]
    got = headline._initial_state(N_LOCAL, 0.02, np.random.default_rng(0))
    want = bench._initial_state(N_LOCAL, 0.02, np.random.default_rng(0))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert headline.FILL == bench.FILL and headline.GRID == bench.GRID


def test_cpu_run_is_the_references_state():
    """No drops, rows conserved (the bench checks both and raises), and
    the long run's state bit-equal to the reference's loop of as many
    steps."""
    out = headline.device_pipeline(N_LOCAL, 0.02, 1, 3, 1, "cpu")["out"]
    _, cap, budget = common.drift_sizing(headline.GRID, N_LOCAL,
                                         headline.FILL, 0.02)
    cfg = jnbody.DriftConfig(
        domain=JDomain(0.0, 1.0, periodic=True), grid=JGrid((1, 1, 1)),
        dt=1.0, capacity=cap, n_local=N_LOCAL, local_budget=budget,
        engine="planar")
    mesh = jmesh.make_mesh(cfg.grid, jax.devices()[:1])
    state = headline._initial_state(N_LOCAL, 0.02, np.random.default_rng(0))
    want = jnbody.make_migrate_loop(cfg, mesh, 3, vgrid=JGrid(
        headline.GRID))(*state)
    for g, w in zip(out[:3], want[:3]):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    stats = out[3]
    assert int(stats.dropped_recv.sum()) == 0
    assert (stats.population.sum(dim=1) == 8 * int(0.9 * N_LOCAL)).all()
    assert stats.fast_path is not None and bool(stats.fast_path.all())
    for f in ("sent", "received", "population", "backlog", "dropped_recv"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                      np.asarray(getattr(want[3], f)))


def test_journal_shard_and_native_fallback(monkeypatch, tmp_path):
    """``BENCH_JOURNAL_DIR`` writes the run's journal shard (migrate and
    fast-path steps, a flow snapshot, the step time); without the C++
    runtime the native keys are null, never a NumPy figure."""
    monkeypatch.setenv("BENCH_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setenv("BENCH_STRESS", "0")
    monkeypatch.setenv("BENCH_HIER", "0")
    monkeypatch.setenv("BENCH_REBALANCE", "0")
    monkeypatch.setenv("BENCH_SERVICE", "0")
    monkeypatch.setenv("BENCH_SOAK", "0")
    monkeypatch.setattr(native, "build", lambda *a, **k: False)
    line = headline.measure(n_local=1024, device="cpu", s1=1, s2=2, reps=1,
                            baseline_n=8 * 512)
    assert line["cpu_native_pps"] is None
    assert line["vs_our_native_cpu"] is None
    assert line["baseline_n"] == 4096
    (shard,) = tmp_path.glob("bench_headline.*.jsonl")
    kinds = [json.loads(x)["kind"] for x in shard.read_text().splitlines()]
    assert kinds.count("migrate_step") == 2 and kinds.count("fast_path") == 2
    assert kinds[-2:] == ["flow_snapshot", "step_time"]
    # the switches turn the captures off, as bench.py's do
    assert line["stress"] is None and line["hier"] is None
    assert line["exchange_dcn_bytes_per_step"] is None
    assert line["rebalance"] is None and line["service"] is None
    assert line["soak"] is None


def test_headline_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        headline.measure(n_local=64)

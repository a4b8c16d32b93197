"""The port's regression guard (``telemetry/regress.py``) against the JAX
package's on the CPU, and its CLI (``tools/bench_check``).

Captures made from a seed with numpy (every guarded metric, nested
fallbacks, recorded and missing spreads, wrappers with ``parsed`` and
failed runs) go through both packages' ``check_capture`` and
``classify_capture``: the same labels and the same report lines. Two
lines are named differences: the fingerprint-drift note (the port
compares ``torch``/``cuda``/``device``/``device_count``, the reference
its jax keys) and the wire-model note (the port's names no TPU
analyzer); both are checked on their own. ``min_of_k``,
``noise_floor`` and ``classify_delta`` agree. The CLI needs
``--history``, refuses a history that holds a TPU capture (the repo's
``BENCH_r*.json``) or one without a fingerprint, and gates the port's
own captures."""

import json

import numpy as np
import pytest

from mpi_grid_redistribute_tpu.telemetry import regress as jregress
from mpi_grid_redistribute_tpu_torch.telemetry import regress
from mpi_grid_redistribute_tpu_torch.tools import bench_check

# the report lines the two packages word differently, on purpose
NAMED_NOTES = ("note        env fingerprint drifted",
               "note        static wire model changed")


def _capture(rng, scale=1.0, spread=True, env=None, nested=False,
             wrap=False, pph=None):
    line = {"metric": "particles_per_sec_per_chip",
            "value": float(rng.uniform(2e9, 3e9) * scale),
            "ms_per_step": float(rng.uniform(2, 3) / scale)}
    if nested:
        line["report"] = {"bw_util": float(rng.uniform(1e-4, 1e-3)),
                          "exchange_bytes_per_sec": float(rng.uniform(1e9,
                                                                      2e9))}
        line["soak"] = {"value": float(rng.uniform(1e8, 2e8) * scale)}
        line["service"] = {"value": float(rng.uniform(1e8, 2e8) * scale),
                           "pipeline_pps": float(rng.uniform(1e8, 2e8)),
                           "probe_cost_factor": float(rng.uniform(1, 1.2))}
        line["rebalance"] = {"steady_ms_per_step": float(rng.uniform(2, 4))}
        line["stress"] = {"bw_util": float(rng.uniform(0.001, 0.01))}
    else:
        line["exchange_bw_util"] = float(rng.uniform(1e-4, 1e-3))
        line["exchange_wire_bytes_per_step"] = 4199200.0
    if spread:
        line["timing_spread"] = float(rng.uniform(0.01, 0.3))
    if env is not None:
        line["env"] = env
    if pph is not None:
        line["progprofile_hash"] = pph
    return {"n": 1, "cmd": "x", "rc": 0, "tail": "", "parsed": line} \
        if wrap else line


PORT_ENV = {"python": "3.12", "torch": "2.11.0+cu128", "cuda": "12.8",
            "device": "NVIDIA H100 80GB HBM3", "device_count": 1}


def _cases(seed):
    rng = np.random.default_rng(seed)
    hist = [_capture(rng, spread=bool(i % 2), nested=bool(i % 3),
                     wrap=bool(i % 2)) for i in range(5)]
    hist.append({"n": 9, "cmd": "x", "rc": 1, "tail": "", "parsed": None})
    return rng, hist


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [1.0, 0.93, 0.5, 2.0])
def test_labels_and_lines_equal_reference(seed, scale):
    rng, hist = _cases(seed)
    cur = _capture(rng, scale=scale, nested=True,
                   spread=bool(seed % 2))
    for threshold in (0.05, 0.10):
        assert regress.check_capture(cur, hist, threshold) == \
            jregress.check_capture(cur, hist, threshold)
        assert regress.classify_capture(cur, hist, threshold) == \
            jregress.classify_capture(cur, hist, threshold)
    assert regress.extract_metrics(cur) == jregress.extract_metrics(cur)
    if scale == 0.5:
        ok, _, labels = regress.classify_capture(cur, hist)
        assert not ok and labels["value"] == regress.REGRESSION


def test_fingerprint_and_wire_notes():
    """The two named lines: the drift note names the port's keys, the
    wire-model note no TPU analyzer; every other line and every label is
    the reference's."""
    rng, hist = _cases(4)
    hist = [dict(h, env=dict(PORT_ENV), progprofile_hash="aa")
            for h in hist[:5] if "parsed" not in h]
    cur = _capture(rng, env=dict(PORT_ENV, torch="2.12.0", device_count=4),
                   pph="bb")
    ok, lines, labels = regress.classify_capture(cur, hist)
    jok, jlines, jlabels = jregress.classify_capture(cur, hist)
    assert (ok, labels) == (jok, jlabels)
    assert [ln for ln in lines if not ln.startswith(NAMED_NOTES)] == [
        ln for ln in jlines if not ln.startswith(NAMED_NOTES)]
    (drift,) = [ln for ln in lines if ln.startswith(NAMED_NOTES[0])]
    assert "torch '2.11.0+cu128'→'2.12.0'" in drift
    assert "device_count 1→4" in drift
    (wire,) = [ln for ln in lines if ln.startswith(NAMED_NOTES[1])]
    assert "'aa'→'bb'" in wire and "progcheck" not in wire
    # a best capture with no fingerprint: the reference's note, verbatim
    bare = [{k: v for k, v in h.items()
             if k not in ("env", "progprofile_hash")} for h in hist]
    note = regress.classify_capture(cur, bare)[1][-1]
    assert note.startswith("note        best capture has no env")
    assert note == jregress.classify_capture(cur, bare)[1][-1]


def test_protocol_helpers_equal_reference():
    rng = np.random.default_rng(7)
    vals = rng.uniform(1, 2, 9).tolist()
    for k in (1, 4, 9):
        it, jt = iter(vals), iter(vals)
        assert regress.min_of_k(lambda: next(it), k=k) == \
            jregress.min_of_k(lambda: next(jt), k=k)
    with pytest.raises(ValueError, match="k must be"):
        regress.min_of_k(lambda: 1.0, k=0)
    for cur, best in ((None, None), (0.1, None), (0.05, 0.2)):
        assert regress.noise_floor(cur, best) == jregress.noise_floor(
            cur, best)
    for delta in (-0.1, 0.0, 0.05, 0.12, 0.3, 1.0):
        for noise in (0.0, 0.04, 0.1):
            assert regress.classify_delta(delta, noise) == \
                jregress.classify_delta(delta, noise)
    assert regress.GUARDED_METRICS == jregress.GUARDED_METRICS
    assert regress._NESTED_KEYS == jregress._NESTED_KEYS


def test_env_fingerprint_is_the_ports():
    fp = regress.env_fingerprint("cpu")
    for key in ("python", "numpy", "torch", "cuda", "device",
                "device_count", "gpu_name_power_limit", "host_cpu",
                "host_cores"):
        assert key in fp, key
    assert fp["device"] == "cpu" and fp["device_count"] == 0
    assert "jax" not in fp
    assert set(regress._FP_COMPARE_KEYS) <= set(fp)


def _dump(path, doc):
    path.write_text(json.dumps(doc))
    return str(path)


def test_cli_gates_the_ports_captures(tmp_path, capsys):
    rng = np.random.default_rng(11)
    (tmp_path / "h").mkdir()
    hist = [_capture(rng, env=PORT_ENV) for _ in range(3)]
    for i, h in enumerate(hist):
        _dump(tmp_path / "h" / f"c{i}.json", h)
    # better than the best on every guarded metric: OK
    best = dict(hist[0], value=1.1 * max(h["value"] for h in hist),
                ms_per_step=0.9 * min(h["ms_per_step"] for h in hist),
                exchange_bw_util=1.1 * max(h["exchange_bw_util"]
                                           for h in hist))
    ok = _dump(tmp_path / "ok.json", best)
    slow = _dump(tmp_path / "slow.json",
                 _capture(rng, scale=0.4, env=PORT_ENV))
    hist = str(tmp_path / "h" / "*.json")
    assert bench_check.main(["--history", hist, "--current", ok]) == 0
    assert "bench-check ok" in capsys.readouterr().out
    assert bench_check.main(["--history", hist, "--current", slow]) == 1
    assert "FAIL (REGRESSION)" in capsys.readouterr().out
    assert bench_check.main(["--history", hist, "--current", slow,
                             "--legacy"]) == 1
    assert bench_check.main(["--history", hist]) in (0, 1)
    assert "checking" in capsys.readouterr().out
    assert bench_check.main(["--history", str(tmp_path / "none*")]) == 2


def test_cli_refuses_a_mixed_fingerprint_history(tmp_path, capsys):
    """A TPU capture of the reference (the repo's ``BENCH_r*.json``) or a
    capture with no fingerprint never becomes the card's baseline."""
    rng = np.random.default_rng(12)
    (tmp_path / "h").mkdir()
    _dump(tmp_path / "h" / "c0.json", _capture(rng, env=PORT_ENV))
    with open("BENCH_r06.json") as f:
        tpu = json.load(f)
    assert "jax" in tpu["parsed"]["env"]
    _dump(tmp_path / "h" / "c1.json", tpu)
    cur = _dump(tmp_path / "cur.json", _capture(rng, env=PORT_ENV))
    hist = str(tmp_path / "h" / "*.json")
    assert bench_check.main(["--history", hist, "--current", cur]) == 2
    out = capsys.readouterr().out
    assert "mixed fingerprints" in out and "c1.json" in out
    assert bench_check.main(["--history", "BENCH_r*.json",
                             "--current", cur]) == 2
    capsys.readouterr()
    bare = _dump(tmp_path / "bare.json", _capture(rng))
    assert bench_check.main(["--history", str(tmp_path / "h" / "c0.json"),
                             "--current", bare]) == 2
    assert "no port fingerprint" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        bench_check.main(["--current", cur])  # --history is required

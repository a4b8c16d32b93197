"""The port's kernelcheck (``analysis/kernelcheck.py``,
``analysis/rules_kernel.py``, ``tools/kernelcheck.py``) against the JAX
package's on the CPU.

The registry carries the reference's six case names, and each of those
cases' inputs are byte-equal to what the reference's builders make;
beside them it carries a case of each kernel the port has beyond the
reference's (``kc.PORT_CASES``: the scan deposit's payload sort and its
tile carries). Each plain
twin is bit-equal to the reference case's ``reference`` and to its Pallas
kernel run in interpret mode on the same inputs, except where the
reference's jitted CPU code contracts kernel 1's drift into a fused
multiply-add (ROADMAP C10): there the drifted positions are held against
the reference twin run op by op (``jax.disable_jit``), which does not
contract, and the key against every leg.

On the CPU the ops take their plain routes, so K001, K002 and K005 check
the plain versions and the checker itself: each rule is shown to fire on
a case broken on purpose (a write past the tensor, a changed input, an
output element left unwritten, a scatter outside its contract's set, a
twin that disagrees), K000 on a case that takes the plain route and on a
kernel with no case, K003 on a footprint over Hopper's limits and on a
baseline that drifted or was written by another nvcc. The CLI's formats,
exit codes, suppressions and baseline round trip are checked here; the
card's run is in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.analysis import kernelcheck as jkc
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.ops import pallas_driftbin
from mpi_grid_redistribute_tpu_torch.analysis import kernelcheck as kc
from mpi_grid_redistribute_tpu_torch.analysis import rules_kernel as rk
from mpi_grid_redistribute_tpu_torch.ops import _build
from mpi_grid_redistribute_tpu_torch.tools import kernelcheck as cli

CPU = torch.device("cpu")
NAMES = sorted(jkc.default_kernels())
# the port's registry: the reference's cases and the port's own
CASES = sorted(NAMES + list(kc.PORT_CASES))


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _plain_outputs(name):
    case = kc.default_kernels()[name].build()
    return list(case.plain(rk.plain_tensors(case, CPU)).values())


# ------------------------------------------------------------- registry


def test_registry_names_are_the_references():
    specs = kc.default_kernels()
    assert sorted(specs) == CASES
    ref = jkc.default_kernels()
    for name in NAMES:
        assert specs[name].scatter == ref[name].scatter, name
    for name in CASES:
        assert specs[name].kernel in _build.KERNELS
        assert specs[name].launches == 1
    assert not set(kc.PORT_CASES) & set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_case_inputs_are_byte_equal_to_the_references(name):
    ref = jkc.default_kernels()[name].build()
    case = kc.default_kernels()[name].build()
    args = _tuple(ref.args)
    ins = list(case.inputs.values())
    assert len(args) == len(ins)
    for a, b in zip(args, ins):
        assert _bits_equal(a, b), name


@pytest.mark.parametrize("name", NAMES)
def test_plain_twin_is_bit_equal_to_the_reference_twin(name):
    ref = jkc.default_kernels()[name].build()
    want = _tuple(ref.reference(ref.args))
    got = _plain_outputs(name)
    assert len(got) == len(want)
    if name == "driftbin_v8_n2048":
        # the jitted twin contracts p + v * dt into an FMA on the CPU
        # (C10): the positions against the twin run op by op, the key
        # against the jitted twin as well
        with jax.disable_jit():
            eager = pallas_driftbin.drift_wrap_bin_xla(
                ref.args, 0.05, JDomain(0.0, 1.0, periodic=True),
                JGrid((2, 2, 2)), 8, 8)
        assert _bits_equal(eager[0], got[0].numpy())
        assert _bits_equal(eager[1], got[1].numpy())
        assert _bits_equal(want[1], got[1].numpy())
        return
    for w, g in zip(want, got):
        assert _bits_equal(w, g.numpy()), name


@pytest.mark.parametrize("name", NAMES)
def test_plain_twin_is_bit_equal_to_the_interpret_kernel(name):
    ref = jkc.default_kernels()[name].build()
    interp = _tuple(ref.run(ref.args, True))
    got = _plain_outputs(name)
    pairs = list(zip(interp, got))
    if name == "driftbin_v8_n2048":
        pairs = pairs[1:]  # the key; the positions carry the FMA (C10)
    for w, g in pairs:
        assert _bits_equal(w, g.numpy()), name


def test_every_build_kernel_has_a_case():
    assert rk.check_registry(kc.default_kernels()) == []
    specs = kc.default_kernels()
    del specs["segdep_2d_6000"]
    found = rk.check_registry(specs)
    assert [(f.rule, f.kernel) for f in found] == [("K000", "segsum_sorted")]
    bogus = dict(kc.default_kernels())
    bogus["x"] = kc.KernelSpec("x", specs["dfscan_300x256"].build, "",
                               "no_such_kernel", "", "")
    assert [f.rule for f in rk.check_registry(bogus)] == ["K000"]


# ------------------------------------------------------- the CPU leg


def test_the_six_cases_are_clean_on_the_plain_routes():
    findings, footprints, n_suppressed = kc.run_kernelcheck(
        kc.default_kernels(), device="cpu")
    assert findings == [] and footprints == {} and n_suppressed == 0


def test_k000_fires_on_a_case_that_takes_the_plain_route():
    """On the CPU every case takes its plain route: with the launch
    counts required, each is a K000 finding (a case guarding nothing)."""
    specs = {n: kc.default_kernels()[n]
             for n in ("overlay_half_7x4096", "segdep_2d_6000")}
    findings, _, _ = kc.run_kernelcheck(specs, rules=["K000"],
                                        device="cpu", require_launches=True,
                                        partial=True)
    assert sorted((f.rule, f.kernel) for f in findings) == [
        ("K000", "overlay_half_7x4096"), ("K000", "segdep_2d_6000")]
    assert all("plain route" in f.message for f in findings)
    assert rk.check_launches("c", specs["segdep_2d_6000"],
                             {"segsum_sorted": 4},
                             {"segsum_sorted": 5}) == []


def test_k000_reports_a_case_that_raises():
    spec = kc.default_kernels()["dfscan_300x256"]

    def build():
        raise RuntimeError("no build")

    broken = {"dfscan_300x256": kc.KernelSpec(
        spec.name, build, "", spec.kernel, spec.op, spec.plain_op)}
    findings, _, _ = kc.run_kernelcheck(broken, rules=["K005"],
                                        device="cpu", partial=True)
    assert [(f.rule, f.kernel) for f in findings] == [
        ("K000", "dfscan_300x256")]
    assert "RuntimeError: no build" in findings[0].message


def _broken(name, run=None, plain=None):
    """The registered case ``name`` with its ``run`` or ``plain``
    replaced (each gets the case's own ``run``/``plain`` as ``orig``)."""
    spec = kc.default_kernels()[name]

    def build():
        case = spec.build()
        orig_run, orig_plain = case.run, case.plain
        if run is not None:
            case.run = lambda t: run(t, orig_run)
        if plain is not None:
            case.plain = lambda t: plain(t, orig_plain)
        return case

    return {name: kc.KernelSpec(spec.name, build, spec.description,
                                spec.kernel, spec.op, spec.plain_op,
                                scatter=spec.scatter)}


def test_k001_fires_on_a_write_past_the_tensor():
    def run(t, orig):
        out = orig(t)
        hi = t["hi"]
        # one float past the end of hi, inside its guard band
        torch.as_strided(hi, (hi.numel() + 1,), (1,))[-1] = 1.0
        return out

    findings, _, _ = kc.run_kernelcheck(_broken("dfscan_300x256", run=run),
                                        rules=["K001"], device="cpu")
    assert [f.rule for f in findings] == ["K001"]
    assert "'hi'" in findings[0].message and "4 after" in findings[0].message


def test_k002_fires_on_a_changed_input_and_an_unwritten_output():
    def run(t, orig):
        out = orig(t)
        t["x"][0, 0] = 7.0  # writes its input
        t["lo"].view(torch.int32)[3, :5] = int(np.int32(-1515870811))
        return out  # lo's first elements read as the sentinel

    findings, _, _ = kc.run_kernelcheck(_broken("dfscan_300x256", run=run),
                                        rules=["K002"], device="cpu")
    msgs = sorted(f.message for f in findings)
    assert [f.rule for f in findings] == ["K002", "K002"]
    assert "5 element(s) of 'lo' were never written" in msgs[0]
    assert "changed 1 element(s) of its input 'x'" in msgs[1]


def test_k002_fires_on_a_scatter_outside_its_contract():
    def run(t, orig):
        out = orig(t)
        t["flat"][2, 0] = 0  # column 0 is no target of this case
        return out

    name = "overlay_half_7x4096"
    assert 0 not in kc.default_kernels()[name].build().inputs["targets"]
    findings, _, _ = kc.run_kernelcheck(_broken(name, run=run),
                                        rules=["K002"], device="cpu")
    msgs = [f.message for f in findings]
    assert any("outside its contract's set" in m for m in msgs), msgs


def test_k002_fires_when_launches_differ_and_a_duplicate_is_not_refused():
    calls = []

    def run(t, orig):
        out = orig(t)
        calls.append(1)
        # the checked run, the sentinel run, then the three repeated
        # launches: flip a bit in the second of those
        if len(calls) == 4:
            t["flat"][1, int(t["targets"][0])] ^= 1
        return out

    name = "overlay_int8_7x8192"
    findings, _, _ = kc.run_kernelcheck(_broken(name, run=run),
                                        rules=["K002"], device="cpu")
    assert ["launch 2 of 3 differs" in f.message for f in findings] == [True]
    spec = kc.default_kernels()[name]

    def build():
        case = spec.build()
        case.duplicate = lambda t: None  # accepts the duplicate
        return case

    quiet = {name: kc.KernelSpec(name, build, "", spec.kernel, spec.op,
                                 spec.plain_op, scatter=True)}
    findings, _, _ = kc.run_kernelcheck(quiet, rules=["K002"], device="cpu")
    assert [f.message for f in findings] == [
        "a duplicate in-range target was not refused under the op's debug "
        "check"]


def test_k005_fires_on_a_twin_that_disagrees():
    def plain(t, orig):
        out = orig(t)
        out["out"] = out["out"].clone()
        out["out"][0, 0] += 1.0
        return out

    findings, _, _ = kc.run_kernelcheck(
        _broken("segdep_2d_6000", plain=plain), rules=["K005"], device="cpu")
    assert [(f.rule, f.message) for f in findings] == [
        ("K005", "'out' differs from the plain twin in 1 of 2048 element(s)")]


# ----------------------------------------------------------- K003


ROW = {"regs": 32, "static_smem": 0, "dynamic_smem": 0, "local_bytes": 0,
       "threads": 256, "max_threads": 1024}


def test_k003_gates_hopper_limits():
    assert rk.check_footprint("c", {"f": dict(ROW)}) == []
    over = dict(ROW, regs=256, static_smem=50000, dynamic_smem=190000,
                threads=1024)
    msgs = [f.message for f in rk.check_footprint("c", {"f": over})]
    assert len(msgs) == 4
    assert any("256 registers a thread > 255" in m for m in msgs)
    assert any("240000 shared bytes a block > 232448" in m for m in msgs)
    assert any("50000 static shared bytes > 49152" in m for m in msgs)
    assert any("256 x 1024 registers a block" in m for m in msgs)
    wide = dict(ROW, threads=2048)
    assert any("2048 threads a block > the 1024" in f.message
               for f in rk.check_footprint("c", {"f": wide}))


def test_k003_baseline_missing_drift_stale_and_toolkit():
    fp = {"a": {"f": dict(ROW)}, "b": {"g": dict(ROW)}}
    base = {"nvcc": "12.8.93", "footprints": copy.deepcopy(fp)}
    assert rk.compare_footprints(fp, base, "12.8.93") == []
    missing = rk.compare_footprints(fp, None, "12.8.93")
    assert [f.rule for f in missing] == ["K003"]
    assert "no footprint baseline" in missing[0].message
    drift = copy.deepcopy(fp)
    drift["a"]["f"]["regs"] = 40
    msgs = [f.message for f in rk.compare_footprints(drift, base, "12.8.93")]
    assert msgs == ["drift: f.regs is 40, the baseline has 32"]
    tool = rk.compare_footprints(fp, base, "12.9.41")
    assert [f.message for f in tool] == [
        "toolkit drift: the footprint baseline was written with nvcc "
        "12.8.93, this run builds with nvcc 12.9.41; re-baseline on purpose "
        "with --update-baseline and justify the change"]
    stale = rk.compare_footprints({"a": fp["a"]}, base, "12.8.93",
                                  check_stale=True)
    assert [(f.kernel, "stale" in f.message) for f in stale] == [("b", True)]
    assert rk.compare_footprints({"a": fp["a"]}, base, "12.8.93",
                                 check_stale=True, partial=True) == []
    moved = {"a": {"f2": dict(ROW)}, "b": fp["b"]}
    assert len(rk.compare_footprints(moved, base, "12.8.93")) == 2


def test_k003_baseline_round_trip(tmp_path):
    from mpi_grid_redistribute_tpu_torch.analysis import baseline

    path = str(tmp_path / "kc.json")
    fp = {"a": {"f": dict(ROW)}}
    baseline.write_kernelcheck_baseline(path, fp, "12.8.93", "H100, 700 W")
    doc = baseline.load_kernelcheck_baseline(path)
    assert doc["footprints"] == fp and doc["nvcc"] == "12.8.93"
    assert rk.compare_footprints(fp, doc, "12.8.93") == []
    assert baseline.load_kernelcheck_baseline(str(tmp_path / "no")) is None


def test_committed_footprint_baseline_covers_the_registry():
    from mpi_grid_redistribute_tpu_torch.analysis import baseline

    doc = baseline.load_kernelcheck_baseline()
    assert sorted(doc["footprints"]) == CASES
    assert doc["nvcc"] and doc["device"].startswith("NVIDIA")
    for name, row in doc["footprints"].items():
        assert row and rk.check_footprint(name, row) == [], name


# ------------------------------------------------------------- CLI


def test_cli_json_sarif_github_on_the_cpu(capsys):
    assert cli.main(["--device", "cpu", "--format=json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["kernels"] == CASES
    assert cli.main(["--device", "cpu", "--format=sarif",
                     "--kernels", "segdep_2d_6000"]) == 0
    run = json.loads(capsys.readouterr().out)["runs"][0]
    assert run["tool"]["driver"]["name"] == "kernelcheck"
    assert run["results"] == []
    assert cli.main(["--device", "cpu", "--format=github",
                     "--kernels", "dfscan_300x256"]) == 0
    assert capsys.readouterr().out == ""


def test_cli_findings_render_in_every_format(monkeypatch, capsys):
    f = kc.KernelFinding("K002", "dfscan_300x256", "changed 1 element(s)")
    monkeypatch.setattr(kc, "run_kernelcheck",
                        lambda *a, **k: ([f], {}, 0))
    assert cli.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "<dfscan_300x256>: K002: changed 1 element(s)" in out
    assert cli.main(["--device", "cpu", "--format=sarif"]) == 1
    run = json.loads(capsys.readouterr().out)["runs"][0]
    assert [r["ruleId"] for r in run["results"]] == ["K002"]
    assert cli.main(["--device", "cpu", "--format=github"]) == 1
    line = capsys.readouterr().out.strip()
    assert line.startswith("::") and "K002" in line
    assert cli.main(["--device", "cpu", "--format=json"]) == 1
    assert json.loads(capsys.readouterr().out)["findings"][0]["rule"] == \
        "K002"


def test_cli_usage_errors_and_listings(capsys):
    assert cli.main(["--rules", "K009", "--device", "cpu"]) == 2
    assert cli.main(["--rules", "K004", "--device", "cpu"]) == 2
    assert cli.main(["--kernels", "nope", "--device", "cpu"]) == 2
    assert cli.main(["--update-baseline", "--device", "cpu"]) == 2
    assert cli.main(["--sanitize", "--device", "cpu"]) == 2
    capsys.readouterr()
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(r in out for r in kc.K_RULE_IDS)
    assert "K004  not applicable" in out
    assert cli.main(["--list-kernels"]) == 0
    out = capsys.readouterr().out
    assert "scatter_rows_16384x7 [scatter]" in out


def test_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_check_baseline_reports_stale_entries(tmp_path, capsys):
    from mpi_grid_redistribute_tpu_torch.analysis import baseline

    path = str(tmp_path / "kc.json")
    fp = {n: {"f": dict(ROW)} for n in CASES}
    baseline.write_kernelcheck_baseline(path, fp, "12.8.93", "card")
    assert cli.main(["--check-baseline", "--baseline", path]) == 0
    fp["gone_case"] = {"f": dict(ROW)}
    baseline.write_kernelcheck_baseline(path, fp, "12.8.93", "card")
    assert cli.main(["--check-baseline", "--baseline", path]) == 1
    assert "gone_case" in capsys.readouterr().out
    assert cli.main(["--check-baseline", "--baseline",
                     str(tmp_path / "none.json")]) == 1


def test_suppressions_line_and_file_level(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("x = 1\ny = 2  # kernelcheck: disable=K002\n")
    f2 = kc.KernelFinding("K002", "c", "m", path=str(src), line=2)
    f1 = kc.KernelFinding("K001", "c", "m", path=str(src), line=2)
    kept, n = kc.apply_suppressions([f1, f2])
    assert kept == [f1] and n == 1
    src.write_text("# kernelcheck: disable-file=all\n")
    assert kc.apply_suppressions([f1, f2]) == ([], 2)
    src.write_text("# gridlint: disable=K002\n")
    assert kc.apply_suppressions([f2]) == ([f2], 0)


def test_sanitizer_summaries_parse():
    assert cli.parse_sanitizer(
        "memcheck", "========= ERROR SUMMARY: 0 errors\n") == 0
    assert cli.parse_sanitizer(
        "memcheck", "========= ERROR SUMMARY: 3 errors\n") == 3
    assert cli.parse_sanitizer(
        "racecheck", "========= RACECHECK SUMMARY: 2 hazards displayed "
        "(2 errors, 0 warnings)\n") == 2
    assert cli.parse_sanitizer("racecheck", "Error: no device\n") is None
    # the sanitizer's own failure is no count of the program's errors
    refused = ("========= COMPUTE-SANITIZER\n========= Error: Device not "
               "supported. Please refer to the \"Supported Devices\" "
               "section\n========= ERROR SUMMARY: 3 errors\n")
    assert cli.parse_sanitizer("memcheck", refused) is None
    assert cli.sanitizer_failure(refused).startswith("Device not supported")


def test_sanitize_without_a_sanitizer_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(cli, "_sanitizer", lambda: None)
    findings, table, failure = cli.sanitize(["dfscan_300x256"])
    assert (findings, table) == ([], {})
    assert failure.startswith("compute-sanitizer not found")


def test_sanitize_that_cannot_check_the_device_exits_2(monkeypatch, capsys):
    """The card's sandbox answers "Device not supported": the run is
    reported as not checked (exit 2), never as the program's errors and
    never as a pass."""
    import subprocess

    text = ("========= COMPUTE-SANITIZER\n========= Error: Device not "
            "supported. Please refer to the \"Supported Devices\" section\n"
            "========= ERROR SUMMARY: 3 errors\n")
    monkeypatch.setattr(cli, "_sanitizer", lambda: "/usr/bin/true")
    monkeypatch.setattr(_build, "build_all", lambda: None)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 1, text, ""))
    findings, table, failure = cli.sanitize(["dfscan_300x256"])
    assert findings == [] and failure.startswith(
        "compute-sanitizer --tool memcheck did not check dfscan_300x256 "
        "(exit 1): Device not supported")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cli.main(["--sanitize", "--kernels", "dfscan_300x256"]) == 2
    assert "did not check" in capsys.readouterr().err
    ok = "========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, 0 " \
        "warnings)\n========= ERROR SUMMARY: 0 errors\n"
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, ok, ""))
    findings, table, failure = cli.sanitize(["dfscan_300x256"])
    assert (findings, failure) == ([], None)
    assert table == {"dfscan_300x256": {"memcheck": 0, "racecheck": 0}}


def test_out_hooks_write_into_the_given_tensor_and_check_it():
    from mpi_grid_redistribute_tpu_torch.ops import dfscan, segdep

    x = torch.randn(4, 32)
    hi, lo = torch.empty(4, 32), torch.empty(4, 32)
    got = dfscan.tile_df_cumsum_rows(x, _out=(hi, lo))
    assert got[0] is hi and got[1] is lo
    want = dfscan.tile_df_cumsum_rows(x)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    with pytest.raises(ValueError, match="_out must be a contiguous"):
        dfscan.tile_df_cumsum_rows(x, _out=(torch.empty(4, 31), lo))
    keys = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    rel = torch.full((1, 4), 0.5)
    with pytest.raises(ValueError, match="_out must be a contiguous"):
        segdep.segsum_sorted(keys, rel, None, 4, (4,),
                             _out=torch.empty(2, 4, dtype=torch.float64))

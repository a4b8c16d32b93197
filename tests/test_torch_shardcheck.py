"""shardcheck's S004 and the DCN-ratio gate over the port's program
registry (``analysis/shardcheck.py``, ``tools/shardcheck.py``),
mirroring the JAX package's ``tests/test_shardcheck.py`` (S004) and
``tests/test_hierarchical.py`` (the DCN-ratio gate) by name where a case
carries over. The registry's sharded programs run once a session in a
gloo world of 8 on the CPU under a time limit. The reference's
shardcheck fails on jax 0.9.0, so the reference's side is its committed
``wire_attribution``."""

import json
import os
import subprocess
import sys

import pytest

from torch_rank_cases import shared_world

from mpi_grid_redistribute_tpu_torch.analysis import (
    baseline as tbaseline,
    progcheck,
    sarif,
    shardcheck,
)
from mpi_grid_redistribute_tpu_torch.utils.costcount import Event

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BASELINE = os.path.join(ROOT, "mpi_grid_redistribute_tpu", "analysis",
                            "progprofile_baseline.json")
PROGRAMS = progcheck.default_programs()
SHARDED = sorted(n for n, p in PROGRAMS.items() if p.topology == "sharded")


def _spec(dcn_shape=None):
    return progcheck.ProgramSpec("p", build=None, dcn_shape=dcn_shape)


def _rec(*colls):
    return {"events": [Event("coll", n, (), b, axes, world)
                       for n, b, axes, world in colls]}


@pytest.fixture(scope="module")
def wires(tmp_path_factory):
    """The live S004 attribution of every registry program: the sharded
    ones from one gloo world of 8 (the registry input), the vrank ones
    recorded here."""
    ranks = shared_world(
        tmp_path_factory, "shardcheck_registry",
        "mpi_grid_redistribute_tpu_torch.analysis.progcheck:world_records",
        progcheck.WORLD_SIZE, args=(SHARDED, None, ("registry",)),
        timeout=600.0)
    out = {}
    for name in SHARDED:
        rec = dict(ranks[0][name]["registry"])
        rec["events"] = [Event(*e) for e in rec["events"]]
        out[name] = shardcheck.wire_profile(rec, PROGRAMS[name])
    vr = {n: p for n, p in PROGRAMS.items() if p.topology == "vranks"}
    rec = progcheck.record_registry(vr, device="cpu", host_read_check=False)
    out.update(shardcheck.wire_profiles(rec, vr))
    return out


# ---------------------------------------------- S004: the attribution


def test_wire_profile_bills_the_crossed_axis():
    w = shardcheck.wire_profile(_rec(("psum", 64, ("x",), False)), _spec())
    assert w == {"per_axis": {"x": 64},
                 "per_domain": {"dcn": 0, "ici": 64}, "total_bytes": 64}


def test_wire_profile_two_axis_collective_bills_both():
    w = shardcheck.wire_profile(
        _rec(("all_to_all", 128, ("x", "y"), True)), _spec())
    assert w["per_axis"] == {"x": 128, "y": 128}
    assert w["per_domain"] == {"dcn": 0, "ici": 128}
    assert w["total_bytes"] == 128


def test_wire_profile_dcn_axis_rolls_up_to_dcn():
    w = shardcheck.wire_profile(_rec(
        ("ppermute", 80, ("dcn_x",), False),
        ("all_to_all", 256, ("x", "y", "z"), False)), _spec((2, 1, 1)))
    assert w["per_axis"] == {"dcn_x": 80, "x": 256, "y": 256, "z": 256}
    assert w["per_domain"] == {"dcn": 80, "ici": 256}
    assert [shardcheck.axis_domain(a) for a in
            ("dcn_x", "pod", "slices_y", "x", "wan")] == [
        "dcn", "dcn", "dcn", "ici", "dcn"]


def test_wire_profile_whole_mesh_collective_crosses_the_pods():
    """A collective over the whole mesh of a deployment over pods crosses
    the expanded axes: ``dcn_x`` in front of the split ``x``."""
    rec = _rec(("pmin", 4, ("x", "y", "z"), True))
    assert shardcheck.wire_profile(rec, _spec((2, 1, 1)))["per_axis"] == {
        "dcn_x": 4, "x": 4, "y": 4, "z": 4}
    assert shardcheck.wire_profile(rec, _spec())["per_domain"] == {
        "dcn": 0, "ici": 4}
    assert shardcheck.expanded_axes(("x", "y", "z"), (1, 2, 2)) == (
        "x", "dcn_y", "y", "dcn_z", "z")


def test_compare_wire_drift_missing_and_stale():
    base = {"p": {"per_axis": {"x": 8}, "per_domain": {"dcn": 0, "ici": 8},
                  "total_bytes": 8}}
    assert shardcheck.compare_wire(base, base) == []
    wide = {"p": {"per_axis": {"x": 16}, "per_domain": {"dcn": 0, "ici": 16},
                  "total_bytes": 16}}
    findings = shardcheck.compare_wire(wide, base)
    assert findings and all(f.rule == "S004" for f in findings)
    assert any("total wire bytes drifted" in f.message for f in findings)
    assert any("axis 'x'" in f.message for f in findings)
    missing = shardcheck.compare_wire(base, {})
    assert "no committed wire-attribution" in missing[0].message
    stale = shardcheck.compare_wire({}, base, check_stale=True)
    assert "stale wire-attribution" in stale[0].message
    assert shardcheck.compare_wire({}, base, check_stale=True,
                                   partial=True) == []


def test_repo_programs_shardcheck_clean(wires):
    doc = tbaseline.load_progprofile_doc()
    assert sorted(wires) == sorted(PROGRAMS)
    assert shardcheck.gate_wires(wires, doc, check_stale=True) == []


def test_s004_perturbed_width_fails_check_until_update(wires, tmp_path):
    """A width perturbed in the committed attribution fails S004 until
    ``--update-baseline`` rewrites it."""
    path = str(tmp_path / "prof.json")
    doc = tbaseline.load_progprofile_doc()
    name = "canonical_planar_sharded"
    doc["wire_attribution"][name]["per_axis"]["x"] += 64
    doc["wire_attribution"][name]["total_bytes"] += 64
    with open(path, "w") as fh:
        json.dump(doc, fh)
    findings = shardcheck.gate_wires(wires, tbaseline.load_progprofile_doc(
        path))
    assert findings and all(f.rule == "S004" and f.program == name
                            for f in findings)
    tbaseline.write_wire_baseline(path, wires)
    assert shardcheck.gate_wires(
        wires, tbaseline.load_progprofile_doc(path)) == []


def test_reference_wire_copy_is_the_references():
    with open(REF_BASELINE) as f:
        ref = json.load(f)["wire_attribution"]["programs"]
    assert tbaseline.load_progprofile_doc()[
        "reference_wire_attribution"] == ref


def test_port_wire_equals_the_references_but_the_stats_gather(wires):
    """Every axis and domain the reference bills, the port bills the
    same bytes plus its stats all-gather (the justified list)."""
    with open(REF_BASELINE) as f:
        ref = json.load(f)["wire_attribution"]["programs"]
    profiles = tbaseline.load_progprofile_baseline()
    for name, w in wires.items():
        extra = profiles[name]["collective_bytes"].get("all_gather", 0) - (
            json.load(open(REF_BASELINE))["profiles"][name][
                "collective_bytes"].get("all_gather", 0))
        assert sorted(w["per_axis"]) == sorted(ref[name]["per_axis"]), name
        for axis, b in w["per_axis"].items():
            assert b - ref[name]["per_axis"][axis] == extra, (name, axis)
        assert w["total_bytes"] - ref[name]["total_bytes"] == extra


# ------------------------------------------- S004: the DCN-ratio gate


def test_check_dcn_ratio_gate():
    def w(hier_dcn, flat_dcn):
        return {
            "canonical_hierarchical_sharded": {
                "per_domain": {"dcn": hier_dcn, "ici": 100}},
            "canonical_sparse_pods": {
                "per_domain": {"dcn": flat_dcn, "ici": 0}},
        }

    assert shardcheck.check_dcn_ratio(w(15, 100)) == []
    out = shardcheck.check_dcn_ratio(w(16, 100))
    assert len(out) == 1 and out[0].rule == "S004"
    assert "16" in out[0].message and "15%" in out[0].message
    out = shardcheck.check_dcn_ratio(w(0, 0))
    assert len(out) == 1 and "vacuous" in out[0].message
    assert shardcheck.check_dcn_ratio({"other": {}}) == []


def test_committed_baseline_holds_the_dcn_ratio():
    """The acceptance criterion against the committed baseline: the
    hierarchical program's DCN bytes at most 15% of the flat sparse
    engine's on the same two pods (the reference: 116 / 4132 B); the
    port's stats all-gather spans both pods and bills DCN on both."""
    wires = tbaseline.load_wire_baseline()
    hier, flat = shardcheck.dcn_ratio(wires)
    assert (hier, flat) == (200, 4212)
    assert hier / flat <= shardcheck.DCN_RATIO_MAX
    assert shardcheck.check_dcn_ratio(wires) == []


def test_live_dcn_ratio_is_the_committed(wires):
    assert shardcheck.dcn_ratio(wires) == (200, 4212)


# ------------------------------------------------------------- CLI


def test_shard_finding_surface():
    f = shardcheck.ShardFinding("S004", "prog", "msg")
    assert f.render() == "<prog>: S004: msg"
    assert f.to_dict()["program"] == "prog"
    doc = sarif.to_sarif([f], "shardcheck", shardcheck.RULE_DOCS)
    assert doc["runs"][0]["results"][0]["ruleId"] == "S004"


def test_rule_docs_cover_all_rules():
    assert set(shardcheck.RULE_DOCS) == set(shardcheck.S_RULE_IDS)
    for rid in shardcheck.NOT_APPLICABLE:
        assert shardcheck.RULE_DOCS[rid].startswith("not applicable")


def test_cli_lists_and_usage(capsys):
    assert shardcheck.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(r in out for r in shardcheck.S_RULE_IDS)
    assert shardcheck.main(["--programs", "nope"]) == 2


def test_cli_vrank_subset_sarif(capsys):
    rc = shardcheck.main(["--programs", "canonical_planar_vranks",
                          "--device", "cpu", "--format", "sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["runs"][0]["results"] == []


def test_cli_check_on_the_tree_exits_0():
    """The acceptance criterion: ``tools.shardcheck --check`` on the
    tree; the text names S001-S003 not applicable and the DCN ratio."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_grid_redistribute_tpu_torch.tools."
         "shardcheck", "--check", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DCN ratio 200 / 4212 B = 4.75%" in proc.stdout
    for rid in shardcheck.NOT_APPLICABLE:
        assert f"{rid}: not applicable" in proc.stdout

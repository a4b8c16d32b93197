"""progcheck's rules J001-J004 over the port's program registry
(``analysis/rules_prog.py``, ``analysis/progcheck.py``), mirroring the
JAX package's ``tests/test_progcheck.py`` by name where a case carries
over. Every rule gets a clean case on the tree and a seeded case on
which it fires. The registry's sharded programs and the seeded world
fixtures (``torch_prog_cases.py``) run once a session in gloo worlds on
the CPU under a time limit, so no test can hang the suite.

The reference's progcheck fails on jax 0.9.0, so J004 and the
reference's side are held against its committed
``progprofile_baseline.json`` (read here, copied into the port's
baseline), not against a run of it.
"""

import json
import os
import subprocess
import sys

import pytest

import torch_prog_cases as cases
from torch_rank_cases import shared_world

from mpi_grid_redistribute_tpu_torch.analysis import (
    baseline as tbaseline,
    core,
    progcheck,
    rules_prog,
)
from mpi_grid_redistribute_tpu_torch.analysis.progcheck import (
    ProgFinding,
    ProgramSpec,
    default_programs,
    registry_coverage,
)
from mpi_grid_redistribute_tpu_torch.utils import costcount

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BASELINE = os.path.join(ROOT, "mpi_grid_redistribute_tpu", "analysis",
                            "progprofile_baseline.json")
SHARDED = sorted(n for n, p in default_programs().items()
                 if p.topology == "sharded")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _events(rec):
    return dict(rec, events=[costcount.Event(*e) for e in rec["events"]])


@pytest.fixture(scope="module")
def registry_world(tmp_path_factory):
    """Every rank's records of every sharded registry program on each of
    its inputs (one gloo world of 8 on the CPU)."""
    return shared_world(
        tmp_path_factory, "progcheck_registry",
        "mpi_grid_redistribute_tpu_torch.analysis.progcheck:world_records",
        progcheck.WORLD_SIZE, args=(SHARDED, None, None), timeout=600.0)


@pytest.fixture(scope="module")
def fixture_world(tmp_path_factory):
    """The seeded world fixtures' records (one gloo world of 2)."""
    return shared_world(tmp_path_factory, "progcheck_fixtures",
                        "torch_prog_cases:fixture_world", 2, timeout=300.0)


@pytest.fixture(scope="module")
def vrank_records():
    """Rank-0 records and host reads of every vrank registry program."""
    vr = {n: p for n, p in default_programs().items()
          if p.topology == "vranks"}
    return progcheck.record_registry(vr, device="cpu")


def _spec(name, **kw):
    return ProgramSpec(name=name, build=None, **kw)


def _world_entry(ranks, name):
    return {
        "records": {d: _events(r) for d, r in ranks[0][name].items()},
        "sequences": {d: [r[name][d]["sequence"] for r in ranks]
                      for d in ranks[0][name]},
    }


# ------------------------------------------- J000: registry coverage


def test_registry_is_complete():
    assert registry_coverage(default_programs()) == []


def test_registry_coverage_catches_missing_engine():
    programs = {k: v for k, v in default_programs().items()
                if k != "canonical_neighbor_vranks"}
    findings = registry_coverage(programs)
    assert [f.rule for f in findings] == ["J000"]
    assert "'neighbor'" in findings[0].message


def test_registry_coverage_catches_missing_resident_tag():
    programs = {k: v for k, v in default_programs().items()
                if "resident" not in v.tags}
    assert any("'resident'" in f.message
               for f in registry_coverage(programs))


def test_register_program_rejects_duplicates():
    spec = default_programs()["canonical_planar_vranks"]
    with pytest.raises(ValueError, match="already registered"):
        progcheck.register_program(spec)


def test_finding_render_and_dict():
    f = ProgFinding("J001", "prog", "msg")
    assert f.render() == "<prog>: J001: msg"
    d = f.to_dict()
    assert d["rule"] == "J001" and d["program"] == "prog"


# ------------------------------ J001: one collective schedule a rank


def test_j001_fires_on_mismatched_schedules_local_pred():
    seqs = {"registry": [[("pmin", 4)], [("psum", 4)]]}
    findings = rules_prog.check_j001("p", seqs)
    assert [f.rule for f in findings] == ["J001"]
    assert "ranks [1]" in findings[0].message


def test_j001_clean_when_schedules_match():
    seqs = {"registry": [[("all_to_all", 32), ("pmin", 4)]] * 8}
    assert rules_prog.check_j001("p", seqs) == []


def test_j001_fires_when_one_rank_falls_back_alone():
    dense = [[("pmin", 4), ("all_to_all", 2048)]] * 2
    over = [[("pmin", 4), ("all_to_all", 2048)],
            [("pmin", 4), ("all_to_all", 512)]]
    findings = rules_prog.check_j001(
        "p", {"registry": dense, "one_rank_overflows": over})
    assert findings and all(f.rule == "J001" for f in findings)
    assert any("not the dense schedule" in f.message for f in findings)


def test_j001_clean_with_pmin_agreed_guard(fixture_world):
    entry = _world_entry(fixture_world, "guard_agreed")
    assert rules_prog.check_j001("guard_agreed", entry["sequences"]) == []


def test_j001_fires_on_a_guard_each_rank_reads_alone(fixture_world):
    """The seeded case: rank 0 overflows and branches on its own guard;
    the recorded schedules differ (a deadlock with unequal wires)."""
    entry = _world_entry(fixture_world, "guard_local")
    findings = rules_prog.check_j001("guard_local", entry["sequences"])
    assert [f.rule for f in findings] == ["J001"]
    assert core.exit_code(findings) == 1


def test_j001_registry_is_clean_on_every_input(registry_world):
    """Every sharded program: the same sequence on all 8 ranks on each
    input, and the dense schedule on every rank when one rank alone
    overflows its mover block (the count-driven ones)."""
    for name in SHARDED:
        entry = _world_entry(registry_world, name)
        assert rules_prog.check_j001(name, entry["sequences"]) == [], name
    count_driven = [n for n in SHARDED
                    if default_programs()[n].engine in progcheck.COUNT_DRIVEN]
    assert sorted(count_driven) == [
        "apply_assignment_oneshot", "canonical_hierarchical_sharded",
        "canonical_neighbor_sharded", "canonical_sparse_pods",
        "canonical_sparse_sharded"]
    for name in count_driven:
        seqs = registry_world[0][name]
        assert "one_rank_overflows" in seqs, name
        if default_programs()[name].fastpath is None:
            assert set(seqs) == {"registry", "one_rank_overflows"}, name
            continue
        assert set(seqs) == set(progcheck.INPUTS), name
        # the movers fit: another (narrower) schedule than the dense one
        assert seqs["fast"]["sequence"] != seqs["registry"]["sequence"]


# -------------------------------------------- J002: resident purity


def test_j002_fires_on_item_in_resident_program():
    fn, args = cases.resident_fixture(item=True)
    reads, err = progcheck.host_reads(fn, args, "cpu")
    spec = _spec("spiked_resident", resident=True)
    findings = rules_prog.check_j002(spec, reads, err)
    assert [f.rule for f in findings] == ["J002"]
    assert "'item': 2" in findings[0].message


def test_j002_clean_without_host_syncs():
    fn, args = cases.resident_fixture(item=False)
    reads, err = progcheck.host_reads(fn, args, "cpu")
    assert reads == {} and err is None
    assert rules_prog.check_j002(_spec("r", resident=True), reads) == []


def test_j002_ignores_non_resident_programs():
    assert rules_prog.check_j002(_spec("r"), {"item": 3}) == []


def test_j002_counts_every_host_read_kind():
    import torch

    x = torch.arange(6.0)
    with progcheck.HostReadCounter() as reads:
        x.sum().item()
        x.tolist()
        bool(x[0] > 0)
        int(x[1])
        float(x[2])
        x.cpu()
        x.numpy()
        torch.nonzero(x)
        torch.masked_select(x, x > 2)
        x[x > 2]
    assert reads.counts == {
        "item": 1, "tolist": 1, "__bool__": 1, "__int__": 1, "__float__": 1,
        "cpu": 1, "numpy": 1, "nonzero": 1, "masked_select": 1,
        "mask_index": 1}


def test_j002_registry_resident_programs_are_pure(vrank_records):
    resident = [n for n, p in default_programs().items() if p.resident]
    assert sorted(resident) == ["pipelined_macro_step",
                                "resident_macro_step",
                                "resident_macro_step_probed"]
    for name in resident:
        entry = vrank_records[name]
        assert entry["host_reads"] == {} and entry["sync_error"] is None, (
            name, entry["host_reads"])


# -------------------------------------- J003: the fast-path contracts


def _recorded(fn, args):
    return {"registry": progcheck.record_program(fn, args)}


def test_j003_migrate_clean(vrank_records):
    spec = default_programs()["migrate_sparse_vranks"]
    recs = vrank_records["migrate_sparse_vranks"]["records"]
    assert len(rules_prog.regions(recs["registry"]["events"],
                                  rules_prog.MIGRATE_FAST)) == 3
    assert rules_prog.check_j003(spec, recs) == []


def test_j003_fixture_migrate_clean():
    spec = _spec("clean_migrate", fastpath="migrate", fast_rows=16)
    assert rules_prog.check_j003(
        spec, _recorded(*cases.migrate_fixture())) == []


def test_j003_fires_on_spiked_sort_in_fast_branch():
    spec = _spec("spiked_sort", fastpath="migrate", fast_rows=16)
    findings = rules_prog.check_j003(
        spec, _recorded(*cases.migrate_fixture(sort=True)))
    assert [f.rule for f in findings] == ["J003"]
    assert "aten::sort" in findings[0].message


def test_j003_fires_on_resident_scale_gather():
    spec = _spec("spiked_gather", fastpath="migrate", fast_rows=16)
    findings = rules_prog.check_j003(
        spec, _recorded(*cases.migrate_fixture(wide_gather=True)))
    assert findings and all(f.rule == "J003" for f in findings)
    assert any("resident-scale" in f.message for f in findings)


def test_j003_fires_when_migrate_fast_path_is_lost():
    spec = _spec("lost", fastpath="migrate", fast_rows=16)
    findings = rules_prog.check_j003(
        spec, _recorded(*cases.resident_fixture()))
    assert [f.rule for f in findings] == ["J003"]
    assert "fast path lost" in findings[0].message


def test_j003_sparse_wire_clean(registry_world, fixture_world):
    spec = default_programs()["canonical_sparse_sharded"]
    entry = _world_entry(registry_world, "canonical_sparse_sharded")
    assert rules_prog.check_j003(spec, entry["records"]) == []
    fixture = _spec("clean_wire", fastpath="sparse_wire",
                    capacity=cases.CAP, mover_cap=cases.B)
    assert rules_prog.check_j003(
        fixture, _world_entry(fixture_world, "sparse_ok")["records"]) == []


def test_j003_fires_on_broken_pool_width_ratio(fixture_world):
    spec = _spec("spiked_wire", fastpath="sparse_wire",
                 capacity=cases.CAP, mover_cap=cases.B)
    findings = rules_prog.check_j003(
        spec, _world_entry(fixture_world, "sparse_broken_width")["records"])
    assert [f.rule for f in findings] == ["J003"]
    assert "B/cap contract" in findings[0].message


def test_j003_neighbor_clean(registry_world, fixture_world):
    spec = default_programs()["canonical_neighbor_sharded"]
    entry = _world_entry(registry_world, "canonical_neighbor_sharded")
    assert rules_prog.check_j003(spec, entry["records"]) == []
    fixture = _spec("clean_neighbor", fastpath="neighbor_wire")
    assert rules_prog.check_j003(
        fixture, _world_entry(fixture_world, "neighbor_ok")["records"]) == []


def test_j003_fires_when_fast_branch_loses_ppermute(fixture_world):
    spec = _spec("spiked_neighbor", fastpath="neighbor_wire")
    findings = rules_prog.check_j003(
        spec,
        _world_entry(fixture_world, "neighbor_lost_ppermute")["records"])
    assert [f.rule for f in findings] == ["J003"]
    assert "ppermute" in findings[0].message


def test_j003_pipeline_clean(vrank_records):
    spec = default_programs()["pipelined_macro_step"]
    recs = vrank_records["pipelined_macro_step"]["records"]
    steady = rules_prog.regions(recs["registry"]["events"],
                                rules_prog.PIPELINE_STEADY)
    assert len(steady) == 3 and all(
        rules_prog.bins_before_landing(r) for r in steady)
    assert rules_prog.check_j003(spec, recs) == []
    fixture = _spec("clean_pipe", fastpath="pipeline")
    assert rules_prog.check_j003(
        fixture, _recorded(*cases.pipeline_fixture())) == []


@pytest.mark.parametrize("seed,words", [
    ({"land_first": True}, "lands step k before it bins"),
    ({"landings": 2}, "lands with 2 scatters"),
])
def test_j003_fires_on_broken_pipeline_iteration(seed, words):
    spec = _spec("spiked_pipe", fastpath="pipeline")
    findings = rules_prog.check_j003(
        spec, _recorded(*cases.pipeline_fixture(**seed)))
    assert findings and all(f.rule == "J003" for f in findings)
    assert any(words in f.message for f in findings)


def test_j003_unknown_fastpath_kind_is_loud():
    with pytest.raises(ValueError, match="unknown fastpath"):
        rules_prog.check_j003(_spec("bad_kind", fastpath="nope"),
                              _recorded(*cases.resident_fixture()))


def test_fastpath_checks_cover_the_registry():
    kinds = {p.fastpath for p in default_programs().values()} - {None}
    assert kinds == set(rules_prog.FASTPATH_CHECKS)


# --------------------------------------- J004: wire/footprint drift


def _fixture_profile(width):
    import torch

    def fn(x):
        return (x * 2.0).sum(dim=0)

    rec = progcheck.record_program(fn, (torch.ones((width, 4)),))
    prof = rules_prog.program_profile(rec)
    prof["collective_bytes"] = {"all_to_all": 16 * width}
    prof["collective_bytes_total"] = 16 * width
    return prof


def test_peak_live_bytes_is_deterministic_and_grows_with_width():
    assert _fixture_profile(16) == _fixture_profile(16)
    assert _fixture_profile(32)["peak_live_bytes"] > \
        _fixture_profile(16)["peak_live_bytes"]


def test_j004_width_perturbation_fails_drift_gate():
    base, wide = _fixture_profile(16), _fixture_profile(32)
    assert rules_prog.compare_profiles({"w": base}, {"w": base}) == []
    findings = rules_prog.compare_profiles({"w": wide}, {"w": base})
    assert findings and all(f.rule == "J004" for f in findings)
    assert any("collective_bytes_total drifted" in f.message
               for f in findings)
    assert any("peak_live_bytes drifted" in f.message for f in findings)
    assert any("all_to_all" in f.message for f in findings)
    # the escape hatch: against the refreshed profile the drift is gone
    assert rules_prog.compare_profiles({"w": wide}, {"w": wide}) == []
    # and the reference's tolerance: within rtol is not a drift
    assert rules_prog.drifted(100, 104, 0.05) is False
    assert rules_prog.drifted(100, 106, 0.05) is True


def test_j004_missing_and_stale_baseline_entries():
    prof = _fixture_profile(16)
    missing = rules_prog.compare_profiles({"m": prof}, {})
    assert [f.rule for f in missing] == ["J004"]
    assert "no committed profile baseline" in missing[0].message
    stale = rules_prog.compare_profiles({}, {"gone": prof},
                                        check_stale=True)
    assert [f.rule for f in stale] == ["J004"]
    assert "stale baseline entry" in stale[0].message
    assert rules_prog.compare_profiles({}, {"gone": prof}, check_stale=True,
                                       partial=True) == []


def test_progprofile_baseline_roundtrip(tmp_path):
    path = str(tmp_path / "prof.json")
    assert tbaseline.load_progprofile_baseline(path) is None
    tbaseline.write_progprofile_baseline(path, {"a": {"x": 3}})
    tbaseline.write_wire_baseline(path, {"a": {"total_bytes": 1}})
    assert tbaseline.load_progprofile_baseline(path) == {"a": {"x": 3}}
    assert tbaseline.load_wire_baseline(path) == {"a": {"total_bytes": 1}}
    (tmp_path / "bad.json").write_text('{"not": "profiles"}')
    with pytest.raises(SystemExit, match="malformed"):
        tbaseline.load_progprofile_baseline(str(tmp_path / "bad.json"))


def _live_profiles(registry_world, vrank_records):
    out = {n: rules_prog.program_profile(e["records"]["registry"])
           for n, e in vrank_records.items()}
    out.update({n: rules_prog.program_profile(
        _events(registry_world[0][n]["registry"])) for n in SHARDED})
    return out


def test_repo_programs_match_the_committed_baseline(registry_world,
                                                    vrank_records):
    """J004 on the tree: the live profiles are the committed ones, and
    every difference from the reference's is on the justified list."""
    doc = tbaseline.load_progprofile_doc()
    live = _live_profiles(registry_world, vrank_records)
    assert sorted(live) == sorted(default_programs())
    assert progcheck.gate_profiles(live, doc, check_stale=True) == []


def test_port_collective_bytes_equal_the_references_but_the_stats_gather(
        registry_world, vrank_records):
    """The acceptance criterion: the port's per-primitive bytes are the
    reference's committed ``profiles`` on all 17 programs, apart from the
    justified ``all_gather`` (and the totals and counts it moves)."""
    with open(REF_BASELINE) as f:
        ref = json.load(f)["profiles"]
    live = _live_profiles(registry_world, vrank_records)
    assert sorted(ref) == sorted(live)
    for name in live:
        mine = dict(live[name]["collective_bytes"])
        theirs = dict(ref[name]["collective_bytes"])
        extra = mine.pop("all_gather", 0) - theirs.pop("all_gather", 0)
        assert mine == theirs, name
        assert extra >= 0
        assert live[name]["collective_bytes_total"] - \
            ref[name]["collective_bytes_total"] == extra
    diffs = rules_prog.reference_differences(
        live, ref, rules_prog.REFERENCE_PROFILE_KEYS)
    assert {k for _, k, _, _ in diffs} == {
        "collective_bytes.all_gather", "collective_bytes_total",
        "collective_count"}


def test_reference_copies_are_the_references():
    with open(REF_BASELINE) as f:
        ref = json.load(f)
    doc = tbaseline.load_progprofile_doc()
    assert doc["reference_profiles"] == ref["profiles"]
    assert doc["reference_wire_attribution"] == \
        ref["wire_attribution"]["programs"]
    for entry in doc["reference_differences"]:
        assert entry["justification"], entry


def test_j004_fires_on_an_unjustified_reference_difference():
    ref = {"p": {"collective_bytes": {"all_to_all": 8},
                 "collective_bytes_total": 8, "collective_count": 1}}
    cur = {"p": {"collective_bytes": {"all_to_all": 8, "all_gather": 4},
                 "collective_bytes_total": 12, "collective_count": 2}}
    findings = rules_prog.compare_reference(
        "J004", "profiles", cur, ref, [],
        rules_prog.REFERENCE_PROFILE_KEYS)
    assert len(findings) == 3 and all(f.rule == "J004" for f in findings)
    justified = [{"section": "profiles", "program": "p", "key": k,
                  "port": a, "reference": b, "justification": "why"}
                 for _, k, a, b in rules_prog.reference_differences(
                     cur, ref, rules_prog.REFERENCE_PROFILE_KEYS)]
    assert rules_prog.compare_reference(
        "J004", "profiles", cur, ref, justified,
        rules_prog.REFERENCE_PROFILE_KEYS) == []
    # a justification without a reason does not count
    justified[0]["justification"] = ""
    assert len(rules_prog.compare_reference(
        "J004", "profiles", cur, ref, justified,
        rules_prog.REFERENCE_PROFILE_KEYS)) == 1


def test_recording_changes_no_count():
    fn, args = cases.pipeline_fixture()
    with costcount.counting() as plain:
        fn(*args)
    rec = progcheck.record_program(fn, args)
    assert rec["cost"] == plain.as_dict()


# ------------------------------------------------------------- CLI


def test_cli_exit_codes_and_json(capsys, tmp_path):
    assert progcheck.main(["--rules", "J999"]) == 2
    capsys.readouterr()
    assert progcheck.main(["--programs", "nope"]) == 2
    capsys.readouterr()
    assert progcheck.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(r in listed for r in progcheck.J_RULE_IDS)
    assert progcheck.main(["--list-programs"]) == 0
    assert "resident_macro_step" in capsys.readouterr().out
    bl = str(tmp_path / "prof.json")
    with open(bl, "w") as fh:
        json.dump(tbaseline.load_progprofile_doc(), fh)
    rc = progcheck.main(["--programs", "resident_macro_step", "--baseline",
                         bl, "--device", "cpu", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["findings"] == []
    assert "resident_macro_step" in out["profiles"]


def test_cli_sarif_and_github_formats(capsys, tmp_path):
    """An empty profile baseline makes the program a J004 finding: a
    cheap way to exercise the failure formats (exit 1)."""
    bl = str(tmp_path / "empty.json")
    with open(bl, "w") as fh:
        json.dump({"profiles": {}}, fh)
    args = ["--programs", "canonical_planar_vranks", "--baseline", bl,
            "--device", "cpu", "--rules", "J004"]
    assert progcheck.main(args + ["--format", "sarif"]) == 1
    sarif = json.loads(capsys.readouterr().out)
    results = sarif["runs"][0]["results"]
    assert results and all(r["ruleId"] == "J004" for r in results)
    assert any("canonical_planar_vranks" in r["message"]["text"]
               for r in results)
    ids = {r["id"] for r in sarif["runs"][0]["tool"]["driver"]["rules"]}
    assert set(progcheck.J_RULE_IDS) <= ids
    assert progcheck.main(args + ["--format", "github"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and all(l.startswith("::warning ") for l in lines)


def test_cli_seeded_programs_exit_1(capsys, monkeypatch):
    """J002 and J003 fire through the CLI on seeded vrank programs
    registered beside the registry (exit 1)."""
    def build(fn_args):
        return lambda device=None, n_local=None, mesh=None: fn_args

    seeded = {
        "seeded_resident": ProgramSpec(
            "seeded_resident", build(cases.resident_fixture(item=True)),
            topology="vranks", resident=True),
        "seeded_fastpath": ProgramSpec(
            "seeded_fastpath", build(cases.migrate_fixture(sort=True)),
            topology="vranks", fastpath="migrate", fast_rows=16),
    }
    monkeypatch.setattr(progcheck, "PROGRAMS",
                        dict(progcheck.PROGRAMS, **seeded))
    rc = progcheck.main(["--programs", ",".join(seeded), "--device", "cpu",
                         "--rules", "J002,J003"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "<seeded_resident>: J002" in out
    assert "<seeded_fastpath>: J003" in out


def test_cli_check_on_the_tree_exits_0():
    """The acceptance criterion: ``progcheck --check --device cpu`` on
    the tree (every program, every rule, the committed baseline)."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "mpi_grid_redistribute_tpu_torch.analysis.progcheck", "--check",
         "--device", "cpu"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s) over 17 program(s)" in proc.stdout


def test_records_cache_serves_the_registry_once(registry_world,
                                                vrank_records, tmp_path,
                                                monkeypatch, capsys):
    """A recording saved where ``RECORDS_CACHE_ENV`` points serves every
    registry-wide request (check_all's progcheck and shardcheck share one
    recording); a recording that misses a program is refused."""
    full = dict(vrank_records)
    full.update(progcheck.world_entries(registry_world, SHARDED))
    path = str(tmp_path / "registry.pkl")
    with pytest.raises(ValueError, match="missing"):
        progcheck.write_records_cache(path, "cpu", vrank_records)
    progcheck.write_records_cache(path, "cpu", full)
    monkeypatch.setenv(progcheck.RECORDS_CACHE_ENV, path)
    monkeypatch.setattr(progcheck, "_record", None)  # must not record
    served = progcheck.record_registry(device="cpu")
    assert sorted(served) == sorted(default_programs())
    assert progcheck.run_progcheck(recorded=served)[0] == []
    only = progcheck.record_registry(
        {n: default_programs()[n] for n in SHARDED[:1]}, device="cpu",
        inputs=("registry",))
    assert list(only[SHARDED[0]]["records"]) == ["registry"]
    assert progcheck.main(["--check", "--device", "cpu"]) == 0
    assert "0 finding(s) over 17 program(s)" in capsys.readouterr().out

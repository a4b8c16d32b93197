"""The port's analysis records against the JAX package's: ``Finding`` and
its renderings, the SARIF documents, the GitHub annotation lines and the
baseline split are byte-equal for the same findings; the checkers' exit
codes follow the reference's convention (0 clean, 1 findings, 2 usage)."""

import json

import pytest

from mpi_grid_redistribute_tpu.analysis import baseline as jbaseline
from mpi_grid_redistribute_tpu.analysis import core as jcore
from mpi_grid_redistribute_tpu.analysis import sarif as jsarif
from mpi_grid_redistribute_tpu_torch.analysis import baseline as tbaseline
from mpi_grid_redistribute_tpu_torch.analysis import core as tcore
from mpi_grid_redistribute_tpu_torch.analysis import sarif as tsarif

ROWS = [
    ("ST01", "tools/storecheck.py", 1, 0, "segment sha256 mismatch", ""),
    ("ST06", "tools/storecheck.py", 1, 0,
     "summary-0003 counts diverge: {'a': 1}", "check"),
    ("A002", "PERF.md", 7, 3, "table is stale\nrun --render (100%)",
     "attribution"),
    ("I004", "a\\b.py", 0, 5, "no flow arrows", ""),
]

RULE_DOCS = {"ST01": "segments match", "A002": "tables current",
             "Z999": "a rule no finding fired"}


def _findings(mod):
    return [mod.Finding(*r) for r in ROWS]


@pytest.mark.parametrize("i", range(len(ROWS)))
def test_finding_renders_as_the_reference(i):
    j, t = jcore.Finding(*ROWS[i]), tcore.Finding(*ROWS[i])
    assert t.render() == j.render()
    assert t.to_dict() == j.to_dict()
    assert t.baseline_key() == j.baseline_key()


@pytest.mark.parametrize("docs", [None, RULE_DOCS])
def test_sarif_byte_equal(docs):
    want = json.dumps(jsarif.to_sarif(_findings(jcore), "storecheck", docs),
                      indent=2)
    got = json.dumps(tsarif.to_sarif(_findings(tcore), "storecheck", docs),
                     indent=2)
    assert got == want


def test_sarif_of_no_findings_and_merge_byte_equal():
    docs = [(m.to_sarif([], "a"), m.to_sarif(_findings(c), "b", RULE_DOCS))
            for m, c in ((jsarif, jcore), (tsarif, tcore))]
    assert json.dumps(tsarif.merge_sarif(docs[1])) == json.dumps(
        jsarif.merge_sarif(docs[0]))


def test_github_annotations_byte_equal():
    assert tsarif.github_annotations(_findings(tcore)) == \
        jsarif.github_annotations(_findings(jcore))


def test_program_findings_fold_the_program_name():
    from mpi_grid_redistribute_tpu.analysis.progcheck import ProgFinding as J
    from mpi_grid_redistribute_tpu_torch.analysis.progcheck import (
        ProgFinding as T,
    )

    j = J("J000", "<registry>", "engine 'x' has no program")
    t = T("J000", "<registry>", "engine 'x' has no program")
    assert t.render() == j.render()
    # the same SARIF result but for the registry module's own path
    jr = jsarif.to_sarif([j], "progcheck")["runs"][0]["results"][0]
    tr = tsarif.to_sarif([t], "progcheck")["runs"][0]["results"][0]
    uri = "physicalLocation", "artifactLocation", "uri"
    for r in (jr, tr):
        loc = r["locations"][0]
        loc[uri[0]][uri[1]][uri[2]] = "<path>"
    assert tr == jr
    assert t.path == "mpi_grid_redistribute_tpu_torch/analysis/progcheck.py"


def test_split_baselined_as_the_reference(tmp_path):
    path = tmp_path / "b.json"
    tbaseline.write_baseline(str(path), _findings(tcore)[:2], ["doc"])
    tkeys = tbaseline.load_baseline(str(path))
    jkeys = jbaseline.load_baseline(str(path))
    assert tkeys == jkeys and len(tkeys) == 2
    tnew, told = tbaseline.split_baselined(_findings(tcore), tkeys)
    jnew, jold = jbaseline.split_baselined(_findings(jcore), jkeys)
    assert [f.to_dict() for f in tnew] == [f.to_dict() for f in jnew]
    assert [f.to_dict() for f in told] == [f.to_dict() for f in jold]


def test_committed_checker_baselines_are_empty():
    for path in (tbaseline.storecheck_baseline_path(),
                 tbaseline.incident_demo_baseline_path()):
        assert tbaseline.load_baseline(path) == set()


def test_malformed_baseline_is_an_error(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"findings": [{"rule": "ST01"}]}))
    with pytest.raises(SystemExit):
        tbaseline.load_baseline(str(path))


def test_exit_codes():
    assert (tcore.EXIT_CLEAN, tcore.EXIT_FINDINGS, tcore.EXIT_USAGE) == (
        0, 1, 2)
    assert tcore.exit_code([]) == 0
    assert tcore.exit_code(_findings(tcore)) == 1


def test_attribution_snapshot_helpers_round_trip(tmp_path):
    path = str(tmp_path / "snap.json")
    assert tbaseline.load_attribution_baseline(path) is None
    assert tbaseline.attribution_hash(path) is None
    tbaseline.write_attribution_baseline(path, roofline={"b": 1, "a": 2})
    tbaseline.write_attribution_baseline(path, phase_tables={"x": {}},
                                         roofline=None)
    doc = tbaseline.load_attribution_baseline(path)
    assert list(doc["roofline"]) == ["a", "b"] and doc["phase_tables"]
    assert len(tbaseline.attribution_hash(path)) == 16
    (tmp_path / "other.json").write_text("{}")
    with pytest.raises(SystemExit):
        tbaseline.load_attribution_baseline(str(tmp_path / "other.json"))

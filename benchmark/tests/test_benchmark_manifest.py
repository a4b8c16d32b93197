"""The manifest and the files the harness finds by name agree, and names or
units the manifest forbids are refused."""

import json
from pathlib import Path

import pytest

from benchmark import spec, trace

ROOT = Path(__file__).resolve().parents[2]
MULTI_CARD_READERS = {"dev_ms.collectives", "wire_mb.step"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_found_by_name(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        cell = spec.load_cell(w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert cell.chips == w["chips"]
        c = configs[w["config"]]
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert c["file"].startswith(manifest["paths"][0] + "/")
    used = {w["config"] for w in manifest["workloads"]}
    assert used == set(configs)


def _reported(manifest, cell):
    """The end-to-end metrics a cell's line has."""
    return {m["name"] for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_metric_file_listed(manifest):
    files = {m.NAME: m for m in trace.load_metrics()}
    cells = {w["name"] for w in manifest["workloads"]}
    named = set()
    for m in manifest["per_layer"]:
        sfx = {spec.load_cell(c).metric_suffix for c in m["workloads"]}
        assert len(sfx) == 1 and set(m["workloads"]) <= cells, m["name"]
        sfx = sfx.pop()
        assert m["name"].endswith(sfx), m["name"]
        f = files[m["name"][:len(m["name"]) - len(sfx)]]
        named.add(f.NAME)
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (
            f.UNIT, f.LAYER, f.MOVES + sfx, f.SOURCE), m["name"]
        for c in m["workloads"]:
            assert m["moves"] in _reported(manifest, c), (m["name"], c)
    # the readers of the exchange between cards read in a cell on several
    # cards (configs/uniform_2x2x2_4card.json), which the manifest has not
    assert set(files) - named == MULTI_CARD_READERS


def test_every_cell_reports_what_the_contract_asks(manifest):
    for w in manifest["workloads"]:
        cell = spec.load_cell(w["name"])
        sfx = cell.metric_suffix
        assert _reported(manifest, w["name"]) == {
            "particles_per_s" + sfx, "call_ms_p95" + sfx, "peak_mem_gib",
            "setup_s"}, w["name"]
        assert any(w["name"] in m["workloads"]
                   for m in manifest["per_layer"])


def test_manifest_names_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in manifest[k]]
    for n in names:
        spec.check_name(n)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        spec.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


@pytest.mark.parametrize("bad", [
    "a b", "x,y", "a/b", "café", "-lead", "", "n" * 65, ".x"])
def test_bad_names_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


@pytest.mark.parametrize("bad", ["tokens per second", "µs", "",
                                 "x" * 17, "ms\t"])
def test_bad_units_refused(bad):
    with pytest.raises(ValueError):
        spec.check_unit(bad)


@pytest.mark.parametrize("workload", [
    "uniform_2x2x2", "uniform_2x2x2.m2_s4.x", "nosuch.m2_s4",
    "uniform_2x2x2.nosuch", "uniform 2x2x2.m2_s4"])
def test_unknown_or_malformed_cell_refused(workload):
    with pytest.raises((ValueError, FileNotFoundError)):
        spec.load_cell(workload)


ONESHOT_READERS = {"dev_ms.call", "redistribute_roofline",
                   "blocking_reads.call", "idle_share"}


def test_each_entry_reports_its_readers(manifest):
    """A configuration's entry is the loop or the one-shot call; a one-shot
    cell runs on one card, one call a step, and lists the readers of the
    call (with the device's idle share), and no loop cell lists the call's
    own readers."""
    cells = {w["name"]: spec.load_cell(w["name"]) for w in manifest["workloads"]}
    assert {c.entry for c in cells.values()} == {"loop", "redistribute"}
    for name, cell in cells.items():
        sfx = cell.metric_suffix
        listed = {m["name"][:len(m["name"]) - len(sfx)]
                  for m in manifest["per_layer"] if name in m["workloads"]}
        if cell.entry == "redistribute":
            assert (cell.chips, cell.steps_per_call) == (1, 1), name
            assert listed == ONESHOT_READERS, name
        else:
            assert not listed & (ONESHOT_READERS - {"idle_share"}), name

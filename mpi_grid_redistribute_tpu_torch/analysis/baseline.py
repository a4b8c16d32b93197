"""The committed baselines of the port's checkers (the port's share of
the JAX package's ``analysis/baseline.py``). Every file holds the port's
own numbers, written by the port's own ``--update-baseline``:

* ``analysis/storecheck_baseline.json`` and
  ``analysis/incident_demo_baseline.json``: grandfathered findings of
  ``tools.storecheck`` and ``tools.incident_demo`` (expected empty).
  Entries match on the line-insensitive :meth:`Finding.baseline_key`;
* ``analysis/progprofile_baseline.json``: the ``profiles`` section, the
  collective bytes each registered program sends a call, counted by
  ``telemetry.roofline.count_cost``, and its recorded peak live bytes
  (progcheck's J004); ``wire_attribution``, those bytes billed to the
  mesh axes and the ICI/DCN domains they cross (shardcheck's S004);
  ``reference_profiles`` and ``reference_wire_attribution``, copies of
  the JAX package's committed sections, and ``reference_differences``,
  the justified list of numbers in which the port differs from them;
* ``telemetry/attribution_baseline.json``: the span tables and the
  roofline rows ``tools.attribution`` measured on the card;
* ``analysis/kernelcheck_baseline.json``: K003's footprint table, the
  registers and shared bytes of every function each kernelcheck case
  launches, read on the card, with the ``nvcc`` version that built them;
* ``analysis/racecheck_baseline.json``: racecheck's justified findings.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from mpi_grid_redistribute_tpu_torch.analysis.core import Finding

BaselineKey = Tuple[str, str, str, str]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PROGPROFILE_NAME = "progprofile_baseline.json"
_STORECHECK_NAME = "storecheck_baseline.json"
_INCIDENT_DEMO_NAME = "incident_demo_baseline.json"
_ATTRIBUTION_NAME = "attribution_baseline.json"
_KERNELCHECK_NAME = "kernelcheck_baseline.json"
_RACECHECK_NAME = "racecheck_baseline.json"


def storecheck_baseline_path() -> str:
    return os.path.join(_HERE, _STORECHECK_NAME)


def incident_demo_baseline_path() -> str:
    return os.path.join(_HERE, _INCIDENT_DEMO_NAME)


def racecheck_baseline_path() -> str:
    return os.path.join(_HERE, _RACECHECK_NAME)


def load_baseline(path: str) -> Set[BaselineKey]:
    """Read a findings baseline into the set of suppressed keys. A missing
    file is an empty baseline; a malformed one is an error (ignoring it
    would un-gate every grandfathered finding)."""
    if not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("findings", data if isinstance(data, list) else [])
    keys: Set[BaselineKey] = set()
    for e in entries:
        try:
            keys.add((e["rule"], e["path"], e["symbol"], e["message"]))
        except (TypeError, KeyError) as exc:
            raise SystemExit(
                f"malformed baseline entry in {path}: {e!r} ({exc})"
            )
    return keys


def write_baseline(path: str, findings, doc: List[str],
                   justification: str = "grandfathered at baseline "
                   "creation") -> None:
    """Write a findings baseline: ``doc`` (the file's explanation, one
    string a line) and one entry a finding."""
    entries = [
        {
            "rule": f.rule,
            "path": f.path,
            "symbol": f.symbol,
            "message": f.message,
            "justification": justification,
        }
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"_doc": list(doc), "findings": entries}, fh, indent=1)
        fh.write("\n")


def split_baselined(
    findings: Iterable[Finding], baseline: Set[BaselineKey]
) -> Tuple[List[Finding], List[Finding]]:
    """Partition into (new, grandfathered) against ``baseline``."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if f.baseline_key() in baseline else new).append(f)
    return new, old


def _read_doc(path: str) -> dict:
    """A whole baseline document, ``{}`` when absent."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        try:
            data = json.load(fh)
        except ValueError as exc:
            raise SystemExit(f"malformed baseline {path}: {exc}")
    if not isinstance(data, dict):
        raise SystemExit(
            f"malformed baseline {path}: expected a top-level JSON object")
    return data


def _write_doc(path: str, doc: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


# -- the collective-bytes profile (the reference's J004 ``profiles``) ------

_PROGPROFILE_COMMENT = (
    "progcheck's J004 and shardcheck's S004 baseline. 'profiles': the "
    "collective bytes of every registered program (analysis/progcheck.py), "
    "one call at the registry's shapes on rank 0 of the program's world, "
    "a primitive and in total, the count of collective calls, and the "
    "recorded peak live bytes (utils/costcount.py's liveness model); "
    "'wire_attribution': those bytes billed to each mesh axis a "
    "collective crosses and once to the ICI or DCN domain "
    "(analysis/shardcheck.py); 'reference_profiles' and "
    "'reference_wire_attribution': copies of the JAX package's committed "
    "sections; 'reference_differences': every number in which the port "
    "differs from them, each with its justification (a difference not on "
    "the list is a finding). Refresh with `python -m "
    "mpi_grid_redistribute_tpu_torch.analysis.progcheck --update-baseline` "
    "and `python -m mpi_grid_redistribute_tpu_torch.tools.shardcheck "
    "--update-baseline` and justify the delta in the commit message."
)


def progprofile_baseline_path() -> str:
    return os.path.join(_HERE, _PROGPROFILE_NAME)


def load_progprofile_baseline(
    path: Optional[str] = None,
) -> Optional[Dict[str, dict]]:
    """name -> profile dict, or ``None`` when the file does not exist."""
    path = path or progprofile_baseline_path()
    if not os.path.exists(path):
        return None
    profiles = _read_doc(path).get("profiles")
    if not isinstance(profiles, dict):
        raise SystemExit(
            f"malformed profile baseline {path}: expected a top-level "
            "'profiles' object")
    return profiles


def load_progprofile_doc(path: Optional[str] = None) -> dict:
    """The whole baseline document (``profiles``, ``wire_attribution``,
    the reference's copied sections and the justified differences),
    ``{}`` when the file does not exist."""
    return _read_doc(path or progprofile_baseline_path())


def write_progprofile_baseline(path: Optional[str],
                               profiles: Dict[str, dict]) -> None:
    path = path or progprofile_baseline_path()
    doc = _read_doc(path)
    doc["comment"] = _PROGPROFILE_COMMENT
    doc["profiles"] = {k: profiles[k] for k in sorted(profiles)}
    _write_doc(path, doc)


def load_wire_baseline(path: Optional[str] = None
                       ) -> Optional[Dict[str, dict]]:
    """shardcheck's S004 ``wire_attribution`` section (name -> per-axis
    and per-domain bytes), ``None`` when absent."""
    wires = _read_doc(path or progprofile_baseline_path()).get(
        "wire_attribution")
    if wires is not None and not isinstance(wires, dict):
        raise SystemExit(
            f"malformed wire baseline {path}: expected a "
            "'wire_attribution' object")
    return wires


def write_wire_baseline(path: Optional[str],
                        wires: Dict[str, dict]) -> None:
    path = path or progprofile_baseline_path()
    doc = _read_doc(path)
    doc["wire_attribution"] = {k: wires[k] for k in sorted(wires)}
    _write_doc(path, doc)


# -- the attribution snapshot (telemetry/attribution_baseline.json) --------

_ATTRIBUTION_COMMENT = (
    "The port's attribution snapshot: phase_tables holds the span tables' "
    "rows (bench/knockout_stages.py, bench/knockout_pipeline.py, "
    "bench/knockout_deposit.py: device time a step by the program's own "
    "spans) measured "
    "on the card named in 'device', the source the PERF.md tables are "
    "rendered from; roofline holds the roofline_report rows (counted "
    "bytes and flops over H100 roofs, measured CUDA-event times). "
    "Timings depend on the card, so `tools.attribution --check` gates "
    "STRUCTURE only. Refresh with `python -m "
    "mpi_grid_redistribute_tpu_torch.tools.attribution --update-baseline` "
    "on the card (then --render)."
)


def attribution_baseline_path() -> str:
    return os.path.join(os.path.dirname(_HERE), "telemetry",
                        _ATTRIBUTION_NAME)


def load_attribution_baseline(path: Optional[str] = None) -> Optional[dict]:
    """The whole snapshot, or ``None`` when it does not exist yet."""
    path = path or attribution_baseline_path()
    if not os.path.exists(path):
        return None
    doc = _read_doc(path)
    if "phase_tables" not in doc and "roofline" not in doc:
        raise SystemExit(
            f"attribution: malformed baseline {path}: expected a "
            "'phase_tables' and/or 'roofline' section")
    return doc


def write_attribution_baseline(path: Optional[str] = None, **sections
                               ) -> None:
    """Merge the given sections (``phase_tables``, ``roofline``,
    ``roofline_wide``, ``device``; a ``None`` one is left as it is) into
    the snapshot."""
    path = path or attribution_baseline_path()
    doc = _read_doc(path)
    doc["comment"] = _ATTRIBUTION_COMMENT
    for name, value in sections.items():
        if value is None:
            continue
        doc[name] = ({k: value[k] for k in sorted(value)}
                     if isinstance(value, dict) else value)
    _write_doc(path, doc)


def attribution_hash(path: Optional[str] = None) -> Optional[str]:
    """Short content hash of the committed snapshot (None when absent)."""
    path = path or attribution_baseline_path()
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()[:16]


# -- the kernelcheck footprint table (K003) --------------------------------

_KERNELCHECK_COMMENT = (
    "K003's footprint table: for each kernelcheck case, every function "
    "one call launches, with its registers a thread, static and dynamic "
    "shared bytes a block, local (spill) bytes a thread, threads a block "
    "and the most threads it can launch with, read with "
    "cudaFuncGetAttributes on the card; 'nvcc' is the toolkit that built "
    "them (another toolkit is reported as drift, never re-baselined "
    "silently); 'device' the card. Refresh on the card with `python -m "
    "mpi_grid_redistribute_tpu_torch.tools.kernelcheck --update-baseline` "
    "and justify the delta in the commit message."
)


def kernelcheck_baseline_path() -> str:
    return os.path.join(_HERE, _KERNELCHECK_NAME)


def load_kernelcheck_baseline(path: Optional[str] = None) -> Optional[dict]:
    """The whole footprint document (``nvcc``, ``footprints``), or
    ``None`` when the file does not exist."""
    path = path or kernelcheck_baseline_path()
    if not os.path.exists(path):
        return None
    doc = _read_doc(path)
    if not isinstance(doc.get("footprints"), dict):
        raise SystemExit(
            f"malformed footprint baseline {path}: expected a top-level "
            "'footprints' object")
    return doc


def write_kernelcheck_baseline(path: Optional[str],
                               footprints: Dict[str, dict], nvcc: str,
                               device: Optional[str]) -> None:
    path = path or kernelcheck_baseline_path()
    _write_doc(path, {
        "comment": _KERNELCHECK_COMMENT,
        "device": device,
        "nvcc": nvcc,
        "footprints": {k: footprints[k] for k in sorted(footprints)},
    })

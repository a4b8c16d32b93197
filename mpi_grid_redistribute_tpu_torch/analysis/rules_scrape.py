"""G007: a scrape-path module never touches the device (the port's
counterpart of the JAX package's ``analysis/rules_scrape.py``).

The metrics plane promises that a scrape of ``/metrics`` or ``/healthz``
is a fold over the journal on the host: ``metrics.from_journal`` replays
recorded events, ``aggregate.merge_journals`` merges JSONL rows, the
store and the query layer read files. A scraper polling every few
seconds must not stall, or be stalled by, the device, and a module that
grows a ``torch`` import also puts torch's import cost on every scrape.
A module opts in with a marker on a line of its own (under its
docstring)::

    # gridlint: scrape-path

Inside a marked module the rule flags any ``import torch`` / ``from
torch ... import`` (the whole package: importing it is how the device
creeps in), and device-sync calls by name (``synchronize``,
``block_until_ready``, ``device_get``, ``device_put``).
"""

from __future__ import annotations

import ast
from typing import List

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    Project,
    call_name,
    last_attr,
    marker_re,
    rule,
)

_MARKER_RE = marker_re("scrape-path")
_SYNC_NAMES = ("synchronize", "block_until_ready", "device_get",
               "device_put")
_DEVICE_PACKAGES = ("torch",)


def _root_module(node: ast.AST) -> str:
    if isinstance(node, ast.Import):
        return node.names[0].name.split(".")[0]
    if isinstance(node, ast.ImportFrom):
        return (node.module or "").split(".")[0]
    return ""


@rule("G007")
def check_scrape_path(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if not mod.marked_module(_MARKER_RE):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                root = _root_module(node)
                if root in _DEVICE_PACKAGES:
                    findings.append(Finding(
                        "G007", mod.relpath, node.lineno, node.col_offset,
                        f"{root} import inside a scrape-path module — the "
                        f"metrics plane is host-only; a scrape must never "
                        f"touch (or wait on) the device",
                        "<module>"))
            elif isinstance(node, ast.Call):
                tail = last_attr(call_name(node))
                if tail in _SYNC_NAMES:
                    findings.append(Finding(
                        "G007", mod.relpath, node.lineno, node.col_offset,
                        f"{tail} inside a scrape-path module — device "
                        f"syncs are forbidden on the scrape path; fold "
                        f"journal rows on the host only",
                        "<module>"))
    return findings

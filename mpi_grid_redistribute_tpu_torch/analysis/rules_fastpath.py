"""G006: no resident-scale op inside a ``# gridlint: fastpath-engine``
function (the port's counterpart of the JAX package's
``analysis/rules_fastpath.py``).

The mover-sparse migrate branch and the count-driven wires exist to make
a step's cost scale with the movers, not the residents: a marked
function may touch the ``[V, mover_cap]`` block and O(V) control
arrays, never the full state beyond one bounded gather or scatter, and
consumes selections made before it. One sort or one gather at an
``arange`` index slipped into it reverts the engine to resident-scale
cost while every test still passes bit for bit. A function opts in with
the marker on the line directly above its ``def``::

    # gridlint: fastpath-engine
    def _sparse_wire(fi, order, bounds, send_counts, R, B, mesh):
        ...

Inside a marked function (lexically, nested defs included) the rule
flags any ``sort`` / ``argsort`` / ``msort`` / ``topk`` / ``lexsort``
call, a ``gather`` / ``index_select`` / ``take`` /
``take_along_dim`` whose index is built from an ``arange``, and a
subscript at an ``arange``-derived index (a dense permutation). Like the
reference's, the check is lexical; progcheck's J003 reads the ops a run
really issues inside the fast region.
"""

from __future__ import annotations

import ast
from typing import List

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    Project,
    call_name,
    finding_at,
    get_arg,
    last_attr,
    marked,
    marker_re,
    rule,
)

_MARKER_RE = marker_re("fastpath-engine")
_SORT_NAMES = ("sort", "argsort", "msort", "topk", "lexsort")
# the index argument's position in each gather spelling
_GATHER_INDEX = {"gather": (2, "index"), "index_select": (2, "index"),
                 "take": (1, "index"), "take_along_dim": (1, "indices")}
_IOTA_NAMES = ("arange",)


def _index_has_iota(idx: ast.AST) -> bool:
    return any(isinstance(sub, ast.Call)
               and last_attr(call_name(sub)) in _IOTA_NAMES
               for sub in ast.walk(idx))


@rule("G006")
def check_fastpath(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        for fi in mod.functions.values():
            if not marked(fi, _MARKER_RE):
                continue
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Subscript):
                    if _index_has_iota(node.slice):
                        findings.append(finding_at(
                            fi, node, "G006",
                            "subscript at an arange-derived index inside a "
                            "fastpath-engine function — a dense gather; "
                            "index with the mover plan instead"))
                    continue
                if not isinstance(node, ast.Call):
                    continue
                tail = last_attr(call_name(node))
                if tail in _SORT_NAMES:
                    findings.append(finding_at(
                        fi, node, "G006",
                        f"{tail} inside a fastpath-engine function — sorts "
                        f"are resident-scale; the fast branch must consume "
                        f"selections made before it"))
                elif tail in _GATHER_INDEX:
                    pos, kw = _GATHER_INDEX[tail]
                    method = isinstance(node.func, ast.Attribute) and (
                        call_name(node) or "").split(".", 1)[0] != "torch"
                    idx = get_arg(node, pos - 1 if method else pos, kw)
                    if idx is not None and _index_has_iota(idx):
                        findings.append(finding_at(
                            fi, node, "G006",
                            f"{tail} at an arange-derived index inside a "
                            f"fastpath-engine function — a full-array "
                            f"gather is a dense permutation; index with "
                            f"the mover plan instead"))
    return findings

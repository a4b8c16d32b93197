"""G010: a marked hot path holds at least one named span (the port's
counterpart of the JAX package's ``analysis/rules_spans.py``).

The attribution stack (the knockouts, the roofline report,
``tools.trace_export``) and progcheck's J003 read the regions the
engines open with ``telemetry.phases.traced_span``: a profiler trace of
a marked engine shows ``rd:sparse_wire`` or ``mig:fast`` lanes instead
of op soup, and J003 finds the fast branch in a recorded run by its
region. That coverage erodes silently: a refactor that drops the span
costs nothing in any correctness suite. So every function marked
``# gridlint: fastpath-engine`` or ``# gridlint: resident-path`` must
lexically hold at least one ``traced_span`` (or ``named_scope``) call,
nested defs included. A host-only ``span()`` does not count. Like the
other marker rules the check is lexical.
"""

from __future__ import annotations

import ast
import re
from typing import List

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    Project,
    call_name,
    last_attr,
    marked,
    rule,
)

_MARKER_RE = re.compile(r"#\s*gridlint:\s*(?:fastpath-engine|resident-path)\b")
_SPAN_TAILS = ("named_scope", "traced_span")


def _has_span(fn_node) -> bool:
    return any(isinstance(call, ast.Call)
               and last_attr(call_name(call)) in _SPAN_TAILS
               for call in ast.walk(fn_node))


@rule("G010")
def check_spans(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        for fi in mod.functions.values():
            if not marked(fi, _MARKER_RE) or _has_span(fi.node):
                continue
            findings.append(Finding(
                "G010", mod.relpath, fi.node.lineno, fi.node.col_offset,
                "marked hot path holds no traced_span — profiler, "
                "knockout and progcheck attribution lose this function; "
                "add a telemetry.phases.traced_span around its hot region",
                fi.qualname))
    return findings

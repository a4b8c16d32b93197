"""G008: a service-path module never masks a fault (the port's copy of
the JAX package's ``analysis/rules_service.py``).

Every failure inside the service loop either surfaces to the supervisor
(which restores from a snapshot) or is journaled as an explicit event;
a fault that disappears inside an exception handler is silent
corruption, and the supervisor's crash-loop breaker only counts what it
sees. A module opts in with a marker on a line of its own::

    # gridlint: service-path

Inside a marked module the rule flags a bare ``except:`` (it catches
``KeyboardInterrupt`` and ``SystemExit`` too) and a handler whose body
only discards (every statement ``pass`` or ``...``).
"""

from __future__ import annotations

import ast
from typing import List

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    Project,
    marker_re,
    rule,
)

_MARKER_RE = marker_re("service-path")


def _body_only_discards(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is Ellipsis):
            continue
        return False
    return True


@rule("G008")
def check_service_path(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if not mod.marked_module(_MARKER_RE):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    "G008", mod.relpath, node.lineno, node.col_offset,
                    "bare `except:` inside a service-path module — it "
                    "eats SystemExit/KeyboardInterrupt and hides faults "
                    "the supervisor must see; catch a named exception type",
                    "<module>"))
            elif _body_only_discards(node.body):
                findings.append(Finding(
                    "G008", mod.relpath, node.lineno, node.col_offset,
                    "swallowed exception (handler body only discards) "
                    "inside a service-path module — a masked fault is "
                    "silent corruption; journal it, convert it to a "
                    "verdict, or re-raise",
                    "<module>"))
    return findings

"""G004: the planar engines' 32-bit row contract (the port's counterpart
of the JAX package's ``analysis/rules_planar.py``).

The planar exchange and halo engines move rows as fused 32-bit words:
``fuse_fields`` / ``_fuse_planar`` pack an ``(n, k)`` field block into
one int32 word stream with ``Tensor.view(torch.int32)``, and the planar
kernels scatter those words. That is only sound for 4-byte element
types: a float64 row is cut in half, an int16 row reads past its lane
(C9 was this fault: eligibility decided on the packed dtype, not the
caller's). ``api._planar_specs`` is the guard: it refuses the planar
path unless every field's ``itemsize`` is 4.

G004 flags:

* a call of ``fuse_fields`` / ``_fuse_planar`` with no ``.itemsize`` or
  ``.element_size()`` comparison in the called function's own body, the
  call site's scope chain, or a same-module caller of the enclosing
  function (the guard is often one frame up);
* ``x.view(torch.int32 | torch.uint32 | torch.float32)`` on a parameter
  ``x`` of a top-level function with no such guard in its scope chain or
  a same-module caller: a public entry point reinterpreting caller data
  unguarded.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    ModuleInfo,
    Project,
    call_name,
    dotted_name,
    last_attr,
    rule,
)

_FUSE_NAMES = ("fuse_fields", "_fuse_planar")
_WORD_DTYPES = ("int32", "uint32", "float32")


def _has_itemsize_check(node: Optional[ast.AST]) -> bool:
    """Does ``node`` hold a comparison that reads ``.itemsize`` or
    ``.element_size()``?"""
    if node is None:
        return False
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Compare):
            continue
        for part in ast.walk(sub):
            if isinstance(part, ast.Attribute) and part.attr in (
                    "itemsize", "element_size"):
                return True
    return False


def _scope_chain_checked(fi: Optional[FunctionInfo]) -> bool:
    while fi is not None:
        if _has_itemsize_check(fi.node):
            return True
        fi = fi.parent
    return False


def _guarded(project: Project, mod: ModuleInfo, fi: FunctionInfo) -> bool:
    """Guarded: its own body compares an itemsize, or a helper it calls
    does (``redistribute`` gates the planar path on ``_planar_specs``)."""
    if _has_itemsize_check(fi.node):
        return True
    for n in ast.walk(fi.node):
        if not isinstance(n, ast.Call):
            continue
        nm = call_name(n)
        if not nm:
            continue
        for tgt in project.resolve_call_target(mod, nm, fi):
            if tgt is not fi and _has_itemsize_check(tgt.node):
                return True
    return False


def _top_ancestor(fi: FunctionInfo) -> FunctionInfo:
    while fi.parent is not None:
        fi = fi.parent
    return fi


def _same_module_caller_checked(project: Project, mod: ModuleInfo,
                                fi: FunctionInfo) -> bool:
    target = _top_ancestor(fi).name
    for other in mod.functions.values():
        if other is fi or isinstance(other.node, ast.Lambda):
            continue
        calls_target = any(
            isinstance(n, ast.Call) and last_attr(call_name(n)) == target
            for n in ast.walk(other.node))
        if calls_target and _guarded(project, mod, other):
            return True
    return False


def _enclosing(mod: ModuleInfo, node: ast.AST) -> Optional[FunctionInfo]:
    best: Optional[FunctionInfo] = None
    best_span: Optional[int] = None
    for fi in mod.functions.values():
        fn = fi.node
        lo, hi = fn.lineno, getattr(fn, "end_lineno", fn.lineno)
        if lo <= node.lineno <= hi:
            span = hi - lo
            if best_span is None or span < best_span:
                best, best_span = fi, span
    return best


def _word_view(node: ast.Call) -> Optional[str]:
    """The parameter name of ``x.view(torch.<32-bit dtype>)``, else
    None."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "view"
            and isinstance(node.func.value, ast.Name)
            and len(node.args) == 1 and not node.keywords):
        return None
    dt = dotted_name(node.args[0]) or ""
    if dt.split(".", 1)[0] == "torch" and last_attr(dt) in _WORD_DTYPES:
        return node.func.value.id
    return None


@rule("G004")
def check_planar_contract(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            tail = last_attr(name)
            if tail in _FUSE_NAMES:
                enclosing = _enclosing(mod, node)
                if _scope_chain_checked(enclosing):
                    continue
                targets = project.resolve_call_target(mod, name, enclosing)
                if any(_has_itemsize_check(t.node) for t in targets):
                    continue
                if enclosing is not None and _same_module_caller_checked(
                        project, mod, enclosing):
                    continue
                findings.append(Finding(
                    "G004", mod.relpath, node.lineno, node.col_offset,
                    f"{tail}(...) packs rows as 32-bit words but no "
                    f".itemsize check guards this call path; gate it like "
                    f"api._planar_specs (refuse when the itemsize is not "
                    f"4)",
                    enclosing.qualname if enclosing else "<module>"))
                continue
            param = _word_view(node)
            if param is None:
                continue
            enclosing = _enclosing(mod, node)
            if enclosing is None or enclosing.parent is not None:
                # nested engine functions get their operands from an
                # already-guarded builder; only top-level entry points
                # reinterpreting caller data count
                continue
            if param not in enclosing.params:
                continue
            if _scope_chain_checked(enclosing):
                continue
            if _same_module_caller_checked(project, mod, enclosing):
                continue
            findings.append(Finding(
                "G004", mod.relpath, node.lineno, node.col_offset,
                f".view to a 32-bit dtype on parameter '{param}' of a "
                f"public entry point with no .itemsize guard; a "
                f"non-4-byte dtype silently corrupts the fused word "
                f"stream",
                enclosing.qualname))
    return findings

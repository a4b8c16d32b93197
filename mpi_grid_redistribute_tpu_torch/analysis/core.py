"""The finding record the port's checkers share, their exit codes, the
AST project model ``analysis.racecheck`` and gridlint read, and
gridlint's rule driver (the port's copy of the JAX package's
``analysis/core.py``: ``Finding``, ``FunctionInfo``, ``ModuleInfo``,
``Project``, ``build_project``, ``iter_py_files``, the name helpers, the
taint pass, ``rule`` and ``run_gridlint``).

Everything in the model is plain ``ast``: a scanned module is never
imported. Call edges resolve module-locally by simple name and across
modules through ``from pkg.mod import name`` / ``pkg.mod.name``
attribute calls over the scanned file set, an approximation (no dynamic
dispatch) that is fast, has no import side effects and never invents a
reachability it cannot see.

The reference's scope facts are jax's: what ``jax.jit`` traces and what
runs in a ``shard_map`` body. The port has neither; its counterpart of
the traced scope is the **step path** (:meth:`Project.step_functions`):
every function marked ``# gridlint: resident-path`` (a chunk's
macro-step) or ``# gridlint: fastpath-engine`` (a fast branch) on the
line above its ``def``, and every function they reach. A host read there
waits for the device (G002, G003). A line ending in ``# gridlint:
disable=G00x[,G00y]`` suppresses those rules on it, and ``# gridlint:
disable-file=G00x`` in a module suppresses them in the whole file
(``all`` names every rule).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import (
    Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple,
)

# the exit-code convention of every checker CLI
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2

RULE_IDS = (
    "G001", "G002", "G003", "G004", "G005", "G006", "G007", "G008",
    "G009", "G010",
)
# jax's rules, with no counterpart in the port (listed, never run)
NOT_APPLICABLE = ("G001", "G005")

_SUPPRESS_RE = re.compile(
    r"#\s*gridlint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>(?:G\d{3}|all)(?:\s*,\s*(?:G\d{3}|all))*)"
)


def marker_re(tag: str) -> "re.Pattern[str]":
    """The opt-in marker ``# gridlint: <tag>``."""
    return re.compile(rf"#\s*gridlint:\s*{re.escape(tag)}\b")


# the markers of the step path: a chunk's macro-step and a fast branch
_STEP_RE = re.compile(r"#\s*gridlint:\s*(?:resident-path|fastpath-engine)\b")


def marked(fi: "FunctionInfo", pattern: "re.Pattern[str]") -> bool:
    """Does the line directly above ``fi``'s ``def`` (above its
    decorators) carry ``pattern``?"""
    node = fi.node
    if isinstance(node, ast.Lambda):
        return False
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    lines = fi.module.lines
    if first < 2 or first - 2 >= len(lines):
        return False
    return bool(pattern.search(lines[first - 2]))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str
    symbol: str = ""  # enclosing function qualname, "" at module level

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def baseline_key(self) -> Tuple[str, str, str, str]:
        """Line-number-insensitive identity used for baseline matching:
        edits above a grandfathered finding must not un-baseline it."""
        return (self.rule, self.path, self.symbol, self.message)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{loc}: {self.rule}{sym}: {self.message}"


def exit_code(findings) -> int:
    """0 when ``findings`` is empty, else 1 (2 is a usage error, which
    argparse and the tools raise themselves)."""
    return EXIT_FINDINGS if findings else EXIT_CLEAN


# -- the project model ---------------------------------------------------


@dataclasses.dataclass
class FunctionInfo:
    """One function (or lambda) definition inside a module."""

    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    module: "ModuleInfo"
    params: Tuple[str, ...]
    parent: Optional["FunctionInfo"]  # lexically enclosing function

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


class ModuleInfo:
    """Parsed module: AST, source lines, function index (the checkers
    scan their own suppression markers in ``lines``)."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        self._scan_suppressions()
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        # import alias -> dotted module ("np" -> "numpy"); from-imports
        # record name -> "module.attr" in from_imports
        self.import_aliases: Dict[str, str] = {}
        self.from_imports: Dict[str, str] = {}
        self._index()

    # -- gridlint suppressions -----------------------------------------

    def _scan_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            if "all" in rules:
                rules = set(RULE_IDS)
            if m.group("file"):
                self.file_suppressions |= rules
            else:
                self.line_suppressions.setdefault(i, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppressions:
            return True
        return rule in self.line_suppressions.get(line, set())

    def marked_module(self, pattern: "re.Pattern[str]") -> bool:
        """Does any line of the module carry ``pattern``?"""
        return any(pattern.search(line) for line in self.lines)

    # -- indexing -------------------------------------------------------

    def _index(self) -> None:
        mod = self

        class V(ast.NodeVisitor):
            def __init__(self) -> None:
                self.stack: List[FunctionInfo] = []

            def _add(self, node, name: str) -> FunctionInfo:
                parent = self.stack[-1] if self.stack else None
                qual = f"{parent.qualname}.{name}" if parent else name
                if isinstance(node, ast.Lambda):
                    args = node.args
                else:
                    args = node.args
                params = tuple(
                    a.arg
                    for a in (
                        list(args.posonlyargs)
                        + list(args.args)
                        + list(args.kwonlyargs)
                        + ([args.vararg] if args.vararg else [])
                        + ([args.kwarg] if args.kwarg else [])
                    )
                )
                fi = FunctionInfo(qual, node, mod, params, parent)
                mod.functions[qual] = fi
                mod.by_name.setdefault(fi.name, []).append(fi)
                node._gridlint_info = fi  # type: ignore[attr-defined]
                return fi

            def visit_FunctionDef(self, node):
                fi = self._add(node, node.name)
                self.stack.append(fi)
                self.generic_visit(node)
                self.stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, node):
                fi = self._add(node, f"<lambda:{node.lineno}>")
                self.stack.append(fi)
                self.generic_visit(node)
                self.stack.pop()

            def visit_Import(self, node):
                for alias in node.names:
                    head = alias.asname or alias.name.split(".")[0]
                    mod.import_aliases[head] = alias.name

            def visit_ImportFrom(self, node):
                if node.module is None or node.level:
                    return
                for alias in node.names:
                    mod.from_imports[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )

        V().visit(self.tree)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def last_attr(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def get_arg(
    call: ast.Call, pos: Optional[int], kw: str
) -> Optional[ast.AST]:
    """Positional-or-keyword argument lookup (no starred handling);
    ``pos=None`` looks up keyword-only."""
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    plain = [a for a in call.args if not isinstance(a, ast.Starred)]
    if (
        pos is not None
        and len(plain) == len(call.args)
        and 0 <= pos < len(plain)
    ):
        return plain[pos]
    return None


class Project:
    """The scanned file set, indexed by path and dotted module name, with
    call-target resolution and the step path (the port's counterpart of
    the reference's jit-reachable scope)."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        self.by_relpath = {m.relpath: m for m in self.modules}
        # dotted module name (best effort from relpath) -> ModuleInfo
        self.by_modname: Dict[str, ModuleInfo] = {}
        for m in self.modules:
            name = m.relpath[:-3].replace("/", ".")
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            self.by_modname[name] = m

    # -- resolution helpers --------------------------------------------

    @staticmethod
    def _lexically_visible(
        cands: List[FunctionInfo], scope: Optional[FunctionInfo]
    ) -> List[FunctionInfo]:
        """Filter same-simple-name candidates to those actually visible
        from ``scope``: module-level defs plus defs nested in the scope
        chain. Without this, a call of one builder's local ``loop`` would
        reach every other builder's local ``loop`` too."""
        chain_ids = {id(None)}
        fi = scope
        while fi is not None:
            chain_ids.add(id(fi))
            fi = fi.parent
        visible = [c for c in cands if id(c.parent) in chain_ids]
        return visible or list(cands)

    def resolve_call_target(
        self, mod: ModuleInfo, name: str, scope: Optional[FunctionInfo]
    ) -> List[FunctionInfo]:
        """Best-effort resolution of a call target to project functions."""
        out: List[FunctionInfo] = []
        head = name.split(".", 1)[0]
        tail = last_attr(name)
        # local / enclosing-scope / module-level function by simple name
        if "." not in name:
            # prefer the lexically closest definition
            cands = mod.by_name.get(name, [])
            if cands:
                return self._lexically_visible(cands, scope)
            target = mod.from_imports.get(name)
            if target:
                tmod_name, _, tfn = target.rpartition(".")
                tmod = self.by_modname.get(tmod_name)
                if tmod:
                    out.extend(tmod.by_name.get(tfn, []))
            return out
        # module-attribute call: resolve head through imports
        target_mod: Optional[ModuleInfo] = None
        if head in mod.from_imports:
            target_mod = self.by_modname.get(mod.from_imports[head])
        if target_mod is None and head in mod.import_aliases:
            target_mod = self.by_modname.get(mod.import_aliases[head])
        if target_mod is not None:
            out.extend(target_mod.by_name.get(tail, []))
        return out

    def _returned_functions(self, fi: FunctionInfo) -> List[FunctionInfo]:
        """Nested functions a builder returns (possibly through a
        ``functools.partial(...)``-style wrapper or a local alias)."""
        out: List[FunctionInfo] = []
        node = fi.node
        if isinstance(node, ast.Lambda):
            return out

        local_defs = {
            f.name: f
            for f in fi.module.functions.values()
            if f.parent is fi
        }

        def peel(expr: ast.AST, depth: int = 0) -> None:
            if depth > 4 or expr is None:
                return
            if isinstance(expr, ast.Name) and expr.id in local_defs:
                out.append(local_defs[expr.id])
                return
            if isinstance(expr, ast.Call):
                fn = last_attr(call_name(expr))
                if fn in ("jit", "partial", "lru_cache", "wraps", "vmap"):
                    for a in expr.args:
                        peel(a, depth + 1)

        for sub in ast.walk(node):
            if isinstance(sub, ast.Return) and sub.value is not None:
                peel(sub.value)
        return out

    def _enclosing_function(
        self, mod: ModuleInfo, target: ast.AST
    ) -> Optional[FunctionInfo]:
        """The innermost FunctionInfo whose node contains ``target``."""
        best: Optional[FunctionInfo] = None
        best_span = None
        for fi in mod.functions.values():
            node = fi.node
            lo = node.lineno
            hi = getattr(node, "end_lineno", lo)
            if lo <= target.lineno <= hi:
                span = hi - lo
                if best is None or span < best_span:
                    best, best_span = fi, span
        return best

    def _close_over_calls(
        self, roots: Set[Tuple[str, str]]
    ) -> Set[Tuple[str, str]]:
        """Transitive closure of project-resolvable call edges. A nested
        def lexically inside a reached function is reached too (it runs
        when its parent does, in this codebase's builder idiom)."""
        reached: Set[Tuple[str, str]] = set()
        frontier = list(roots)
        while frontier:
            key = frontier.pop()
            if key in reached:
                continue
            reached.add(key)
            mod = self.by_relpath.get(key[0])
            if mod is None:
                continue
            fi = mod.functions.get(key[1])
            if fi is None:
                continue
            # lexically nested defs
            for sub in mod.functions.values():
                if sub.parent is fi:
                    frontier.append((mod.relpath, sub.qualname))
            # call edges out of this function's own statements (do not
            # descend into nested defs: they are pushed separately above,
            # and their bodies' calls belong to them)
            for call in self._own_calls(fi):
                nm = call_name(call)
                if not nm:
                    continue
                for tgt in self.resolve_call_target(mod, nm, fi):
                    frontier.append((tgt.module.relpath, tgt.qualname))
        return reached

    @staticmethod
    def _own_calls(fi: FunctionInfo) -> Iterable[ast.Call]:
        """Call nodes in ``fi``'s body, including nested lambdas/defs
        (reaching them there is fine: a call inside a nested def fires
        when the parent runs, in this codebase's builder idiom)."""
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                yield node

    # -- the step path ---------------------------------------------------

    def step_functions(self) -> List[FunctionInfo]:
        """Functions marked on the step path (``resident-path`` or
        ``fastpath-engine``) and
        every function they reach, sorted by path and name (computed
        once)."""
        cached = getattr(self, "_step_functions", None)
        if cached is not None:
            return cached
        roots = {(m.relpath, fi.qualname) for m in self.modules
                 for fi in m.functions.values() if marked(fi, _STEP_RE)}
        out = []
        for relpath, qual in sorted(self._close_over_calls(roots)):
            mod = self.by_relpath.get(relpath)
            if mod and qual in mod.functions:
                out.append(mod.functions[qual])
        self._step_functions = out
        return out


def iter_py_files(paths: Sequence[str], root: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(os.path.abspath(p))
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d
                    for d in dirnames
                    if d not in ("__pycache__", ".git", ".venv",
                                 "node_modules")
                ]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        out.append(os.path.abspath(os.path.join(dirpath, f)))
    return sorted(set(out))


def build_project(paths: Sequence[str], root: Optional[str] = None) -> Project:
    root = os.path.abspath(root or os.getcwd())
    modules = []
    for path in iter_py_files(paths, root):
        rel = os.path.relpath(path, root)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
            modules.append(ModuleInfo(path, rel, src))
        except (SyntaxError, UnicodeDecodeError) as e:
            raise SystemExit(f"cannot parse {rel}: {e}")
    return Project(modules)


# -- taint: which local names carry tensors ------------------------------

# annotations that mark a parameter as host-side configuration, never a
# tensor: builtin scalars and the port's static descriptors
_STATIC_ANNOTATIONS = frozenset({
    "int", "float", "bool", "str", "bytes", "Domain", "GridEdges",
    "ProcessGrid", "RankMesh", "HierarchicalMesh",
})
# tensor metadata that needs no device read
_STATIC_ATTRS = ("shape", "ndim", "dtype", "device", "itemsize",
                 "is_cuda", "layout")
_STATIC_CALLS = ("len", "isinstance", "range", "enumerate", "size", "dim",
                 "numel", "element_size")


def _annotation_is_static(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    for n in ast.walk(ann):
        if isinstance(n, ast.Name) and n.id in _STATIC_ANNOTATIONS:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ANNOTATIONS:
            return True
        if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value in _STATIC_ANNOTATIONS):
            return True
    return False


def _static_params(fi: FunctionInfo) -> Set[str]:
    out: Set[str] = set()
    args = getattr(fi.node, "args", None)
    if args is None:
        return out
    for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
        if _annotation_is_static(getattr(a, "annotation", None)):
            out.add(a.arg)
    return out


def tainted_names(fi: FunctionInfo) -> Set[str]:
    """Forward may-taint over a function's assignments: parameters may
    be tensors; a name assigned from an expression mentioning a tainted
    name (or a ``torch`` call) is tainted. ``.shape``/``.dtype``/
    ``len()``/``.numel()`` of a tensor need no device read and break the
    chain, as do parameters annotated with a host type (``dt: float``,
    ``domain: Domain``)."""
    tainted: Set[str] = set(fi.params) - _static_params(fi)
    for _ in range(2):
        for stmt in ast.walk(fi.node):
            if isinstance(stmt, ast.Assign):
                if expr_mentions_tainted(stmt.value, tainted):
                    for t in stmt.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
            elif isinstance(stmt, ast.AugAssign):
                if (expr_mentions_tainted(stmt.value, tainted)
                        and isinstance(stmt.target, ast.Name)):
                    tainted.add(stmt.target.id)
            elif isinstance(stmt, (ast.For, ast.comprehension)):
                if expr_mentions_tainted(stmt.iter, tainted):
                    for n in ast.walk(stmt.target):
                        if isinstance(n, ast.Name):
                            tainted.add(n.id)
    return tainted


def expr_mentions_tainted(expr: ast.AST, tainted: Set[str]) -> bool:
    """May the value of ``expr`` be (or hold) a tensor's data?"""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Attribute):
        if expr.attr in _STATIC_ATTRS:
            return False
        return expr_mentions_tainted(expr.value, tainted)
    if isinstance(expr, ast.Call):
        name = call_name(expr) or ""
        if last_attr(name) in _STATIC_CALLS:
            return False
        if name.split(".", 1)[0] == "torch":
            return True
        parts = [expr.func] + list(expr.args) + [k.value
                                                 for k in expr.keywords]
        return any(expr_mentions_tainted(p, tainted) for p in parts)
    return any(expr_mentions_tainted(c, tainted)
               for c in ast.iter_child_nodes(expr))


def finding_at(fi: FunctionInfo, node: ast.AST, rule_id: str,
               msg: str) -> Finding:
    return Finding(rule_id, fi.module.relpath, node.lineno,
                   node.col_offset, msg, fi.qualname)


# -- gridlint's rule registry and driver ---------------------------------

RuleFn = Callable[[Project], List[Finding]]
_RULES: List[Tuple[str, RuleFn]] = []


def rule(rule_id: str):
    """Register a gridlint rule body (``project -> findings``)."""
    def deco(fn: RuleFn) -> RuleFn:
        _RULES.append((rule_id, fn))
        return fn

    return deco


def run_gridlint(paths: Sequence[str], root: Optional[str] = None,
                 rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Scan ``paths`` and return the unsuppressed findings, sorted."""
    # the rule modules register on import
    from mpi_grid_redistribute_tpu_torch.analysis import (  # noqa: F401
        rules_fastpath, rules_jit, rules_planar, rules_resident,
        rules_scrape, rules_service, rules_spans,
    )

    project = build_project(paths, root)
    wanted = set(rules) if rules else set(RULE_IDS)
    findings: List[Finding] = []
    seen: Set[Tuple] = set()
    for rule_id, fn in _RULES:
        if rule_id not in wanted:
            continue
        for f in fn(project):
            mod = project.by_relpath.get(f.path)
            if mod is not None and mod.suppressed(f.rule, f.line):
                continue
            key = (f.rule, f.path, f.line, f.col, f.message)
            if key in seen:
                continue
            seen.add(key)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings

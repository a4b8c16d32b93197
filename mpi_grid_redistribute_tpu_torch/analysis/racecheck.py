"""racecheck: the host-thread topology model and T-rule registry (the
port's twin of the JAX package's ``analysis/racecheck.py``; the rules
are ``analysis/rules_thread.py``, the CLI ``tools/racecheck.py``).

The port's service control plane runs real host threads: the driver's
async snapshot writer (``service/driver.py``), the checkpoint's write and
read pools (``utils/checkpoint.py``), and ``tools/metrics_serve.py``'s
drive loop and ``ThreadingHTTPServer`` pool. "Which thread touches which
state under which lock" is a correctness contract that pytest exercises
only probabilistically. racecheck checks it syntactically: plain
``ast``, no import of the scanned code, no torch.

The model (:class:`ThreadModel`) infers, project-wide:

* **thread roots**: ``threading.Thread(target=f)`` creation sites (with
  daemon/joined facts from a module-wide alias scan), every method of an
  ``http.server`` request-handler subclass (the ThreadingHTTPServer pool;
  flagged ``multi`` because the pool can run a method concurrently with
  itself), and every HealthMonitor callback registration
  (``add_callback`` / ``on_alert=``: callbacks run inline on whichever
  thread evaluates, so their bodies, e.g. the flight recorder's capture
  path, are analyzed like spawned targets);
* **reachability**: a call-graph closure per root over class-aware,
  import-resolved (relative imports included) call edges, plus a
  ``main`` closure seeded from every function no spawned root reaches;
* **shared-state matrix**: per ``(class, field)`` / ``(module,
  global)``: every read/write site, the locks held there (lexical
  ``with <lock>:`` scopes over ``threading.Lock/RLock`` objects), and
  the roots that reach it;
* **lock facts**: acquisition-order edges and blocking calls made while
  holding a lock.

Known approximations (each conservative choice is documented at the
rule that makes it): resolution is name/annotation/constructor-based (no
dynamic dispatch), lambdas are opaque, ``lock.acquire()`` without
``with`` is not modeled, and the matrix is object-insensitive (a class's
fields are merged across instances, with a creation-site heuristic, see
``rules_thread`` T001, keeping thread-local instances from drowning the
report). ``concurrent.futures`` pools are not roots: their workers run
functions handed to ``pool.map``/``submit``, which this model (like the
reference's) does not follow.

Suppressions use racecheck's own marker so a gridlint line never
silences a T rule: ``# racecheck: disable=T001[,T003]`` on the line,
``# racecheck: disable-file=all`` anywhere in the file. The single
declared journal writer of a thread target is marked
``# racecheck: recorder-writer`` within the target's def (rule T005),
and a module on the service path carries ``# gridlint: service-path``
(rule T004).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import (
    Callable,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Project,
    build_project,
    call_name,
    dotted_name,
    get_arg,
    last_attr,
)

T_RULE_IDS = ("T001", "T002", "T003", "T004", "T005")

#: the ambient root every function unreached by a spawned closure runs on
MAIN = "main"

_SUPPRESS_RE = re.compile(
    r"#\s*racecheck:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>(?:T\d{3}|all)(?:\s*,\s*(?:T\d{3}|all))*)"
)
_WRITER_MARKER_RE = re.compile(r"#\s*racecheck:\s*recorder-writer\b")
_SERVICE_MARKER_RE = re.compile(r"#\s*gridlint:\s*service-path\b")

_HANDLER_BASES = frozenset(
    {
        "BaseHTTPRequestHandler",
        "SimpleHTTPRequestHandler",
        "CGIHTTPRequestHandler",
        "BaseRequestHandler",
        "StreamRequestHandler",
        "DatagramRequestHandler",
    }
)

# container methods that mutate their receiver: a call through a
# ``self.field`` / module-global receiver is a WRITE to that binding's
# referent for the shared-state matrix
_MUTATORS = frozenset(
    {
        "append", "appendleft", "extend", "extendleft", "insert",
        "add", "remove", "discard", "pop", "popleft", "popitem",
        "clear", "update", "setdefault", "sort", "reverse",
    }
)

# method names too generic for the unresolved-receiver fallback: an
# ``x.get()`` with unknown ``x`` must not edge into every class that
# happens to define ``get``. Deliberately NOT here: record / record_at /
# events / counts / evaluate / note_step_time — the telemetry verbs
# racecheck exists to track conservatively.
_COMMON_METHODS = frozenset(
    {
        "get", "set", "add", "append", "appendleft", "extend", "insert",
        "pop", "popleft", "update", "clear", "remove", "discard", "copy",
        "keys", "values", "items", "setdefault", "sort", "reverse",
        "join", "start", "run", "close", "open", "read", "write",
        "flush", "seek", "send", "recv", "put", "acquire", "release",
        "wait", "notify", "is_set", "locked",
        "strip", "split", "lower", "upper", "format", "encode",
        "decode", "replace", "startswith", "endswith",
        "search", "match", "group", "findall", "sub",
        "mkdir", "exists", "unlink", "resolve", "absolute",
        "sum", "max", "min", "mean", "std", "any", "all", "item",
        "astype", "reshape", "tolist", "count", "index", "inc", "dec",
        "observe", "labels", "save", "load", "cancel", "total_seconds",
    }
)

# dotted names (import-resolved) that block the calling thread
_BLOCKING_CANON = frozenset(
    {
        "time.sleep",
        "subprocess.run",
        "subprocess.check_call",
        "subprocess.check_output",
        "subprocess.call",
        "urllib.request.urlopen",
        "socket.create_connection",
    }
)
# attribute tails that block regardless of receiver
_BLOCKING_TAILS = frozenset(
    {
        "sleep", "block_until_ready", "serve_forever", "urlopen",
        "accept", "recv", "recvfrom", "connect", "sendall",
        "getaddrinfo",
    }
)

#: ("class", class name, attr) | ("module", relpath, name)
LockId = Tuple[str, str, str]
#: (relpath, qualname) — project-unique function identity
FnKey = Tuple[str, str]


def lock_str(lock: LockId) -> str:
    kind, owner, name = lock
    if kind == "class":
        return f"{owner}.{name}"
    return f"{owner}:{name}"


def _module_dotted(relpath: str) -> str:
    name = relpath[:-3].replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


@dataclasses.dataclass
class CallFact:
    """One call expression inside a function's own body."""

    name: str                       # dotted source text of the callee
    node: ast.Call
    held: Tuple[LockId, ...]        # locks lexically held at the site
    targets: Tuple[FnKey, ...] = () # resolved project targets


@dataclasses.dataclass(frozen=True)
class Access:
    """One read/write of a class field or module global."""

    owner: Tuple[str, str]  # ("class", name) | ("module", relpath)
    field: str
    op: str                 # "read" | "write"
    fnkey: FnKey
    relpath: str
    line: int
    col: int
    locks: FrozenSet[LockId]
    init: bool              # write inside __init__: pre-publication

    @property
    def symbol(self) -> str:
        kind, owner = self.owner
        base = owner if kind == "class" else _module_dotted(owner)
        return f"{base}.{self.field}"


@dataclasses.dataclass
class BlockFact:
    """One blocking call site (held locks recorded, possibly empty)."""

    name: str
    line: int
    col: int
    held: Tuple[LockId, ...]


@dataclasses.dataclass
class ThreadFn:
    """One function with its collected thread facts."""

    relpath: str
    qual: str
    node: ast.AST
    mod: ModuleInfo
    cls: Optional[str]        # effective owner class (lexically inherited)
    parent: Optional[FnKey]   # lexically enclosing function
    calls: List[CallFact] = dataclasses.field(default_factory=list)
    accesses: List[Access] = dataclasses.field(default_factory=list)
    direct_locks: List[Tuple[LockId, int]] = dataclasses.field(
        default_factory=list
    )
    blocking: List[BlockFact] = dataclasses.field(default_factory=list)
    globals_decl: Set[str] = dataclasses.field(default_factory=set)

    @property
    def key(self) -> FnKey:
        return (self.relpath, self.qual)

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]


@dataclasses.dataclass
class ThreadRoot:
    """One source of concurrency: a Thread target or a handler method."""

    label: str                 # stable, line-insensitive identity
    kind: str                  # "thread" | "handler"
    fnkey: Optional[FnKey]     # None when the target didn't resolve
    target_desc: str
    created_in: Optional[FnKey]
    relpath: str               # module that creates/declares the root
    line: int
    daemon: Optional[bool]     # None = never set anywhere we can see
    joined: bool
    multi: bool                # pool/loop: may race a copy of itself
    marked_writer: bool        # '# racecheck: recorder-writer' on target


@dataclasses.dataclass
class _ClassInfo:
    name: str
    relpath: str
    bases: Tuple[str, ...]
    methods: Dict[str, FnKey]


class ThreadModel:
    """Project-wide thread topology + shared-state facts (see module
    docstring). Built once per run; rules only query it."""

    def __init__(self, project: Project):
        self.project = project
        self.fns: Dict[FnKey, ThreadFn] = {}
        self.children: Dict[FnKey, List[FnKey]] = {}
        self.module_fns: Dict[str, Dict[str, FnKey]] = {}
        self.module_globals: Dict[str, Set[str]] = {}
        self.classes: Dict[str, List[_ClassInfo]] = {}
        self.methods_by_name: Dict[str, List[FnKey]] = {}
        self.imports: Dict[str, Tuple[Dict[str, str], Dict[str, str]]] = {}
        self.module_locks: Dict[str, Set[str]] = {}
        self.class_locks: Set[Tuple[str, str]] = set()
        # (held, acquired) -> first acquisition site (relpath, line, qual)
        self.lock_edges: Dict[
            Tuple[LockId, LockId], Tuple[str, int, str]
        ] = {}
        self.roots: List[ThreadRoot] = []
        self.root_by_label: Dict[str, ThreadRoot] = {}
        self.reach: Dict[str, Set[FnKey]] = {}
        self.main_reach: Set[FnKey] = set()
        self.edges: Dict[FnKey, Set[FnKey]] = {}
        self._suppress: Dict[str, Tuple[Set[str], Dict[int, Set[str]]]] = {}
        self._roots_cache: Dict[FnKey, FrozenSet[str]] = {}
        self._self_attr_cache: Dict[Tuple[str, str], Optional[str]] = {}

        for mod in project.modules:
            self.imports[mod.relpath] = self._module_imports(mod)
            self._index_module(mod)
        self._find_locks()
        for f in list(self.fns.values()):
            self._collect_fn(f)
        self._find_roots()
        self._closures()

    # -- suppressions (racecheck's own marker, not gridlint's) ----------

    def suppressed(self, relpath: str, rule: str, line: int) -> bool:
        mod = self.project.by_relpath.get(relpath)
        if mod is None:
            return False
        if relpath not in self._suppress:
            file_rules: Set[str] = set()
            line_rules: Dict[int, Set[str]] = {}
            for i, text in enumerate(mod.lines, start=1):
                m = _SUPPRESS_RE.search(text)
                if not m:
                    continue
                rules = {r.strip() for r in m.group("rules").split(",")}
                if "all" in rules:
                    rules = set(T_RULE_IDS)
                if m.group("file"):
                    file_rules |= rules
                else:
                    line_rules.setdefault(i, set()).update(rules)
            self._suppress[relpath] = (file_rules, line_rules)
        file_rules, line_rules = self._suppress[relpath]
        return rule in file_rules or rule in line_rules.get(line, set())

    def service_marked(self, relpath: str) -> bool:
        mod = self.project.by_relpath.get(relpath)
        if mod is None:
            return False
        return any(_SERVICE_MARKER_RE.search(l) for l in mod.lines)

    # -- indexing -------------------------------------------------------

    def _module_imports(
        self, mod: ModuleInfo
    ) -> Tuple[Dict[str, str], Dict[str, str]]:
        """(aliases, froms) with RELATIVE imports resolved — core's
        from_imports skips them, but the package uses them heavily."""
        aliases = dict(mod.import_aliases)
        froms: Dict[str, str] = {}
        dotted = mod.relpath[:-3].replace("/", ".")
        if dotted.endswith(".__init__"):
            pkg_parts = dotted[: -len(".__init__")].split(".")
        else:
            pkg_parts = dotted.split(".")[:-1]
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level:
                cut = len(pkg_parts) - (node.level - 1)
                if cut < 0:
                    continue
                base = pkg_parts[:cut]
                modname = ".".join(
                    base + ([node.module] if node.module else [])
                )
            elif node.module:
                modname = node.module
            else:
                continue
            for alias in node.names:
                froms[alias.asname or alias.name] = (
                    f"{modname}.{alias.name}"
                )
        return aliases, froms

    def _index_module(self, mod: ModuleInfo) -> None:
        relpath = mod.relpath
        self.module_fns[relpath] = {}
        g = self.module_globals[relpath] = set()
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    stmt.targets
                    if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            g.add(n.id)

        def reg_fn(node, qual, parent_key, cls_name, cls_info):
            f = ThreadFn(
                relpath=relpath, qual=qual, node=node, mod=mod,
                cls=cls_name, parent=parent_key,
            )
            self.fns[f.key] = f
            if parent_key is not None:
                self.children.setdefault(parent_key, []).append(f.key)
            if parent_key is None and cls_info is None:
                self.module_fns[relpath][node.name] = f.key
            if cls_info is not None:
                cls_info.methods.setdefault(node.name, f.key)
                self.methods_by_name.setdefault(node.name, []).append(
                    f.key
                )
            walk(node, qual, f.key, cls_name)

        def walk(node, qual_prefix, parent_key, cls_name):
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    q = (
                        f"{qual_prefix}.{child.name}"
                        if qual_prefix
                        else child.name
                    )
                    reg_fn(child, q, parent_key, cls_name, None)
                elif isinstance(child, ast.ClassDef):
                    bases = tuple(
                        last_attr(dotted_name(b))
                        for b in child.bases
                        if dotted_name(b)
                    )
                    ci = _ClassInfo(child.name, relpath, bases, {})
                    self.classes.setdefault(child.name, []).append(ci)
                    q = (
                        f"{qual_prefix}.{child.name}"
                        if qual_prefix
                        else child.name
                    )
                    for sub in child.body:
                        if isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            reg_fn(
                                sub, f"{q}.{sub.name}", parent_key,
                                child.name, ci,
                            )
                        else:
                            walk(sub, q, parent_key, child.name)
                else:
                    walk(child, qual_prefix, parent_key, cls_name)

        walk(mod.tree, "", None, None)

    def _find_locks(self) -> None:
        def is_lock_ctor(value) -> bool:
            return (
                isinstance(value, ast.Call)
                and last_attr(call_name(value)) in ("Lock", "RLock")
            )

        for mod in self.project.modules:
            locks = self.module_locks.setdefault(mod.relpath, set())
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and is_lock_ctor(
                    stmt.value
                ):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            locks.add(t.id)
        for f in self.fns.values():
            if f.cls is None:
                continue
            for n in ast.walk(f.node):
                if (
                    isinstance(n, ast.Assign)
                    and is_lock_ctor(n.value)
                ):
                    for t in n.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            self.class_locks.add((f.cls, t.attr))

    # -- per-function fact collection -----------------------------------

    def _canon(self, relpath: str, nm: str) -> str:
        """Import-resolved dotted name ('np.x' -> 'numpy.x')."""
        aliases, froms = self.imports.get(relpath, ({}, {}))
        parts = nm.split(".")
        if len(parts) == 1:
            return froms.get(nm, nm)
        head = parts[0]
        rest = ".".join(parts[1:])
        if head in froms:
            return f"{froms[head]}.{rest}"
        if head in aliases:
            return f"{aliases[head]}.{rest}"
        return nm

    def _blocking_name(
        self, relpath: str, nm: str, call: ast.Call
    ) -> Optional[str]:
        canon = self._canon(relpath, nm)
        if canon in _BLOCKING_CANON:
            return canon
        tail = last_attr(nm)
        if tail in _BLOCKING_TAILS:
            return nm
        if nm == "open" and isinstance(call.func, ast.Name):
            return "open"
        if tail in ("join", "wait") and isinstance(
            call.func, ast.Attribute
        ):
            # thread-join / event-wait shape: no args, or a single
            # numeric timeout. str.join / os.path.join have other arg
            # shapes (and os.path resolves through imports).
            if canon.startswith(("os.path.", "posixpath.", "ntpath.")):
                return None
            if isinstance(call.func.value, ast.Constant):
                return None
            if any(k.arg != "timeout" for k in call.keywords):
                return None
            if not call.args:
                return nm
            if (
                len(call.args) == 1
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, (int, float))
            ):
                return nm
        return None

    def _lock_of(self, f: ThreadFn, expr: ast.AST) -> Optional[LockId]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            if f.cls and (f.cls, expr.attr) in self.class_locks:
                return ("class", f.cls, expr.attr)
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.module_locks.get(f.relpath, ()):
                return ("module", f.relpath, expr.id)
            _, froms = self.imports.get(f.relpath, ({}, {}))
            tgt = froms.get(expr.id)
            if tgt:
                tmod_name, _, lname = tgt.rpartition(".")
                tmod = self.project.by_modname.get(tmod_name)
                if tmod and lname in self.module_locks.get(
                    tmod.relpath, ()
                ):
                    return ("module", tmod.relpath, lname)
            return None
        if isinstance(expr, ast.Attribute):
            d = dotted_name(expr)
            if d:
                head, _, lname = d.rpartition(".")
                aliases, froms = self.imports.get(f.relpath, ({}, {}))
                modname = froms.get(head) or aliases.get(head)
                tmod = (
                    self.project.by_modname.get(modname)
                    if modname
                    else None
                )
                if tmod and lname in self.module_locks.get(
                    tmod.relpath, ()
                ):
                    return ("module", tmod.relpath, lname)
        return None

    def _collect_fn(self, f: ThreadFn) -> None:
        node = f.node
        relpath = f.relpath
        gset = self.module_globals.get(relpath, set())
        method_attrs: Set[int] = set()

        for n in ast.walk(node):
            if isinstance(n, ast.Global):
                f.globals_decl.update(n.names)
        params: Set[str] = set()
        args = getattr(node, "args", None)
        if args is not None:
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            ):
                params.add(a.arg)
        local_stores: Set[str] = set()
        for n in ast.walk(node):
            if (
                isinstance(n, ast.Name)
                and isinstance(n.ctx, (ast.Store, ast.Del))
                and n.id not in f.globals_decl
            ):
                local_stores.add(n.id)

        is_init = f.name in ("__init__", "__post_init__", "__new__")

        def add_access(owner, field, op, site, held):
            f.accesses.append(
                Access(
                    owner=owner, field=field, op=op, fnkey=f.key,
                    relpath=relpath, line=site.lineno,
                    col=site.col_offset, locks=frozenset(held),
                    init=is_init and op == "write",
                )
            )

        def facts(n, held):
            if isinstance(n, ast.Call):
                nm = call_name(n)
                if isinstance(n.func, ast.Attribute):
                    method_attrs.add(id(n.func))
                if nm:
                    f.calls.append(CallFact(nm, n, tuple(held)))
                    b = self._blocking_name(relpath, nm, n)
                    if b:
                        f.blocking.append(
                            BlockFact(
                                b, n.lineno, n.col_offset, tuple(held)
                            )
                        )
                    if (
                        isinstance(n.func, ast.Attribute)
                        and n.func.attr in _MUTATORS
                    ):
                        recv = n.func.value
                        if (
                            isinstance(recv, ast.Attribute)
                            and isinstance(recv.value, ast.Name)
                            and recv.value.id == "self"
                            and f.cls
                        ):
                            add_access(
                                ("class", f.cls), recv.attr, "write",
                                n, held,
                            )
                        elif (
                            isinstance(recv, ast.Name)
                            and recv.id in gset
                            and recv.id not in local_stores
                            and recv.id not in params
                        ):
                            add_access(
                                ("module", relpath), recv.id, "write",
                                n, held,
                            )
            elif isinstance(n, ast.Attribute):
                if (
                    isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    and f.cls
                    and id(n) not in method_attrs
                ):
                    op = (
                        "write"
                        if isinstance(n.ctx, (ast.Store, ast.Del))
                        else "read"
                    )
                    add_access(("class", f.cls), n.attr, op, n, held)
            elif isinstance(n, ast.Subscript):
                if isinstance(n.ctx, (ast.Store, ast.Del)):
                    v = n.value
                    if (
                        isinstance(v, ast.Attribute)
                        and isinstance(v.value, ast.Name)
                        and v.value.id == "self"
                        and f.cls
                    ):
                        add_access(
                            ("class", f.cls), v.attr, "write", n, held
                        )
                    elif (
                        isinstance(v, ast.Name)
                        and v.id in gset
                        and v.id not in local_stores
                        and v.id not in params
                    ):
                        add_access(
                            ("module", relpath), v.id, "write", n, held
                        )
            elif isinstance(n, ast.Name):
                if isinstance(n.ctx, (ast.Store, ast.Del)):
                    if n.id in f.globals_decl:
                        add_access(
                            ("module", relpath), n.id, "write", n, held
                        )
                elif n.id in f.globals_decl:
                    add_access(
                        ("module", relpath), n.id, "read", n, held
                    )
                elif (
                    n.id in gset
                    and n.id not in local_stores
                    and n.id not in params
                ):
                    add_access(
                        ("module", relpath), n.id, "read", n, held
                    )

        def visit(n, held):
            if isinstance(
                n,
                (
                    ast.FunctionDef,
                    ast.AsyncFunctionDef,
                    ast.Lambda,
                    ast.ClassDef,
                ),
            ):
                return  # separate scope: facts belong to its own owner
            if isinstance(n, (ast.With, ast.AsyncWith)):
                acquired: List[Tuple[LockId, int]] = []
                for item in n.items:
                    visit(item.context_expr, held)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, held)
                    lk = self._lock_of(f, item.context_expr)
                    if lk is not None:
                        acquired.append((lk, n.lineno))
                for lk, ln in acquired:
                    f.direct_locks.append((lk, ln))
                    for h in held:
                        if h != lk:
                            self.lock_edges.setdefault(
                                (h, lk), (relpath, ln, f.qual)
                            )
                inner = tuple(held) + tuple(
                    lk for lk, _ in acquired if lk not in held
                )
                for stmt in n.body:
                    visit(stmt, inner)
                return
            facts(n, held)
            for c in ast.iter_child_nodes(n):
                visit(c, held)

        if isinstance(node, ast.Lambda):
            visit(node.body, ())
        else:
            for stmt in node.body:
                visit(stmt, ())

    # -- thread roots ---------------------------------------------------

    def _fn_marked_writer(self, key: FnKey) -> bool:
        f = self.fns.get(key)
        if f is None:
            return False
        lo = max(1, f.node.lineno - 1)
        hi = getattr(f.node, "end_lineno", f.node.lineno)
        for text in f.mod.lines[lo - 1 : hi]:
            if _WRITER_MARKER_RE.search(text):
                return True
        return False

    def _resolve_target(
        self, f: ThreadFn, expr: Optional[ast.AST]
    ) -> List[FnKey]:
        if expr is None:
            return []
        if isinstance(expr, ast.Name):
            cur: Optional[ThreadFn] = f
            while cur is not None:
                for k in self.children.get(cur.key, []):
                    if self.fns[k].name == expr.id:
                        return [k]
                cur = (
                    self.fns.get(cur.parent)
                    if cur.parent is not None
                    else None
                )
            k = self.module_fns.get(f.relpath, {}).get(expr.id)
            if k:
                return [k]
            _, froms = self.imports.get(f.relpath, ({}, {}))
            tgt = froms.get(expr.id)
            if tgt:
                return self._resolve_dotted(tgt)
            return []
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and f.cls
        ):
            return self._lookup_method(f.cls, expr.attr)
        return []

    def _in_loop(self, f: ThreadFn, call: ast.Call) -> bool:
        found = False

        def rec(n, inloop):
            nonlocal found
            if n is call and inloop:
                found = True
                return
            if (
                isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                )
                and n is not f.node
            ):
                return
            il = inloop or isinstance(
                n, (ast.For, ast.AsyncFor, ast.While)
            )
            for c in ast.iter_child_nodes(n):
                rec(c, il)

        rec(f.node, False)
        return found

    def _thread_aliases(
        self, f: ThreadFn, call: ast.Call
    ) -> Tuple[Set[str], Set[str]]:
        names: Set[str] = set()
        attrs: Set[str] = set()
        for n in ast.walk(f.node):
            if isinstance(n, ast.Assign) and n.value is call:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        attrs.add(t.attr)
        for _ in range(2):
            for n in ast.walk(f.mod.tree):
                if not isinstance(n, ast.Assign):
                    continue
                src = n.value
                hit = (
                    isinstance(src, ast.Name) and src.id in names
                ) or (
                    isinstance(src, ast.Attribute) and src.attr in attrs
                )
                if not hit:
                    continue
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        attrs.add(t.attr)
        return names, attrs

    def _find_roots(self) -> None:
        for f in list(self.fns.values()):
            for cf in f.calls:
                if last_attr(cf.name) != "Thread":
                    continue
                if self._canon(f.relpath, cf.name) != "threading.Thread":
                    continue
                call = cf.node
                tks = self._resolve_target(
                    f, get_arg(call, 1, "target")
                )
                tgt_expr = get_arg(call, 1, "target")
                daemon: Optional[bool] = None
                dm = get_arg(call, None, "daemon")
                if isinstance(dm, ast.Constant):
                    daemon = bool(dm.value)
                names, attrs = self._thread_aliases(f, call)
                if daemon is None:
                    for n in ast.walk(f.mod.tree):
                        if (
                            isinstance(n, ast.Assign)
                            and isinstance(
                                n.targets[0], ast.Attribute
                            )
                            and n.targets[0].attr == "daemon"
                        ):
                            recv = n.targets[0].value
                            if (
                                isinstance(recv, ast.Name)
                                and recv.id in names
                            ) or (
                                isinstance(recv, ast.Attribute)
                                and recv.attr in attrs
                            ):
                                if isinstance(n.value, ast.Constant):
                                    daemon = bool(n.value.value)
                joined = False
                for n in ast.walk(f.mod.tree):
                    if (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "join"
                    ):
                        recv = n.func.value
                        if (
                            isinstance(recv, ast.Name)
                            and recv.id in names
                        ) or (
                            isinstance(recv, ast.Attribute)
                            and recv.attr in attrs
                        ):
                            joined = True
                for tk in tks or [None]:
                    if tk is not None:
                        desc = tk[1]
                        label = f"thread:{desc}@{tk[0]}"
                    else:
                        desc = (
                            dotted_name(tgt_expr)
                            if tgt_expr is not None
                            else None
                        ) or "<unresolved>"
                        label = f"thread:{desc}@{f.relpath}"
                    self.roots.append(
                        ThreadRoot(
                            label=label, kind="thread", fnkey=tk,
                            target_desc=desc, created_in=f.key,
                            relpath=f.relpath, line=call.lineno,
                            daemon=daemon, joined=joined,
                            multi=self._in_loop(f, call),
                            marked_writer=(
                                self._fn_marked_writer(tk)
                                if tk
                                else False
                            ),
                        )
                    )
        # handler pools: every method of an http.server handler subclass
        def is_handler_class(ci: _ClassInfo, depth=0) -> bool:
            if depth > 2:
                return False
            for b in ci.bases:
                if b in _HANDLER_BASES:
                    return True
                for bi in self.classes.get(b, []):
                    if is_handler_class(bi, depth + 1):
                        return True
            return False

        for cname, infos in sorted(self.classes.items()):
            for ci in infos:
                if not is_handler_class(ci):
                    continue
                for mname, mkey in sorted(ci.methods.items()):
                    fn = self.fns[mkey]
                    self.roots.append(
                        ThreadRoot(
                            label=(
                                f"handler:{cname}.{mname}@{ci.relpath}"
                            ),
                            kind="handler", fnkey=mkey,
                            target_desc=f"{cname}.{mname}",
                            created_in=None, relpath=ci.relpath,
                            line=fn.node.lineno, daemon=True,
                            joined=True, multi=True,
                            marked_writer=self._fn_marked_writer(mkey),
                        )
                    )
        # callback roots: HealthMonitor callbacks (``*.add_callback(fn)``
        # / ``HealthMonitor(on_alert=fn)``) run inline on WHICHEVER
        # thread calls evaluate() — the driver loop, the demo drive
        # thread, an HTTP handler — so the callback body (e.g. the
        # flight recorder's capture path) must be analyzed like a
        # spawned target that can race any of them. ``multi``: distinct
        # evaluating threads can run the same callback concurrently.
        for f in list(self.fns.values()):
            for cf in f.calls:
                call = cf.node
                if last_attr(cf.name) == "add_callback":
                    expr = get_arg(call, 0, "cb")
                elif (
                    self._constructor_class(f.relpath, cf.name)
                    == "HealthMonitor"
                ):
                    expr = get_arg(call, None, "on_alert")
                else:
                    continue
                if expr is None:
                    continue
                tks = self._resolve_callback(f, expr)
                for tk in tks or [None]:
                    if tk is not None:
                        desc = tk[1]
                        label = f"callback:{desc}@{tk[0]}"
                    else:
                        desc = (
                            dotted_name(expr)
                            if not isinstance(expr, ast.Lambda)
                            else None
                        ) or "<unresolved>"
                        label = f"callback:{desc}@{f.relpath}"
                    self.roots.append(
                        ThreadRoot(
                            label=label, kind="callback", fnkey=tk,
                            target_desc=desc, created_in=f.key,
                            relpath=f.relpath, line=call.lineno,
                            daemon=True, joined=True, multi=True,
                            marked_writer=(
                                self._fn_marked_writer(tk)
                                if tk
                                else False
                            ),
                        )
                    )
        for r in self.roots:
            self.root_by_label.setdefault(r.label, r)

    def _resolve_callback(
        self, f: ThreadFn, expr: Optional[ast.AST]
    ) -> List[FnKey]:
        """Thread-target resolution plus the registration idiom
        :func:`_resolve_target` cannot see: ``obj.method`` where ``obj``
        was constructed from a project class in scope (the
        ``fr = FlightRecorder(...); monitor.add_callback(fr.on_finding)``
        shape of :func:`...telemetry.incident.install`)."""
        tks = self._resolve_target(f, expr)
        if tks:
            return tks
        if isinstance(expr, ast.Attribute):
            cls = self._class_of_expr(f, expr.value)
            if cls:
                return self._lookup_method(cls, expr.attr)
        return []

    # -- call resolution ------------------------------------------------

    def _lookup_method(
        self, cls: str, meth: str, depth: int = 0
    ) -> List[FnKey]:
        out: List[FnKey] = []
        for ci in self.classes.get(cls, []):
            k = ci.methods.get(meth)
            if k is not None:
                out.append(k)
            elif depth < 2:
                for b in ci.bases:
                    out.extend(self._lookup_method(b, meth, depth + 1))
        return out

    def _constructor_class(
        self, relpath: str, nm: str
    ) -> Optional[str]:
        tail = last_attr(self._canon(relpath, nm))
        return tail if tail in self.classes else None

    def _class_of_annotation(self, ann) -> Optional[str]:
        if ann is None:
            return None
        for n in ast.walk(ann):
            if isinstance(n, ast.Name) and n.id in self.classes:
                return n.id
            if isinstance(n, ast.Attribute) and n.attr in self.classes:
                return n.attr
            if (
                isinstance(n, ast.Constant)
                and isinstance(n.value, str)
                and n.value.strip("'\"") in self.classes
            ):
                return n.value.strip("'\"")
        return None

    def _class_of_expr(
        self, f: ThreadFn, expr, depth: int = 0
    ) -> Optional[str]:
        if depth > 3 or expr is None:
            return None
        if isinstance(expr, ast.Call):
            nm = call_name(expr)
            if nm:
                return self._constructor_class(f.relpath, nm)
            return None
        if isinstance(expr, ast.Name):
            return self._class_of_local(f, expr.id, depth + 1)
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and f.cls
        ):
            return self._class_of_self_attr(f.cls, expr.attr)
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                c = self._class_of_expr(f, v, depth + 1)
                if c:
                    return c
        if isinstance(expr, ast.IfExp):
            return self._class_of_expr(
                f, expr.body, depth + 1
            ) or self._class_of_expr(f, expr.orelse, depth + 1)
        return None

    def _class_of_local(
        self, f: ThreadFn, name: str, depth: int = 0
    ) -> Optional[str]:
        if depth > 4:
            return None
        cur: Optional[ThreadFn] = f
        while cur is not None:
            args = getattr(cur.node, "args", None)
            if args is not None:
                for a in (
                    list(args.posonlyargs)
                    + list(args.args)
                    + list(args.kwonlyargs)
                ):
                    if a.arg == name:
                        return self._class_of_annotation(a.annotation)
            for n in ast.walk(cur.node):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Name) and t.id == name:
                            c = self._class_of_expr(
                                cur, n.value, depth + 1
                            )
                            if c:
                                return c
            cur = (
                self.fns.get(cur.parent)
                if cur.parent is not None
                else None
            )
        return None

    def _class_of_self_attr(
        self, cls: str, attr: str
    ) -> Optional[str]:
        ck = (cls, attr)
        if ck in self._self_attr_cache:
            return self._self_attr_cache[ck]
        self._self_attr_cache[ck] = None  # cut recursion cycles
        result: Optional[str] = None
        for ci in self.classes.get(cls, []):
            for mkey in ci.methods.values():
                mf = self.fns[mkey]
                for n in ast.walk(mf.node):
                    if not isinstance(n, ast.Assign):
                        continue
                    for t in n.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and t.attr == attr
                        ):
                            c = self._class_of_expr(mf, n.value, 1)
                            if c:
                                result = c
                if result:
                    break
            if result:
                break
        self._self_attr_cache[ck] = result
        return result

    def _resolve_dotted(self, full: str, depth: int = 0) -> List[FnKey]:
        if depth > 3:
            return []
        modname, _, name = full.rpartition(".")
        tmod = self.project.by_modname.get(modname)
        if tmod is None:
            return []
        rel = tmod.relpath
        k = self.module_fns.get(rel, {}).get(name)
        if k:
            return [k]
        for ci in self.classes.get(name, []):
            if ci.relpath == rel:
                init = ci.methods.get("__init__")
                return [init] if init else []
        _, froms = self.imports.get(rel, ({}, {}))
        nxt = froms.get(name)
        if nxt:
            return self._resolve_dotted(nxt, depth + 1)
        return []

    def _resolve_call(self, f: ThreadFn, cf: CallFact) -> List[FnKey]:
        nm = cf.name
        parts = nm.split(".")
        tail = parts[-1]
        if len(parts) == 1:
            cur: Optional[ThreadFn] = f
            while cur is not None:
                for k in self.children.get(cur.key, []):
                    if self.fns[k].name == nm:
                        return [k]
                cur = (
                    self.fns.get(cur.parent)
                    if cur.parent is not None
                    else None
                )
            k = self.module_fns.get(f.relpath, {}).get(nm)
            if k:
                return [k]
            for ci in self.classes.get(nm, []):
                if ci.relpath == f.relpath:
                    init = ci.methods.get("__init__")
                    return [init] if init else []
            _, froms = self.imports.get(f.relpath, ({}, {}))
            tgt = froms.get(nm)
            if tgt:
                return self._resolve_dotted(tgt)
            return []
        head = parts[0]
        if head == "self" and f.cls:
            if len(parts) == 2:
                m = self._lookup_method(f.cls, tail)
                if m:
                    return m
            elif len(parts) == 3:
                c2 = self._class_of_self_attr(f.cls, parts[1])
                if c2:
                    m = self._lookup_method(c2, tail)
                    if m:
                        return m
        else:
            aliases, froms = self.imports.get(f.relpath, ({}, {}))
            modname = froms.get(head) or aliases.get(head)
            if modname is not None:
                keys = self._resolve_dotted(
                    modname + "." + ".".join(parts[1:])
                )
                if keys:
                    return keys
            if len(parts) == 2:
                c2 = self._class_of_local(f, head)
                if c2:
                    m = self._lookup_method(c2, tail)
                    if m:
                        return m
            elif len(parts) == 3:
                c1 = self._class_of_local(f, head)
                if c1:
                    c2 = self._class_of_self_attr(c1, parts[1])
                    if c2:
                        m = self._lookup_method(c2, tail)
                        if m:
                            return m
        # unresolved receiver: conservative project-wide match by
        # method name, gated by the common-name blocklist
        if tail not in _COMMON_METHODS:
            return list(self.methods_by_name.get(tail, []))
        return []

    # -- closures -------------------------------------------------------

    def _bfs(self, seeds: Set[FnKey]) -> Set[FnKey]:
        reached: Set[FnKey] = set()
        frontier = list(seeds)
        while frontier:
            k = frontier.pop()
            if k in reached:
                continue
            reached.add(k)
            frontier.extend(self.edges.get(k, ()))
        return reached

    def _closures(self) -> None:
        for f in self.fns.values():
            outs: Set[FnKey] = set()
            for cf in f.calls:
                tks = tuple(self._resolve_call(f, cf))
                cf.targets = tks
                outs.update(tks)
            self.edges[f.key] = outs
        spawned_union: Set[FnKey] = set()
        for label, root in self.root_by_label.items():
            if root.fnkey is None:
                self.reach[label] = set()
                continue
            cl = self._bfs({root.fnkey})
            self.reach[label] = cl
            spawned_union |= cl
        seeds = set(self.fns) - spawned_union
        self.main_reach = self._bfs(seeds)
        # one-level caller-guard inference: a function whose EVERY known
        # call site holds lock L is effectively guarded by L (the
        # ``_record_locked`` pattern — acquire in the public method,
        # mutate in a private helper). Never applied to root targets:
        # the runtime enters those with no locks held.
        incoming: Dict[FnKey, List[FrozenSet[LockId]]] = {}
        for f in self.fns.values():
            for cf in f.calls:
                for tk in cf.targets:
                    incoming.setdefault(tk, []).append(
                        frozenset(cf.held)
                    )
        root_keys = {r.fnkey for r in self.roots if r.fnkey}
        self.fn_caller_guard: Dict[FnKey, FrozenSet[LockId]] = {}
        for k, helds in incoming.items():
            if k in root_keys:
                continue
            g = frozenset.intersection(*helds)
            if g:
                self.fn_caller_guard[k] = g

    def roots_of(self, key: FnKey) -> FrozenSet[str]:
        """Labels of every root whose closure contains ``key`` (plus
        ``main`` when the main closure does; a function nothing reaches
        is main — dead code runs on no other thread)."""
        if key in self._roots_cache:
            return self._roots_cache[key]
        labels = {
            label
            for label, cl in self.reach.items()
            if key in cl
        }
        if key in self.main_reach or not labels:
            labels.add(MAIN)
        out = frozenset(labels)
        self._roots_cache[key] = out
        return out

    # -- queries for rules ----------------------------------------------

    def shared_entries(
        self,
    ) -> Dict[Tuple[Tuple[str, str], str], List[Access]]:
        out: Dict[Tuple[Tuple[str, str], str], List[Access]] = {}
        for f in self.fns.values():
            guard = self.fn_caller_guard.get(f.key)
            for a in f.accesses:
                if guard:
                    a = dataclasses.replace(a, locks=a.locks | guard)
                out.setdefault((a.owner, a.field), []).append(a)
        return out

    def receiver_is_fresh_local(self, f: ThreadFn, cf: CallFact) -> bool:
        """True when the call receiver is a local variable assigned from
        a project-class constructor IN THIS function — a thread-local
        object, not shared state (kills from_journal/aggregate noise).
        Peels ``x if x is not None else Cls()`` default-registry idioms:
        the branch that matters on the unshared path is the fresh
        constructor."""
        parts = cf.name.split(".")
        if len(parts) < 2 or parts[0] == "self":
            return False
        head = parts[0]
        for n in ast.walk(f.node):
            if not isinstance(n, ast.Assign):
                continue
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == head:
                    if self._is_fresh_ctor(f, n.value):
                        return True
        return False

    def _is_fresh_ctor(self, f: ThreadFn, expr, depth: int = 0) -> bool:
        if depth > 2 or expr is None:
            return False
        if isinstance(expr, ast.Call):
            nm = call_name(expr)
            return bool(nm and self._constructor_class(f.relpath, nm))
        if isinstance(expr, ast.IfExp):
            return self._is_fresh_ctor(
                f, expr.body, depth + 1
            ) or self._is_fresh_ctor(f, expr.orelse, depth + 1)
        if isinstance(expr, ast.BoolOp):
            return any(
                self._is_fresh_ctor(f, v, depth + 1)
                for v in expr.values
            )
        return False


# -- rule registry and runner -------------------------------------------

TRuleFn = Callable[[ThreadModel], List[Finding]]
_T_RULES: List[Tuple[str, TRuleFn]] = []


def t_rule(rule_id: str):
    def deco(fn: TRuleFn) -> TRuleFn:
        _T_RULES.append((rule_id, fn))
        return fn

    return deco


def build_model(
    paths: Sequence[str], root: Optional[str] = None
) -> ThreadModel:
    return ThreadModel(build_project(paths, root))


def run_racecheck(
    paths: Sequence[str],
    root: Optional[str] = None,
    rules: Optional[Iterable[str]] = None,
    model: Optional[ThreadModel] = None,
) -> List[Finding]:
    """Scan ``paths`` and return unsuppressed findings, sorted."""
    from mpi_grid_redistribute_tpu_torch.analysis import (  # noqa: F401
        rules_thread,
    )

    if model is None:
        model = build_model(paths, root)
    wanted = set(rules) if rules else set(T_RULE_IDS)
    findings: List[Finding] = []
    seen: Set[Tuple] = set()
    for rule_id, fn in _T_RULES:
        if rule_id not in wanted:
            continue
        for f in fn(model):
            if model.suppressed(f.path, f.rule, f.line):
                continue
            key = (f.rule, f.path, f.line, f.col, f.message)
            if key in seen:
                continue
            seen.add(key)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


T_RULE_DOCS = {
    "T001": "no unguarded cross-thread writes: a class field / module "
    "global written from one thread root and touched from another must "
    "have one lock held at every access site",
    "T002": "no lock-acquisition-order cycles (lexical with-nesting "
    "plus one level of calls made while holding a lock)",
    "T003": "no blocking call (sleep/join/wait/subprocess/file or "
    "socket I/O/block_until_ready) while holding a lock",
    "T004": "threads created in service-path-marked modules must be "
    "daemon=True and joined somewhere in the module",
    "T005": "StepRecorder/MetricsRegistry mutation is only reachable "
    "from thread roots marked '# racecheck: recorder-writer' (single-"
    "writer journal discipline; fresh thread-local instances exempt)",
}

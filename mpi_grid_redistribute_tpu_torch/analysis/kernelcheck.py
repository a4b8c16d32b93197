"""kernelcheck: the checker of the port's hand-written CUDA kernels (the
twin of the JAX package's ``analysis/kernelcheck.py``).

The reference captures every ``pallas_call``'s grid and BlockSpecs at
trace time and interprets them abstractly. A CUDA kernel has no such
anatomy to read: its addressing is arithmetic inside a ``.cu`` file. So
the port checks what each kernel DOES, at the reference's registered
shapes: a registry of the reference's six cases (names, shapes and
seeded inputs) and cases of the kernels the port has beyond them
(:data:`PORT_CASES`: the scan deposit's payload sort, which computes its
keys, and its tile carries), each calling the port's public op with its
plain twin beside it, and the rules

- **K000** registry completeness: every kernel in ``ops._build.KERNELS``
  has a case, and on the card each case raises its kernel's launch count
  by the number it expects (a case that takes the plain route guards
  nothing);
- **K001** in-bounds addressing: every tensor a case hands its op
  (inputs, in-place operands and ``_out=`` outputs) is the interior of a
  larger allocation whose guard bands (``rules_kernel.GUARD_BYTES`` a side)
  hold a sentinel byte; after the launch every guard byte must still be
  it. Reads out of bounds are ``compute-sanitizer --tool memcheck``'s
  part (``tools.kernelcheck --sanitize``);
- **K002** write coverage and overlap: with its outputs filled with the
  sentinel, a dense kernel leaves no sentinel where its plain twin writes
  a value, a scatter kernel writes exactly its contract's set (kernel
  2/3: column ``t`` for every ``0 <= t < m``; kernel 6: row ``t`` for
  every ``0 <= t < n``; other targets dropped) and nothing else, and no
  input changes. A case tagged ``scatter=True`` is also held to strict
  disjointness: three back-to-back launches give the same bits, and a
  duplicate in-range target is refused where the port refuses one
  (``ops/overlay.py``'s debug check);
- **K003** the card's footprint: registers a thread, static and dynamic
  shared bytes, local (spill) bytes and threads a block of every
  function a case launches (``<stem>_resource_usage`` in each
  ``csrc/*.cu``), gated against Hopper's limits and exactly against the
  committed ``analysis/kernelcheck_baseline.json``, which records the
  ``nvcc`` that built it;
- **K004** is not applicable: lane tiling is a property of the TPU
  compiler;
- **K005** each case bit-equal to its plain twin on the same inputs.

With ``device="cpu"`` the ops take their plain routes: K000's registry
leg, K001, K002 and K005 then check the plain versions (and the checker
itself); the launch counts and K003 need the card and are not run.

Suppressions use kernelcheck's own marker, ``kernelcheck:
disable=K00x`` after a hash on the finding's line, or its
``disable-file=`` form anywhere in the file (spelled without the hash
here, so this file suppresses nothing). The CLI is
``tools/kernelcheck.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

K_RULE_IDS = ("K000", "K001", "K002", "K003", "K004", "K005")
# the rules a run executes; K004 has no CUDA counterpart
RUN_RULES = ("K000", "K001", "K002", "K003", "K005")

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SELF_PATH = "mpi_grid_redistribute_tpu_torch/analysis/kernelcheck.py"

_SUPPRESS_RE = re.compile(
    r"#\s*kernelcheck:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>(?:K\d{3}|all)(?:\s*,\s*(?:K\d{3}|all))*)"
)

# ---------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelFinding:
    """One K-rule violation in one registered case. The surface of the
    tools' ``Finding`` (rule/path/line/message, ``symbol`` and
    ``baseline_key``), so the shared SARIF and github formatters apply;
    the symbol is the case's name."""

    rule: str
    kernel: str
    message: str
    path: str = _SELF_PATH
    line: int = 1

    @property
    def symbol(self) -> str:
        return self.kernel

    def baseline_key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.kernel, self.message)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: <{self.kernel}>: {self.rule}: "
                f"{self.message}")


# ---------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------


@dataclasses.dataclass
class KernelCase:
    """One built case.

    ``inputs`` are the builder's numpy arrays by name; ``roles`` gives
    each tensor the op touches its role: ``"in"`` (read only),
    ``"inout"`` (read and updated in place), ``"overwrite"`` (updated in
    place, never read: in the sentinel run it starts as the sentinel) or
    ``"out"`` (an ``_out=`` output; ``out_specs`` gives its shape and
    dtype). ``run(t)`` calls the public op on the tensors ``t`` and
    returns its outputs by name; ``plain(t)`` calls the plain twin the
    same way. ``written(inputs)`` gives, for a scatter kernel, the
    element mask of each output its contract writes; ``duplicate(t)``
    calls the op with a duplicate in-range target where the port refuses
    one; ``functions(t)`` is the op's ``launch_functions``."""

    inputs: Dict[str, np.ndarray]
    roles: Dict[str, str]
    run: Callable
    plain: Callable
    functions: Callable
    out_specs: Dict[str, Tuple[tuple, str]] = dataclasses.field(
        default_factory=dict)
    written: Optional[Callable] = None
    duplicate: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A registered case: its ``build`` (-> :class:`KernelCase`), the
    ``_build.KERNELS`` entry it launches and how many launches one call
    adds. ``scatter=True`` holds it to strict disjointness."""

    name: str
    build: Callable[[], KernelCase]
    description: str
    kernel: str
    op: str
    plain_op: str
    launches: int = 1
    scatter: bool = False


KERNELS: Dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    if spec.name in KERNELS:
        raise ValueError(f"kernel case {spec.name!r} registered twice")
    KERNELS[spec.name] = spec
    return spec


@contextlib.contextmanager
def _env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


# -- the reference's six cases, their inputs made as its builders make
# them (same seeds, same draws in the same order) ----------------------


def _build_driftbin() -> KernelCase:
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.ops import driftbin

    V, n = 8, 2048
    dt = 0.05
    domain = Domain(0.0, 1.0, periodic=True)
    grid = ProcessGrid((2, 2, 2))
    r = np.random.default_rng(11)
    m = V * n
    pos = (r.random((3, m), dtype=np.float32) * 2 - 0.5).astype(np.float32)
    vel = (r.random((3, m), dtype=np.float32) - 0.5).astype(np.float32)
    alive = (r.random((m,)) < 0.9).astype(np.int32)
    flat = np.concatenate(
        [pos.view(np.int32), vel.view(np.int32), alive[None, :]], axis=0)

    def run(t):
        f, key = driftbin.drift_wrap_bin(t["flat"], dt, domain, grid, V, V,
                                         _out=t["key"])
        return {"flat": f, "key": key}

    def plain(t):
        f, key = driftbin.drift_wrap_bin_plain(t["flat"], dt, domain, grid,
                                               V, V)
        return {"flat": f, "key": key}

    return KernelCase(
        inputs={"flat": flat}, roles={"flat": "inout", "key": "out"},
        out_specs={"key": ((V, n), "int32")}, run=run, plain=plain,
        functions=lambda t: driftbin.launch_functions(t["flat"], V))


def _build_scatter() -> KernelCase:
    from mpi_grid_redistribute_tpu_torch.ops import scatter

    n_rows, k, p = 2 * 8192, 7, 300  # the reference's 2 * BLOCK rows
    r = np.random.default_rng(12)
    flat = r.standard_normal((n_rows, k)).astype(np.float32)
    targets = r.choice(n_rows + 96, size=p, replace=False).astype(np.int32)
    targets[0] = -3  # negative = drop
    rows = r.standard_normal((p, k)).astype(np.float32)

    def run(t):
        return {"flat": scatter.scatter_rows(t["flat"], t["targets"],
                                             t["rows"])}

    def plain(t):
        return {"flat": scatter.scatter_rows_plain(t["flat"], t["targets"],
                                                   t["rows"])}

    def written(a):
        tg = a["targets"]
        mask = np.zeros(a["flat"].shape, bool)
        mask[tg[(tg >= 0) & (tg < n_rows)]] = True
        return {"flat": mask}

    return KernelCase(
        inputs={"flat": flat, "targets": targets, "rows": rows},
        roles={"flat": "overwrite", "targets": "in", "rows": "in"},
        run=run, plain=plain, written=written,
        functions=lambda t: scatter.launch_functions(
            t["flat"], t["targets"], t["rows"]))


def _mk_overlay_case(seed, k, m, p, encoding) -> KernelCase:
    """The reference's overlay case without its TPU block width ``w``
    (the CUDA kernel places each column directly)."""
    import torch

    from mpi_grid_redistribute_tpu_torch.ops import overlay

    r = np.random.default_rng(seed)
    # raw int32 words: every encoding must carry any bit pattern exactly
    flat = r.integers(-(2**31), 2**31 - 1, size=(k, m), dtype=np.int32)
    cols = r.integers(-(2**31), 2**31 - 1, size=(k, p), dtype=np.int32)
    targets = r.choice(m + 128, size=p, replace=False).astype(np.int32)

    def run(t):
        return {"flat": overlay.overlay_scatter_planar(
            t["flat"], t["targets"], t["cols"], encoding=encoding)}

    def plain(t):
        return {"flat": overlay.overlay_scatter_planar_plain(
            t["flat"], t["targets"], t["cols"])}

    def written(a):
        tg = a["targets"]
        mask = np.zeros(a["flat"].shape, bool)
        mask[:, tg[(tg >= 0) & (tg < m)]] = True
        return {"flat": mask}

    def duplicate(t):
        tg = t["targets"].clone()
        ok = torch.nonzero((tg >= 0) & (tg < m)).flatten()
        tg[ok[1]] = tg[ok[0]]
        with _env("MPI_GRID_OVERLAY_DEBUG", "1"):
            overlay.overlay_scatter_planar(t["flat"], tg, t["cols"],
                                           encoding=encoding)

    return KernelCase(
        inputs={"flat": flat, "targets": targets, "cols": cols},
        roles={"flat": "overwrite", "targets": "in", "cols": "in"},
        run=run, plain=plain, written=written, duplicate=duplicate,
        functions=lambda t: overlay.launch_functions(
            t["flat"], t["targets"], t["cols"]))


def _build_overlay_int8() -> KernelCase:
    return _mk_overlay_case(13, 7, 8192, 300, "int8")


def _build_overlay_half() -> KernelCase:
    return _mk_overlay_case(14, 7, 4096, 200, "half")


def _build_dfscan() -> KernelCase:
    from mpi_grid_redistribute_tpu_torch.ops import dfscan

    r = np.random.default_rng(15)
    x = r.standard_normal((300, 256)).astype(np.float32)

    def run(t):
        hi, lo = dfscan.tile_df_cumsum_rows(t["x"], _out=(t["hi"], t["lo"]))
        return {"hi": hi, "lo": lo}

    def plain(t):
        hi, lo = dfscan.tile_df_cumsum_rows_plain(t["x"])
        return {"hi": hi, "lo": lo}

    return KernelCase(
        inputs={"x": x}, roles={"x": "in", "hi": "out", "lo": "out"},
        out_specs={"hi": (x.shape, "float32"), "lo": (x.shape, "float32")},
        run=run, plain=plain,
        functions=lambda t: dfscan.launch_functions(t["x"]))


def _build_segdep() -> KernelCase:
    from mpi_grid_redistribute_tpu_torch.ops import segdep

    n_cells, n, d = 512, 6000, 2
    vblock = (8, 8)
    r = np.random.default_rng(16)
    # sorted keys + a sentinel tail; rel DYADIC (multiples of 1/4), so the
    # corner weights are multiples of 1/16 and every summation order
    # gives the same bits: the data on which kernel 4 and its plain twin
    # are bit-comparable
    keys = np.sort(r.integers(0, n_cells, size=n - 200)).astype(np.int32)
    keys = np.concatenate([keys, np.full((200,), n_cells, np.int32)])
    rel = (r.integers(0, 32, size=(d, n)) * 0.25).astype(np.float32)

    def run(t):
        return {"out": segdep.segsum_sorted(t["keys"], t["rel"], None,
                                            n_cells, vblock, _out=t["out"])}

    def plain(t):
        return {"out": segdep.segsum_sorted_plain(t["keys"], t["rel"], None,
                                                  n_cells, vblock)}

    return KernelCase(
        inputs={"keys": keys, "rel": rel},
        roles={"keys": "in", "rel": "in", "out": "out"},
        out_specs={"out": ((1 << d, n_cells), "float32")},
        run=run, plain=plain,
        functions=lambda t: segdep.launch_functions(t["keys"], t["rel"],
                                                    None))


# -- the port's own kernels, which replace no TPU kernel ----------------


def _build_rowsort_keys() -> KernelCase:
    from mpi_grid_redistribute_tpu_torch.ops import rowsort

    V, n, vblock = 2, 2500, (8, 8, 8)
    r = np.random.default_rng(18)
    # two vranks' 8^3 blocks side by side along x; ~10% invalid slots, and
    # on valid ones a NaN, -0.0, an infinity, positions outside the block
    # and on its upper face
    lo = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]], np.float32)
    inv_h = np.array([16.0, 8.0, 8.0], np.float32)
    v = np.repeat(np.arange(V), n)
    pos = (lo[v].T + r.random((3, V * n), dtype=np.float32)
           * (1.0 / inv_h[:, None] * 8.0)).astype(np.float32)
    valid = r.random(V * n) < 0.9
    pos[0, :6] = (np.nan, -0.0, np.inf, -0.25, 1.5, 0.5)
    pos[1, n:n + 2] = (-np.inf, 1.0)
    valid[:6] = valid[n:n + 2] = True
    mass = r.uniform(0.5, 2.0, V * n).astype(np.float32)

    def run(t):
        k, rows = rowsort.sort_keyed_rows(
            t["pos"], t["valid"], t["mass"], t["lo"], t["inv_h"], vblock,
            _out=(t["keys_s"], t["rows_s"]))
        return {"keys_s": k, "rows_s": rows}

    def plain(t):
        k, rows = rowsort.sort_keyed_rows_plain(
            t["pos"], t["valid"], t["mass"], t["lo"], t["inv_h"], vblock)
        return {"keys_s": k, "rows_s": rows}

    ins = {"pos": pos, "valid": valid, "mass": mass, "lo": lo,
           "inv_h": inv_h}
    return KernelCase(
        inputs=ins,
        roles=dict(dict.fromkeys(ins, "in"), keys_s="out", rows_s="out"),
        out_specs={"keys_s": ((V * n,), "int32"),
                   "rows_s": ((V * n, rowsort.ROW_FLOATS), "float32")},
        run=run, plain=plain,
        functions=lambda t: rowsort.launch_functions(t["pos"]))


def _build_tilecarry() -> KernelCase:
    from mpi_grid_redistribute_tpu_torch.ops import tilecarry

    g, T, tile = 2, 3000, 4
    r = np.random.default_rng(19)
    # within-tile prefixes of 2 channels, hi rows above lo rows: 3000
    # tiles, so that two launches run (ten doubling steps, then two), and
    # a NaN, an infinity and -0.0 among the tile totals
    pack = r.normal(size=(2 * g, T * tile)).astype(np.float32)
    pack[g:] *= np.float32(2.0**-24)
    pack[0, tile - 1] = -0.0
    pack[1, 700 * tile - 1] = np.nan
    pack[0, 2500 * tile - 1] = np.inf

    def run(t):
        return {"out": tilecarry.tile_carries(t["pack"], tile,
                                              _out=t["out"])}

    def plain(t):
        return {"out": tilecarry.tile_carries_plain(t["pack"], tile)}

    return KernelCase(
        inputs={"pack": pack},
        roles={"pack": "in", "out": "out"},
        out_specs={"out": ((2 * g, T + 1), "float32")},
        run=run, plain=plain,
        functions=lambda t: tilecarry.launch_functions(t["pack"], tile))


# the cases of the port's own kernels, beside the reference's six
PORT_CASES = ("rowsort_keys_3d_2x2500", "tilecarry_2x3000")

_DEFAULTS_BUILT = False


def _register_defaults() -> None:
    """Register the reference's six cases and :data:`PORT_CASES` (and, by
    importing their ops, the kernels of ``ops._build.KERNELS`` they
    launch)."""
    from mpi_grid_redistribute_tpu_torch.ops import (  # noqa: F401
        dfscan, driftbin, overlay, rowsort, scatter, segdep, tilecarry,
    )

    global _DEFAULTS_BUILT
    if _DEFAULTS_BUILT:
        return
    _DEFAULTS_BUILT = True
    ops = "mpi_grid_redistribute_tpu_torch.ops"
    register_kernel(KernelSpec(
        "driftbin_v8_n2048", _build_driftbin,
        "fused drift+wrap+bin, [7, 16384] int32 planar state updated in "
        "place, [8, 2048] key (kernel 1)",
        "drift_wrap_bin", f"{ops}.driftbin.drift_wrap_bin",
        f"{ops}.driftbin.drift_wrap_bin_plain"))
    register_kernel(KernelSpec(
        "scatter_rows_16384x7", _build_scatter,
        "row scatter, [16384, 7] f32 destination, 300 targets, one "
        "negative and some past the end (kernel 6)",
        "scatter_rows", f"{ops}.scatter.scatter_rows",
        f"{ops}.scatter.scatter_rows_plain", scatter=True))
    register_kernel(KernelSpec(
        "overlay_int8_7x8192", _build_overlay_int8,
        "landing column scatter, int8 encoding, [7, 8192] int32 state, "
        "300 targets (kernel 3)",
        "overlay_scatter_planar", f"{ops}.overlay.overlay_scatter_planar",
        f"{ops}.overlay.overlay_scatter_planar_plain", scatter=True))
    register_kernel(KernelSpec(
        "overlay_half_7x4096", _build_overlay_half,
        "landing column scatter, half encoding, [7, 4096] int32 state, "
        "200 targets (kernel 2)",
        "overlay_scatter_planar", f"{ops}.overlay.overlay_scatter_planar",
        f"{ops}.overlay.overlay_scatter_planar_plain", scatter=True))
    register_kernel(KernelSpec(
        "dfscan_300x256", _build_dfscan,
        "within-tile double-float prefix, [300, 256] f32, the register "
        "route (kernel 5)",
        "tile_df_cumsum_rows", f"{ops}.dfscan.tile_df_cumsum_rows",
        f"{ops}.dfscan.tile_df_cumsum_rows_plain"))
    register_kernel(KernelSpec(
        "segdep_2d_6000", _build_segdep,
        "segmented CIC corner sums, 6000 sorted keys (200 sentinels) "
        "into 512 cells, D = 2, unit mass (kernel 4)",
        "segsum_sorted", f"{ops}.segdep.segsum_sorted",
        f"{ops}.segdep.segsum_sorted_plain"))
    register_kernel(KernelSpec(
        "rowsort_keys_3d_2x2500", _build_rowsort_keys,
        "stable key-value radix sort of the scan deposit's payload rows, "
        "the keys computed in its pack from the positions: 2 vranks of "
        "2500 slots onto 8^3 blocks, D = 3, ~10% invalid, NaN, -0.0, "
        "infinities and positions off the block (the port's own kernel)",
        "sort_rows", f"{ops}.rowsort.sort_keyed_rows",
        f"{ops}.rowsort.sort_keyed_rows_plain"))
    register_kernel(KernelSpec(
        "tilecarry_2x3000", _build_tilecarry,
        "the scan deposit's tile carries, the double-float prefix over the "
        "last elements of 3000 tiles of 4 in 2 channels, two launches, a "
        "NaN, an infinity and -0.0 among them (the port's own kernel)",
        "tile_carries", f"{ops}.tilecarry.tile_carries",
        f"{ops}.tilecarry.tile_carries_plain"))


def default_kernels() -> Dict[str, KernelSpec]:
    _register_defaults()
    return dict(KERNELS)


# ---------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------


def _scan_suppressions(path: str):
    file_rules: set = set()
    line_rules: Dict[int, set] = {}
    abspath = path if os.path.isabs(path) else os.path.join(_REPO_ROOT,
                                                            path)
    if not os.path.exists(abspath):
        return file_rules, line_rules
    with open(abspath, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            if "all" in rules:
                rules = set(K_RULE_IDS)
            if m.group("file"):
                file_rules |= rules
            else:
                line_rules.setdefault(i, set()).update(rules)
    return file_rules, line_rules


def apply_suppressions(findings):
    """``(kept, n_suppressed)`` under the kernelcheck markers of each
    finding's file."""
    cache: Dict[str, tuple] = {}
    kept: List[KernelFinding] = []
    n_suppressed = 0
    for f in findings:
        if f.path not in cache:
            cache[f.path] = _scan_suppressions(f.path)
        file_rules, line_rules = cache[f.path]
        if f.rule in file_rules or f.rule in line_rules.get(f.line, set()):
            n_suppressed += 1
        else:
            kept.append(f)
    return kept, n_suppressed


# ---------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------


def check_case(name: str, spec: KernelSpec, device, selected,
               require_launches: bool):
    """Every selected rule on one case. Returns ``(findings, footprint
    row or None)``."""
    import torch

    from mpi_grid_redistribute_tpu_torch.analysis import rules_kernel as rk
    from mpi_grid_redistribute_tpu_torch.ops import _build

    findings: List[KernelFinding] = []
    case = spec.build()
    arena = rk.Arena(case, device)
    before = _build.counts()
    got = case.run(arena.tensors)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = _build.counts()
    if "K000" in selected and require_launches:
        findings += rk.check_launches(name, spec, before, after)
    if "K001" in selected:
        findings += rk.guard_findings(name, arena)
    want = case.plain(rk.plain_tensors(case, device))
    if "K002" in selected:
        findings += rk.input_findings(name, case, arena)
        if case.written is None:
            findings += rk.dense_findings(name, got, want)
        else:
            findings += rk.scatter_findings(name, case, device)
    if "K005" in selected:
        findings += rk.check_k005(name, got, want)
    row = None
    if "K003" in selected and device.type == "cuda":
        row = rk.footprint(spec, case, arena.tensors)
        findings += rk.check_footprint(name, row)
    return findings, row


def run_kernelcheck(kernels: Dict[str, KernelSpec],
                    rules: Optional[Sequence[str]] = None, device=None,
                    require_launches: Optional[bool] = None,
                    partial: bool = False):
    """Check every case on ``device`` (default: the card). Returns
    ``(findings, footprints, n_suppressed)``; footprints (K003's table)
    are measured only on the card, and the CALLER gates them against the
    baseline (``rules_kernel.compare_footprints``), so
    ``--update-baseline`` shares one run. ``require_launches`` (default:
    on the card) turns on K000's launch-count leg."""
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.analysis import rules_kernel as rk

    dev = _device.resolve(device)
    if require_launches is None:
        require_launches = dev.type == "cuda"
    selected = set(rules) if rules else set(RUN_RULES)
    findings: List[KernelFinding] = []
    footprints: Dict[str, dict] = {}
    if "K000" in selected and not partial:
        findings += rk.check_registry(kernels)
    for name in sorted(kernels):
        try:
            got, row = check_case(name, kernels[name], dev, selected,
                                  require_launches)
        except Exception as exc:  # a broken case fails loudly, and the
            # other cases still run
            findings.append(KernelFinding(
                "K000", name, f"the case failed to build or run: "
                f"{type(exc).__name__}: {exc}"))
            continue
        findings += got
        if row is not None:
            footprints[name] = row
    findings, n_suppressed = apply_suppressions(findings)
    return findings, footprints, n_suppressed

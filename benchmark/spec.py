"""A cell of the benchmark: its configuration and traffic files, found by
name, checked, and the sizes the run derives from them.

A cell ``<config>.<mix>`` reads ``configs/<config>.json`` (one deployment:
its rank grid, how the grid lies on the cards, the slots a vrank, the fill,
the deposit if any, the suffix of its metrics' names) and
``traffic/<mix>.json`` (the migration a step and the steps a call).

A configuration may also give its rows a clustered distribution whose
particles turn around with periods and phases of their own (``rows``),
and own its space by a cell grid assigned to the slabs by load
(``cells``); the two go together. Without them a cell runs as uniform
rows on the canonical grid.

A configuration's ``entry`` names the program entry a cell times: absent,
the drift loop; ``"redistribute"``, the public one-shot
``GridRedistribute.redistribute()`` call on snapshots of rows that its
traffic file describes (``snapshots``, ``edit_rows``, ``vel_scale``):
one call a step.

:func:`drift_sizing` and :func:`lpt_assignment` are frozen copies of the
program's ``bench/common.drift_sizing`` and
``parallel/migrate.balanced_assignment``, and :func:`lognormal_sizing` of
the sizing in ``bench/config2_clustered``, so a change to the program
cannot move the yardstick.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
DIRS = {"config": "configs", "traffic": "traffic"}
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def check_name(name: str, what: str = "name") -> str:
    """``name`` if the manifest allows it: a letter, digit or ``_`` first,
    then at most 63 more letters, digits, ``_``, ``.`` and ``-``."""
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise ValueError(f"{what} {name!r}: a name is 1 to 64 of A-Z a-z "
                         f"0-9 _ . - and starts with a letter, digit or _")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.fullmatch(unit):
        raise ValueError(f"unit {unit!r}: 1 to 16 of A-Z a-z 0-9 _ / % . -")
    return unit


def _load(kind: str, name: str) -> dict:
    check_name(name, kind)
    if "." in name:
        raise ValueError(f"{kind} {name!r}: a {kind} name has no '.'")
    path = ROOT / DIRS[kind] / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r} ({path} is missing)")
    data = json.loads(path.read_text())
    if data.get("name") != name:
        raise ValueError(f"{path}: 'name' is {data.get('name')!r}, "
                         f"not {name!r}")
    return data


def drift_sizing(grid_shape, n_local: int, fill: float, migration: float,
                 headroom: float = 1.3):
    """Per-axis velocity scale for ~``migration`` of the rows to cross a
    subdomain face a step (dt = 1), the per-pair exchange ``capacity`` and
    the compact-routing ``local_budget``. Face neighbours an axis: extent
    1 -> 0, 2 -> 1 (both periodic wraps reach the same one), else 2;
    undecomposed axes take the mean decomposed scale."""
    g = np.asarray(grid_shape, np.int64)
    dec = g > 1
    n_dec = max(int(dec.sum()), 1)
    distinct = int(np.where(g == 1, 0, np.where(g == 2, 1, 2)).sum())
    distinct = max(distinct, 1)
    v = np.where(dec, migration / n_dec * 2.0 / g, 0.0)
    v = np.where(dec, v, v[dec].mean() if dec.any() else migration)
    cap = max(64, math.ceil(fill * n_local * migration / distinct * headroom))
    budget = max(256, math.ceil(fill * n_local * migration * headroom))
    return v.astype(np.float32), cap, budget


def lognormal_sizing(cells, migration: float):
    """Per-axis velocity scale of the clustered rows: ``migration / 3 *
    2 / g`` on an axis of ``g`` cells, so that about ``migration`` of the
    rows cross a cell face a step."""
    g = np.asarray(cells, np.float32)
    return (migration / 3.0 * 2.0 / g).astype(np.float32)


def hot_slab_sizing(hot: int, migration: float):
    """``(capacity, budget)`` of the exchange from the rows of the hottest
    slab at the draw, as ``bench/config2_clustered`` sizes them."""
    c = math.ceil(hot * migration * 2.0)
    return max(64, c), max(256, c)


def lpt_assignment(cell_loads, n_ranks: int) -> tuple:
    """Static cell -> slab map by LPT, "longest processing time first":
    cells heaviest first (a stable order, so ties keep cell order), each to
    the first least-loaded slab. ``cell_loads`` is the row-major cell
    histogram; returns a tuple of int."""
    loads = np.asarray(cell_loads, dtype=np.int64)
    if loads.ndim != 1 or loads.size < n_ranks:
        raise ValueError(f"need >= {n_ranks} cells, got shape {loads.shape}")
    order = np.argsort(-loads, kind="stable")
    bins = np.zeros((n_ranks,), np.int64)
    assign = np.zeros(loads.shape, np.int32)
    for c in order:
        r = int(np.argmin(bins))
        assign[c] = r
        bins[r] += loads[c]
    return tuple(int(x) for x in assign)


def _strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell: the deployment, its traffic and what follows from them.

    The rank grid ``grid`` lies on ``dev_grid`` cards, each holding a
    ``vgrid`` block of it as vranks; slab ``s = card * V + v`` (row-major
    card rank, then row-major vrank) is grid cell ``card_cell * vgrid +
    vrank_cell`` on every axis.

    Under an assignment (``cells`` set) the slabs own instead the cells of
    the ``cells`` grid that ``assignment`` gives them, by LPT of the seed's
    cell histogram. The draw (``state.draw``) measures the histogram,
    fills ``assignment``, sizes ``capacity`` and ``budget`` from the
    hottest slab, and returns the cell so completed."""

    name: str
    config: dict
    traffic: dict
    grid: Tuple[int, ...]
    dev_grid: Tuple[int, ...]
    vgrid: Tuple[int, ...]
    n_local: int
    fill: float
    dt: float
    steps_per_call: int
    vel_scale: Tuple[float, ...]
    capacity: Optional[int]
    budget: Optional[int]
    deposit_shape: Optional[Tuple[int, ...]]
    deposit_method: Optional[str]
    rows: Optional[dict] = None
    cells: Optional[Tuple[int, ...]] = None
    assignment: Optional[Tuple[int, ...]] = None

    @property
    def chips(self) -> int:
        return math.prod(self.dev_grid)

    @property
    def V(self) -> int:
        return math.prod(self.vgrid)

    @property
    def n_slabs(self) -> int:
        return math.prod(self.grid)

    @property
    def live_per_slab(self) -> int:
        return int(self.fill * self.n_local)

    @property
    def live_total(self) -> int:
        if self.rows is not None:
            return int(self.rows["particles"])
        return self.live_per_slab * self.n_slabs

    @property
    def turn_calls(self) -> Optional[int]:
        """The least number of calls between two turns of a clustered
        particle (``rows``' ``turn_calls``; ``reference.turn_schedule``), or
        ``None``: uniform rows never turn."""
        return None if self.rows is None else int(self.rows["turn_calls"])

    @property
    def entry(self) -> str:
        """The program entry the cell times: ``"loop"`` (the drift loop,
        a configuration without ``entry``) or ``"redistribute"``."""
        return self.config.get("entry", "loop")

    @property
    def metric_suffix(self) -> str:
        """The configuration's ``metric_suffix`` (``""`` if it has none):
        appended to the name of every metric the cell reports but
        ``peak_mem_gib`` and ``setup_s``, so that the deployments whose
        runs spread differently are held to bounds of their own."""
        return self.config.get("metric_suffix") or ""

    def slab_cells(self) -> np.ndarray:
        """``[n_slabs, D]`` grid cell of every slab."""
        D = len(self.grid)
        out = np.zeros((self.n_slabs, D), np.int64)
        dstr, vstr = _strides(self.dev_grid), _strides(self.vgrid)
        for s in range(self.n_slabs):
            card, v = divmod(s, self.V)
            for a in range(D):
                dc = (card // dstr[a]) % self.dev_grid[a]
                vc = (v // vstr[a]) % self.vgrid[a]
                out[s, a] = dc * self.vgrid[a] + vc
        return out

    def slab_of_cell_table(self) -> np.ndarray:
        """``[prod(grid)]`` slab of each row-major grid cell; under an
        assignment ``[prod(cells)]``, the assignment itself."""
        if self.cells is not None:
            if self.assignment is None:
                raise ValueError(f"{self.name}: the assignment is made at "
                                 f"the draw (state.draw)")
            return np.asarray(self.assignment, np.int64)
        cells = self.slab_cells()
        flat = (cells * np.asarray(_strides(self.grid))).sum(axis=1)
        table = np.empty(self.n_slabs, np.int64)
        table[flat] = np.arange(self.n_slabs)
        return table


def load_cell(workload: str) -> Cell:
    """The cell ``<config>.<mix>``, its files read and checked."""
    check_name(workload, "workload")
    if workload.count(".") != 1:
        raise ValueError(f"workload {workload!r} is not <config>.<mix>")
    cname, tname = workload.split(".")
    return make_cell(workload, _load("config", cname), _load("traffic", tname))


def make_cell(name: str, config: dict, traffic: dict) -> Cell:
    if "entry" in config:
        return _oneshot_cell(name, config, traffic)
    grid = tuple(int(g) for g in config["grid"])
    dev_grid = tuple(int(g) for g in config["dev_grid"])
    vgrid = tuple(int(g) for g in config["vgrid"])
    if len(grid) != 3 or len(dev_grid) != 3 or len(vgrid) != 3:
        raise ValueError(f"{name}: grid, dev_grid and vgrid have 3 axes")
    if tuple(d * v for d, v in zip(dev_grid, vgrid)) != grid:
        raise ValueError(f"{name}: dev_grid * vgrid != grid")
    if int(config["chips"]) != math.prod(dev_grid):
        raise ValueError(f"{name}: chips != prod(dev_grid)")
    dom = config["domain"]
    if (dom["lo"], dom["hi"], dom["periodic"]) != (0.0, 1.0, True):
        raise ValueError(f"{name}: the drift loop runs in the periodic "
                         f"unit box")
    n_local = int(config["slots_per_vrank"])
    migration = float(traffic["migration"])
    dep = config.get("deposit")
    if dep is not None and math.prod(dev_grid) != 1:
        raise ValueError(f"{name}: the density is judged on one card only")
    rows, cells = config.get("rows"), config.get("cells")
    if (rows is None) != (cells is None):
        raise ValueError(f"{name}: rows and cells go together")
    if rows is None:
        fill = float(config["fill"])
        vel, cap, budget = drift_sizing(grid, n_local, fill, migration,
                                        float(config["headroom"]))
    else:
        cells = tuple(int(c) for c in cells)
        if len(cells) != 3 or int(rows["turn_calls"]) < 1:
            raise ValueError(f"{name}: cells have 3 axes, and turn_calls "
                             f"is 1 or more")
        if (math.prod(cells) < math.prod(grid) or dep is not None
                or math.prod(dev_grid) != 1):
            raise ValueError(f"{name}: an assignment needs a cell a slab at "
                             f"least, one card and no deposit")
        fill = int(rows["particles"]) / (n_local * math.prod(grid))
        vel = lognormal_sizing(cells, migration)
        cap = budget = None  # from the hottest slab, at the draw
    return Cell(
        name=name, config=config, traffic=traffic, grid=grid,
        dev_grid=dev_grid, vgrid=vgrid, n_local=n_local, fill=fill,
        dt=float(config["dt"]), steps_per_call=int(traffic["steps_per_call"]),
        vel_scale=tuple(float(v) for v in vel), capacity=cap, budget=budget,
        deposit_shape=None if dep is None else tuple(dep["shape"]),
        deposit_method=None if dep is None else dep["method"],
        rows=rows, cells=cells,
    )


ENTRIES = ("redistribute",)


def _oneshot_cell(name: str, config: dict, traffic: dict) -> Cell:
    """A cell of the one-shot call: every rank's ``slots_per_vrank`` slots
    on one card, the first ``fill`` of them live in every snapshot."""
    if config["entry"] not in ENTRIES:
        raise ValueError(f"{name}: entry {config['entry']!r} is not one of "
                         f"{ENTRIES}")
    grid = tuple(int(g) for g in config["grid"])
    dev_grid = tuple(int(g) for g in config["dev_grid"])
    vgrid = tuple(int(g) for g in config["vgrid"])
    if grid != vgrid or dev_grid != (1, 1, 1) or int(config["chips"]) != 1:
        raise ValueError(f"{name}: the one-shot call holds every rank as a "
                         f"vrank of one card (vgrid = grid, dev_grid 1x1x1)")
    dom = config["domain"]
    if (dom["lo"], dom["hi"], dom["periodic"]) != (0.0, 1.0, True):
        raise ValueError(f"{name}: the one-shot call runs in the periodic "
                         f"unit box")
    if any(config.get(k) is not None for k in ("deposit", "rows", "cells")):
        raise ValueError(f"{name}: the one-shot call takes no deposit, rows "
                         f"or cells")
    n, fill = int(config["slots_per_vrank"]), float(config["fill"])
    snaps, edit = int(traffic["snapshots"]), int(traffic["edit_rows"])
    if snaps < 1 or not 1 <= edit <= int(fill * n):
        raise ValueError(f"{name}: snapshots is 1 or more, edit_rows from 1 "
                         f"to the live rows a rank")
    return Cell(
        name=name, config=config, traffic=traffic, grid=grid,
        dev_grid=dev_grid, vgrid=vgrid, n_local=n, fill=fill, dt=0.0,
        steps_per_call=1,
        vel_scale=(float(traffic["vel_scale"]),) * 3, capacity=None,
        budget=None, deposit_shape=None, deposit_method=None,
    )

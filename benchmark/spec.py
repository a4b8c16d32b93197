"""A cell of the benchmark: its configuration and traffic files, found by
name, checked, and the sizes the run derives from them.

A cell ``<config>.<mix>`` reads ``configs/<config>.json`` (one deployment:
its rank grid, how the grid lies on the cards, the slots a vrank, the fill,
the deposit if any, the suffix of its metrics' names) and
``traffic/<mix>.json`` (the migration a step and the steps a call). :func:`drift_sizing` is a frozen copy of the program's
``bench/common.drift_sizing``, so a change to the program cannot move the
yardstick.
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
    vrank_cell`` on every axis."""

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
    capacity: int
    budget: int
    deposit_shape: Optional[Tuple[int, ...]]
    deposit_method: Optional[str]

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
        return self.live_per_slab * self.n_slabs

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
        """``[prod(grid)]`` slab of each row-major grid cell."""
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
    fill = float(config["fill"])
    migration = float(traffic["migration"])
    vel, cap, budget = drift_sizing(grid, n_local, fill, migration,
                                    float(config["headroom"]))
    dep = config.get("deposit")
    if dep is not None and math.prod(dev_grid) != 1:
        raise ValueError(f"{name}: the density is judged on one card only")
    return Cell(
        name=name, config=config, traffic=traffic, grid=grid,
        dev_grid=dev_grid, vgrid=vgrid, n_local=n_local, fill=fill,
        dt=float(config["dt"]), steps_per_call=int(traffic["steps_per_call"]),
        vel_scale=tuple(float(v) for v in vel), capacity=cap, budget=budget,
        deposit_shape=None if dep is None else tuple(dep["shape"]),
        deposit_method=None if dep is None else dep["method"],
    )

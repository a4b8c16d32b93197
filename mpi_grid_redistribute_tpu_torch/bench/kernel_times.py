"""Card times of kernel 2 (landing column scatter) and kernel 4
(segmented CIC deposit) beside their library yardsticks:

    python -m mpi_grid_redistribute_tpu_torch.bench.kernel_times

``chip_smoke.py`` calls :func:`overlay_inputs`, :func:`time_overlay`,
:func:`config5_slab_stream` and :func:`time_segdep` with its own bench
sizing. Run alone, the script takes the sizing of config 5
(``bench/config5_deposit.build``: 8 vranks of 2^20 rows, its
``local_budget`` of updates a vrank) and also times kernel 4's probes
(:func:`segdep_probes`).

Kernel 2 runs on the bench state's ``[7, V * n_local]`` int32 shape with
``V * local_budget`` unique targets in random order (10% dropped),
beside ``index_put_`` of the in-range updates. Kernel 4 runs on the
config-5 slab stream (8 * 2^20 rows, unit mass, 8 * 64^3 cells) beside
``index_add_`` of precomputed corner channels (the summing part only).
Every time is the mean of 20 calls, min of 3, once as a replayed CUDA
graph (the device's time) and once as eager launches (the host's launch
cost included).

Run alone it uses only the kernels' public wrappers, so it also runs
from a checkout of an earlier commit (copied into its ``bench/``), which
is how a redesign is timed against its parent in one call. Prints one
JSON line ``{"kernel_times": ...}``; needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch


def overlay_inputs(V: int, n_local: int, budget: int, seed: int = 3):
    """``(flat0 [7, V * n_local], cols [7, P], targets [P])`` at the
    loop's landing shape, ``P = V * budget`` unique targets in random
    order, 10% of them dropped (``m``) and 16 negative."""
    K, m = 7, V * n_local
    P = V * budget
    g = torch.Generator(device="cuda").manual_seed(seed)
    flat0 = torch.randint(-(2**31), 2**31 - 1, (K, m), dtype=torch.int32,
                          device="cuda", generator=g)
    targets = torch.randperm(m, device="cuda", generator=g)[:P].to(
        torch.int32
    )
    drop = torch.rand(P, device="cuda", generator=g) < 0.1
    targets = torch.where(drop, torch.full_like(targets, m), targets)
    targets[:16] = -1
    cols = torch.randint(-(2**31), 2**31 - 1, (K, P), dtype=torch.int32,
                         device="cuda", generator=g)
    return flat0, cols, targets


def _both(profiling, fn):
    return {"graph": profiling.cuda_graph_time_ms(fn),
            "eager": profiling.cuda_time_ms(fn)}


def time_overlay(overlay, profiling, flat0, cols, targets):
    """``{"kernel": {"graph": ms, "eager": ms}, "index_put_": ...}``."""
    work = flat0.clone()
    K, m = work.shape
    rows = torch.arange(K, device="cuda")[:, None]
    ok = (targets >= 0) & (targets < m)
    t_ok = targets[ok].long()[None, :]
    c_ok = cols[:, ok].contiguous()
    return {
        "kernel": _both(profiling, lambda: overlay.overlay_scatter_planar(
            work, targets, cols)),
        "index_put_": _both(profiling, lambda: work.index_put_(
            (rows, t_ok), c_ok)),
    }


def config5_slab_stream(deposit, cfg, vgrid, pos_p, alive):
    """The slab stream kernel 4 sees in the config-5 step: the keys and
    rel rows of the start state (rows on their own slabs), sorted slab by
    slab as ``_slab_deposit_from_keys`` sorts them. Returns ``(keys,
    rel, n_cells, vblock)``."""
    D = 3
    V = vgrid.nranks
    vblock = tuple(m // v for m, v in zip(cfg.deposit_shape, vgrid.shape))
    vcells = np.asarray([vgrid.cell_of_rank(v) for v in range(V)],
                        np.float32)
    lo_all = torch.from_numpy(
        (vcells / np.asarray(vgrid.shape, np.float32)).astype(np.float32)
    ).cuda()
    inv_h = torch.full((D,), float(cfg.deposit_shape[0]), device="cuda")
    key, rel, _, in_block = deposit._slab_keys_mxu(
        pos_p.reshape(D, -1), None, alive, lo_all, inv_h, vblock
    )
    if not bool(in_block):
        raise RuntimeError("config-5 start state is not slab-resident")
    keys_s, order = torch.sort(key, dim=1, stable=True)
    n = key.shape[1]
    col = (order + torch.arange(V, device="cuda")[:, None] * n).reshape(-1)
    rel_s = torch.index_select(torch.stack(rel).reshape(D, -1), 1, col)
    n_cells = V * int(np.prod(vblock))
    return keys_s.reshape(-1), rel_s.contiguous(), n_cells, vblock


def time_segdep(segdep, profiling, stream):
    """Kernel 4 and ``index_add_`` of precomputed channels, graph and
    eager."""
    keys, rel, n_cells, vblock = stream
    wch = segdep._corner_weights([rel[d] for d in range(rel.shape[0])],
                                 None, vblock)
    seg = keys.clamp(0, n_cells).long()
    acc = torch.zeros((wch.shape[0], n_cells + 1), device="cuda")
    return {
        "kernel": _both(profiling, lambda: segdep.segsum_sorted(
            keys, rel, None, n_cells, vblock)),
        "index_add_": _both(profiling,
                            lambda: acc.index_add_(1, seg, wch)),
    }


def segdep_probes(segdep, profiling, stream):
    """What bounds kernel 4: its canvas memset alone, reading the stream
    alone, the kernel with no valid row (loads, no run writes) and at
    D = 1 (a third of the rel bytes, a quarter of the channel writes)."""
    keys, rel, n_cells, vblock = stream
    out = torch.empty((1 << rel.shape[0], n_cells), device="cuda")
    sentinel = torch.full_like(keys, n_cells)
    return {
        "memset": _both(profiling, out.zero_),
        "read": _both(profiling, lambda: (keys.max(), rel.amax())),
        "all_sentinel": _both(profiling, lambda: segdep.segsum_sorted(
            sentinel, rel, None, n_cells, vblock)),
        "d1": _both(profiling, lambda: segdep.segsum_sorted(
            keys, rel[:1], None, n_cells, vblock[:1])),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    from mpi_grid_redistribute_tpu_torch.bench import config5_deposit
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import (
        _build, deposit, overlay, segdep,
    )
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    cfg, vgrid, (pos, _, alive) = config5_deposit.build(method="mxu")
    flat0, cols, targets = overlay_inputs(vgrid.nranks, cfg.n_local,
                                          cfg.local_budget)
    k2 = time_overlay(overlay, profiling, flat0, cols, targets)
    del flat0, cols, targets
    pos_p = torch.from_numpy(nbody.rows_to_planar(pos, 1)).cuda()
    stream = config5_slab_stream(deposit, cfg, vgrid, pos_p,
                                 torch.from_numpy(alive).cuda())
    k4 = time_segdep(segdep, profiling, stream)
    k4["probes"] = segdep_probes(segdep, profiling, stream)
    print(json.dumps({"kernel_times": {
        "card": smi, "overlay_scatter_planar": k2, "segsum_sorted": k4,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

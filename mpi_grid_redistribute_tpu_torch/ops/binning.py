"""Periodic wrap, position -> cell -> destination binning, and the
destination sort (port of the JAX package's ``ops/binning.py``).

Every float expression keeps the reference's op order on float32
constants computed the same way (numpy float32 arithmetic), because one
ulp is enough to re-home a particle. Two conventions are pinned here and
in the CUDA drift-bin kernel:

  * float -> int32 conversion SATURATES like XLA's: NaN -> 0, +inf and
    values >= 2^31 -> INT_MAX, -inf and values < -2^31 -> INT_MIN
    (:func:`floor_to_int32`). ``Tensor.to(torch.int32)`` alone gives
    INT_MIN for all of these, which after the cell clip would put a huge
    coordinate on an open axis into cell 0 instead of the last cell;
  * multiplications and additions are never fused (no FMA), matching
    the TPU. A jitted JAX function on the CPU does contract ``p + v*dt``,
    so CPU bit comparisons with the drift use a ``dt`` whose product is
    exact (a power of two, or 1.0 as the bench uses).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid


def _is_pow2(x: float) -> bool:
    """True for positive powers of two (reciprocal exactly representable)."""
    if x <= 0 or not math.isfinite(x):
        return False
    mant, _ = math.frexp(x)
    return mant == 0.5


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """0-d float32 constant on ``like``'s device (a Python float operand
    would be a weakly typed scalar; a tensor pins float32 arithmetic)."""
    return torch.tensor(np.float32(x), dtype=torch.float32, device=like.device)


def floor_to_int32(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` as int32 with XLA's saturating conversion: NaN -> 0,
    values beyond the int32 range (and +-inf) clamp to its ends. The
    clamp bound 2^31 - 128 is the largest float32 below 2^31; anything
    the callers clip afterwards to a cell range sees the same cell."""
    f = torch.floor(x)
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return f.clamp(-2147483648.0, 2147483520.0).to(torch.int32)


def _remainder(q: torch.Tensor, ext) -> torch.Tensor:
    """``jnp.remainder`` semantics: C ``fmod`` plus the sign fix (the
    result takes the divisor's sign). ``torch.remainder`` computes
    ``a - b * floor(a / b)`` instead, which differs in the last bits."""
    e = _f32(ext, q)
    r = torch.fmod(q, e)
    fix = (r != 0) & ((r < 0) != (e < 0))
    return torch.where(fix, r + e, r)


def remainder_fast(q: torch.Tensor, ext: float) -> torch.Tensor:
    """``remainder(q, ext)`` with the reciprocal-multiply path for
    power-of-two extents (exact there: ``1/ext``, the scale and the
    subtraction are all exact), folded into ``[0, ext)`` on every input
    exactly as the reference does; other extents take
    :func:`_remainder`."""
    if _is_pow2(float(ext)):
        inv = _f32(1.0 / ext, q)
        e = _f32(ext, q)
        r = q - torch.floor(q * inv) * e
        return torch.where((r < 0) | (r >= e), torch.zeros_like(r), r)
    return _remainder(q, ext)


def axis_consts(domain: Domain, grid_shape, d: int):
    """Per-axis float32 constants ``(lo, ext, hi, inv_ext, inv_w)``,
    computed with numpy float32 arithmetic so the bits match the
    reference's constant folding (``hi = lo + ext`` and ``inv_w = g / ext``
    are float32 operations; ``inv_ext`` is 0 for non-power-of-two
    extents, which take the fmod path)."""
    lo = np.float32(domain.lo[d])
    ext = np.float32(domain.extent[d])
    hi = np.float32(lo + ext)
    inv_ext = (
        np.float32(np.float32(1.0) / ext)
        if _is_pow2(float(domain.extent[d]))
        else np.float32(0)
    )
    inv_w = np.float32(np.float32(grid_shape[d]) / ext)
    return lo, ext, hi, inv_ext, inv_w


def _wrap_axis(p: torch.Tensor, domain: Domain, d: int) -> torch.Tensor:
    lo = _f32(domain.lo[d], p)
    w = remainder_fast(p - lo, domain.extent[d])
    if domain.lo[d] != 0.0:
        # XLA folds `0 + r` to `r`, which keeps an fmod result of -0.0
        # negative; the add (skipped at lo == 0) would make it +0.0
        w = lo + w
    hi = _f32(np.float32(domain.lo[d]) + np.float32(domain.extent[d]), p)
    return torch.where(w >= hi, lo, w)


def wrap_periodic_planar(pos: torch.Tensor, domain: Domain) -> torch.Tensor:
    """Wrap ``[..., D, n]`` float32 positions into ``[lo, hi)`` along the
    periodic axes; open axes pass through unchanged."""
    out = []
    for d in range(pos.shape[-2]):
        p = pos[..., d, :]
        out.append(_wrap_axis(p, domain, d) if domain.periodic[d] else p)
    return torch.stack(out, dim=-2)


def dest_key_planar(pos: torch.Tensor, alive: torch.Tensor, domain: Domain,
                    full_grid: ProcessGrid, V: int,
                    R_total: int) -> torch.Tensor:
    """The single-device vrank engine's binning: ``[D, V*n]`` float32
    positions (already drift-wrapped) and ``[V*n]`` alive flags ->
    ``[V, n]`` int32 destination key. Periodic axes are wrapped once
    more (an identity for ``lo == 0``, replicated for bit equality),
    binned by floor-multiply + clip + stride; stayers and holes get the
    sentinel ``R_total``."""
    m = pos.shape[-1]
    n = m // V
    dv = torch.zeros((m,), dtype=torch.int32, device=pos.device)
    for d in range(domain.ndim):
        pd = pos[d]
        if domain.periodic[d]:
            pd = _wrap_axis(pd, domain, d)
        lo, _, _, _, inv_w = axis_consts(domain, full_grid.shape, d)
        cell = floor_to_int32((pd - _f32(lo, pd)) * _f32(inv_w, pd))
        cell = cell.clamp(0, full_grid.shape[d] - 1)
        dv = dv + cell * full_grid.strides[d]
    dv = dv.reshape(V, n)
    me = torch.arange(V, dtype=torch.int32, device=pos.device)[:, None]
    stay = dv == me
    return torch.where(
        alive.reshape(V, n) & ~stay, dv, torch.full_like(dv, R_total)
    )


def sorted_dest_counts_batched(dest: torch.Tensor, n_dest: int):
    """Stable sort of each ``[V, n]`` key row by destination, with the
    per-destination counts read off the sorted keys by binary search.

    Returns ``(order [V, n], counts [V, n_dest], bounds [V, n_dest + 1])``
    as int32; ``bounds`` are the segment starts in sorted space and the
    sentinel ``n_dest`` (stayers, holes) sorts to the tail uncounted.

    The reference's two-level leaver selection (chunk sorts plus one
    small candidate sort) is left out: only the leaver prefix of
    ``order`` (its first ``counts[v].sum()`` entries), the counts and
    the bounds are contractual there, and this flat packed sort
    reproduces all three bit for bit. Its tail is the sentinel-sorted
    stayers, which no consumer reads.
    """
    V, n = dest.shape
    dev = dest.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    b = max(1, (n - 1).bit_length())
    if n_dest + 1 <= (1 << (31 - b)):
        # packed single-operand sort: (dest << b) | iota is unique, so an
        # unstable one-word sort equals the stable (key, iota) sort
        packed = torch.sort((dest << b) | iota, dim=-1).values
        order = packed & ((1 << b) - 1)
        edges = torch.arange(n_dest + 1, dtype=torch.int32, device=dev) << b
    else:
        packed, idx = torch.sort(dest, dim=-1, stable=True)
        order = idx.to(torch.int32)
        edges = torch.arange(n_dest + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(
        packed, edges.expand(V, -1).contiguous(), side="left"
    ).to(torch.int32)
    return order, bounds[:, 1:] - bounds[:, :-1], bounds


def bounds_dense(keys_sorted: torch.Tensor, n_edges: int,
                 stride: int = 1) -> torch.Tensor:
    """``searchsorted(keys_sorted, arange(n_edges) * stride, 'left')`` as
    int32: for each edge, the number of keys below it. Keys past the last
    edge (sentinels) fall in no bound. The reference builds this from two
    sorts because the TPU's searchsorted scatters; one
    ``torch.searchsorted`` gives the same integers."""
    if (n_edges - 1) * stride >= 2**31:
        raise ValueError(
            f"bounds_dense: edge grid (n_edges={n_edges}, stride={stride}) "
            f"exceeds int32"
        )
    edges = torch.arange(
        n_edges, dtype=torch.int32, device=keys_sorted.device
    ) * stride
    return torch.searchsorted(keys_sorted, edges, side="left").to(torch.int32)


def sorted_dest_counts(dest: torch.Tensor, n_dest: int):
    """One-row :func:`sorted_dest_counts_batched`: ``[N]`` keys ->
    ``(order [N], counts [n_dest], bounds [n_dest + 1])``."""
    order, counts, bounds = sorted_dest_counts_batched(dest[None], n_dest)
    return order[0], counts[0], bounds[0]

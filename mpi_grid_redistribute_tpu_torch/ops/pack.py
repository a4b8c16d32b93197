"""Planar column gathers (port of the JAX package's ``ops/pack.py``)."""

from __future__ import annotations

import torch


def gather_plan_cols(fused: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather plan-addressed columns of a planar ``[K, W]`` matrix in one
    flat gather: ``idx [...]`` (flat column indices into ``W``, already
    clipped in range) -> ``[K, *idx.shape]``. Callers mask invalid slots
    themselves."""
    flat = torch.index_select(fused, 1, idx.reshape(-1))
    return flat.reshape((fused.shape[0],) + tuple(idx.shape))

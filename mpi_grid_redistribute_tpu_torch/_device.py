"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the GPU: raise when there is none instead of
    quietly running on the CPU. Any explicit device is taken as given
    (the tests pass ``"cpu"``, where kernels run as their plain
    versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

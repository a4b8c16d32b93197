"""Device resolution shared by the port's entry points, and small
constant tables kept on a device."""

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


class OnDevice:
    """Small constant arrays, copied to a device once and reused (a copy
    per call would be a host-to-device transfer per step)."""

    def __init__(self, *arrays):
        self._arrays = arrays
        self._cache = {}

    def get(self, device):
        if device not in self._cache:
            self._cache[device] = tuple(
                torch.from_numpy(a).to(device) for a in self._arrays
            )
        return self._cache[device]

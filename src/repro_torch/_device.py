"""Device resolution shared by every entry point of the port.

Every public function takes ``device=None``, which means the CUDA card.
A host without CUDA raises :class:`CudaUnavailableError` unless the
caller asked for the CPU by name (``device="cpu"``), so a run never
drifts onto the CPU unnoticed.
"""
from __future__ import annotations

import torch


class CudaUnavailableError(RuntimeError):
    """The entry point was asked for the CUDA card (explicitly, or by the
    ``device=None`` default) on a host where ``torch.cuda.is_available()``
    is false.  Pass ``device="cpu"`` to run the plain PyTorch versions."""


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device on a host without CUDA raises
    :class:`CudaUnavailableError`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            f"device {str(dev)!r} requested (device=None means 'cuda') but "
            f"torch.cuda.is_available() is False on this host; pass "
            f"device='cpu' to run the plain PyTorch versions")
    return dev

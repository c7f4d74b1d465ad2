"""Plain PyTorch oracles shared by the kernels' plain versions."""
from __future__ import annotations

import torch


def select_slot_ref(loads, w, k, capacity, *, strategy: str = "best"):
    """Fit-strategy selection over rows: loads f32[N, M]; w, k, capacity
    [N].  Returns i32[N]: the chosen slot (ties to the lowest), or ``M``
    when nothing fits."""
    n, m = loads.shape
    idx = torch.arange(m, device=loads.device)
    fits = (idx[None, :] < k[:, None]) & (loads + w[:, None]
                                          <= capacity[:, None])
    inf = float("inf")      # a Python scalar: no host-to-device copy
    if strategy == "first":
        best = torch.where(fits, idx[None, :].float(), inf).argmin(1)
    elif strategy == "best":
        # max load among fitting slots, lowest slot on a tie
        score = torch.where(fits, loads, -inf)
        best = torch.where(score == score.amax(1, keepdim=True), idx,
                           m).amin(1)
    elif strategy == "worst":
        score = torch.where(fits, loads, inf)
        best = torch.where(score == score.amin(1, keepdim=True), idx,
                           m).amin(1)
    else:
        raise ValueError(strategy)
    return torch.where(fits.any(1), best, m).to(torch.int32)

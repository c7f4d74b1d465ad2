"""Fit-strategy slot selection: a CUDA kernel and its plain version.

Given slot loads and an item, pick the first, best (tightest) or worst
(most slack) slot it fits in; ties break to the lowest slot, an item fits
iff ``slot < k`` and ``load + w <= capacity``, ``M`` means nothing fits
and ``NEG`` marks an inactive instance.  The packers of
``repro_torch.core.pack`` call it for every first/best/worst insert.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import select_slot_ref

NEG = -1
STRATEGY_CODE = {"first": 1, "best": 2, "worst": 3}


def select_slot_plain(loads, w, k, capacity, *, strategy: str,
                      active: Optional[torch.Tensor] = None):
    """Plain version over a batch of streams: loads f32[B, N, M]; w, k,
    capacity, active [B, N].  Returns i32[B, N]."""
    b, n, m = loads.shape
    slot = select_slot_ref(loads.reshape(b * n, m), w.reshape(-1),
                           k.reshape(-1), capacity.reshape(-1),
                           strategy=strategy).reshape(b, n)
    if active is not None:
        slot = torch.where(active.bool(), slot, torch.full_like(slot, NEG))
    return slot


@_build.counted
def select_slot_grid(loads, w, k, capacity, *, strategy: str = "best",
                     active: Optional[torch.Tensor] = None):
    """Batched fit selection: loads f32[B, N, M]; w, capacity f32[B, N];
    k i32[B, N] (bins created); active optional int/bool[B, N].  Returns
    i32[B, N]: the chosen slot, ``M`` if nothing fits, ``NEG`` if inactive.

    Replaces the Pallas kernel ``src/repro/kernels/binpack_select.py``
    (``select_slot_grid`` over ``_select_tile_kernel``;
    ``select_slot_batch`` is its singleton batch).  On the H100 it is
    bound by bytes: the ``[B, N, M]`` loads plane is read once.  The
    simple design is one thread per (stream, instance) row looping over
    its M slots.

    CPU tensors run ``select_slot_plain``; CUDA tensors launch the kernel
    (``csrc/binpack_select.cu``) or raise.
    """
    if strategy not in STRATEGY_CODE:
        raise ValueError(f"strategy must be one of {tuple(STRATEGY_CODE)}, "
                         f"got {strategy!r}")
    b, n, m = loads.shape
    if loads.device.type == "cpu":
        return select_slot_plain(loads, w, k, capacity, strategy=strategy,
                                 active=active)
    dev = loads.device
    args = [loads.to(torch.float32).contiguous()]
    for name, x, dt in (("w", w, torch.float32), ("k", k, torch.int32),
                        ("capacity", capacity, torch.float32)):
        x = x.to(device=dev, dtype=dt).contiguous()
        if x.shape != (b, n):
            raise ValueError(f"{name} must have shape [{b}, {n}]; got "
                             f"{tuple(x.shape)}")
        args.append(x)
    act = None
    if active is not None:
        act = active.to(device=dev, dtype=torch.int32).contiguous()
        if act.shape != (b, n):
            raise ValueError(f"active must have shape [{b}, {n}]; got "
                             f"{tuple(act.shape)}")
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    _build.launch("select_slot_f32", *(x.data_ptr() for x in args),
                  None if act is None else act.data_ptr(), out.data_ptr(),
                  b, n, m, STRATEGY_CODE[strategy], _build.stream_ptr(dev))
    select_slot_grid.launches += 1
    return out


def select_slot_batch(loads, w, k, capacity, *, strategy: str = "best",
                      active: Optional[torch.Tensor] = None):
    """Single stream: loads f32[N, M]; w, k, capacity, active [N].  The
    same kernel at batch 1."""
    return select_slot_grid(
        loads[None], w[None], k[None], capacity[None], strategy=strategy,
        active=None if active is None else active[None])[0]

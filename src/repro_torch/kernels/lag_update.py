"""The lag twin's per-step drain: a CUDA kernel and its plain version.

One step, per stream row:

  1. production:  avail_i = lag_i + produced_i (nothing where inactive);
  2. segment sum: L_c = sum of avail_i over readable, assigned, active
                  partitions of bin c;
  3. drain:       each such partition sheds min(1, cap_c / L_c) of its
                  backlog; an inactive partition ends the step at exactly 0.

``lag_update_reference`` is the plain PyTorch version (the CPU path, and
the yardstick the CUDA kernel is held against on the card);
``lag_update_batch`` / ``lag_update_single`` dispatch on the tensors'
device.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

_TINY = 1e-30


def lag_update_reference(lag, produced, assign, readable, cap, *, m: int,
                         active: Optional[torch.Tensor] = None):
    """Plain version over ``(..., N)`` state tensors.

    lag, produced: f32[..., N]; assign: i32[..., N] bin name (< ``m``;
    -1 = unassigned); readable: bool/int[..., N] (0 during migration
    downtime); cap: a float or f32 broadcastable to the per-bin sums
    ``[..., M]``; active: optional bool/int[..., N] (0 = the partition does
    not exist: no production, no drain, lag forced to 0).  Returns f32[..., N].
    """
    readable = readable.bool()
    if active is not None:
        act = active.bool()
        produced = torch.where(act, produced, torch.zeros_like(produced))
        readable = readable & act
    avail = lag + produced
    names = torch.arange(m, dtype=assign.dtype, device=assign.device)
    live = readable & (assign >= 0)
    onehot = (assign.unsqueeze(-1) == names) & live.unsqueeze(-1)  # [..., N, M]
    zero = avail.new_zeros(())
    per_bin = torch.where(onehot, avail.unsqueeze(-1), zero).sum(-2)
    if not torch.is_tensor(cap):
        cap = torch.tensor(cap, dtype=torch.float32, device=avail.device)
    ratio = torch.clamp(cap / torch.clamp(per_bin, min=_TINY), max=1.0)
    frac = torch.where(onehot, ratio.unsqueeze(-2), zero).sum(-1)
    out = torch.clamp(avail * (1.0 - frac), min=0.0)
    if active is not None:
        out = torch.where(act, out, zero)
    return out


@_build.counted
def lag_update_batch(lag, produced, assign, readable, cap, *,
                     active: Optional[torch.Tensor] = None):
    """Fused produce + segment-sum + proportional drain over stream rows.

    lag, produced: f32[B, N]; assign: i32[B, N] (-1 = unassigned);
    readable: int/bool[B, N]; cap: f32[B, M] per-bin drain budget;
    active: optional int/bool[B, N].  Returns f32[B, N].

    Replaces the Pallas kernel ``src/repro/kernels/lag_update.py``
    (``lag_update_batch`` and the rank-1 ``lag_update_single``, both over
    ``_drain_math``).  On the H100 it is bound by bytes: about 24 B per
    partition and 4 B per bin, read or written once.  The simple design is
    one block per row with ``avail``/``assign``/``live`` staged in shared
    memory; each thread sums its own bin's live backlog over the row in
    index order (O(N^2) a row, no atomics, deterministic).

    CPU tensors run ``lag_update_reference``; CUDA tensors launch the
    kernel (``csrc/lag_update.cu``) or raise.
    """
    b, n = lag.shape
    m = cap.shape[-1]
    if lag.device.type == "cpu":
        return lag_update_reference(lag, produced, assign, readable, cap,
                                    m=m, active=active)
    if cap.shape != (b, m):
        raise ValueError(f"cap must be f32[B, M] = [{b}, M]; got "
                         f"{tuple(cap.shape)}")
    dev = lag.device
    f32 = lambda x: x.to(device=dev, dtype=torch.float32).contiguous()
    i32 = lambda x: x.to(device=dev, dtype=torch.int32).contiguous()
    args = [f32(lag), f32(produced), i32(assign), i32(readable), f32(cap)]
    for name, x in zip(("produced", "assign", "readable"), args[1:4]):
        if x.shape != (b, n):
            raise ValueError(f"{name} must have shape [{b}, {n}]; got "
                             f"{tuple(x.shape)}")
    act = None if active is None else i32(active)
    if act is not None and act.shape != (b, n):
        raise ValueError(f"active must have shape [{b}, {n}]; got "
                         f"{tuple(act.shape)}")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    _build.launch("lag_update_f32", *(x.data_ptr() for x in args),
                  None if act is None else act.data_ptr(), out.data_ptr(),
                  b, n, m, _build.stream_ptr(dev))
    lag_update_batch.launches += 1
    return out


def lag_update_single(lag, produced, assign, readable, cap, *,
                      active: Optional[torch.Tensor] = None):
    """Rank-1 entry: one stream, f32[N] state and f32[M] ``cap``; the same
    kernel at batch 1."""
    return lag_update_batch(
        lag[None], produced[None], assign[None], readable[None], cap[None],
        active=None if active is None else active[None])[0]

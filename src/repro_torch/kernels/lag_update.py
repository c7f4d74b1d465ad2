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


#: the inputs the kernel reads, with the dtypes it takes each in (a bool
#: mask is one byte); the last is the optional ``active``
_INPUTS = (("lag", (torch.float32,)), ("produced", (torch.float32,)),
           ("assign", (torch.int32, torch.int64)),
           ("readable", (torch.bool, torch.int32)), ("cap", (torch.float32,)),
           ("active", (torch.bool, torch.int32)))


def _launch_args(ins, b, n, m, dev):
    """The kernel's arguments for ``ins`` (lag, produced, assign,
    readable, cap, active or None): pointers, the dtype flags, row
    strides, and the copies made (to be kept alive until the launch).
    Each input is read as it is held: rows at any stride with each row
    contiguous (one step of a [B, T, N] mask goes in as it is), bool or
    int32 masks, int32 or int64 ``assign``; only a row that is not
    contiguous is copied.  Raises on a shape, dtype or device the kernel
    does not take."""
    ptrs, strides, kept = [], [], []
    where = dev.index if dev.type == "cuda" else -1     # as get_device()
    for (name, takes), x in zip(_INPUTS, ins):
        if x is None:
            ptrs.append(None)
            strides.append(0)
            continue
        shape = (b, m) if name == "cap" else (b, n)
        if x.shape != shape or x.dtype not in takes or x.get_device() != where:
            raise ValueError(
                f"lag_update: {name} must be {list(shape)} of one of "
                f"{[str(d) for d in takes]} on {dev}; got "
                f"{list(x.shape)} {x.dtype} on {x.device}")
        st = x.stride()
        if st[1] != 1 and shape[1] > 1:
            x = x.contiguous()
            kept.append(x)
            st = x.stride()
        ptrs.append(x.data_ptr())
        strides.append(st[0])
    _, _, assign, readable, _, active = ins
    flags = (assign.dtype == torch.int64, readable.dtype == torch.int32,
             active is not None and active.dtype == torch.int32)
    return ptrs, flags, strides, kept


@_build.counted
def lag_update_batch(lag, produced, assign, readable, cap, *,
                     active: Optional[torch.Tensor] = None):
    """Fused produce + segment-sum + proportional drain over stream rows.

    lag, produced: f32[B, N]; assign: i32/i64[B, N] (-1 = unassigned);
    readable: bool/i32[B, N]; cap: f32[B, M] per-bin drain budget;
    active: optional bool/i32[B, N].  Returns f32[B, N].

    Replaces the Pallas kernel ``src/repro/kernels/lag_update.py``
    (``lag_update_batch`` and the rank-1 ``lag_update_single``, both over
    ``_drain_math``).  On the H100 it is bound by bytes: 22 B a partition
    at the lag twin's dtypes and 4 B a live bin's cap, read or written
    once.  A warp drains a row, 8 rows a block; for N <= 32 a lane is a
    partition and each bin's backlog is summed over the lanes that share
    the bin (``__match_any_sync``), in partition order with plain adds:
    deterministic, no atomics.  The kernel reads every input in the dtype
    and row stride the caller holds it in, so the engine's bool masks and
    int64 ``assign`` go in without a cast.

    CPU tensors run ``lag_update_reference``; CUDA tensors launch the
    kernel (``csrc/lag_update.cu``) or raise.
    """
    b, n = lag.shape
    m = cap.shape[-1]
    if lag.device.type == "cpu":
        return lag_update_reference(lag, produced, assign, readable, cap,
                                    m=m, active=active)
    dev = lag.device
    ptrs, flags, strides, _kept = _launch_args(
        (lag, produced, assign, readable, cap, active), b, n, m, dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    _build.launch("lag_update_f32", *ptrs, out.data_ptr(), b, n, m, *flags,
                  *strides, _build.stream_ptr(dev))
    lag_update_batch.launches += 1
    return out


def lag_update_single(lag, produced, assign, readable, cap, *,
                      active: Optional[torch.Tensor] = None):
    """Rank-1 entry: one stream, f32[N] state and f32[M] ``cap``; the same
    kernel at batch 1."""
    return lag_update_batch(
        lag[None], produced[None], assign[None], readable[None], cap[None],
        active=None if active is None else active[None])[0]

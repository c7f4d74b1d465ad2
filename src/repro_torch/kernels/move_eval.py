"""Cost change of every single-item move: a CUDA kernel and its plain version.

The annealer (``repro_torch.opt.anneal``) runs many chains at once; each
anneal step every chain needs the cost change of every relocation of one
partition ``p`` to one bin name ``b`` under

    cost = bins_used + (lam / C) * sum_{moved p} speed(p)

(the paper's consumer count plus the Eq. 10 R-score weighted by ``lam``),
an ``f32[K, N, M]`` plane.  A move is allowed iff

    b != assign[p]  and  (loads[b] + w <= C   or
                          counts[b] == 0 and w > C)

(an item wider than a bin may sit alone in its own overflow bin) and, with
a mask, the item is active; every other move reads ``MOVE_BLOCKED``.

``move_delta_reference`` is the plain PyTorch version (the CPU path, and
the yardstick the kernel is held against on the card); ``move_delta_batch``
dispatches on the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

#: large finite sentinel for masked moves (finite, so -MOVE_BLOCKED / T
#: stays inside the float32 range for any sane temperature)
MOVE_BLOCKED = 1e30


def move_delta_reference(loads, counts, assign, speeds, prev, lam, capacity,
                         *, active: Optional[torch.Tensor] = None):
    """Plain version over ``(..., M)`` bin state and ``(..., N)`` items.

    loads f32[..., M] load per bin name; counts int[..., M] items per bin
    name; assign int[..., N] current bin name per item (>= 0); speeds
    f32[..., N]; prev int[..., N] previous bin name (-1 = unassigned: the
    R-score prices moves of previously-assigned items only); lam, capacity
    f32[...]; active optional bool/int[..., N] (0 blocks every move of the
    item).  Returns f32[..., N, M]: ``delta[..., p, b]``, or
    ``MOVE_BLOCKED`` for a no-op or infeasible move.  The arithmetic runs
    in the reference's order, so the two agree bit for bit.
    """
    loads = loads.to(torch.float32)
    counts = counts.to(torch.int32)
    assign = assign.long()
    speeds = speeds.to(torch.float32)
    prev = prev.long()
    m = loads.shape[-1]
    lam = torch.as_tensor(lam, dtype=torch.float32,
                          device=loads.device)[..., None, None]
    cap = torch.as_tensor(capacity, dtype=torch.float32,
                          device=loads.device)[..., None, None]
    count_a = counts.gather(-1, assign)                          # (..., N)
    names = torch.arange(m, device=loads.device)
    w = speeds.unsqueeze(-1)                                     # (..., N, 1)
    empty = (counts == 0).unsqueeze(-2)                          # (..., 1, M)
    d_bins = empty.float() - (count_a == 1).float().unsqueeze(-1)
    sticky = prev >= 0
    was_moved = ((assign != prev) & sticky).float()
    now_moved = ((names != prev.unsqueeze(-1))
                 & sticky.unsqueeze(-1)).float()
    d_r = (now_moved - was_moved.unsqueeze(-1)) * w * (lam / cap)
    allowed = ((assign.unsqueeze(-1) != names)
               & ((loads.unsqueeze(-2) + w <= cap) | (empty & (w > cap))))
    if active is not None:
        allowed = allowed & active.bool().unsqueeze(-1)
    return torch.where(allowed, d_bins + d_r, MOVE_BLOCKED)


@_build.counted
def move_delta_batch(loads, counts, assign, speeds, prev, lam, cap, *,
                     active: Optional[torch.Tensor] = None):
    """Every move's cost change over a batch of chains, one launch.

    loads f32[K, M]; counts int[K, M]; assign, prev int[K, N]; speeds
    f32[K, N]; lam, cap f32[K]; active optional int/bool[K, N].  Returns
    f32[K, N, M] (``MOVE_BLOCKED`` where blocked).

    Replaces the Pallas kernel ``src/repro/kernels/move_eval.py``
    (``move_delta_batch`` over ``_move_eval_kernel``).  On the H100 it is
    bound by bytes: the ``[K, N, M]`` plane is written once.  The simple
    design is one block per (chain, tile of 16 items), threads over the
    tile's (item, bin) pairs.

    CPU tensors run ``move_delta_reference``; CUDA tensors launch the
    kernel (``csrc/move_eval.cu``) or raise.
    """
    k, m = loads.shape
    n = assign.shape[-1]
    if loads.device.type == "cpu":
        return move_delta_reference(loads, counts, assign, speeds, prev, lam,
                                    cap, active=active)
    dev = loads.device
    f32 = lambda x: x.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    i32 = lambda x: x.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    args = [f32(loads), i32(counts), i32(assign), f32(speeds), i32(prev),
            f32(lam), f32(cap)]
    want = ((k, m), (k, m), (k, n), (k, n), (k, n), (k,), (k,))
    names = ("loads", "counts", "assign", "speeds", "prev", "lam", "cap")
    for name, x, shape in zip(names, args, want):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {list(shape)}; got "
                             f"{list(x.shape)}")
    act = None if active is None else i32(active)
    if act is not None and tuple(act.shape) != (k, n):
        raise ValueError(f"active must have shape [{k}, {n}]; got "
                         f"{list(act.shape)}")
    out = torch.empty((k, n, m), dtype=torch.float32, device=dev)
    _build.launch("move_eval_f32", *(x.data_ptr() for x in args),
                  None if act is None else act.data_ptr(), out.data_ptr(),
                  k, n, m, _build.stream_ptr(dev))
    move_delta_batch.launches += 1
    return out

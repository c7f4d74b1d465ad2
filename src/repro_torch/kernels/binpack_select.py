"""Fit-strategy slot selection and the packers' item walk: CUDA kernels and
their plain versions.

Given slot loads and an item, pick the first, best (tightest) or worst
(most slack) slot it fits in; ties break to the lowest slot, an item fits
iff ``slot < k`` and ``load + w <= capacity``, ``M`` means nothing fits
and ``NEG`` marks an inactive instance.  ``select_slot_grid`` runs that
selection over a batch of rows; ``pack_rows`` runs a whole packing call
of ``repro_torch.core.pack`` -- every insert of every row, each choosing
its slot with the same selection code -- in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build
from .ref import select_slot_ref

NEG = -1
STRATEGY_CODE = {"next": 0, "first": 1, "best": 2, "worst": 3}
SORT_KEYS = ("cumulative", "max_partition")
#: dynamic shared memory one block may use on the H100 (227 KB)
MAX_BLOCK_SMEM = 232_448


@dataclasses.dataclass
class PackedRows:
    bin_of: torch.Tensor   # i64[R, N]  bin name per item (NEG if inactive)
    loads: torch.Tensor    # f32[R, M]  load per creation slot
    names: torch.Tensor    # i64[R, M]  name per creation slot
    n_bins: torch.Tensor   # i64[R]     bins created


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
    bound by bytes: the ``[B, N, M]`` loads plane is read once.  One warp
    per (stream, instance) row: the lanes stride across the M slots, one
    coalesced read a pass, and a shuffle butterfly reduces their choices.

    CPU tensors run ``select_slot_plain``; CUDA tensors launch the kernel
    (``csrc/binpack_select.cu``) or raise.
    """
    if strategy not in STRATEGY_CODE or strategy == "next":
        raise ValueError(f"strategy must be one of ('first', 'best', "
                         f"'worst'), got {strategy!r}")
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


def pack_row_bytes(n: int) -> int:
    """Shared-memory bytes the packing kernel keeps for one row of ``n``
    items (``pack_row_bytes`` in ``csrc/binpack_select.cu``): 14n + 4
    words of per-item, per-slot and per-consumer arrays, three bitmasks
    over the 2n + 2 names, n flag bytes, rounded up to 16."""
    words = (2 * n + 2 + 31) // 32
    return (4 * (14 * n + 4 + 3 * words) + n + 15) // 16 * 16


#: the widest row the packing kernel takes: one row a block, in all of a
#: block's shared memory
PACK_MAX_N = max(n for n in range(MAX_BLOCK_SMEM // 56 + 1)
                 if pack_row_bytes(n) <= MAX_BLOCK_SMEM)


class PackWidthError(ValueError):
    """A packing call on the card with more items a row than
    ``PACK_MAX_N``: the row's state would not fit one block's shared
    memory."""


@_build.counted
def pack_rows(speeds, prev, capacity, *, strategy: str,
              decreasing: bool = False, sticky: bool = True,
              sort_key: Optional[str] = None,
              active: Optional[torch.Tensor] = None) -> PackedRows:
    """One packing call over rows: speeds f32[R, N], prev int[R, N]
    (previous bin names, -1 = none; a name outside ``[0, 2N + 2)`` counts
    as none), active optional bool[R, N].  ``sort_key=None`` is the
    classical any-fit (``strategy`` next/first/best/worst, ``decreasing``,
    ``sticky``); ``sort_key`` ``"cumulative"`` or ``"max_partition"`` is
    Modified Any Fit with fit ``strategy`` (best/worst).

    Replaces, with ``select_slot_grid``, the Pallas kernel
    ``src/repro/kernels/binpack_select.py`` and carries the reference's
    scans around it (``repro.core.jaxpack.pack_jax`` /
    ``modified_any_fit_jax``) into one launch: one warp a row, the row's
    packing state in shared memory, every insert's slot chosen by the
    selection code of ``select_slot_grid``.  On the H100 it is bound by
    neither bytes nor operations but by the latency of the serial item
    walk within a row; the design's gain is one launch, and a handful of
    host ops, a call instead of one launch and 25-45 ops an insert.

    CPU tensors run the plain versions (``core.pack.pack_plain`` /
    ``modified_any_fit_plain``); CUDA tensors launch the kernel
    (``csrc/binpack_select.cu``) or raise, and a row wider than
    ``PACK_MAX_N`` raises :class:`PackWidthError`.
    """
    modified = sort_key is not None
    allowed = ("best", "worst") if modified else tuple(STRATEGY_CODE)
    if strategy not in allowed:
        raise ValueError(f"strategy must be one of {allowed}, got "
                         f"{strategy!r}")
    if modified and sort_key not in SORT_KEYS:
        raise ValueError(f"sort_key must be one of {SORT_KEYS} or None, got "
                         f"{sort_key!r}")
    if speeds.device.type == "cpu":
        # the plain versions live beside their callers (core.pack imports
        # this module, so the import waits for the call; the submodule by
        # its full name: the package's ``pack`` is the py packer)
        from repro_torch.core.pack import modified_any_fit_plain, pack_plain

        if modified:
            return modified_any_fit_plain(
                speeds, prev, capacity, fit=strategy, sort_key=sort_key,
                active=active)
        return pack_plain(speeds, prev, capacity, strategy=strategy,
                          decreasing=decreasing, sticky=sticky,
                          active=active)
    if speeds.dim() != 2:
        raise ValueError(f"speeds must be [R, N]; got {tuple(speeds.shape)}")
    rows, n = speeds.shape
    if n > PACK_MAX_N:
        raise PackWidthError(
            f"pack_rows takes at most PACK_MAX_N = {PACK_MAX_N} items a row "
            f"(a row's state must fit one block's {MAX_BLOCK_SMEM} bytes of "
            f"shared memory); got N = {n}")
    dev = speeds.device
    sp = speeds.to(torch.float32).contiguous()
    pv = prev.to(device=dev, dtype=torch.long).contiguous()
    if pv.shape != (rows, n):
        raise ValueError(f"prev must have shape [{rows}, {n}]; got "
                         f"{tuple(pv.shape)}")
    act = None
    if active is not None:
        act = active.to(device=dev, dtype=torch.bool).contiguous()
        if act.shape != (rows, n):
            raise ValueError(f"active must have shape [{rows}, {n}]; got "
                             f"{tuple(act.shape)}")
    m = 2 * n + 1 if modified else n + 1
    out = PackedRows(
        bin_of=torch.empty((rows, n), dtype=torch.long, device=dev),
        loads=torch.empty((rows, m), dtype=torch.float32, device=dev),
        names=torch.empty((rows, m), dtype=torch.long, device=dev),
        n_bins=torch.empty((rows,), dtype=torch.long, device=dev))
    if rows == 0:
        return out
    _build.launch("pack_rows_f32", sp.data_ptr(), pv.data_ptr(),
                  None if act is None else act.data_ptr(),
                  out.bin_of.data_ptr(), out.loads.data_ptr(),
                  out.names.data_ptr(), out.n_bins.data_ptr(), rows, n,
                  int(modified), STRATEGY_CODE[strategy], int(decreasing),
                  int(sticky), int(sort_key == "cumulative"),
                  float(capacity), _build.stream_ptr(dev))
    pack_rows.launches += 1
    return out

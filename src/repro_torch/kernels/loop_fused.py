"""The lag twin's closed loop for the heuristic packers, all T steps in
one launch: a CUDA kernel and its plain version.

Each step of one (policy, stream) row replays the heuristic packer
exactly:

  1. traversal order: identity, or ``pack``'s stable non-increasing sort
     for Decreasing variants (as a pairwise rank, no sort primitive);
  2. slot selection per item (next/first/best/worst as a masked
     double-min: lowest score, then lowest slot) and bin creation;
  3. the Sec. IV-C sticky renaming of creation slots to bin names, with
     the ``2n+2`` name universe packed into 32-bit masks (``n <= 14``);
  4. migration downtime (a moved partition is unreadable for
     ``migration_steps`` steps);
  5. produce + proportional drain (the ``lag_update`` math in slot space:
     slot <-> name is a bijection per step, so per-bin sums match).

The helpers ``_order`` / ``_struct`` (phases 1-2, any leading axes) and
``_name_drain`` (phases 3-5 on ``[R, N]`` rows) are shared with the fused
engine ``repro_torch.lagsim.fused``, which runs phases 1-2 wide over all
steps before a lean loop over phases 3-5.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

NEG = -1
_TINY = 1e-30
_BIG_SLOT = 127        # > any slot index: the tie-break filler of the min
MAX_PARTITIONS = 14    # 2n + 2 bin names in a 32-bit mask
STRATEGY_CODE = {"next": 0, "first": 1, "best": 2, "worst": 3}


def _order(speeds):
    """Stable non-increasing order of ``speeds [..., N]`` as a pairwise rank
    (strictly greater, plus equal with a lower index).  Returns
    ``(order, rank)``: item at each traversal position, and each item's
    position."""
    n = speeds.shape[-1]
    iota = torch.arange(n, device=speeds.device)
    gt = speeds.unsqueeze(-1) < speeds.unsqueeze(-2)
    eq_lo = ((speeds.unsqueeze(-1) == speeds.unsqueeze(-2))
             & (iota.unsqueeze(0) < iota.unsqueeze(1)))
    rank = (gt | eq_lo).sum(-1)
    order = torch.empty_like(rank).scatter_(-1, rank,
                                            iota.expand_as(rank).clone())
    return order, rank


def _select_consts(strategies: Sequence[str], reps: int, device):
    """Per-row select constants for rows ``p * reps + r``: ``is_next``, and
    the score ``a_sgn * load + b_first * slot`` that every other strategy
    minimizes (first: slot; best: -load; worst: +load)."""
    code = torch.tensor([STRATEGY_CODE[s] for s in strategies],
                        device=device).repeat_interleave(reps)
    is_next = code == 0
    a_sgn = torch.where(code == 2, -1.0, torch.where(code == 3, 1.0, 0.0))
    b_first = (code == 1).float()
    return is_next, a_sgn, b_first


def _struct(sp_ord, order, act_ord, capacity: float, is_next, a_sgn,
            b_first):
    """Phases 1-2 on traversal-ordered items ``[..., R, N]`` (rows last but
    one; the per-row constants broadcast over any leading axes).  Returns
    ``(slot_ord, creator, k)``: each item's creation slot in traversal
    order (``NEG`` if inactive), the item that created each slot, and the
    bin count."""
    n = sp_ord.shape[-1]
    m = n + 1
    dev = sp_ord.device
    lead = sp_ord.shape[:-1]
    iota_m = torch.arange(m, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    b_off = b_first.unsqueeze(-1) * iota_m.float()
    a_sgn = a_sgn.unsqueeze(-1)
    loads = torch.full(lead + (m,), float("inf"), device=dev)
    creator = torch.full(lead + (m,), NEG, dtype=torch.long, device=dev)
    k = torch.zeros(lead, dtype=torch.long, device=dev)
    lastload = torch.zeros(lead, device=dev)
    slot_ord = []
    for i in range(n):
        w = sp_ord[..., i]
        j = order[..., i]
        d = loads + w.unsqueeze(-1)
        fits = d <= capacity
        score = torch.where(fits, a_sgn * loads + b_off, inf)
        mn = score.amin(-1)
        s_sel = torch.where(score == mn.unsqueeze(-1), iota_m,
                            _BIG_SLOT).amin(-1)
        ok_next = (k > 0) & (lastload + w <= capacity)
        found = torch.where(is_next, ok_next, mn < inf)
        slot = torch.where(found, torch.where(is_next, k - 1, s_sel), k)
        upd = iota_m == slot.unsqueeze(-1)
        a = None if act_ord is None else act_ord[..., i]
        if a is not None:
            upd = upd & a.unsqueeze(-1)
        loads = torch.where(upd, torch.where(found.unsqueeze(-1), d,
                                             w.unsqueeze(-1)), loads)
        creator = torch.where(upd & ~found.unsqueeze(-1), j.unsqueeze(-1),
                              creator)
        new_last = torch.where(found & (slot == k - 1), lastload + w,
                               torch.where(found, lastload, w))
        grow = ~found if a is None else (a & ~found)
        lastload = new_last if a is None else torch.where(a, new_last,
                                                          lastload)
        k = k + grow.long()
        slot_ord.append(slot if a is None else torch.where(a, slot, NEG))
    return torch.stack(slot_ord, -1), creator, k


def _name_drain(lag, prev, down, produced, act, slot_of, creator, k, *,
                cap_step: float, mig: int):
    """Phases 3-5 on rows ``[R, N]``: sticky naming of the creation slots,
    downtime, produce + drain.  Returns ``(new_lag, new_assign, new_down,
    moved, unread)``."""
    rows, n = lag.shape
    dev = lag.device
    bit = torch.arange(32, device=dev)
    # previous name of each slot's creator (NEG for a slot nobody created)
    p_all = torch.where(creator[:, :n] >= 0,
                        prev.gather(1, torch.clamp(creator[:, :n], min=0)),
                        NEG)
    claimed = torch.zeros(rows, dtype=torch.long, device=dev)
    seen = torch.zeros_like(claimed)
    q = torch.zeros_like(claimed)
    new_assign = torch.full((rows, n), NEG, dtype=torch.long, device=dev)
    for s in range(n):
        v = p_all[:, s]
        vbit = torch.bitwise_left_shift(torch.ones_like(v),
                                        torch.clamp(v, min=0))
        live = s < k
        cand = (v >= 0) & ((seen & vbit) == 0)
        seen = torch.where(v >= 0, seen | vbit, seen)
        win = cand & (v >= q) & live
        nm = torch.where(win, v, q)
        new_assign = torch.where((slot_of == s) & live.unsqueeze(1),
                                 nm.unsqueeze(1), new_assign)
        claimed = torch.where(win, claimed | vbit, claimed)
        adv = (live & ~win) | (win & (v == q))
        mask = claimed | (torch.bitwise_left_shift(torch.ones_like(q),
                                                   q + 1) - 1)
        # q <- the lowest unset bit of mask (the kernel's popc(low - 1))
        unset = ((mask.unsqueeze(1) >> bit) & 1) == 0
        q = torch.where(adv, torch.where(unset, bit, 64).amin(1), q)
    moved = (prev >= 0) & (new_assign >= 0) & (new_assign != prev)
    down = torch.where(moved, mig, torch.clamp(down - 1, min=0))
    avail = lag + produced
    live_p = (down == 0) & (new_assign >= 0) & (slot_of >= 0)
    iota_m = torch.arange(n + 1, device=dev)
    onehot = (slot_of.unsqueeze(-1) == iota_m) & live_p.unsqueeze(-1)
    zero = avail.new_zeros(())
    # per-bin sums in item index order, as the kernel adds them: any other
    # order drifts by float rounding that the lag recursion carries on
    per_bin = torch.zeros(rows, n + 1, device=dev)
    for j in range(n):
        per_bin = per_bin + torch.where(onehot[:, j], avail[:, j:j + 1], zero)
    cap = torch.full_like(per_bin, cap_step)
    ratio = torch.clamp(cap / torch.clamp(per_bin, min=_TINY), max=1.0)
    frac = torch.where(live_p, ratio.gather(1, torch.clamp(slot_of, min=0)),
                       zero)
    new_lag = torch.clamp(avail * (1.0 - frac), min=0.0)
    unread = down > 0
    if act is not None:
        new_lag = torch.where(act, new_lag, zero)
        unread = unread & act
    return new_lag, new_assign, down, moved, unread


def _outputs(rows: int, t: int, n: int, record_assign: bool, dev):
    """Preallocated per-step outputs of a loop over ``rows`` rows: lag
    total and max (f32), consumers, migrations, unreadable (i32), and the
    assignments (i32[rows, T, N]) with ``record_assign``."""
    out = [torch.empty((rows, t), device=dev) for _ in range(2)]
    out += [torch.empty((rows, t), dtype=torch.int32, device=dev)
            for _ in range(3)]
    if record_assign:
        out.append(torch.empty((rows, t, n), dtype=torch.int32, device=dev))
    return out


def _record(out, step: int, lag, k, moved, unread, assign) -> None:
    """Write one step's reductions (and assignment) into ``_outputs``.
    The lag total is summed in partition index order, as the kernel adds
    it, so the two agree bit for bit."""
    total = torch.zeros_like(lag[:, 0])
    for j in range(lag.shape[1]):
        total = total + lag[:, j]
    for dst, val in zip(out, (total, lag.amax(1), k, moved.sum(1),
                              unread.sum(1), assign)):
        dst[:, step] = val


def _per_policy(out, p: int, b: int):
    """Rows ``p * B + b`` -> a leading ``[P, B]``."""
    return tuple(x.reshape(p, b, *x.shape[1:]) for x in out)


def _consts(capacity: float, dt: float) -> Tuple[float, float, float]:
    """``(capacity, capacity * dt, dt)`` rounded to float32 as the
    reference rounds them."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return f32(capacity), f32(capacity * dt), f32(dt)


def loop_fused_reference(rates, *, strategies: Sequence[str],
                         decreasing: Sequence[bool], capacity: float = 1.0,
                         dt: float = 1.0, migration_steps: int = 2,
                         active: Optional[torch.Tensor] = None,
                         initial_lag: Optional[torch.Tensor] = None,
                         record_assign: bool = False):
    """Plain version of ``loop_fused``: the reference's ``_one_step``
    batched over rows ``p * B + b`` and looped over T.  Same arguments and
    outputs as ``loop_fused``."""
    b, t, n = rates.shape
    p = len(strategies)
    dev = rates.device
    cap, cap_step, dt = _consts(capacity, dt)
    is_next, a_sgn, b_first = _select_consts(strategies, b, dev)
    dec = torch.tensor([bool(d) for d in decreasing],
                       device=dev).repeat_interleave(b).unsqueeze(1)
    iota_n = torch.arange(n, device=dev)
    rates = rates.to(torch.float32)
    act_all = None if active is None else active.bool()
    lag = (torch.zeros(p * b, n, device=dev) if initial_lag is None
           else initial_lag.to(torch.float32).repeat(p, 1))
    prev = torch.full((p * b, n), NEG, dtype=torch.long, device=dev)
    down = torch.zeros((p * b, n), dtype=torch.long, device=dev)
    out = _outputs(p * b, t, n, record_assign, dev)
    for step in range(t):
        speeds = rates[:, step].repeat(p, 1)
        act = None if act_all is None else act_all[:, step].repeat(p, 1)
        produced = speeds * dt
        if act is not None:
            produced = torch.where(act, produced, 0.0)
        order_d, rank_d = _order(speeds)
        order = torch.where(dec, order_d, iota_n)
        pos = torch.where(dec, rank_d, iota_n)
        slot_ord, creator, k = _struct(
            speeds.gather(1, order), order,
            None if act is None else act.gather(1, order),
            cap, is_next, a_sgn, b_first)
        slot_of = slot_ord.gather(1, pos)
        lag, prev, down, moved, unread = _name_drain(
            lag, prev, down, produced, act, slot_of, creator, k,
            cap_step=cap_step, mig=int(migration_steps))
        _record(out, step, lag, k, moved, unread, prev)
    return _per_policy(out, p, b)


def _rows16(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``x [B, T, N]`` as ``B`` rows that the kernel's bulk copies can
    read: the tensor holding the rows, each starting on a 16-byte
    boundary, and its row stride in elements.  A contiguous, aligned
    ``x`` whose rows are a multiple of 16 bytes is used as it is; anything
    else is copied once into zero-padded rows."""
    b = x.shape[0]
    row = x[0].numel()
    per16 = 16 // x.element_size()
    if x.is_contiguous() and x.data_ptr() % 16 == 0 and row % per16 == 0:
        return x, row
    rs = -(-row // per16) * per16
    out = x.new_zeros((b, rs))
    out[:, :row] = x.reshape(b, row)
    return out, rs


@_build.counted
def loop_fused(rates, *, strategies: Sequence[str],
               decreasing: Sequence[bool], capacity: float = 1.0,
               dt: float = 1.0, migration_steps: int = 2,
               active: Optional[torch.Tensor] = None,
               initial_lag: Optional[torch.Tensor] = None,
               record_assign: bool = False):
    """Run heuristic policies' whole closed loops over ``rates f32[B, T, N]``
    in one launch.

    ``strategies`` / ``decreasing`` name one heuristic per policy ``P``
    (next/first/best/worst, Decreasing or not: NF..WFD); ``active`` is an
    optional bool[B, T, N] mask and ``initial_lag`` an optional f32[B, N]
    backlog seed.  Returns ``(lag_total f32[P, B, T], lag_max f32[P, B, T],
    consumers, migrations, unreadable i32[P, B, T])`` plus ``assigns
    i32[P, B, T, N]`` with ``record_assign``.  The reference's
    steps-per-block K has no counterpart: the kernel carries state across
    all T steps in registers (``LagSimConfig.fused_steps`` is validated in
    ``resolve``).

    Replaces the Pallas megakernel ``src/repro/kernels/loop_fused.py:220``
    (``loop_fused_batch`` over ``_loop_fused_kernel`` / ``_one_step``).
    On the H100 it is bound by operations: per row and step, O(N * M)
    slot selection plus O(N^2) rank and naming work against a few
    hundred bytes.  One lane a (policy, stream) row, its state in
    registers: the kernel is instantiated for each ``n <= 14`` and reads
    and writes every per-item and per-slot array at compile-time indices
    only.  A warp is one policy over 32 consecutive streams, and the
    block's policies share each rate and mask slab, brought into shared
    memory once by TMA bulk copies.

    CPU tensors run ``loop_fused_reference``; CUDA tensors launch the
    kernel (``csrc/loop_fused.cu``) or raise.
    """
    for s in strategies:
        if s not in STRATEGY_CODE:
            raise ValueError(f"strategy must be one of "
                             f"{tuple(STRATEGY_CODE)}, got {s!r}")
    if len(decreasing) != len(strategies):
        raise ValueError("strategies and decreasing must name the same "
                         "policies")
    b, t, n = rates.shape
    if n > MAX_PARTITIONS:
        raise ValueError(
            f"loop_fused packs bin names into 32-bit masks and supports "
            f"n <= {MAX_PARTITIONS} partitions; got n = {n} (the lag engine "
            f"falls back to the unfused loop above the limit)")
    kw = dict(strategies=strategies, decreasing=decreasing,
              capacity=capacity, dt=dt, migration_steps=migration_steps,
              active=active, initial_lag=initial_lag,
              record_assign=record_assign)
    if rates.device.type == "cpu":
        return loop_fused_reference(rates, **kw)
    dev = rates.device
    p = len(strategies)
    cap, cap_step, dt32 = _consts(capacity, dt)
    rates, rs = _rows16(rates.to(torch.float32))
    act, rsm = None, 0
    if active is not None:
        if tuple(active.shape) != (b, t, n):
            raise ValueError(f"active must have shape {(b, t, n)}; got "
                             f"{tuple(active.shape)}")
        act, rsm = _rows16(active.to(device=dev, dtype=torch.bool).view(
            torch.uint8))
    lag0 = None
    if initial_lag is not None:
        lag0 = initial_lag.to(device=dev, dtype=torch.float32).contiguous()
        if lag0.shape != (b, n):
            raise ValueError(f"initial_lag must have shape [{b}, {n}]; got "
                             f"{tuple(lag0.shape)}")
    strat = torch.tensor([STRATEGY_CODE[s] for s in strategies],
                         dtype=torch.int32, device=dev)
    dec = torch.tensor([int(bool(d)) for d in decreasing], dtype=torch.int32,
                       device=dev)
    out = _outputs(p * b, t, n, record_assign, dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    asg = out[5] if record_assign else None
    _build.launch("loop_fused_f32", rates.data_ptr(), ptr(act), ptr(lag0),
                  strat.data_ptr(), dec.data_ptr(),
                  *(x.data_ptr() for x in out[:5]), ptr(asg), p, b, t, n,
                  rs, rsm, cap, cap_step, dt32, int(migration_steps),
                  _build.stream_ptr(dev))
    loop_fused.launches += 1
    return _per_policy(out, p, b)


def loop_fused_batch(rates, *, strategy: str, decreasing: bool,
                     capacity: float = 1.0, dt: float = 1.0,
                     migration_steps: int = 2, active=None,
                     initial_lag=None):
    """The reference's single-strategy signature, less its block size K:
    ``(lag_total, lag_max, consumers, migrations, unreadable [B, T],
    assigns [B, T, N])``."""
    out = loop_fused(rates, strategies=(strategy,), decreasing=(decreasing,),
                     capacity=capacity, dt=dt,
                     migration_steps=migration_steps, active=active, initial_lag=initial_lag,
                     record_assign=True)
    return tuple(o[0] for o in out)

"""The paper's packing algorithms, batched over rows ``[R, N]``.

One row is one packing instance (in the lag twin: one stream under one
policy).  ``pack`` and ``modified_any_fit`` take a whole batch in one
call: on a CUDA tensor they launch the ``pack_rows`` kernel once for
every row of the call (``kernels/binpack_select.py``), on a CPU tensor
they run the plain versions below.  Semantics -- tie-breaking, the Sec.
IV-C sticky naming and the ``active`` mask contract -- follow the
reference ``repro.core.jaxpack`` (``pack_jax``, ``modified_any_fit_jax``)
exactly.

The plain versions ``pack_plain`` / ``modified_any_fit_plain`` walk the
items in a static Python loop; every per-row choice that the reference
makes with ``lax.cond`` or a scalar index becomes a masked update over the
row axis, so a whole batch packs in one pass with no host
synchronisation.  They launch nothing, on any device: first/best/worst
inserts choose their slot with ``select_slot_plain``; next-fit only ever
looks at the last bin.

Conventions: ``speeds`` f32[R, N]; ``prev`` int[R, N] previous bin name
(-1 = unassigned; a name outside ``[0, 2n+2)`` counts as unassigned);
``active`` optional bool[R, N] (an inactive item packs to ``NEG``, adds
no load and claims no name).  Bin names lie in ``[0, 2n+2)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.binpack_select import (PackedRows, pack_rows,
                                                select_slot_plain)

NEG = -1


def _take(x, idx):
    """``x[r, idx[r]]`` for every row."""
    return x.gather(1, idx.unsqueeze(1)).squeeze(1)


def _put(x, iota, idx, val, gate=None):
    """``x`` with ``x[r, idx[r]] = val[r]`` for every row (where ``gate``);
    ``iota`` is ``arange(x.shape[1])``.  Out-of-range ``idx`` writes
    nothing."""
    hit = iota == idx.unsqueeze(1)
    if gate is not None:
        hit = hit & gate.unsqueeze(1)
    if torch.is_tensor(val):
        val = val.unsqueeze(1)
    return torch.where(hit, val, x)


def _stable_order(keys):
    """``jnp.lexsort(keys)`` over rows: the LAST key is primary.  A chain
    of stable sorts, from the first key to the last."""
    perm = None
    for key in keys:
        k = key if perm is None else key.gather(1, perm)
        idx = torch.sort(k, dim=1, stable=True).indices
        perm = idx if perm is None else perm.gather(1, idx)
    return perm


def _select_slot(loads, k, w, capw, strategy: str):
    """Masked fit selection over created slots ``[0, k)`` per row.
    Returns ``(slot, found)``: the chosen slot where found, else ``k``
    (the slot a new bin would take)."""
    if strategy == "next":
        last = torch.clamp(k - 1, min=0)
        found = (k > 0) & (_take(loads, last) + w <= capw)
        return torch.where(found, last, k), found
    slot = select_slot_plain(loads.unsqueeze(1), w.unsqueeze(1),
                             k.unsqueeze(1), capw.unsqueeze(1),
                             strategy=strategy)[:, 0].long()
    found = slot < loads.shape[1]
    return torch.where(found, slot, k), found


class _Space:
    """The per-call constants of one packer run: iotas and the capacity."""

    def __init__(self, rows: int, n: int, m: int, u: int, capacity, dev):
        self.n_iota = torch.arange(n, device=dev)
        self.m_iota = torch.arange(m, device=dev)
        self.u_iota = torch.arange(u, device=dev)
        self.u = u
        self.capw = torch.full((rows,), float(capacity), dtype=torch.float32,
                               device=dev)


def _place_or_create(state, sp: _Space, j, w, prev_name, strategy: str,
                     gate=None):
    """Any-fit insert of item ``j`` per row: the selected open bin, else a
    new bin named by the Sec. IV-C rule (the item's previous name if still
    unused, else the lowest unused name).  ``gate`` leaves rows whose item
    does not take part untouched."""
    loads, names, used, k, bin_of = state
    slot, found = _select_slot(loads, k, w, sp.capw, strategy)
    lowest = torch.where(used, sp.u, sp.u_iota).amin(1)
    sticky_ok = (prev_name >= 0) & ~_take(used, torch.clamp(prev_name, min=0))
    name_new = torch.where(sticky_ok, prev_name, lowest)
    name = torch.where(found, _take(names, slot), name_new)
    loads = _put(loads, sp.m_iota, slot, _take(loads, slot) + w, gate)
    names = _put(names, sp.m_iota, slot, name, gate)
    used = _put(used, sp.u_iota, name, True, gate)
    grow = ~found if gate is None else (~found & gate)
    bin_of = _put(bin_of, sp.n_iota, j, name, gate)
    return loads, names, used, k + grow.long(), bin_of


def _prev_names(prev, u: int):
    """``prev`` as int64 with every name outside ``[0, u)`` set to NEG."""
    prev = prev.long()
    return torch.where((prev >= 0) & (prev < u), prev, NEG)


def pack(speeds, prev, capacity, *, strategy: str = "first",
         decreasing: bool = False, sticky: bool = True,
         active: Optional[torch.Tensor] = None) -> PackedRows:
    """Classical any-fit (NF/FF/BF/WF and their Decreasing variants) over
    rows; reference: ``repro.core.jaxpack.pack_jax``.  One ``pack_rows``
    launch on a CUDA tensor, ``pack_plain`` on a CPU tensor."""
    return pack_rows(speeds, prev, capacity, strategy=strategy,
                     decreasing=decreasing, sticky=sticky, active=active)


def modified_any_fit(speeds, prev, capacity, *, fit: str = "best",
                     sort_key: str = "cumulative",
                     active: Optional[torch.Tensor] = None) -> PackedRows:
    """Algorithm 1 (MWF/MBF/MWFP/MBFP) over rows; reference:
    ``repro.core.jaxpack.modified_any_fit_jax``.  One ``pack_rows``
    launch on a CUDA tensor, ``modified_any_fit_plain`` on a CPU
    tensor."""
    return pack_rows(speeds, prev, capacity, strategy=fit,
                     sort_key=sort_key, active=active)


def pack_plain(speeds, prev, capacity, *, strategy: str = "first",
               decreasing: bool = False, sticky: bool = True,
               active: Optional[torch.Tensor] = None) -> PackedRows:
    """Plain version of ``pack``: the item walk as a Python loop of
    masked updates over the rows."""
    rows, n = speeds.shape
    dev = speeds.device
    m = n + 1
    sp = _Space(rows, n, m, 2 * n + 2, capacity, dev)
    speeds = speeds.to(torch.float32)
    prev = _prev_names(prev, sp.u)
    if decreasing:
        # stable non-increasing sort: lexsort((arange(n), -speeds))
        order = torch.sort(-speeds, dim=1, stable=True).indices
    else:
        order = sp.n_iota.expand(rows, n)
    state = (torch.zeros(rows, m, dtype=torch.float32, device=dev),
             torch.full((rows, m), NEG, dtype=torch.long, device=dev),
             torch.zeros(rows, sp.u, dtype=torch.bool, device=dev),
             torch.zeros(rows, dtype=torch.long, device=dev),
             torch.full((rows, n), NEG, dtype=torch.long, device=dev))
    none = torch.full((rows,), NEG, dtype=torch.long, device=dev)
    act = None if active is None else active.bool()
    for i in range(n):
        j = order[:, i]
        gate = None if act is None else _take(act, j)
        state = _place_or_create(
            state, sp, j, _take(speeds, j),
            _take(prev, j) if sticky else none, strategy, gate)
    loads, names, _, k, bin_of = state
    return PackedRows(bin_of=bin_of, loads=loads, names=names, n_bins=k)


def modified_any_fit_plain(speeds, prev, capacity, *, fit: str = "best",
                           sort_key: str = "cumulative",
                           active: Optional[torch.Tensor] = None
                           ) -> PackedRows:
    """Plain version of ``modified_any_fit``.

    Every item appears twice in a ``2n``-entry schedule: in its consumer's
    phase 1 (smallest to biggest, open bins only) and phase 2 (biggest to
    smallest, into the consumer's own bin).  Consumers go in non-increasing
    key order.  The reference's per-entry ``lax.cond`` becomes masked
    updates (phase differs per row).  Leftovers get a final decreasing
    any-fit with sticky naming.  An inactive item is absent: it enters no
    phase and never reaches the final stage.
    """
    if fit not in ("best", "worst"):
        raise ValueError(fit)
    if sort_key not in ("cumulative", "max_partition"):
        raise ValueError(sort_key)
    rows, n = speeds.shape
    dev = speeds.device
    m = 2 * n + 1
    u = 2 * n + 2
    s = u                                   # consumer-segment universe
    sp = _Space(rows, n, m, u, capacity, dev)
    speeds = speeds.to(torch.float32)
    prev = _prev_names(prev, u)
    assigned = prev >= 0
    pending0 = ~assigned
    if active is not None:
        act = active.bool()
        assigned = assigned & act
        pending0 = ~assigned & act
    cseg = torch.where(assigned, prev, s - 1)     # s-1: the unassigned dummy
    seg_oh = cseg.unsqueeze(2) == sp.u_iota       # [R, n, s]

    # consumer sort keys; the cumulative key is summed in item index order
    # (the reference's scatter-add order) so near-ties rank identically
    zero = speeds.new_zeros(())
    if sort_key == "cumulative":
        key = torch.zeros(rows, s, dtype=torch.float32, device=dev)
        for jj in range(n):
            key = key + torch.where(seg_oh[:, jj], speeds[:, jj:jj + 1], zero)
    else:
        key = torch.where(seg_oh, speeds.unsqueeze(2), zero).amax(1)
    key = torch.where(seg_oh.any(1), key, float("-inf"))
    crank_order = torch.sort(-key, dim=1, stable=True).indices   # rank -> c
    crank = torch.empty_like(crank_order).scatter_(
        1, crank_order, sp.u_iota.expand(rows, s))
    item_rank = crank.gather(1, cseg)                             # [R, n]

    pid = sp.n_iota.expand(rows, n)
    p1 = _stable_order((-pid, speeds, item_rank))   # speed asc, pid desc
    p2 = _stable_order((pid, -speeds, item_rank))   # speed desc, pid asc
    # interleave per consumer: its phase-1 entries, then its phase-2 ones
    seq_items = torch.cat([p1, p2], 1)
    seq_phase = torch.cat([torch.zeros(n, dtype=torch.long, device=dev),
                           torch.ones(n, dtype=torch.long, device=dev)])
    seq_pos = torch.cat([sp.n_iota, sp.n_iota])
    entry_key = (item_rank.gather(1, seq_items) * (2 * n)
                 + seq_phase * n + seq_pos)                       # unique
    entry_order = torch.sort(entry_key, dim=1).indices
    seq_items = seq_items.gather(1, entry_order)
    seq_phase = seq_phase.expand(rows, 2 * n).gather(1, entry_order)

    loads = torch.zeros(rows, m, dtype=torch.float32, device=dev)
    names = torch.full((rows, m), NEG, dtype=torch.long, device=dev)
    used = torch.zeros(rows, u, dtype=torch.bool, device=dev)
    k = torch.zeros(rows, dtype=torch.long, device=dev)
    bin_of = torch.full((rows, n), NEG, dtype=torch.long, device=dev)
    placed = torch.zeros(rows, n, dtype=torch.bool, device=dev)
    to_u = pending0.clone()
    u_order = torch.where(assigned, 3 * n, pid)
    fail1 = torch.zeros(rows, s, dtype=torch.bool, device=dev)
    own_slot = torch.full((rows, s), NEG, dtype=torch.long, device=dev)
    own_fail = torch.zeros(rows, s, dtype=torch.bool, device=dev)
    for e in range(2 * n):
        j = seq_items[:, e]
        w = _take(speeds, j)
        c = _take(cseg, j)
        go = ~(_take(placed, j) | ~_take(assigned, j))
        do1 = go & (seq_phase[:, e] == 0)
        do2 = go & (seq_phase[:, e] == 1)
        # phase 1: try the open bins (a consumer stops at its first failure)
        slot, found = _select_slot(loads, k, w, sp.capw, fit)
        found = found & ~_take(fail1, c)
        put1 = do1 & found
        loads = _put(loads, sp.m_iota, slot, _take(loads, slot) + w, put1)
        bin_of = _put(bin_of, sp.n_iota, j, _take(names, slot), put1)
        placed = _put(placed, sp.n_iota, j, True, put1)
        fail1 = _put(fail1, sp.u_iota, c, True, do1 & ~found)
        # phase 2: the consumer's own bin (named c), created on first use
        own_c = _take(own_slot, c)
        create = do2 & (own_c < 0)
        names = _put(names, sp.m_iota, k, c, create)
        used = _put(used, sp.u_iota, c, True, create)
        own_slot = _put(own_slot, sp.u_iota, c, k, create)
        own = torch.where(create, k, torch.clamp(own_c, min=0))
        k = k + create.long()
        lo = _take(loads, own)
        # oversized exception: an item with w > C may hold its own empty bin
        fits = (((lo + w <= sp.capw) | ((lo == 0.0) & (w > sp.capw)))
                & ~_take(own_fail, c))
        put2 = do2 & fits
        defer = do2 & ~fits
        loads = _put(loads, sp.m_iota, own, lo + w, put2)
        bin_of = _put(bin_of, sp.n_iota, j, c, put2)
        placed = _put(placed, sp.n_iota, j, True, put2)
        own_fail = _put(own_fail, sp.u_iota, c, True, defer)
        to_u = _put(to_u, sp.n_iota, j, True, defer)
        u_order = _put(u_order, sp.n_iota, j, n + e, defer)

    # final stage (lines 27-29): decreasing any-fit over U, sticky naming
    final_order = _stable_order((u_order, -speeds))
    state = (loads, names, used, k, bin_of)
    for i in range(n):
        j = final_order[:, i]
        state = _place_or_create(state, sp, j, _take(speeds, j),
                                 _take(prev, j), fit, _take(to_u, j))
    loads, names, _, k, bin_of = state
    return PackedRows(bin_of=bin_of, loads=loads, names=names, n_bins=k)

"""Modified Any Fit algorithms (paper Sec. IV-B, Algorithm 1): the
pure-Python packers behind the ``py`` backend, a copy of
``repro.core.modified``.

The four family members (Table II):

  MWF   worst-fit insert, consumers sorted by cumulative write speed
  MBF   best-fit insert,  consumers sorted by cumulative write speed
  MWFP  worst-fit insert, consumers sorted by max partition write speed
  MBFP  best-fit insert,  consumers sorted by max partition write speed

Faithful to Algorithm 1 line by line, including its break semantics:

* consumers are processed in sorted order (non-increasing key);
* per consumer, its partitions are sorted decreasing and tried
  **smallest -> biggest** against the bins already created for the next
  iteration (``assignOpenBin``; no bin creation) -- first failure breaks;
* if partitions remain, the consumer's *own* bin is created
  (``createConsumer(c)`` -- the bin keeps the consumer's name, which is what
  makes the family rebalance-frugal) and the remaining partitions are
  inserted **biggest -> smallest** -- first failure breaks, all leftovers
  (including smaller ones that might still have fit) join the unassigned set,
  exactly as the pseudocode's lines 18-25 state;
* finally the unassigned set is sorted decreasing and placed with the fit
  strategy, creating sticky-named bins on demand.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .assignment import ConsumerId, PackResult, PartitionId
from .binpack import Bins

SORT_KEYS = ("cumulative", "max_partition")


def _consumer_key(parts: Sequence[PartitionId], speeds: Mapping[PartitionId, float], key: str) -> float:
    vals = [speeds[p] for p in parts if p in speeds]
    if not vals:
        return 0.0
    return float(sum(vals)) if key == "cumulative" else float(max(vals))


def modified_any_fit(
    speeds: Mapping[PartitionId, float],
    capacity: float,
    group: Optional[Mapping[ConsumerId, Sequence[PartitionId]]] = None,
    *,
    fit: str = "best",
    sort_key: str = "cumulative",
    unassigned: Optional[Iterable[PartitionId]] = None,
) -> PackResult:
    """One iteration of Algorithm 1.

    ``group``      -- current consumer-group configuration C (consumer ->
                      partitions).  Partitions no longer present in ``speeds``
                      (deleted upstream) are dropped.
    ``unassigned`` -- currently unassigned partitions U (new partitions, or
                      partitions of failed consumers).  Defaults to every
                      partition in ``speeds`` not covered by ``group``.
    """
    if fit not in ("best", "worst"):
        raise ValueError(f"modified any fit requires 'best' or 'worst', got {fit!r}")
    if sort_key not in SORT_KEYS:
        raise ValueError(f"unknown sort key {sort_key!r}")
    group = {c: [p for p in parts if p in speeds] for c, parts in (group or {}).items()}

    covered = {p for parts in group.values() for p in parts}
    if unassigned is None:
        pending: List[PartitionId] = [p for p in speeds if p not in covered]
    else:
        pending = [p for p in unassigned if p in speeds and p not in covered]

    prev_map = {p: c for c, parts in group.items() for p in parts}
    bins = Bins(capacity, prev=prev_map, sticky=True)

    # line 2: S <- sort C on cumulative or max partition (non-increasing;
    # stable tie-break on consumer id for determinism)
    order = sorted(group, key=lambda c: (-_consumer_key(group[c], speeds, sort_key), c))

    for c in order:                                            # line 3
        pset = sorted(group[c], key=lambda p: -speeds[p])      # lines 4-5 (decreasing)
        if not pset:
            continue
        # lines 6-13: smallest -> biggest into already-created bins
        i = len(pset) - 1
        while i >= 0:
            p = pset[i]
            slot = bins.select_slot(speeds[p], fit)            # assignOpenBin
            if slot is None:
                break                                          # line 9-10
            bins.place(slot, p, speeds[p])
            pset.pop(i)                                        # line 12
            i -= 1
        if not pset:                                           # lines 14-16
            continue
        # line 17: createConsumer(c) -- the consumer's own bin, keeping its name
        own = bins.create_empty(c)
        # lines 18-24: biggest -> smallest into the own bin, break on failure.
        # Oversized exception (w > C, possible under Eq. 11 streams): an item
        # that can never satisfy Eq. 6 is allowed to occupy its own *empty*
        # bin -- otherwise it would bounce through U into a renamed bin and
        # register as a phantom migration every iteration.
        while pset:
            p = pset[0]
            ok = bins.fits(own, speeds[p]) or (
                bins.loads[own] == 0.0 and speeds[p] > bins.capacity)
            if not ok:
                break                                          # lines 20-21
            bins.place(own, p, speeds[p])
            pset.pop(0)                                        # line 23
        pending.extend(pset)                                   # line 25

    # lines 27-29: decreasing any-fit over the unassigned set
    pending.sort(key=lambda p: -speeds[p])
    for p in pending:
        bins.assign_any_fit(p, speeds[p], fit)

    return bins.result()


def _member(fit: str, sort_key: str):
    def algo(speeds, capacity, prev=None, sticky: bool = True, unassigned=None,
             group=None):
        if group is None and prev is not None:
            from .assignment import group_view
            group = group_view(prev)
        return modified_any_fit(speeds, capacity, group, fit=fit,
                                sort_key=sort_key, unassigned=unassigned)
    algo.__name__ = f"M{'B' if fit == 'best' else 'W'}F{'P' if sort_key == 'max_partition' else ''}"
    return algo


mwf = _member("worst", "cumulative")
mbf = _member("best", "cumulative")
mwfp = _member("worst", "max_partition")
mbfp = _member("best", "max_partition")

MODIFIED = {"MWF": mwf, "MBF": mbf, "MWFP": mwfp, "MBFP": mbfp}


def __getattr__(name: str):
    # deprecation shim: the combined name->callable table is now derived
    # from the registry (tests/test_registry.py pins the warning)
    if name == "ALL_ALGORITHMS":
        from repro_torch.registry import (PACKER_FAMILIES, list_policies,
                                          packer_for)
        from repro_torch.registry.compat import warn_deprecated

        warn_deprecated(__name__, "ALL_ALGORITHMS",
                        "repro_torch.registry.packer_for(name, backend='py')")
        return {n: packer_for(n, backend="py")
                for n in list_policies(family=PACKER_FAMILIES, backend="py")}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

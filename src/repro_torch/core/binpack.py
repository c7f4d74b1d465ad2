"""Classical bin-packing approximation algorithms (paper Sec. II-B)
plus the rebalance-aware "sticky" adaptation of Sec. IV-C: the
pure-Python packers behind the ``py`` backend, a copy of
``repro.core.binpack``.

All algorithms share one packing engine; they differ only in

* the *fit strategy* used to select an open bin
  (``next`` / ``first`` / ``best`` / ``worst``), and
* whether the item list is pre-sorted in non-increasing order
  (the "Decreasing" offline variants).

Sticky adaptation (Sec. IV-C, quoted): "If the consumer that is currently
assigned to the partition has not yet been created in the future assignment,
this is the bin that is created, otherwise, the lowest index bin that does
not yet exist is the one created."  This never changes the number of bins an
algorithm uses -- it only renames newly created bins -- but it reduces the
Rscore because a partition whose bin keeps its old name was not migrated.

Oversized items (w > C, possible under the paper's stream model Eq. 11) can
never satisfy Eq. 6; they receive a dedicated bin that is allowed to
overflow.  Nothing else ever fits next to them (load already >= C), so the
remaining invariants are untouched.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .assignment import ConsumerId, PackResult, PartitionId

FIT_STRATEGIES = ("next", "first", "best", "worst")


class Bins:
    """Mutable list of open bins with the Sec. IV-C naming rule."""

    def __init__(
        self,
        capacity: float,
        prev: Optional[Mapping[PartitionId, ConsumerId]] = None,
        sticky: bool = True,
    ):
        self.capacity = float(capacity)
        self.prev = dict(prev or {})
        self.sticky = bool(sticky)
        self.loads: List[float] = []          # indexed by creation slot
        self.names: List[ConsumerId] = []     # slot -> bin name
        self._used_names: set = set()
        self.pid_to_bin: Dict[PartitionId, ConsumerId] = {}

    # -- naming ------------------------------------------------------------
    def _fresh_name(self, pid: PartitionId) -> ConsumerId:
        if self.sticky:
            c = self.prev.get(pid)
            if c is not None and c not in self._used_names:
                return c
        i = 0
        while i in self._used_names:
            i += 1
        return i

    # -- queries -----------------------------------------------------------
    def fits(self, slot: int, w: float) -> bool:
        return self.loads[slot] + w <= self.capacity

    def select_slot(self, w: float, strategy: str) -> Optional[int]:
        """Pick an open bin for an item of size ``w`` or None if nothing fits.

        Ties break toward the lowest creation slot (left-most bin), matching
        both the paper's list-of-bins semantics and ``argmin``/``argmax``
        first-occurrence semantics of the JAX implementation.
        """
        if strategy == "next":
            if self.loads and self.fits(len(self.loads) - 1, w):
                return len(self.loads) - 1
            return None
        best: Optional[int] = None
        for slot, load in enumerate(self.loads):
            if load + w > self.capacity:
                continue
            if strategy == "first":
                return slot
            if best is None:
                best = slot
            elif strategy == "best" and load > self.loads[best]:
                best = slot            # tightest fit = max load among fitting
            elif strategy == "worst" and load < self.loads[best]:
                best = slot            # most slack = min load among fitting
        return best

    # -- mutation ----------------------------------------------------------
    def place(self, slot: int, pid: PartitionId, w: float) -> None:
        self.loads[slot] += w
        self.pid_to_bin[pid] = self.names[slot]

    def create(self, pid: PartitionId, w: float, name: Optional[ConsumerId] = None) -> int:
        """Open a new bin (named per Sec. IV-C unless forced) holding ``pid``."""
        if name is None:
            name = self._fresh_name(pid)
        assert name not in self._used_names, f"bin name {name!r} already exists"
        slot = len(self.loads)
        self.loads.append(0.0)
        self.names.append(name)
        self._used_names.add(name)
        self.place(slot, pid, w)
        return slot

    def create_empty(self, name: ConsumerId) -> int:
        assert name not in self._used_names, f"bin name {name!r} already exists"
        slot = len(self.loads)
        self.loads.append(0.0)
        self.names.append(name)
        self._used_names.add(name)
        return slot

    def assign_any_fit(self, pid: PartitionId, w: float, strategy: str) -> int:
        """Any-fit insert: selected open bin, else a freshly created bin."""
        slot = self.select_slot(w, strategy)
        if slot is None:
            return self.create(pid, w)
        self.place(slot, pid, w)
        return slot

    def result(self) -> PackResult:
        return PackResult(
            pid_to_bin=dict(self.pid_to_bin),
            loads={self.names[s]: self.loads[s] for s in range(len(self.loads))},
            creation_order=list(self.names),
        )


def _as_items(items) -> List[Tuple[PartitionId, float]]:
    if isinstance(items, Mapping):
        return list(items.items())
    return [(pid, float(w)) for pid, w in items]


def pack(
    items,
    capacity: float,
    *,
    strategy: str = "first",
    decreasing: bool = False,
    prev: Optional[Mapping[PartitionId, ConsumerId]] = None,
    sticky: bool = True,
) -> PackResult:
    """Run one classical bin-packing pass.

    ``items`` -- mapping pid -> write speed, or sequence of (pid, speed).
    Sequence order is the online arrival order; ``decreasing=True`` applies
    the offline non-increasing pre-sort (stable, so equal speeds keep their
    arrival order).
    """
    if strategy not in FIT_STRATEGIES:
        raise ValueError(f"unknown fit strategy {strategy!r}")
    lst = _as_items(items)
    if decreasing:
        lst = sorted(lst, key=lambda kv: -kv[1])
    bins = Bins(capacity, prev=prev, sticky=sticky)
    for pid, w in lst:
        bins.assign_any_fit(pid, w, strategy)
    return bins.result()


# -- the paper's eight classical baselines ---------------------------------

def _make(strategy: str, decreasing: bool):
    def algo(speeds, capacity, prev=None, sticky: bool = True, unassigned=None):
        # `unassigned` accepted for signature compatibility with the modified
        # family (classical algorithms repack everything each iteration).
        return pack(speeds, capacity, strategy=strategy, decreasing=decreasing,
                    prev=prev, sticky=sticky)
    algo.__name__ = ("" if not decreasing else "") + strategy
    return algo


next_fit = _make("next", False)
next_fit_decreasing = _make("next", True)
first_fit = _make("first", False)
first_fit_decreasing = _make("first", True)
best_fit = _make("best", False)
best_fit_decreasing = _make("best", True)
worst_fit = _make("worst", False)
worst_fit_decreasing = _make("worst", True)

CLASSICAL = {
    "NF": next_fit,
    "NFD": next_fit_decreasing,
    "FF": first_fit,
    "FFD": first_fit_decreasing,
    "BF": best_fit,
    "BFD": best_fit_decreasing,
    "WF": worst_fit,
    "WFD": worst_fit_decreasing,
}

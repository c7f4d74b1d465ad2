"""Rscore -- the paper's rebalance-cost metric (Eq. 10), over dicts.

    R_i = (1/C) * sum_{p in P_i} s(p)

where P_i is the set of partitions rebalanced in iteration i and s(p) the
partition's current write speed.  A copy of ``repro.core.rscore``: the
sum runs in Python floats over the moved set, as the reference's does.
"""
from __future__ import annotations

from typing import Container, Mapping, Optional, Set

from .assignment import ConsumerId, PartitionId, rebalanced_partitions


def rscore(
    prev: Mapping[PartitionId, ConsumerId],
    new: Mapping[PartitionId, ConsumerId],
    speeds: Mapping[PartitionId, float],
    capacity: float,
    *,
    missing: str = "zero",
    active: Optional[Container[PartitionId]] = None,
) -> float:
    """Eq. 10 between two assignments.

    ``active`` (optional): the set of partitions that currently exist.
    A partition outside it never counts as rebalanced -- a deleted
    topic's hand-off stalls nothing (its consumer simply stops reading),
    matching the masked array contract where dead partitions assign to
    ``-1``.
    """
    moved = rebalanced_partitions(prev, new)
    if active is not None:
        moved = {p for p in moved if p in active}
    return rscore_of_set(moved, speeds, capacity, missing=missing)


def rscore_of_set(
    moved: Set[PartitionId],
    speeds: Mapping[PartitionId, float],
    capacity: float,
    *,
    missing: str = "zero",
) -> float:
    """Eq. 10 over an explicit moved-set.

    ``missing`` fixes the contract for partitions in ``moved`` that have
    no entry in ``speeds``: ``"zero"`` (default) counts them as speed 0.0
    (the monitor has no sample yet for a partition that appeared
    mid-iteration, and a never-measured partition has consumed nothing a
    hand-off could stall); ``"raise"`` raises ``KeyError`` naming every
    uncovered partition, for callers whose speed maps must be total.
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    if missing not in ("zero", "raise"):
        raise ValueError(
            f"missing must be 'zero' or 'raise', got {missing!r}")
    if missing == "raise":
        unknown = [p for p in moved if p not in speeds]
        if unknown:
            raise KeyError(
                f"no write-speed sample for rebalanced partitions "
                f"{sorted(unknown, key=repr)!r}; pass missing='zero' to "
                f"count them as 0 (the monitor-gap contract)")
    return float(sum(speeds.get(p, 0.0) for p in moved)) / float(capacity)


def recovery_iterations(r: float, rebalance_seconds: float) -> float:
    """Max consumer iterations to recover the backlog accumulated while
    rebalancing (Sec. IV-A: 'the combination of the time it took to
    rebalance ... and the Rscore')."""
    return r * rebalance_seconds

"""Shared assignment/state dataclasses for the bin-packing autoscaler (a
copy of ``repro.core.assignment``).

Terminology follows the paper (Landau et al., 2022):

* partition  -- an ordered queue (Kafka partition / request stream / data
  shard).  Identified by any hashable id.
* consumer   -- a bin.  Identified by a non-negative int ("bin index"; the
  paper's list-of-bins is indexed left to right).
* assignment -- map partition -> consumer.  Exactly one consumer per
  partition (paper Eq. 7); a consumer may hold many partitions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Iterable, List, Mapping, Sequence, Set

PartitionId = Hashable
ConsumerId = int


@dataclasses.dataclass
class PackResult:
    """Outcome of one bin-packing iteration.

    ``pid_to_bin`` maps each partition to the *name* of its bin.  Bin names
    are consumer ids: with the sticky adaptation (paper Sec. IV-C) a newly
    created bin takes the name of the partition's previous consumer when that
    name is still free, so a partition that stays put is not counted as
    rebalanced.
    """

    pid_to_bin: Dict[PartitionId, ConsumerId]
    loads: Dict[ConsumerId, float]
    creation_order: List[ConsumerId]

    @property
    def n_bins(self) -> int:
        return len(self.creation_order)

    def bins(self) -> Dict[ConsumerId, List[PartitionId]]:
        out: Dict[ConsumerId, List[PartitionId]] = {c: [] for c in self.creation_order}
        for pid, cid in self.pid_to_bin.items():
            out[cid].append(pid)
        return out

    def composition(self) -> Set[frozenset]:
        """Multiset-as-set of bin contents (names stripped) for equivalence tests."""
        return {frozenset(ps) for ps in self.bins().values()}


def rebalanced_partitions(
    prev: Mapping[PartitionId, ConsumerId],
    new: Mapping[PartitionId, ConsumerId],
) -> Set[PartitionId]:
    """Partitions whose consumer changed between two iterations.

    A partition that was previously unassigned incurs no stop->start hand-off
    (nobody has to stop reading it), so only partitions present in *both*
    assignments with a different consumer count as rebalanced.
    """
    return {p for p, c in new.items() if p in prev and prev[p] != c}


def group_view(assignment: Mapping[PartitionId, ConsumerId]) -> Dict[ConsumerId, List[PartitionId]]:
    """Invert a partition->consumer map into the controller's group view."""
    try:
        pids = sorted(assignment)
    except TypeError:  # mixed / unorderable pid types
        pids = sorted(assignment, key=repr)
    out: Dict[ConsumerId, List[PartitionId]] = {}
    for pid in pids:
        out.setdefault(assignment[pid], []).append(pid)
    return out


def total_load(loads: Mapping[ConsumerId, float]) -> float:
    return float(sum(loads.values()))


def capacity_lower_bound(speeds: Iterable[float], capacity: float) -> int:
    """L1 lower bound ceil(sum w / C) on the number of bins."""
    total = float(sum(speeds))
    if total <= 0.0:
        return 0
    import math

    return int(math.ceil(total / capacity - 1e-12))

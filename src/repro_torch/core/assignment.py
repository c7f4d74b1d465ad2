"""Assignment helpers shared by the R-score (a copy of what
``repro.core.assignment`` gives ``rscore``).

A partition is identified by any hashable id; a consumer (a bin) by a
non-negative int; an assignment maps partition -> consumer.
"""
from __future__ import annotations

from typing import Hashable, Mapping, Set

PartitionId = Hashable
ConsumerId = int


def rebalanced_partitions(
    prev: Mapping[PartitionId, ConsumerId],
    new: Mapping[PartitionId, ConsumerId],
) -> Set[PartitionId]:
    """Partitions whose consumer changed between two iterations.

    A partition that was previously unassigned incurs no stop->start
    hand-off (nobody has to stop reading it), so only partitions present
    in *both* assignments with a different consumer count as rebalanced.
    """
    return {p for p, c in new.items() if p in prev and prev[p] != c}

"""In-process broker with Kafka's ordering/offset/single-reader semantics
(a copy of ``repro.broker.sim``).

One change: each partition keeps a running prefix of its records' byte
counts, so ``bytes_between`` (and with it ``Broker.lag``, which the
closed loop calls for every partition on every tick) is O(1) instead of
a sum over the backlog.  It returns the same integer, slice semantics
included."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

from .clock import Clock, SimClock


class TopicPartition(NamedTuple):
    """String-integer pair identifying any partition within a topic (Sec. V-A)."""

    topic: str
    partition: int


@dataclasses.dataclass
class Record:
    offset: int
    timestamp: float
    key: Optional[str]
    value: Any
    nbytes: int


class Partition:
    """Append-only ordered log."""

    def __init__(self):
        self._log: List[Record] = []
        self._bytes = 0
        self._prefix: List[int] = [0]   # bytes of records [0, i)

    def append(self, timestamp: float, value: Any, key: Optional[str] = None,
               nbytes: Optional[int] = None) -> int:
        if nbytes is None:
            nbytes = len(value) if isinstance(value, (bytes, str)) else 64
        rec = Record(len(self._log), timestamp, key, value, int(nbytes))
        self._log.append(rec)
        self._bytes += rec.nbytes
        self._prefix.append(self._bytes)
        return rec.offset

    def read(self, offset: int, max_records: Optional[int] = None,
             max_bytes: Optional[int] = None) -> List[Record]:
        out: List[Record] = []
        nb = 0
        for rec in self._log[offset:]:
            if max_records is not None and len(out) >= max_records:
                break
            if max_bytes is not None and out and nb + rec.nbytes > max_bytes:
                break
            out.append(rec)
            nb += rec.nbytes
        return out

    @property
    def end_offset(self) -> int:
        return len(self._log)

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def bytes_between(self, lo_offset: int, hi_offset: int) -> int:
        """Bytes of ``self._log[lo_offset:hi_offset]`` in O(1)."""
        lo, hi, _ = slice(lo_offset, hi_offset).indices(len(self._log))
        return self._prefix[hi] - self._prefix[lo] if hi > lo else 0


class Topic:
    def __init__(self, name: str, n_partitions: int):
        self.name = name
        self.partitions: List[Partition] = [Partition() for _ in range(n_partitions)]

    def ensure(self, idx: int) -> Partition:
        while idx >= len(self.partitions):
            self.partitions.append(Partition())
        return self.partitions[idx]


class ConsumerHandle:
    """A group member's read handle over its assigned partitions.

    The broker enforces the paper's invariant: at most one member of a group
    reads a partition at any time (two-phase migration relies on this).
    """

    def __init__(self, broker: "Broker", group: str, member: str):
        self.broker = broker
        self.group = group
        self.member = member
        self.assigned: set = set()
        self.closed = False

    def assign(self, tp: TopicPartition) -> None:
        self.broker._acquire(self.group, self.member, tp)
        self.assigned.add(tp)

    def unassign(self, tp: TopicPartition) -> None:
        if tp in self.assigned:
            self.broker._release(self.group, self.member, tp)
            self.assigned.discard(tp)

    def poll(self, max_bytes: int) -> Dict[TopicPartition, List[Record]]:
        """Fetch records round-robin from assigned partitions up to max_bytes."""
        out: Dict[TopicPartition, List[Record]] = {}
        budget = max_bytes
        for tp in sorted(self.assigned):
            if budget <= 0:
                break
            part = self.broker.partition(tp)
            off = self.broker.committed(self.group, tp)
            recs = part.read(off, max_bytes=budget)
            if recs:
                out[tp] = recs
                budget -= sum(r.nbytes for r in recs)
        return out

    def commit(self, tp: TopicPartition, offset: int) -> None:
        self.broker.commit(self.group, tp, offset)

    def close(self) -> None:
        for tp in list(self.assigned):
            self.unassign(tp)
        self.closed = True


class Broker:
    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or SimClock()
        self.topics: Dict[str, Topic] = {}
        self._offsets: Dict[Tuple[str, TopicPartition], int] = {}
        self._readers: Dict[Tuple[str, TopicPartition], str] = {}

    # -- admin ---------------------------------------------------------------
    def create_topic(self, name: str, n_partitions: int) -> Topic:
        if name not in self.topics:
            self.topics[name] = Topic(name, n_partitions)
        return self.topics[name]

    def partition(self, tp: TopicPartition) -> Partition:
        return self.topics[tp.topic].ensure(tp.partition)

    def describe_log_dirs(self, topics: Optional[Iterable[str]] = None
                          ) -> Dict[TopicPartition, int]:
        """Bytes per TopicPartition -- AdminClient.describeLogDirs() analogue."""
        out: Dict[TopicPartition, int] = {}
        for name, topic in self.topics.items():
            if topics is not None and name not in topics:
                continue
            for i, p in enumerate(topic.partitions):
                out[TopicPartition(name, i)] = p.size_bytes
        return out

    # -- produce/consume -----------------------------------------------------
    def produce(self, tp: TopicPartition, value: Any, key: Optional[str] = None,
                nbytes: Optional[int] = None) -> int:
        return self.partition(tp).append(self.clock.now(), value, key, nbytes)

    def consumer(self, group: str, member: str) -> ConsumerHandle:
        return ConsumerHandle(self, group, member)

    def committed(self, group: str, tp: TopicPartition) -> int:
        return self._offsets.get((group, tp), 0)

    def commit(self, group: str, tp: TopicPartition, offset: int) -> None:
        self._offsets[(group, tp)] = max(offset, self.committed(group, tp))

    def lag(self, group: str, tp: TopicPartition) -> int:
        part = self.partition(tp)
        return part.bytes_between(self.committed(group, tp), part.end_offset)

    def total_lag(self, group: str, topic: str) -> int:
        t = self.topics[topic]
        return sum(self.lag(group, TopicPartition(topic, i))
                   for i in range(len(t.partitions)))

    # -- single-reader enforcement --------------------------------------------
    def _acquire(self, group: str, member: str, tp: TopicPartition) -> None:
        holder = self._readers.get((group, tp))
        if holder is not None and holder != member:
            raise RuntimeError(
                f"partition {tp} already read by {holder!r} in group {group!r}; "
                f"{member!r} must wait for the stop->ack hand-off")
        self._readers[(group, tp)] = member

    def _release(self, group: str, member: str, tp: TopicPartition) -> None:
        if self._readers.get((group, tp)) == member:
            del self._readers[(group, tp)]

    def reader_of(self, group: str, tp: TopicPartition) -> Optional[str]:
        return self._readers.get((group, tp))

    def expel(self, group: str, member: str) -> None:
        """Group-coordinator eviction of a dead member: frees all the
        partitions it held so survivors can take over (committed offsets are
        retained, so no data is lost -- it is re-read from the last commit)."""
        for (g, tp), holder in list(self._readers.items()):
            if g == group and holder == member:
                del self._readers[(g, tp)]

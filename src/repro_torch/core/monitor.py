"""Monitor process (paper Sec. V-A).

Samples each partition's log size via ``describe_log_dirs()``, keeps a 30 s
sliding window of (timestamp, size) pairs per partition, estimates the write
speed as (latest - earliest) / window span, and publishes the measurement map
to the ``monitor.writeSpeed`` topic for the controller.  A copy of
``repro.core.monitor``; host code.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Deque, Dict, Iterable, Optional, Tuple

from repro_torch.broker import Broker, TopicPartition

WRITE_SPEED_TOPIC = "monitor.writeSpeed"
DEFAULT_WINDOW_SECS = 30.0


@dataclasses.dataclass
class Measurement:
    """One measurement map: write speed (bytes/s) per partition, stamped."""

    timestamp: float
    speeds: Dict[TopicPartition, float]

    def to_record(self) -> str:
        return json.dumps({
            "timestamp": self.timestamp,
            "speeds": [[tp.topic, tp.partition, s] for tp, s in self.speeds.items()],
        })

    @staticmethod
    def from_record(raw: str) -> "Measurement":
        d = json.loads(raw)
        return Measurement(
            timestamp=d["timestamp"],
            speeds={TopicPartition(t, int(p)): float(s) for t, p, s in d["speeds"]},
        )


class Monitor:
    def __init__(
        self,
        broker: Broker,
        topics: Iterable[str],
        window_secs: float = DEFAULT_WINDOW_SECS,
        publish: bool = True,
    ):
        self.broker = broker
        self.topics = list(topics)
        self.window = float(window_secs)
        self.publish = publish
        self._samples: Dict[TopicPartition, Deque[Tuple[float, int]]] = {}
        if publish:
            broker.create_topic(WRITE_SPEED_TOPIC, 1)

    def sample(self) -> Measurement:
        """Query partition sizes, update windows, publish + return speeds."""
        now = self.broker.clock.now()
        sizes = self.broker.describe_log_dirs(self.topics)
        speeds: Dict[TopicPartition, float] = {}
        for tp, size in sizes.items():
            q = self._samples.setdefault(tp, deque())
            q.append((now, size))
            # queries older than the window are guaranteed to be at the front
            while q and q[0][0] < now - self.window:
                q.popleft()
            t0, s0 = q[0]
            t1, s1 = q[-1]
            span = t1 - t0
            speeds[tp] = (s1 - s0) / span if span > 0 else 0.0
        m = Measurement(now, speeds)
        if self.publish:
            rec = m.to_record()
            self.broker.produce(TopicPartition(WRITE_SPEED_TOPIC, 0), rec,
                                nbytes=len(rec))
        return m


def read_latest_measurement(broker: Broker, group: str = "controller"
                            ) -> Optional[Measurement]:
    """Controller-side: drain monitor.writeSpeed, return the newest map."""
    tp = TopicPartition(WRITE_SPEED_TOPIC, 0)
    if WRITE_SPEED_TOPIC not in broker.topics:
        return None
    part = broker.partition(tp)
    off = broker.committed(group, tp)
    recs = part.read(off)
    if not recs:
        return None
    broker.commit(group, tp, recs[-1].offset + 1)
    return Measurement.from_record(recs[-1].value)

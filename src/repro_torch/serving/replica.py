"""Consumer replica (paper Sec. V-B, Fig. 4).

Each replica cycles through four phases:

  1. fetch up to BATCH_BYTES from its assigned partitions (or give up after
     WAIT_TIME_SECS);
  2. process records, batching by topic (one destination table per topic);
  3. asynchronously insert each topic batch into the data lake (``Sink``);
  4. drain its metadata mailbox, apply state changes (start/stop/shutdown/
     report), persist its state, and ack to the controller.

In this container the replica is driven by a simulated clock: ``step(dt)``
performs one cycle with a byte budget ``rate * dt`` (the paper's consumer
works at a constant max rate C when saturated -- the SBSBP capacity
assumption, validated in their Fig. 10 and in our capacity-calibration
benchmark).  ``rate_factor`` < 1 models a straggler.

A copy of ``repro.serving.replica``; host code.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from repro_torch.broker import Broker, ConsumerHandle, TopicPartition
from repro_torch.core.controller import CONTROLLER_INBOX, consumer_mailbox


class Sink:
    """Data-lake stand-in: one 'table' per topic."""

    def __init__(self):
        self.tables: Dict[str, int] = {}
        self.records: Dict[str, int] = {}

    def insert(self, topic: str, nbytes: int, nrecords: int) -> None:
        self.tables[topic] = self.tables.get(topic, 0) + nbytes
        self.records[topic] = self.records.get(topic, 0) + nrecords


@dataclasses.dataclass
class ReplicaConfig:
    batch_bytes: int = 1 << 20         # BATCH_BYTES
    wait_time_secs: float = 1.0        # WAIT_TIME_SECS
    rate: float = 2.3e6                # max consumption rate C (bytes/s)
    group: str = "autoscaler"


class Replica:
    def __init__(self, cid: int, broker: Broker, sink: Sink,
                 config: Optional[ReplicaConfig] = None, rate_factor: float = 1.0):
        self.cid = int(cid)
        self.broker = broker
        self.sink = sink
        self.cfg = config or ReplicaConfig()
        self.rate_factor = float(rate_factor)
        self.member = f"consumer-{self.cid}"
        self.handle: ConsumerHandle = broker.consumer(self.cfg.group, self.member)
        self.mailbox = consumer_mailbox(self.cid)
        self._meta_group = f"meta-{self.cid}"
        # A fresh incarnation must not replay state changes addressed to a
        # previous incarnation of this consumer id (stale start/stop would
        # break the single-reader invariant): seek the mailbox to latest.
        # The controller (re)sends everything relevant after creating us.
        broker.create_topic(self.mailbox.topic, 1)
        end = broker.partition(self.mailbox).end_offset
        broker.commit(self._meta_group, self.mailbox, end)
        self.alive = True
        self.crashed = False
        self._carry = 0.0              # unused byte budget carried across steps
        self.consumed_bytes = 0
        self.last_rate = 0.0
        self.backlog_hint = 0

    # ------------------------------------------------------------------ io
    def _send(self, msg: dict) -> None:
        msg = dict(msg, consumer=self.cid)
        raw = json.dumps(msg)
        self.broker.produce(CONTROLLER_INBOX, raw, nbytes=len(raw))

    def _read_metadata(self) -> List[dict]:
        part = self.broker.partition(self.mailbox)
        off = self.broker.committed(self._meta_group, self.mailbox)
        recs = part.read(off)
        if recs:
            self.broker.commit(self._meta_group, self.mailbox, recs[-1].offset + 1)
        return [json.loads(r.value) for r in recs]

    def persisted_metadata(self) -> str:
        return json.dumps({"consumer": self.cid,
                           "partitions": [[tp.topic, tp.partition]
                                          for tp in sorted(self.handle.assigned)]})

    # ---------------------------------------------------------------- cycle
    def step(self, dt: float) -> int:
        """One consumer cycle with a byte budget of rate*dt.  Returns bytes
        consumed."""
        if not self.alive or self.crashed:
            return 0
        budget = self.cfg.rate * self.rate_factor * dt + self._carry
        consumed = 0

        # phase 1: fetch up to BATCH_BYTES (bounded by the rate budget)
        fetch_cap = int(min(self.cfg.batch_bytes, budget))
        batches = self.handle.poll(fetch_cap) if fetch_cap > 0 else {}

        # phase 2: process + batch per topic (destination table per topic)
        per_topic: Dict[str, List] = {}
        for tp, recs in batches.items():
            per_topic.setdefault(tp.topic, []).extend(recs)

        # phase 3: async insert per topic table
        for topic, recs in per_topic.items():
            nbytes = sum(r.nbytes for r in recs)
            self.sink.insert(topic, nbytes, len(recs))
            consumed += nbytes
        # at-least-once: commit only after the sink accepted the batch
        for tp, recs in batches.items():
            self.handle.commit(tp, recs[-1].offset + 1)

        self._carry = min(budget - consumed, self.cfg.rate * self.rate_factor)
        self.consumed_bytes += consumed
        self.last_rate = consumed / dt if dt > 0 else 0.0
        self.backlog_hint = sum(self.broker.lag(self.cfg.group, tp)
                                for tp in self.handle.assigned)

        # phase 4: metadata queue -> update state, persist, ack
        for msg in self._read_metadata():
            self._apply_metadata(msg)

        if self.alive:
            self._send({"type": "heartbeat",
                        "stats": {"rate": self.last_rate,
                                  "backlog": self.backlog_hint,
                                  "capacity": self.cfg.rate * self.rate_factor}})
        return consumed

    def _apply_metadata(self, msg: dict) -> None:
        typ = msg["type"]
        if typ == "stop":
            tps = [TopicPartition(t, int(p)) for t, p in msg["partitions"]]
            for tp in tps:
                self.handle.unassign(tp)
            self.persisted_metadata()
            self._send({"type": "stopped",
                        "partitions": [[tp.topic, tp.partition] for tp in tps]})
        elif typ == "start":
            tps = [TopicPartition(t, int(p)) for t, p in msg["partitions"]]
            for tp in tps:
                self.handle.assign(tp)
            self.persisted_metadata()
            self._send({"type": "started",
                        "partitions": [[tp.topic, tp.partition] for tp in tps]})
        elif typ == "report_state":
            self._send({"type": "state_report",
                        "partitions": [[tp.topic, tp.partition]
                                       for tp in sorted(self.handle.assigned)]})
        elif typ == "shutdown":
            self.handle.close()
            self.alive = False
            self._send({"type": "shutdown_ack"})

    # ------------------------------------------------------------- failures
    def crash(self) -> None:
        """Hard failure: stops processing *without* releasing partitions --
        the controller must detect the missing heartbeats, expel the member
        via the group coordinator, and repack its partitions."""
        self.crashed = True

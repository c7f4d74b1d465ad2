"""Controller (paper Sec. V-C): orchestrates the consumer group.

State machine (Fig. 5):  SENTINEL -> REASSIGN -> GROUP_MANAGEMENT -> SENTINEL,
with SYNCHRONIZE on start-up / recovery.

* SENTINEL        -- ingest monitor measurements + consumer acks/heartbeats,
                     detect dead consumers, evaluate the exit conditions.
* REASSIGN        -- run the configured bin-packing algorithm on the current
                     write speeds given the current assignment.
* GROUP_MANAGEMENT-- compute the state diff (consumers to create, partitions
                     to stop/start per consumer, consumers to decommission)
                     and drive the **two-phase synchronous migration**: a
                     partition's `start` is only sent after the previous
                     owner's `stop` is acknowledged, so at most one consumer
                     of the group ever reads a partition (broker enforces it).
* SYNCHRONIZE     -- reconcile perceived state with the consumers' persisted
                     state (crash recovery).

Communication (Fig. 3): topic ``consumer.metadata``; partition 0 is the
controller inbox, partition N+1 is consumer N's mailbox -- every byte a
consumer reads is relevant to it (the paper's "efficient communication
model").

A copy of ``repro.core.controller`` on the port's registry: the packer is
the ``py`` one-shot packer (``packer_for(name, backend="py")``; the
port's ``packer_for`` defaults to ``torch``), so the controller runs on
the host and touches no device.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple

from repro_torch.broker import Broker, TopicPartition

from repro_torch.registry import PACKER_FAMILIES, list_policies, packer_for

from .assignment import ConsumerId, PackResult, rebalanced_partitions
from .rscore import rscore_of_set

METADATA_TOPIC = "consumer.metadata"
CONTROLLER_PARTITION = 0


def consumer_mailbox(cid: ConsumerId) -> TopicPartition:
    return TopicPartition(METADATA_TOPIC, int(cid) + 1)


CONTROLLER_INBOX = TopicPartition(METADATA_TOPIC, CONTROLLER_PARTITION)


def _tp_key(tp: TopicPartition) -> List:
    return [tp.topic, tp.partition]


def _tp_from(raw) -> TopicPartition:
    return TopicPartition(raw[0], int(raw[1]))


class ControllerState(enum.Enum):
    SYNCHRONIZE = "synchronize"
    SENTINEL = "sentinel"
    REASSIGN = "reassign"
    GROUP_MANAGEMENT = "group_management"


@dataclasses.dataclass
class StateDiff:
    """Difference between current and desired group state (Sec. V-C)."""

    to_create: List[ConsumerId]
    to_stop: Dict[ConsumerId, List[TopicPartition]]
    to_start: Dict[ConsumerId, List[TopicPartition]]
    to_delete: List[ConsumerId]

    @property
    def is_empty(self) -> bool:
        return not (self.to_create or self.to_stop or self.to_start or self.to_delete)


def state_diff(
    current: Mapping[TopicPartition, ConsumerId],
    desired: Mapping[TopicPartition, ConsumerId],
    live_consumers: Set[ConsumerId],
) -> StateDiff:
    to_create = sorted({c for c in desired.values() if c not in live_consumers})
    to_stop: Dict[ConsumerId, List[TopicPartition]] = {}
    to_start: Dict[ConsumerId, List[TopicPartition]] = {}
    for tp, new_c in desired.items():
        old_c = current.get(tp)
        if old_c == new_c:
            continue
        if old_c is not None:
            to_stop.setdefault(old_c, []).append(tp)
        to_start.setdefault(new_c, []).append(tp)
    keep = set(desired.values())
    to_delete = sorted(c for c in live_consumers if c not in keep)
    for d in (to_stop, to_start):
        for v in d.values():
            v.sort()
    return StateDiff(to_create, to_stop, to_start, to_delete)


@dataclasses.dataclass
class MigrationRecord:
    """Bookkeeping of one reassignment for Rscore accounting / tests."""

    iteration: int
    started_at: float
    rscore: float
    moved: Set[TopicPartition]
    n_bins: int
    finished_at: Optional[float] = None

    @property
    def duration(self) -> Optional[float]:
        return None if self.finished_at is None else self.finished_at - self.started_at


class ReplicaManagerProtocol:
    """Replica lifecycle (the paper's Kubernetes deployments)."""

    def create(self, cid: ConsumerId) -> None:
        raise NotImplementedError

    def delete(self, cid: ConsumerId) -> None:
        raise NotImplementedError

    def list(self) -> Set[ConsumerId]:
        raise NotImplementedError


@dataclasses.dataclass
class ControllerConfig:
    capacity: float
    algorithm: str = "MBFP"             # paper's best modified variant
    overload_factor: float = 1.0        # consumer load > f*C triggers repack
    scaledown_margin: int = 1           # repack if packer saves >= margin bins
    heartbeat_timeout: float = 60.0
    min_reassign_interval: float = 0.0  # cool-down between repacks
    group: str = "autoscaler"


class Controller:
    def __init__(self, broker: Broker, manager: ReplicaManagerProtocol,
                 config: ControllerConfig):
        self.broker = broker
        self.manager = manager
        self.cfg = config
        if config.algorithm not in list_policies(family=PACKER_FAMILIES,
                                                 backend="py"):
            raise ValueError(f"unknown algorithm {config.algorithm!r}")
        self.algorithm: Callable = packer_for(config.algorithm, backend="py")
        broker.create_topic(METADATA_TOPIC, 1)

        self.state = ControllerState.SYNCHRONIZE
        self.assignment: Dict[TopicPartition, ConsumerId] = {}   # perceived
        self.live: Set[ConsumerId] = set()
        self.speeds: Dict[TopicPartition, float] = {}
        self.last_heartbeat: Dict[ConsumerId, float] = {}
        self.replica_stats: Dict[ConsumerId, dict] = {}
        self.draining: Set[ConsumerId] = set()
        self.iteration = 0
        self.last_reassign_at = -1e18
        self.migrations: List[MigrationRecord] = []
        # in-flight two-phase migration: tp -> ("stop_sent"|"start_sent", old, new)
        self._inflight: Dict[TopicPartition, Tuple[str, Optional[ConsumerId], ConsumerId]] = {}
        self._pending_delete: Set[ConsumerId] = set()
        self._sync_waiting: Set[ConsumerId] = set()

    # ------------------------------------------------------------------ util
    def _send(self, cid: ConsumerId, msg: dict) -> None:
        raw = json.dumps(msg)
        self.broker.produce(consumer_mailbox(cid), raw, nbytes=len(raw))

    def _drain_inbox(self) -> List[dict]:
        part = self.broker.partition(CONTROLLER_INBOX)
        off = self.broker.committed(self.cfg.group, CONTROLLER_INBOX)
        recs = part.read(off)
        if recs:
            self.broker.commit(self.cfg.group, CONTROLLER_INBOX, recs[-1].offset + 1)
        return [json.loads(r.value) for r in recs]

    # -------------------------------------------------------------- sentinel
    def observe_measurement(self, speeds: Mapping[TopicPartition, float]) -> None:
        self.speeds = dict(speeds)

    def _process_inbox(self) -> None:
        now = self.broker.clock.now()
        for msg in self._drain_inbox():
            cid = int(msg["consumer"])
            typ = msg["type"]
            self.last_heartbeat[cid] = now
            if typ == "heartbeat":
                if "stats" in msg:
                    self.replica_stats[cid] = msg["stats"]
                continue
            if typ == "state_report":
                self._sync_waiting.discard(cid)
                self.live.add(cid)
                for raw in msg["partitions"]:
                    self.assignment[_tp_from(raw)] = cid
            elif typ == "stopped":
                for raw in msg["partitions"]:
                    tp = _tp_from(raw)
                    ent = self._inflight.get(tp)
                    if ent and ent[0] == "stop_sent":
                        _, old, new = ent
                        self._send(new, {"type": "start", "partitions": [_tp_key(tp)]})
                        self._inflight[tp] = ("start_sent", old, new)
                    if self.assignment.get(tp) == cid:
                        del self.assignment[tp]
            elif typ == "started":
                for raw in msg["partitions"]:
                    tp = _tp_from(raw)
                    ent = self._inflight.pop(tp, None)
                    self.assignment[tp] = cid
            elif typ == "shutdown_ack":
                self.live.discard(cid)
                self._pending_delete.discard(cid)
                self.manager.delete(cid)

    def _detect_failures(self) -> Set[ConsumerId]:
        now = self.broker.clock.now()
        dead = {c for c in self.live
                if now - self.last_heartbeat.get(c, now) > self.cfg.heartbeat_timeout}
        for c in dead:
            # Kafka group-coordinator semantics: expel the member, freeing its
            # partitions; its decode/read state is rebuilt from committed
            # offsets by whoever inherits the partitions.
            self.broker.expel(self.cfg.group, f"consumer-{c}")
            self.live.discard(c)
            self.manager.delete(c)
            for tp, cid in list(self.assignment.items()):
                if cid == c:
                    del self.assignment[tp]
            # abort in-flight migrations touching the dead consumer
            for tp, (phase, old, new) in list(self._inflight.items()):
                if old == c or new == c:
                    del self._inflight[tp]
        return dead

    def _loads(self) -> Dict[ConsumerId, float]:
        loads: Dict[ConsumerId, float] = {c: 0.0 for c in self.live}
        for tp, cid in self.assignment.items():
            loads[cid] = loads.get(cid, 0.0) + self.speeds.get(tp, 0.0)
        return loads

    def _should_reassign(self) -> bool:
        if self._inflight:
            return False                      # finish the current migration first
        now = self.broker.clock.now()
        if now - self.last_reassign_at < self.cfg.min_reassign_interval:
            return False
        if not self.speeds:
            return False
        unassigned = [tp for tp in self.speeds if tp not in self.assignment]
        if unassigned:
            return True
        if self.draining & set(self.assignment.values()):
            return True
        loads = self._loads()
        if any(l > self.cfg.overload_factor * self.cfg.capacity for l in loads.values()):
            return True
        # scale-down check: would the packer save >= margin bins?
        res = self._pack()
        return res.n_bins <= len([c for c in self.live if c not in self.draining]) \
            - self.cfg.scaledown_margin

    # -------------------------------------------------------------- reassign
    def _pack(self) -> PackResult:
        prev = {tp: c for tp, c in self.assignment.items() if c not in self.draining}
        res = self.algorithm(dict(self.speeds), self.cfg.capacity, prev=prev)
        return self._remap_draining(res)

    def _remap_draining(self, desired: PackResult) -> PackResult:
        """A draining (straggler) consumer must never be reused as a bin:
        rename colliding bins to fresh ids so the drained replica ends up
        with no assignment and is decommissioned."""
        bad = set(desired.pid_to_bin.values()) & self.draining
        if not bad:
            return desired
        used = set(desired.pid_to_bin.values()) | self.live | self.draining
        mapping: Dict[ConsumerId, ConsumerId] = {}
        nxt = 0
        for b in sorted(bad):
            while nxt in used:
                nxt += 1
            mapping[b] = nxt
            used.add(nxt)
        remap = lambda c: mapping.get(c, c)
        return PackResult(
            pid_to_bin={tp: remap(c) for tp, c in desired.pid_to_bin.items()},
            loads={remap(c): l for c, l in desired.loads.items()},
            creation_order=[remap(c) for c in desired.creation_order],
        )

    # ------------------------------------------------------------- lifecycle
    def run_once(self) -> ControllerState:
        """One controller step; returns the state it finished in."""
        self._process_inbox()

        if self.state == ControllerState.SYNCHRONIZE:
            if not self._sync_waiting:
                discovered = self.manager.list()
                if discovered - self.live:
                    self._sync_waiting = set(discovered - self.live)
                    for cid in self._sync_waiting:
                        self._send(cid, {"type": "report_state"})
                    return self.state
                self.state = ControllerState.SENTINEL
            return self.state

        self._detect_failures()

        if self.state == ControllerState.SENTINEL:
            if self._inflight:
                self._finish_migration_if_done()
                return self.state
            if self._should_reassign():
                self.state = ControllerState.REASSIGN
            else:
                return self.state

        if self.state == ControllerState.REASSIGN:
            desired = self._pack()
            self.state = ControllerState.GROUP_MANAGEMENT
            self._apply(desired)
            return self.state

        if self.state == ControllerState.GROUP_MANAGEMENT:
            self._finish_migration_if_done()
            return self.state

        return self.state

    def _apply(self, desired: PackResult) -> None:
        now = self.broker.clock.now()
        diff = state_diff(self.assignment, desired.pid_to_bin, self.live)
        moved = rebalanced_partitions(self.assignment, desired.pid_to_bin)
        self.iteration += 1
        self.migrations.append(MigrationRecord(
            iteration=self.iteration, started_at=now,
            rscore=rscore_of_set(moved, self.speeds, self.cfg.capacity),
            moved=set(moved), n_bins=desired.n_bins))
        self.last_reassign_at = now

        # 1. create new consumer instances (deployment name == mailbox id)
        for cid in diff.to_create:
            self.manager.create(cid)
            self.live.add(cid)
            self.last_heartbeat[cid] = now
        # 2. two-phase migration: stop first; start goes out on stop-ack.
        for tp, new_c in desired.pid_to_bin.items():
            old_c = self.assignment.get(tp)
            if old_c == new_c:
                continue
            if old_c is None or old_c not in self.live:
                # fresh partition (or owner died): start immediately
                self._send(new_c, {"type": "start", "partitions": [_tp_key(tp)]})
                self._inflight[tp] = ("start_sent", None, new_c)
            else:
                self._send(old_c, {"type": "stop", "partitions": [_tp_key(tp)]})
                self._inflight[tp] = ("stop_sent", old_c, new_c)
        # 3. consumers with no assignment are decommissioned once idle
        self._pending_delete |= set(diff.to_delete)
        self.draining -= set(diff.to_delete)
        self.state = ControllerState.GROUP_MANAGEMENT
        self._finish_migration_if_done()

    def _finish_migration_if_done(self) -> None:
        if self._inflight:
            return
        now = self.broker.clock.now()
        if self.migrations and self.migrations[-1].finished_at is None:
            self.migrations[-1].finished_at = now
        for cid in sorted(self._pending_delete):
            if not any(c == cid for c in self.assignment.values()):
                self._send(cid, {"type": "shutdown"})
        self.state = ControllerState.SENTINEL

    # ------------------------------------------------------------ extensions
    def drain(self, cid: ConsumerId) -> None:
        """Straggler mitigation: schedule ``cid`` for repack-away + removal."""
        self.draining.add(cid)

    def check_stragglers(self, rate_threshold: float = 0.5) -> Set[ConsumerId]:
        """Drain replicas whose achieved rate stays below
        ``rate_threshold * C`` while they still have backlog -- i.e. they are
        saturated but underperforming the calibrated capacity (extension of
        the paper's constant-capacity load model)."""
        found = set()
        for cid, stats in self.replica_stats.items():
            if cid not in self.live or cid in self.draining:
                continue
            if stats.get("backlog", 0) > 0 and \
                    stats.get("rate", 0.0) < rate_threshold * self.cfg.capacity:
                self.drain(cid)
                found.add(cid)
        return found

    def persisted_state(self) -> str:
        return json.dumps({
            "assignment": [[_tp_key(tp), cid] for tp, cid in self.assignment.items()],
            "iteration": self.iteration,
        })

    @staticmethod
    def recover(broker: Broker, manager: ReplicaManagerProtocol,
                config: ControllerConfig) -> "Controller":
        """Fresh controller that rebuilds its view via SYNCHRONIZE."""
        return Controller(broker, manager, config)

"""Replica lifecycle management (the paper's Kubernetes deployments).

``SimulatedReplicaManager`` spawns in-process ``Replica`` objects; the
deployment "manifest name" is the replica's mailbox id, mirroring the paper's
``metadata.name`` trick.  On real infrastructure the same protocol would be
backed by the cluster API (one deployment per consumer).

A copy of ``repro.serving.manager``; host code.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Set

from repro_torch.broker import Broker
from repro_torch.core.controller import ReplicaManagerProtocol

from .replica import Replica, ReplicaConfig, Sink


class SimulatedReplicaManager(ReplicaManagerProtocol):
    def __init__(self, broker: Broker, sink: Optional[Sink] = None,
                 config: Optional[ReplicaConfig] = None,
                 replica_factory: Optional[Callable[[int], Replica]] = None):
        self.broker = broker
        self.sink = sink or Sink()
        self.config = config or ReplicaConfig()
        self.replicas: Dict[int, Replica] = {}
        self._factory = replica_factory
        self.created_total = 0
        self.deleted_total = 0

    def create(self, cid: int) -> None:
        existing = self.replicas.get(cid)
        if existing is not None and existing.alive and not existing.crashed:
            return
        if self._factory is not None:
            self.replicas[cid] = self._factory(cid)
        else:
            self.replicas[cid] = Replica(cid, self.broker, self.sink, self.config)
        self.created_total += 1

    def delete(self, cid: int) -> None:
        rep = self.replicas.pop(cid, None)
        if rep is not None:
            rep.alive = False
            self.deleted_total += 1

    def list(self) -> Set[int]:
        return {cid for cid, r in self.replicas.items() if r.alive}

    # -- simulation helpers -------------------------------------------------
    def step_all(self, dt: float) -> int:
        return sum(r.step(dt) for r in list(self.replicas.values()))

    def n_alive(self) -> int:
        return len(self.list())

"""End-to-end autoscaling simulation: producers -> broker -> monitor ->
controller -> replica group (paper Fig. 3), on a simulated clock.

The workload is a per-partition byte-rate function; the driver ticks the
world forward, periodically sampling the monitor and stepping the controller
and replicas, while recording the metrics the paper reports (consumer count,
Rscore per reassignment, consumer-group lag).

A copy of ``repro.serving.simulation``: host code, with the
reference's numpy draws in the reference's order (producer jitter,
``random_walk_rates``), so the same seed gives the same world in both
packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.broker import Broker, SimClock, TopicPartition
from repro_torch.core.controller import Controller, ControllerConfig
from repro_torch.core.monitor import Monitor

from .manager import SimulatedReplicaManager
from .replica import ReplicaConfig, Sink

RateFn = Callable[[TopicPartition, float], float]


@dataclasses.dataclass
class SimMetrics:
    times: List[float] = dataclasses.field(default_factory=list)
    n_replicas: List[int] = dataclasses.field(default_factory=list)
    lag_bytes: List[int] = dataclasses.field(default_factory=list)
    produced: List[int] = dataclasses.field(default_factory=list)
    consumed: List[int] = dataclasses.field(default_factory=list)

    def as_arrays(self):
        return {k: np.asarray(v) for k, v in dataclasses.asdict(self).items()}


class AutoscaleSimulation:
    """Closed-loop world simulation.

    Randomness: ``seed`` drives only this object's producer-side jitter rng
    (``rate_jitter`` below); deterministic workloads (``constant_rates``, or
    any jitter-free ``rate_fn``) are unaffected by it.  Stochastic rate
    functions such as ``random_walk_rates`` carry their *own* seed argument
    -- pass it there, not here.
    """

    def __init__(
        self,
        n_partitions: int,
        rate_fn: RateFn,
        capacity: float = 2.3e6,            # the paper's measured 2.3 MB/s
        algorithm: str = "MBFP",
        topic: str = "sensors",
        record_bytes: int = 512,
        monitor_interval: float = 5.0,
        heartbeat_timeout: float = 30.0,
        min_reassign_interval: float = 0.0,
        overload_factor: float = 1.0,
        seed: int = 0,
        rate_jitter: float = 0.0,           # +-fraction of rate, from ``seed``
    ):
        self.clock = SimClock()
        self.broker = Broker(self.clock)
        self.topic = topic
        self.n_partitions = n_partitions
        self.broker.create_topic(topic, n_partitions)
        self.rate_fn = rate_fn
        self.record_bytes = record_bytes
        self.monitor = Monitor(self.broker, [topic])
        self.sink = Sink()
        self.replica_cfg = ReplicaConfig(rate=capacity)
        self.manager = SimulatedReplicaManager(self.broker, self.sink, self.replica_cfg)
        self.controller = Controller(
            self.broker, self.manager,
            ControllerConfig(capacity=capacity, algorithm=algorithm,
                             heartbeat_timeout=heartbeat_timeout,
                             min_reassign_interval=min_reassign_interval,
                             overload_factor=overload_factor))
        self.monitor_interval = monitor_interval
        self._accum: Dict[int, float] = {i: 0.0 for i in range(n_partitions)}
        self._next_monitor = 0.0
        self.metrics = SimMetrics()
        self.rng = np.random.default_rng(seed)
        self.rate_jitter = float(rate_jitter)
        self.produced_bytes = 0

    # ------------------------------------------------------------------ tick
    def _produce(self, dt: float) -> None:
        t = self.clock.now()
        jitter = (1.0 + self.rate_jitter *
                  self.rng.uniform(-1.0, 1.0, self.n_partitions)
                  if self.rate_jitter else None)
        for i in range(self.n_partitions):
            tp = TopicPartition(self.topic, i)
            rate = max(0.0, self.rate_fn(tp, t))
            if jitter is not None:
                rate = max(0.0, rate * jitter[i])
            self._accum[i] += rate * dt
            while self._accum[i] >= self.record_bytes:
                self.broker.produce(tp, value=b"x" * 0, nbytes=self.record_bytes)
                self._accum[i] -= self.record_bytes
                self.produced_bytes += self.record_bytes

    def tick(self, dt: float = 1.0) -> None:
        self._produce(dt)
        self.clock.advance(dt)
        if self.clock.now() >= self._next_monitor:
            m = self.monitor.sample()
            self.controller.observe_measurement(m.speeds)
            self._next_monitor = self.clock.now() + self.monitor_interval
        self.controller.run_once()
        consumed = self.manager.step_all(dt)
        self.controller.run_once()      # pick up acks promptly
        self.metrics.times.append(self.clock.now())
        self.metrics.n_replicas.append(self.manager.n_alive())
        self.metrics.lag_bytes.append(self.broker.total_lag("autoscaler", self.topic))
        self.metrics.produced.append(self.produced_bytes)
        self.metrics.consumed.append(consumed)

    def run(self, seconds: float, dt: float = 1.0) -> SimMetrics:
        steps = int(round(seconds / dt))
        for _ in range(steps):
            self.tick(dt)
        return self.metrics

    # ------------------------------------------------------------- scenarios
    @staticmethod
    def constant_rates(rates: Sequence[float]) -> RateFn:
        def fn(tp: TopicPartition, t: float) -> float:
            return rates[tp.partition]
        return fn

    @staticmethod
    def random_walk_rates(n: int, capacity: float, delta: float, seed: int = 0,
                          step_every: float = 5.0) -> RateFn:
        """Eq. 11 applied as a continuous workload."""
        rng = np.random.default_rng(seed)
        state = {"t": 0.0, "rates": rng.uniform(0, capacity, n)}

        def fn(tp: TopicPartition, t: float) -> float:
            while t >= state["t"] + step_every:
                state["rates"] = np.maximum(
                    0.0, state["rates"] + rng.uniform(-delta, delta, n) / 100.0 * capacity)
                state["t"] += step_every
            return float(state["rates"][tp.partition])
        return fn

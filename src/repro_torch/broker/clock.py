"""Clock abstraction: simulated time for tests/benchmarks, wall time for
deployments (a copy of ``repro.broker.clock``)."""
from __future__ import annotations

import time


class Clock:
    def now(self) -> float:  # seconds
        raise NotImplementedError


class WallClock(Clock):
    def now(self) -> float:
        return time.monotonic()


class SimClock(Clock):
    """Deterministic, manually advanced clock."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        assert dt >= 0.0
        self._t += dt
        return self._t

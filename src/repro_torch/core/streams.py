"""Test-data generation (paper Sec. VI-A, Eq. 11).

A *measurement* maps each partition to its write speed at one instant; a
*stream* is a list of N measurements.  Speeds evolve by a bounded random walk

    s_i(p) = max{0, s_{i-1}(p) + phi(delta)/100 * C}

with phi(delta) uniform on [-delta, +delta].  The paper generates 6 streams
with N=500 and delta in {0, 5, 10, 15, 20, 25}; initial speeds are uniform on
[0, 100%]*C (the other three init modes showed no significant difference and
are provided for completeness).

A copy of ``repro.core.streams`` (numpy): the same seed gives the same
arrays bit for bit.
"""
from __future__ import annotations

from typing import Literal, Sequence

import numpy as np

PAPER_DELTAS = (0, 5, 10, 15, 20, 25)
PAPER_N_MEASUREMENTS = 500

InitMode = Literal["random", "zero", "half", "full"]


def initial_speeds(
    n_partitions: int,
    capacity: float,
    init: InitMode = "random",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    if init == "random":
        return rng.uniform(0.0, capacity, size=n_partitions)
    if init == "zero":
        return np.zeros(n_partitions)
    if init == "half":
        return np.full(n_partitions, 0.5 * capacity)
    if init == "full":
        return np.full(n_partitions, float(capacity))
    raise ValueError(f"unknown init mode {init!r}")


def generate_stream(
    n_partitions: int,
    n_measurements: int = PAPER_N_MEASUREMENTS,
    delta: float = 10.0,
    capacity: float = 1.0,
    init: InitMode = "random",
    seed: int = 0,
) -> np.ndarray:
    """Return an (N, P) array of write speeds following Eq. 11."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_measurements, n_partitions), dtype=np.float64)
    out[0] = initial_speeds(n_partitions, capacity, init, rng)
    for i in range(1, n_measurements):
        step = rng.uniform(-delta, delta, size=n_partitions) / 100.0 * capacity
        out[i] = np.maximum(0.0, out[i - 1] + step)
    return out


def paper_streams(
    n_partitions: int,
    capacity: float = 1.0,
    init: InitMode = "random",
    seed: int = 0,
    n_measurements: int = PAPER_N_MEASUREMENTS,
) -> dict:
    """The paper's six streams, keyed by delta."""
    return {
        d: generate_stream(n_partitions, n_measurements, d, capacity, init, seed + k)
        for k, d in enumerate(PAPER_DELTAS)
    }

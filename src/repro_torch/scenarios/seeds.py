"""Seed trace library: empirically-grounded Kafka workload shapes.

"How Fast Can We Insert?" (arXiv 2003.06452) benchmarks Kafka ingestion
end to end and reports three load shapes our synthetic suite should not
ignore: a *sustained insert plateau* (throughput steps up to a sustained
maximum, holds, and falls away -- their Fig. 4/5 steady-state runs),
*heavy partition skew* (per-partition throughput spread over an order of
magnitude once batching and producer keys interact), and *lifecycle
churn* (topics created and dropped between benchmark phases).  Each seed
below is the :mod:`repro_torch.core.scenarios` ``adversarial`` composite
family pinned to one of those shapes, materialized as a versioned
:class:`~repro_torch.scenarios.traces.Trace` with the provenance in
``meta`` (the reference's ``SEED_SHAPES``, copied).

Seeds are deterministic: ``seed_trace(name)`` with the default seed
gives the same bytes on every call on one device type (a CPU generator
and a CUDA generator seeded alike draw different numbers, and neither
draws the reference's stream), so they double as fixtures.  They are
also the adversarial search's sanity anchor -- a search that cannot beat
the *fixed* plateau seed on violation fraction is not searching.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, Tuple

from repro_torch.scenarios.traces import Trace, trace_from_scenario

#: seed name -> (description, adversarial-family knobs)
SEED_SHAPES: Dict[str, Tuple[str, Dict[str, Any]]] = {
    "kafka_insert_plateau": (
        "sustained insert plateau: rates step to ~2x capacity mid-trace "
        "and hold (arXiv 2003.06452 steady-state ingest)",
        {"base_rate": 0.15, "tail_sigma": 0.6, "burst_start_frac": 0.3,
         "burst_len_frac": 0.4, "burst_amp": 2.0, "noise": 0.05}),
    "kafka_partition_skew": (
        "heavy-tail partition skew: log-normal per-partition rates, a "
        "few whales carry most of the load (arXiv 2003.06452 batching/"
        "key skew)",
        {"base_rate": 0.35, "tail_sigma": 2.0, "burst_amp": 0.0,
         "burst_len_frac": 0.05, "noise": 0.1}),
    "kafka_lifecycle_churn": (
        "lifecycle churn: half the partitions exist only mid-trace and "
        "others flip on/off (topics created/dropped between benchmark "
        "phases)",
        {"base_rate": 0.25, "tail_sigma": 0.8, "burst_amp": 0.5,
         "burst_start_frac": 0.5, "burst_len_frac": 0.2, "churn_p": 0.05,
         "lifecycle_frac": 0.5, "birth_frac": 0.1, "death_frac": 0.8,
         "noise": 0.05}),
}


def list_seeds() -> Tuple[str, ...]:
    """Registered seed names, in registration order."""
    return tuple(SEED_SHAPES)


def seed_trace(name: str, seed=None, *, batch: int = 4, iters: int = 256,
               n: int = 16, capacity: float = 1.0, device=None) -> Trace:
    """Materialize one seed shape as a validated :class:`Trace`, drawn on
    ``device`` (``None`` = the CUDA card) from a generator seeded ``seed``
    (or from the generator ``seed``).

    Deterministic: the default seed is fixed per seed name, so the same
    call on one device type gives bit-identical traces across sessions.
    """
    if name not in SEED_SHAPES:
        raise ValueError(
            f"unknown seed trace {name!r}; have {sorted(SEED_SHAPES)}")
    desc, knobs = SEED_SHAPES[name]
    if seed is None:
        # crc32, not hash(): stable across interpreter sessions
        seed = zlib.crc32(name.encode()) % (2 ** 31)
    trace = trace_from_scenario("adversarial", seed, batch, iters, n,
                                capacity=capacity, name=name, device=device,
                                **knobs)
    trace.source = f"seed:{name}"
    trace.meta["description"] = desc
    trace.meta["paper"] = "arXiv:2003.06452"
    return trace


__all__ = ["SEED_SHAPES", "list_seeds", "seed_trace"]

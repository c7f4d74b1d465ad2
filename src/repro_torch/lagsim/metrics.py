"""SLO metrics over simulated lag trajectories.

The paper's claim is qualitative ("guarantees adequate consumption
rates ... at lower operational costs"); these metrics make it measurable
per (policy, scenario):

* ``peak_lag``        -- worst total backlog ever observed (bytes).
* ``mean_lag``        -- time-averaged total backlog (bytes).
* ``violation_frac``  -- fraction of steps with total lag above the SLO
                         threshold (a lag-based availability SLO).
* ``time_to_drain``   -- longest single excursion above the threshold
                         (seconds): how long a spike takes to drain.
* ``consumer_seconds``-- integral of the consumer count over time: the
                         operational cost the paper minimizes.
* ``total_migrations``-- partitions moved over the run (rebalance churn;
                         the R-score prices exactly this).

All functions are plain numpy over trailing-time arrays ``[..., T]`` so
they work on a single ``LagTrace`` and on stacked ``[P, B, T]`` sweeps
alike (tensors are copied to the host first).  The port keeps its own
copy of the reference's ``repro.lagsim.metrics``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SLO_METRIC_NAMES = ("peak_lag", "mean_lag", "violation_frac", "time_to_drain",
                    "consumer_seconds", "total_migrations")


def longest_excursion(mask: np.ndarray) -> np.ndarray:
    """Length (in steps) of the longest run of ``True`` along the last axis."""
    mask = np.asarray(mask, bool)
    run = np.zeros(mask.shape[:-1], np.int64)
    best = np.zeros_like(run)
    for t in range(mask.shape[-1]):
        run = np.where(mask[..., t], run + 1, 0)
        best = np.maximum(best, run)
    return best


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def slo_summary(lag_total, consumers, migrations, *, slo_lag: float,
                dt: float = 1.0) -> Dict[str, np.ndarray]:
    """Reduce trajectories ``[..., T]`` to the SLO metric dict ``[...]``."""
    lag_total = _host(lag_total)
    consumers = _host(consumers)
    migrations = _host(migrations)
    over = lag_total > slo_lag
    return {
        "peak_lag": lag_total.max(axis=-1),
        "mean_lag": lag_total.mean(axis=-1),
        "violation_frac": over.mean(axis=-1),
        "time_to_drain": longest_excursion(over) * dt,
        "consumer_seconds": consumers.sum(axis=-1) * dt,
        "total_migrations": migrations.sum(axis=-1),
    }


def summarize_sweep(result, cfg) -> Dict[str, np.ndarray]:
    """SLO summary of a ``LagSweepResult`` under ``cfg`` (arrays ``[P, B]``).

    Pass the same config the sweep ran with; an unset ``slo_lag`` uses the
    config's own default (``cfg.slo_lag_or_default``).
    """
    return slo_summary(result.lag_total, result.consumers, result.migrations,
                       slo_lag=cfg.slo_lag_or_default, dt=cfg.dt)

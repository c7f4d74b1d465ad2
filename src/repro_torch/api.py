"""Public facade of the port (the closed-loop verb so far).

``simulate`` runs the lag twin -- policies x traces with migration
downtime, shared drain budgets and SLO metrics -- on the CUDA card
unless the caller passes ``device="cpu"``.  It returns the reference's
``SimulateOutcome`` shape (numpy arrays, the same metric dict), so the
two packages' results compare directly.  The reference's fleet layer
(bucketing, ragged inputs) waits for a later slice: ``simulate`` takes
one uniform ``[B, T, N]`` batch and calls ``sweep_lag`` directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.lagsim import LagSimConfig, slo_summary, sweep_lag
from repro_torch.registry import list_policies

#: schema version stamped on every result dataclass (the reference's)
API_VERSION = 1


@dataclasses.dataclass
class SimulateOutcome:
    """Closed-loop lag sweep: SLO metrics per policy x stream."""

    policies: Tuple[str, ...]
    metrics: Dict[str, np.ndarray]    # metric -> [P, B]
    lag_total: np.ndarray             # f32[P, B, T] raw trajectories
    consumers: np.ndarray             # i32[P, B, T]
    migrations: np.ndarray            # i32[P, B, T]
    schema_version: int = API_VERSION


def simulate(traces, *, policies: Optional[Sequence[str]] = None,
             config: Optional[LagSimConfig] = None, active=None, device=None,
             **cfg_overrides) -> SimulateOutcome:
    """Closed-loop lag twin over ``traces`` f32[B, T, N] (a tensor or an
    array): backlog, shared drain budgets and migration downtime per
    policy, reduced to SLO metrics (violation fraction, peak lag,
    time-to-drain, consumer-seconds, migrations).  ``active`` (bool[B, T,
    N]) marks masked partitions as unreadable-and-empty.
    ``cfg_overrides`` replace fields of ``config`` (e.g. ``fused_steps=8,
    fused_kernel=True`` runs the heuristic packers through the
    ``loop_fused`` kernel; ``use_kernel=True`` drains every per-step loop
    through the ``lag_update`` kernel).  ``policies=None`` runs every
    registered policy.  ``device=None`` means the CUDA card."""
    if policies is None:
        policies = list_policies()
    cfg = config if config is not None else LagSimConfig()
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    res = sweep_lag(tuple(policies), traces, cfg, active=active,
                    device=device)
    host = {f: getattr(res, f).cpu().numpy()
            for f in ("lag_total", "consumers", "migrations")}
    metrics = slo_summary(**host, slo_lag=cfg.slo_lag_or_default, dt=cfg.dt)
    return SimulateOutcome(policies=res.policies, metrics=metrics, **host)


__all__ = ["API_VERSION", "SimulateOutcome", "simulate"]

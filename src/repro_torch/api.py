"""Public facade of the port (the closed-loop and optimizer verbs so far).

``simulate`` runs the lag twin -- policies x traces with migration
downtime, shared drain budgets and SLO metrics -- and ``optimize`` traces
one instance's bins-vs-R-score Pareto frontier with the batched annealer,
both on the CUDA card unless the caller passes ``device="cpu"``.  They
return the reference's ``SimulateOutcome`` / ``OptimizeOutcome`` shapes
(numpy arrays and plain floats), so the two packages' results compare
directly.  The reference's fleet layer (bucketing, ragged inputs) waits
for a later slice: ``simulate`` takes one uniform ``[B, T, N]`` batch and
calls ``sweep_lag`` directly, and refuses ``fleet=``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.lagsim import (LagSimConfig, NotPortedError, slo_summary,
                                sweep_lag)
from repro_torch.registry import PACKER_FAMILIES, list_policies

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
    #: the reference's in-loop telemetry results (recorder frames,
    #: streaming-sketch summaries, incidents); ``None`` until the port
    #: carries in-loop telemetry
    telemetry: Optional[List[Any]] = None
    sketches: Optional[List[List[Any]]] = None
    incidents: Optional[List[List[Any]]] = None
    schema_version: int = API_VERSION


def simulate(traces, *, policies: Optional[Sequence[str]] = None,
             config: Optional[LagSimConfig] = None, active=None, fleet=None,
             device=None, **cfg_overrides) -> SimulateOutcome:
    """Closed-loop lag twin over ``traces`` f32[B, T, N] (a tensor or an
    array): backlog, shared drain budgets and migration downtime per
    policy, reduced to SLO metrics (violation fraction, peak lag,
    time-to-drain, consumer-seconds, migrations).  ``active`` (bool[B, T,
    N]) marks masked partitions as unreadable-and-empty.
    ``cfg_overrides`` replace fields of ``config`` (e.g. ``fused_steps=8,
    fused_kernel=True`` runs the heuristic packers through the
    ``loop_fused`` kernel; ``use_kernel=True`` drains every per-step loop
    through the ``lag_update`` kernel).  ``policies=None`` runs every
    registered policy.  ``fleet`` (the reference's bucketed fleet layer)
    is not ported: anything but ``None`` raises :class:`NotPortedError`.
    ``device=None`` means the CUDA card."""
    if fleet is not None:
        raise NotPortedError(
            "simulate(fleet=...) is not yet ported to repro_torch: the fleet "
            "layer (repro.fleet.FleetRunner) is ROADMAP.md queue 1, item 1; "
            "leave it None")
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


@dataclasses.dataclass
class OptimizeOutcome:
    """Annealed lambda-sweep Pareto frontier of one packing instance."""

    lambdas: List[float]
    per_lambda: List[Tuple[float, float]]   # best (bins, rscore) per lambda
    front: List[Tuple[float, float]]        # non-dominated set
    hypervolume: float
    heuristics: Dict[str, dict]             # name -> frontier metrics
    schema_version: int = API_VERSION


def optimize(speeds, prev=None, capacity: float = 1.0, *,
             lambdas: Sequence[float] = (0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
             restarts: int = 4, steps: int = 250, seed: int = 0,
             score_heuristics: Union[bool, Sequence[str]] = True,
             device=None) -> OptimizeOutcome:
    """Trace the bins-vs-R-score Pareto frontier of one instance with the
    batched annealer (draws from a generator seeded ``seed``), and
    optionally place registered packers against it by domination status
    and hypervolume share.  ``device=None`` means the CUDA card."""
    from repro_torch.opt import anneal_frontier, heuristic_point

    sp = np.asarray(speeds, np.float64)
    pv = (np.full(sp.shape[0], -1, np.int32) if prev is None
          else np.asarray(prev, np.int32))
    fr = anneal_frontier(sp, pv, capacity, lambdas=tuple(lambdas),
                         restarts=restarts, steps=steps, seed=seed,
                         device=device)
    if score_heuristics is True:
        names = list_policies(family=PACKER_FAMILIES)
    elif score_heuristics:
        names = tuple(score_heuristics)
    else:
        names = ()
    heur = {name: fr.heuristic_metrics(
        heuristic_point(name, sp, pv, capacity, device=device))
        for name in names}
    return OptimizeOutcome(lambdas=fr.lambdas, per_lambda=fr.per_lambda,
                           front=fr.front, hypervolume=fr.hypervolume,
                           heuristics=heur)


__all__ = ["API_VERSION", "OptimizeOutcome", "SimulateOutcome", "optimize",
           "simulate"]

"""Public facade of the port: the reference's ``repro.api`` verbs on the
card.

* ``pack``      -- one packing decision of any registered packer ->
                   ``PackOutcome``;
* ``sweep``     -- every algorithm x a batch of speed streams ->
                   ``SweepOutcome``;
* ``simulate``  -- closed-loop lag twin: policies x traces with migration
                   downtime and SLO metrics -> ``SimulateOutcome``;
* ``optimize``  -- lambda-sweep annealed Pareto frontier of one instance
                   -> ``OptimizeOutcome``;
* ``evaluate``  -- the paper's Figs. 6-9 tables (CBS / avg R-score /
                   Pareto membership) on Eq. 11 streams ->
                   ``EvaluateOutcome``.

Each verb runs on the CUDA card unless the caller passes
``device="cpu"``, and returns the reference's outcome dataclass field for
field (numpy arrays and plain floats), so the two packages' results
compare directly.  ``sweep`` and ``simulate`` execute through the fleet
layer (``repro_torch.fleet``): a shared ``default_fleet()`` runner
buckets scenarios by padded shape under a bounded run cache; both take
an optional ``active`` bool[B, T, N] mask and an optional ``fleet=``
runner.  ``FleetRunner`` / ``FleetConfig``, the control plane's
``ControlPlaneConfig`` and the telemetry names (``TelemetryConfig``,
``SketchConfig``, ``AlertConfig``, the exporters, ...) are re-exported
lazily, as the reference's are.  ``BenchReport`` is the reference's
envelope for ``BENCH_*.json`` files.  Every verb records an
``api.<verb>`` span (``telemetry.spans``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.rscore import rscore
from repro_torch.lagsim import LagSimConfig
from repro_torch.registry import PACKER_FAMILIES, list_policies, packer_for
from repro_torch.telemetry.spans import traced

#: schema version stamped on every result dataclass (the reference's)
API_VERSION = 1

#: fleet re-exports resolve lazily, as the reference's do
_FLEET_EXPORTS = ("FleetRunner", "FleetConfig")
#: lagsim re-exports, lazily for the same reason
_LAGSIM_EXPORTS = ("ControlPlaneConfig", "FUSED_MAX_PARTITIONS",
                   "FusedPathError")
#: in-loop recorder / sketch / alert / exporter re-exports
_TELEMETRY_EXPORTS = ("TelemetryConfig", "TelemetryFrame", "EventStream",
                      "SketchConfig", "SketchSummary", "AlertConfig",
                      "AlertRule", "Incident", "prometheus_exposition",
                      "validate_exposition", "otlp_metrics_json")


def __getattr__(name: str):
    if name in _FLEET_EXPORTS:
        from repro_torch import fleet as _fleet

        return getattr(_fleet, name)
    if name in _LAGSIM_EXPORTS:
        from repro_torch import lagsim as _lagsim

        return getattr(_lagsim, name)
    if name in _TELEMETRY_EXPORTS:
        from repro_torch import telemetry as _telemetry

        return getattr(_telemetry, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_DEFAULT_FLEET = None


def default_fleet():
    """The module-level ``FleetRunner`` every verb routes through unless
    given ``fleet=``: one bounded run cache across ``sweep`` /
    ``simulate`` calls."""
    global _DEFAULT_FLEET
    if _DEFAULT_FLEET is None:
        from repro_torch.fleet import FleetRunner

        _DEFAULT_FLEET = FleetRunner()
    return _DEFAULT_FLEET


# ---------------------------------------------------------------------------
# result dataclasses (the reference's versioned schema)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackOutcome:
    """One packing decision."""

    algorithm: str
    backend: str
    capacity: float
    n_bins: int
    assignment: Dict[Any, int]        # pid -> consumer (bin name)
    loads: Dict[int, float]           # consumer -> assigned write speed
    rscore: Optional[float] = None    # Eq. 10 vs ``prev`` (None: no prev)
    schema_version: int = API_VERSION


@dataclasses.dataclass
class SweepOutcome:
    """Batched scenario sweep, axes ``[algorithm, stream, iteration]``."""

    algorithms: Tuple[str, ...]
    bins: np.ndarray                  # i32[A, B, T]
    rscores: np.ndarray               # f32[A, B, T]
    migrations: np.ndarray            # i32[A, B, T]
    schema_version: int = API_VERSION


@dataclasses.dataclass
class SimulateOutcome:
    """Closed-loop lag sweep: SLO metrics per policy x stream."""

    policies: Tuple[str, ...]
    metrics: Dict[str, np.ndarray]    # metric -> [P, B]
    lag_total: np.ndarray             # f32[P, B, T] raw trajectories
    consumers: np.ndarray             # i32[P, B, T]
    migrations: np.ndarray            # i32[P, B, T]
    #: per-stream recorder frames ([P, T, K] channels; ``None`` unless
    #: the telemetry override records frames)
    telemetry: Optional[List[Any]] = None
    #: per-stream, per-policy finalized sketch summaries (``None`` unless
    #: ``telemetry.sketch`` is on)
    sketches: Optional[List[List[Any]]] = None
    #: per-stream decoded incidents (``None`` unless alerts are on)
    incidents: Optional[List[List[Any]]] = None
    schema_version: int = API_VERSION


@traced("api.simulate")
def simulate(traces, *, policies: Optional[Sequence[str]] = None,
             config: Optional[LagSimConfig] = None, active=None, fleet=None,
             control_plane=None, device=None,
             **cfg_overrides) -> SimulateOutcome:
    """Closed-loop lag twin over ``traces`` f32[B, T, N] (a tensor or an
    array): backlog, shared drain budgets and migration downtime per
    policy, reduced to SLO metrics (violation fraction, peak lag,
    time-to-drain, consumer-seconds, migrations), executed through the
    fleet layer (``fleet``, else ``default_fleet()``).  ``active``
    (bool[B, T, N]) marks masked partitions as unreadable-and-empty.
    ``cfg_overrides`` replace fields of ``config`` (e.g. ``fused_steps=8,
    fused_kernel=True`` runs the heuristic packers through the
    ``loop_fused`` kernel; ``use_kernel=True`` drains every per-step loop
    through the ``lag_update`` kernel).  ``policies=None`` runs every
    registered policy.

    ``control_plane`` (a ``ControlPlaneConfig`` or a mapping of its knobs)
    runs every policy behind an emulated scaler control plane: polling,
    observation/actuation delay, cooldown, replica clamps and the
    scale-event rebalance storm.  Inconsistent knobs raise a named
    ``ValueError`` before anything runs.

    ``telemetry=TelemetryConfig(...)`` (a config override) turns on the
    in-loop observability: ``record_frames`` fills ``.telemetry``,
    ``sketch=SketchConfig(...)`` fills ``.sketches`` and
    ``alerts=AlertConfig(rules=...)`` fills ``.incidents``; export them
    with ``prometheus_exposition`` / ``otlp_metrics_json``.
    ``device=None`` means the CUDA card."""
    if policies is None:
        policies = list_policies()
    cfg = config if config is not None else LagSimConfig()
    if control_plane is not None:
        from repro_torch.lagsim import ControlPlaneConfig

        if isinstance(control_plane, Mapping):
            control_plane = ControlPlaneConfig(**control_plane)
        cfg_overrides["control_plane"] = control_plane
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cfg.resolve(traces.shape[-1] if hasattr(traces, "shape")
                else np.asarray(traces).shape[-1])  # fail fast on bad knobs
    runner = fleet if fleet is not None else default_fleet()
    res = runner.simulate(tuple(policies), traces, cfg, active=active,
                          device=device)
    # lag_max and unreadable are not read: they stay on the card
    st = res.stacked(("lag_total", "consumers", "migrations"))
    metrics = {k: np.asarray(v)
               for k, v in res.summarize(cfg, stacked=st).items()}
    sketches = None
    if res.sketch is not None:
        sketches = [[s for _, s in res.sketch_summaries(i)]
                    for i in range(len(res.sketch))]
    incidents = None
    if res.incidents is not None:
        incidents = [res.scenario_incidents(i)
                     for i in range(len(res.incidents))]
    return SimulateOutcome(policies=res.policies, metrics=metrics,
                           lag_total=st["lag_total"],
                           consumers=st["consumers"],
                           migrations=st["migrations"],
                           telemetry=res.telemetry,
                           sketches=sketches, incidents=incidents)


@dataclasses.dataclass
class OptimizeOutcome:
    """Annealed lambda-sweep Pareto frontier of one packing instance."""

    lambdas: List[float]
    per_lambda: List[Tuple[float, float]]   # best (bins, rscore) per lambda
    front: List[Tuple[float, float]]        # non-dominated set
    hypervolume: float
    heuristics: Dict[str, dict]             # name -> frontier metrics
    schema_version: int = API_VERSION


@traced("api.optimize")
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


@dataclasses.dataclass
class EvaluateOutcome:
    """The paper's Figs. 6-9 tables over Eq. 11 delta-streams."""

    algorithms: Tuple[str, ...]
    deltas: Tuple[int, ...]
    cbs: Dict[int, Dict[str, float]]        # Eq. 12 per delta
    avg_rscore: Dict[int, Dict[str, float]]  # Eq. 13 per delta
    pareto: Dict[int, List[str]]            # front membership per delta
    schema_version: int = API_VERSION


@dataclasses.dataclass
class BenchReport:
    """Shared envelope for ``BENCH_*.json`` artifacts.

    ``as_dict`` keeps each benchmark's top-level keys (``config`` /
    ``families`` / anything in ``extra``) and stamps the shared schema
    fields.
    """

    kind: str                          # e.g. "lagsim", "opt"
    config: Dict[str, Any]
    families: Dict[str, Any]
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = API_VERSION

    def as_dict(self) -> Dict[str, Any]:
        reserved = {"schema_version", "kind", "config", "families"}
        clash = reserved & set(self.extra)
        if clash:
            raise ValueError(
                f"BenchReport.extra must not shadow envelope keys: "
                f"{sorted(clash)}")
        return {
            "schema_version": self.schema_version,
            "kind": self.kind,
            "config": self.config,
            "families": self.families,
            **self.extra,
        }

    def write(self, path: str) -> Dict[str, Any]:
        out = self.as_dict()
        with open(path, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
        return out


@traced("api.pack")
def pack(speeds, capacity: float, *, algorithm: str = "BFD", prev=None,
         device=None) -> PackOutcome:
    """One packing decision with any registered packer, in the
    reference's array form (its ``backend="jax"``): ``speeds`` f32[n],
    ``prev`` i32[n] (-1 = unassigned); pids are array indices.  One
    ``pack_rows`` launch on the card.  The R-score against ``prev`` runs
    in Python floats over dicts, as the reference's does.  ``device=None``
    means the CUDA card."""
    fn = packer_for(algorithm)
    dev = resolve_device(device)
    sp = np.asarray(speeds, np.float64)
    pv = (np.full(sp.shape[0], -1, np.int32) if prev is None
          else np.asarray(prev, np.int32))
    res = fn(torch.tensor(sp[None], dtype=torch.float32, device=dev),
             torch.tensor(pv[None], device=dev), capacity)
    n_bins = int(res.n_bins[0])
    bin_of = res.bin_of[0].cpu().numpy()
    assignment = {int(j): int(c) for j, c in enumerate(bin_of)}
    names = res.names[0, :n_bins].cpu().numpy()
    lds = res.loads[0, :n_bins].cpu().numpy()
    loads = {int(c): float(l) for c, l in zip(names, lds)}
    speeds_of = {int(j): float(w) for j, w in enumerate(sp)}
    prev_of = {int(j): int(c) for j, c in enumerate(pv) if c >= 0}
    r = rscore(prev_of, assignment, speeds_of, capacity) if prev_of else None
    return PackOutcome(algorithm=algorithm.upper(), backend="torch",
                       capacity=float(capacity), n_bins=n_bins,
                       assignment=assignment, loads=loads, rscore=r)


@traced("api.sweep")
def sweep(traces, capacity: float = 1.0, *,
          algorithms: Optional[Sequence[str]] = None, active=None,
          fleet=None, device=None) -> SweepOutcome:
    """Every algorithm (default: the 12 packers) x a batch of streams
    ``f32[B, T, N]``, executed through the fleet layer: one packing call
    of all streams an algorithm a step.  ``active`` (bool[B, T, N])
    masks partitions that do not exist at a step (they pack to ``-1``).
    ``device=None`` means the CUDA card."""
    if algorithms is None:
        algorithms = list_policies(family=PACKER_FAMILIES)
    runner = fleet if fleet is not None else default_fleet()
    res = runner.sweep(tuple(algorithms), traces, capacity, active=active,
                       device=device)
    bins, rscores, migrations = res.stacked()
    return SweepOutcome(algorithms=res.algorithms, bins=bins,
                        rscores=rscores, migrations=migrations)


@traced("api.evaluate")
def evaluate(*, algorithms: Optional[Sequence[str]] = None,
             deltas: Sequence[int] = (5, 15, 25), n_partitions: int = 30,
             n_measurements: int = 120, capacity: float = 1.0,
             seed: int = 0, device=None) -> EvaluateOutcome:
    """The paper's evaluation (Figs. 6-9): Cardinal Bin Score (Eq. 12),
    average R-score (Eq. 13) and Pareto-front membership per
    delta-stream (Eq. 11, drawn with numpy from ``seed``), through
    ``sweep``.  ``device=None`` means the CUDA card."""
    from repro_torch.core.metrics import cbs_from_bins, pareto_front
    from repro_torch.core.streams import generate_stream

    if algorithms is None:
        algorithms = list_policies(family=PACKER_FAMILIES)
    algorithms = tuple(a.upper() for a in algorithms)
    deltas = tuple(int(d) for d in deltas)
    batch = np.stack([
        generate_stream(n_partitions, n_measurements, d, capacity, seed=seed)
        for d in deltas
    ])
    out = sweep(batch, capacity, algorithms=algorithms, device=device)
    cbs: Dict[int, Dict[str, float]] = {}
    avg_r: Dict[int, Dict[str, float]] = {}
    pareto: Dict[int, List[str]] = {}
    for i, d in enumerate(deltas):
        cbs[d] = dict(zip(algorithms,
                          cbs_from_bins(out.bins[:, i, :]).tolist()))
        avg_r[d] = dict(zip(algorithms,
                            out.rscores[:, i, :].mean(axis=1).tolist()))
        pts = {a: (cbs[d][a], avg_r[d][a]) for a in algorithms}
        pareto[d] = sorted(pareto_front(pts))
    return EvaluateOutcome(algorithms=algorithms, deltas=deltas, cbs=cbs,
                           avg_rscore=avg_r, pareto=pareto)


__all__ = [
    "AlertConfig",
    "AlertRule",
    "API_VERSION",
    "BenchReport",
    "ControlPlaneConfig",
    "default_fleet",
    "evaluate",
    "EvaluateOutcome",
    "EventStream",
    "FleetConfig",
    "FleetRunner",
    "FUSED_MAX_PARTITIONS",
    "FusedPathError",
    "Incident",
    "optimize",
    "OptimizeOutcome",
    "otlp_metrics_json",
    "pack",
    "PackOutcome",
    "prometheus_exposition",
    "simulate",
    "SimulateOutcome",
    "SketchConfig",
    "SketchSummary",
    "sweep",
    "SweepOutcome",
    "TelemetryConfig",
    "TelemetryFrame",
    "validate_exposition",
]

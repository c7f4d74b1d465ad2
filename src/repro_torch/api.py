"""Public facade of the port: the reference's ``repro.api`` verbs on the
card.

* ``pack``      -- one packing decision of any registered packer, on
                   either backend -> ``PackOutcome``;
* ``sweep``     -- every algorithm x a batch of speed streams ->
                   ``SweepOutcome``;
* ``simulate``  -- closed-loop lag twin: policies x traces with migration
                   downtime and SLO metrics -> ``SimulateOutcome``;
* ``optimize``  -- lambda-sweep annealed Pareto frontier of one instance
                   -> ``OptimizeOutcome``;
* ``evaluate``  -- the paper's Figs. 6-9 tables (CBS / avg R-score /
                   Pareto membership) on Eq. 11 streams ->
                   ``EvaluateOutcome``;
* ``attack``    -- adversarial scenario search: evolve the workload
                   genome that maximizes one policy's SLO violation, with
                   a random-search baseline at equal evals ->
                   ``AttackOutcome``;
* ``replay``    -- run a versioned on-disk trace (the reference's format,
                   or a ``Trace``) through the fleet path ->
                   ``ReplayOutcome``.

Each verb runs on the CUDA card unless the caller passes
``device="cpu"`` (``pack(backend="py")`` runs on the host), and returns
the reference's outcome dataclass field for field (numpy arrays and
plain floats), so the two packages' results compare directly.  ``sweep``
and ``simulate`` execute through the fleet layer (``repro_torch.fleet``):
a shared ``default_fleet()`` runner buckets scenarios by padded shape
under a bounded run cache; both take an optional ``active`` bool[B, T,
N] mask and an optional ``fleet=`` runner.  ``FleetRunner`` /
``FleetConfig``, the control plane's ``ControlPlaneConfig``, the
telemetry names (``TelemetryConfig``, ``SketchConfig``, ``AlertConfig``,
the exporters, ...) and the scenario engine's names (``Trace``,
``load_trace``, ``save_trace``, ``seed_trace``, ``SearchConfig``,
``SearchResult``) are re-exported lazily, as the reference's are.

Policy discovery re-exports the port's registry: ``list_policies``,
``make_policy``, ``get_spec``, ``packer_for``, ``PolicySpec``,
``Policy``, ``BACKENDS`` -- the port's backends are ``py`` (the
reference's pure-Python packers) and ``torch`` (the counterpart of the
reference's ``jax``: the batched tensor path on the card).  The span
tracer is re-exported too (``Tracer``, ``default_tracer``, ``span``);
every verb records an ``api.<verb>`` span.  ``BenchReport`` is the
reference's envelope for ``BENCH_*.json`` files, and ``selfcheck()``
the reference's surface check.
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
from repro_torch.registry import (
    BACKENDS,
    FAMILIES,
    PACKER_FAMILIES,
    Policy,
    PolicySpec,
    get_spec,
    list_policies,
    make_policy,
    packer_for,
)
from repro_torch.telemetry.spans import Tracer, default_tracer, span, traced

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
#: scenario-engine re-exports (trace format + adversarial search)
_SCENARIO_EXPORTS = ("Trace", "SearchConfig", "SearchResult", "load_trace",
                     "save_trace", "seed_trace")


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
    if name in _SCENARIO_EXPORTS:
        from repro_torch import scenarios as _scenarios

        return getattr(_scenarios, name)
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
         backend: str = "py", device=None) -> PackOutcome:
    """One packing decision with any registered packer.

    ``backend="py"`` (the reference's default): ``speeds`` is a mapping
    pid -> write speed (or a sequence of (pid, speed)), ``prev`` maps pid
    -> previous consumer; the pure-Python packers run on the host.
    ``backend="torch"`` (the reference's ``"jax"``): ``speeds`` is f32[n],
    ``prev`` i32[n] (-1 = unassigned), pids are array indices; one
    ``pack_rows`` launch on ``device`` (``None`` = the CUDA card).  The
    R-score against ``prev`` runs in Python floats over dicts, as the
    reference's does."""
    fn = packer_for(algorithm, backend=backend)
    if backend == "py":
        speeds_of = dict(speeds)
        prev_of = dict(prev) if prev else None
        res = fn(speeds_of, capacity, prev=prev_of)
        assignment = dict(res.pid_to_bin)
        loads = {int(c): float(l) for c, l in res.loads.items()}
        n_bins = res.n_bins
    else:
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
    return PackOutcome(algorithm=algorithm.upper(), backend=backend,
                       capacity=float(capacity), n_bins=int(n_bins),
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


@dataclasses.dataclass
class AttackOutcome:
    """Adversarial search result: the worst workload found for one
    policy, plus the random-search baseline at equal oracle evals
    (``baseline_fitness`` / ``beats_baseline`` are ``None`` when the
    baseline was skipped)."""

    policy: str
    family: str
    best_fitness: float
    best_violation_frac: float
    best_incidents: float
    witness_genome: List[float]
    witness_knobs: Dict[str, float]
    history: List[float]              # best-so-far fitness per generation
    evals: int
    generations_run: int
    seed: int
    baseline_fitness: Optional[float] = None
    beats_baseline: Optional[bool] = None
    #: the full ``repro_torch.scenarios.SearchResult`` pair (search,
    #: baseline)
    search: Any = None
    baseline: Any = None
    schema_version: int = API_VERSION


@dataclasses.dataclass
class ReplayOutcome:
    """One on-disk trace replayed through the fleet path."""

    trace_name: str
    source: str
    shape: Tuple[int, int, int]       # (B, T, N) as simulated
    resampled: bool
    policies: Tuple[str, ...]
    metrics: Dict[str, np.ndarray]    # metric -> [P, B]
    #: full per-policy trajectories (the ``simulate`` result the replay
    #: reduces to metrics)
    result: Optional[SimulateOutcome] = None
    schema_version: int = API_VERSION


@traced("api.attack")
def attack(policy: str, *, family: str = "adversarial", config=None,
           sim=None, seed: int = 0, baseline: bool = True, fleet=None,
           device=None) -> AttackOutcome:
    """Evolve the scenario genome that maximizes ``policy``'s SLO
    violation (``repro_torch.scenarios.search``), then -- with
    ``baseline=True`` -- run uniform random search at the *same*
    fitness-oracle eval budget and report whether the evolution strictly
    beat it.

    ``config`` is a ``SearchConfig`` (population, generations, trace
    shape, incident weight); ``sim`` a ``LagSimConfig`` for the fitness
    oracle.  A fixed ``seed`` gives a bit-identical search on one device
    type.  The witness genome replays via
    ``SearchResult.witness_trace`` + :func:`replay`.  ``device=None``
    means the CUDA card.
    """
    from repro_torch.scenarios import search as _search

    cfg = config if config is not None else _search.SearchConfig()
    sim_cfg = sim if sim is not None else LagSimConfig()
    runner = fleet if fleet is not None else default_fleet()
    kw = dict(family=family, config=cfg, sim=sim_cfg, seed=seed,
              runner=runner, device=device)
    res = _search.attack(policy, **kw)
    base = None
    if baseline:
        base = _search.random_search(policy, evals=res.evals, **kw)
    return AttackOutcome(
        policy=res.policy, family=res.family,
        best_fitness=res.best_fitness,
        best_violation_frac=res.best_violation_frac,
        best_incidents=res.best_incidents,
        witness_genome=[float(g) for g in res.best_genome],
        witness_knobs=dict(res.best_knobs),
        history=list(res.history), evals=res.evals,
        generations_run=res.generations_run, seed=int(seed),
        baseline_fitness=None if base is None else base.best_fitness,
        beats_baseline=(None if base is None
                        else res.best_fitness > base.best_fitness),
        search=res, baseline=base)


@traced("api.replay")
def replay(trace, *, policies: Optional[Sequence[str]] = None,
           config=None, iters: Optional[int] = None,
           method: str = "hold", fleet=None, device=None,
           **cfg_overrides) -> ReplayOutcome:
    """Replay an on-disk trace (a path to a ``.json``/``.npz`` written by
    ``save_trace`` of either package, or a ``Trace``) through the fleet
    path -- load, validate, optionally resample to ``iters`` steps, and
    run :func:`simulate` on the trace's rates + mask on ``device``
    (``None`` = the CUDA card).

    The trace's recorded ``capacity`` drives the sim unless the caller
    overrides it (``config=`` or ``capacity=``).  Replay is
    padding-exact: the metrics equal a direct run of the same arrays.
    """
    from repro_torch.scenarios import load_trace as _load
    from repro_torch.scenarios import resample_trace as _resample

    tr = _load(trace) if isinstance(trace, str) else trace
    resampled = False
    if iters is not None and int(iters) != tr.iters:
        tr = _resample(tr, int(iters), method=method)
        resampled = True
    if config is None and "capacity" not in cfg_overrides:
        cfg_overrides["capacity"] = float(tr.capacity)
    out = simulate(tr.rates, policies=policies, config=config,
                   active=tr.active, fleet=fleet, device=device,
                   **cfg_overrides)
    return ReplayOutcome(
        trace_name=tr.name, source=tr.source,
        shape=(tr.batch, tr.iters, tr.n), resampled=resampled,
        policies=out.policies, metrics=out.metrics, result=out)


# ---------------------------------------------------------------------------
# surface checks
# ---------------------------------------------------------------------------

def selfcheck() -> None:
    """The reference's surface check: the exported surface is intact,
    matches the documented surface (README "Public API", when the repo
    checkout is present), and the registry is populated for every family
    on its expected backends.  Touches no device."""
    import os
    import re
    import sys

    mod = sys.modules[__name__]
    # hasattr, not a globals() lookup: the re-exports resolve through the
    # module-level __getattr__ to stay lazy
    missing = [name for name in __all__ if not hasattr(mod, name)]
    assert not missing, f"__all__ exports missing objects: {missing}"
    assert __all__ == sorted(__all__, key=str.lower), (
        "__all__ must stay sorted (case-insensitive) so the documented "
        "surface is diffable")
    readme = os.path.join(os.path.dirname(__file__), "..", "..", "README.md")
    if os.path.exists(readme):            # repo checkout (not an install)
        with open(readme) as f:
            text = f.read()
        m = re.search(r"## Public API\n(.*?)(?:\n## |\Z)", text, re.S)
        assert m, "README.md must keep a '## Public API' section"
        documented = set(re.findall(r"`([A-Za-z_][A-Za-z0-9_]*)`",
                                    m.group(1)))
        undocumented = set(__all__) - documented
        assert not undocumented, (
            f"exports missing from README Public API: {sorted(undocumented)}")
    for family in FAMILIES:
        names = list_policies(family=family)
        assert names, f"no policies registered for family {family!r}"
    packers_py = list_policies(family=PACKER_FAMILIES, backend="py")
    packers_torch = list_policies(family=PACKER_FAMILIES, backend="torch")
    assert packers_py == packers_torch, (
        "every packer must be registered on both backends: "
        f"{packers_py} != {packers_torch}")
    assert len(packers_torch) == 12, packers_torch


__all__ = [
    "AlertConfig",
    "AlertRule",
    "API_VERSION",
    "attack",
    "AttackOutcome",
    "BACKENDS",
    "BenchReport",
    "ControlPlaneConfig",
    "default_fleet",
    "default_tracer",
    "evaluate",
    "EvaluateOutcome",
    "EventStream",
    "FAMILIES",
    "FleetConfig",
    "FleetRunner",
    "FUSED_MAX_PARTITIONS",
    "FusedPathError",
    "get_spec",
    "Incident",
    "list_policies",
    "load_trace",
    "make_policy",
    "optimize",
    "OptimizeOutcome",
    "otlp_metrics_json",
    "pack",
    "PACKER_FAMILIES",
    "packer_for",
    "PackOutcome",
    "Policy",
    "PolicySpec",
    "prometheus_exposition",
    "replay",
    "ReplayOutcome",
    "save_trace",
    "SearchConfig",
    "SearchResult",
    "seed_trace",
    "selfcheck",
    "simulate",
    "SimulateOutcome",
    "SketchConfig",
    "SketchSummary",
    "span",
    "sweep",
    "SweepOutcome",
    "TelemetryConfig",
    "TelemetryFrame",
    "Trace",
    "Tracer",
    "validate_exposition",
]


if __name__ == "__main__":
    selfcheck()
    for fam in FAMILIES:
        print(f"{fam:<10} {', '.join(list_policies(family=fam))}")
    print("repro_torch.api selfcheck OK "
          f"(API_VERSION={API_VERSION}, {len(__all__)} exports)")

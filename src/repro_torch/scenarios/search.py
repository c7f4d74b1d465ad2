"""Adversarial scenario search: evolve the workload that breaks a policy.

The paper's claim -- R-score policies "guarantee adequate consumption
rates" at lower cost -- is tested here by *optimizing against it*: a
genome (``scenarios.genome``) parameterizes a registered scenario family
(burst timing and amplitude, churn rate, heavy-tail index, lifecycle
windows for the ``adversarial`` composite), and an evolutionary loop
(elites + tournament selection + uniform crossover + gaussian mutation,
on f32 tensors on the search's device) maximizes the policy's SLO
damage.  The fitness oracle is the fleet itself --
:meth:`FleetRunner.fitness` -- returning ``violation_frac`` plus
(optionally) burn-rate incident counts per genome, so one oracle call
runs a whole population as one batch ``[P * S, iters, n]`` through the
lag twin on the card, and every generation after the first hits the
runner's warm cache entry (constant ``(B, T, N, cfg)``).

Determinism: one scenario seed is shared by *every* evaluation of a
search (each genome's block of rows is
``generate_masked_scenario(family, scenario_seed, S, iters, n, **knobs)``
with a generator seeded anew), so fitness is a pure function of the
genome, a fixed ``seed`` replays the identical search, and the
random-search baseline (:func:`random_search`) is comparable
eval-for-eval.  Early stopping is per-generation: ``patience``
generations without ``min_delta`` improvement end the search, and the
baseline is then run at the *actual* eval budget the evolution consumed.

Randomness is injectable (:class:`SearchNoise`): without it every draw
comes from one ``torch.Generator`` seeded ``seed`` on the search's
device, in a fixed order (the scenario seed, the initial population's
uniforms, then each generation's tournament, crossover and mutation
draws, or the baseline's population uniforms).  The operators follow the
reference (``repro.scenarios.search``) operation for operation, so fed
the same draws and fitness they give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.scenarios import (FamilySpec, family_spec,
                                        generate_masked_scenario)
from repro_torch.fleet.runner import FleetRunner
from repro_torch.lagsim import LagSimConfig
from repro_torch.scenarios.genome import (genome_bounds, genome_knobs,
                                          random_population, repair_genome)
from repro_torch.scenarios.traces import Trace, trace_from_scenario


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Static knobs of one adversarial search (hashable).

    ``pop_size * generations`` bounds the fitness-oracle evals; each
    eval simulates ``scenarios_per_genome`` traces of shape
    ``(iters, n)``.  ``incident_weight > 0`` folds per-step incident
    counts into the fitness (requires an alerting ``LagSimConfig``)."""

    pop_size: int = 16
    generations: int = 8
    elite_frac: float = 0.25
    crossover_p: float = 0.5
    mutation_scale: float = 0.12
    patience: int = 3
    min_delta: float = 1e-4
    scenarios_per_genome: int = 1
    iters: int = 128
    n: int = 8
    capacity: float = 1.0
    incident_weight: float = 0.0

    def __post_init__(self) -> None:
        if int(self.pop_size) < 2:
            raise ValueError(
                f"pop_size must be >= 2, got {self.pop_size}")
        if int(self.generations) < 1 or int(self.patience) < 1:
            raise ValueError("generations and patience must be >= 1")
        if not 0.0 < float(self.elite_frac) < 1.0:
            raise ValueError(
                f"elite_frac must be in (0, 1), got {self.elite_frac!r}")
        if int(self.scenarios_per_genome) < 1:
            raise ValueError("scenarios_per_genome must be >= 1")

    @property
    def n_elites(self) -> int:
        return max(1, int(round(self.elite_frac * self.pop_size)))


@dataclasses.dataclass
class SearchResult:
    """One search's outcome: the worst workload found and how it got
    there.  ``history`` is best-so-far fitness per generation;
    ``evals`` the fitness-oracle evaluations actually spent (early
    stopping may end below ``pop_size * generations``)."""

    policy: str
    family: str
    method: str                     # "evolution" | "random"
    best_fitness: float
    best_violation_frac: float
    best_incidents: float
    best_genome: np.ndarray         # f32[K]
    best_knobs: Dict[str, float]
    history: List[float]
    evals: int
    generations_run: int
    seed: int

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready envelope row (the reference's
        ``BENCH_adversarial`` row)."""
        return {
            "policy": self.policy, "family": self.family,
            "method": self.method,
            "best_fitness": round(float(self.best_fitness), 6),
            "best_violation_frac": round(float(self.best_violation_frac), 6),
            "best_incidents": round(float(self.best_incidents), 6),
            "best_genome": [round(float(g), 6) for g in self.best_genome],
            "best_knobs": {k: round(float(v), 6)
                           for k, v in self.best_knobs.items()},
            "history": [round(float(h), 6) for h in self.history],
            "evals": int(self.evals),
            "generations_run": int(self.generations_run),
            "seed": int(self.seed),
        }

    def witness_trace(self, config: SearchConfig, seed: int = 0,
                      batch: int = 4, device=None) -> Trace:
        """Materialize the witness genome as a replayable :class:`Trace`
        drawn on ``device`` (``None`` = the CUDA card) from a generator
        seeded ``seed`` (provenance: policy + genome in ``meta``)."""
        trace = trace_from_scenario(
            self.family, seed, batch, config.iters, config.n,
            capacity=config.capacity, device=device,
            name=f"witness_{self.policy.lower()}", **self.best_knobs)
        trace.source = f"adversarial:{self.policy}"
        trace.meta["genome"] = [float(g) for g in self.best_genome]
        trace.meta["best_violation_frac"] = float(self.best_violation_frac)
        return trace


@dataclasses.dataclass(frozen=True)
class SearchNoise:
    """The randomness of one search, injected in place of its generator.

    * ``population`` -- the initial population's uniforms ``f32[P, K]``
      in [0, 1);
    * per generation after the first (entry ``g - 1`` makes generation
      ``g``'s population): the evolution's tournament candidates
      ``tournament`` (int ``[n_ch, 2, 2]`` in ``[0, P)``), crossover mask
      ``crossover`` (bool ``[n_ch, K]``, True keeps parent 0's gene) and
      mutation normals ``mutation`` (f32 ``[n_ch, K]``), with ``n_ch = P
      - n_elites``; the random baseline's population uniforms
      ``baseline`` (f32 ``[P, K]``);
    * ``scenario`` -- ``knobs -> (rates f32[S, iters, n], active
      bool[S, iters, n])``, one genome's block of rows, in place of the
      family generator under the search's scenario seed.

    A search that needs a draw the noise does not hold raises a named
    ``ValueError``."""

    population: torch.Tensor
    tournament: Sequence[torch.Tensor] = ()
    crossover: Sequence[torch.Tensor] = ()
    mutation: Sequence[torch.Tensor] = ()
    baseline: Sequence[torch.Tensor] = ()
    scenario: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None


class _Draws:
    """The search's draws, in their fixed order, from one generator
    seeded ``seed`` on ``device``: first the scenario seed, then the rest,
    each of which ``noise`` replaces when it is given."""

    def __init__(self, noise: Optional[SearchNoise], seed: int,
                 device: torch.device, k_dim: int, cfg: SearchConfig):
        self.noise = noise
        self.dev = device
        self.k_dim = k_dim
        self.cfg = cfg
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.scenario_seed = int(torch.randint(
            0, 2 ** 62, (1,), generator=self.gen, device=device))

    def _rand(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.dev)

    def _held(self, field: str, gen: int):
        seq = getattr(self.noise, field)
        if gen - 1 >= len(seq):
            raise ValueError(
                f"SearchNoise.{field} holds {len(seq)} generations; "
                f"generation {gen} needs one more")
        return torch.as_tensor(seq[gen - 1], device=self.dev)

    def population(self) -> torch.Tensor:
        shape = (int(self.cfg.pop_size), self.k_dim)
        if self.noise is None:
            return self._rand(shape)
        return torch.as_tensor(self.noise.population, dtype=torch.float32,
                               device=self.dev)

    def evolve(self, gen: int):
        """-> (tournament i64[n_ch, 2, 2], crossover bool[n_ch, K],
        mutation f32[n_ch, K]) making generation ``gen``."""
        n_ch = int(self.cfg.pop_size) - self.cfg.n_elites
        if self.noise is None:
            cand = torch.randint(0, int(self.cfg.pop_size), (n_ch, 2, 2),
                                 generator=self.gen, device=self.dev)
            keep = self._rand((n_ch, self.k_dim)) < self.cfg.crossover_p
            normal = torch.randn((n_ch, self.k_dim), generator=self.gen,
                                 device=self.dev)
            return cand, keep, normal
        return (self._held("tournament", gen).long(),
                self._held("crossover", gen).bool(),
                self._held("mutation", gen).to(torch.float32))

    def baseline(self, gen: int) -> torch.Tensor:
        if self.noise is None:
            return self._rand((int(self.cfg.pop_size), self.k_dim))
        return self._held("baseline", gen).to(torch.float32)


def family_representatives(backend: str = "torch") -> Dict[str, str]:
    """First registered policy per registry family (registration order
    = paper order), the envelope's per-family champions."""
    from repro_torch.registry import get_spec, list_policies

    out: Dict[str, str] = {}
    for name in list_policies(backend=backend):
        fam = get_spec(name, backend=backend).family
        out.setdefault(fam, name)
    return out


def _scenario_oracle(spec: FamilySpec, cfg: SearchConfig, draws: _Draws):
    """``genomes f32[P, K] -> (rates, active)`` with the population
    flattened into one fleet batch ``[P * S, iters, n]`` (constant across
    generations, so the runner's cache entry stays warm).  Each genome is
    repaired, read to the host as knobs (one ``[P, K]`` copy a
    generation), and drawn from a generator seeded with the search's one
    scenario seed, so genome ``i``'s rows are exactly
    ``generate_masked_scenario(family, scenario_seed, S, iters, n,
    **knobs_i)``: fitness differences are knob differences, not noise
    realizations."""
    s = int(cfg.scenarios_per_genome)
    if draws.noise is not None and draws.noise.scenario is not None:
        scenario = draws.noise.scenario
    else:
        def scenario(**knobs):
            return generate_masked_scenario(
                spec.name, draws.scenario_seed, s, cfg.iters, cfg.n,
                capacity=cfg.capacity, device=draws.dev, **knobs)

    def batch(genomes: torch.Tensor):
        rows = [scenario(**genome_knobs(spec, g))
                for g in repair_genome(spec, genomes).cpu().numpy()]
        p = genomes.shape[0]
        sp = torch.stack([r[0] for r in rows]).to(torch.float32)
        ac = torch.stack([r[1] for r in rows]).bool()
        return (sp.reshape(p * s, cfg.iters, cfg.n),
                ac.reshape(p * s, cfg.iters, cfg.n))

    return batch


def _evolve(spec: FamilySpec, cfg: SearchConfig, pop: torch.Tensor,
            fit: torch.Tensor, cand: torch.Tensor, keep: torch.Tensor,
            normal: torch.Tensor) -> torch.Tensor:
    """One generation's transition ``(pop, fitness, draws) -> pop``:
    the ``n_elites`` fittest (a stable sort: ties keep population order),
    then ``P - n_elites`` children, each of two tournament-2 parents (the
    first candidate wins a tie), crossed over gene by gene, mutated by
    ``normal * mutation_scale * span`` and repaired, each operation in
    f32 in the reference's written order."""
    lo, hi = genome_bounds(spec)
    span = torch.from_numpy(hi - lo).to(pop.device)
    order = torch.argsort(-fit, stable=True)
    elites = pop[order[:cfg.n_elites]]
    better = (fit[cand[..., 0]] >= fit[cand[..., 1]])[..., None]
    parents = torch.where(better, pop[cand[..., 0]], pop[cand[..., 1]])
    child = torch.where(keep, parents[:, 0], parents[:, 1])
    noise = normal * cfg.mutation_scale * span
    child = child + noise
    return torch.cat([elites, repair_genome(spec, child)], 0)


def _evaluate(runner: FleetRunner, policy: str, sim: LagSimConfig,
              cfg: SearchConfig, oracle, pop: torch.Tensor, device
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (fitness f32[P], violation_frac f32[P], incidents f32[P]),
    each genome averaged over its ``scenarios_per_genome`` traces."""
    rates, active = oracle(pop)
    fb = runner.fitness([policy], rates, sim, active=active,
                        incident_weight=cfg.incident_weight, device=device)
    p, s = pop.shape[0], int(cfg.scenarios_per_genome)
    mean = lambda a: np.asarray(a[0]).reshape(p, s).mean(axis=1)  # noqa: E731
    return mean(fb.fitness), mean(fb.violation_frac), mean(fb.incidents)


def _run(policy: str, family: str, method: str, config: SearchConfig,
         sim: LagSimConfig, seed: int, runner: Optional[FleetRunner],
         budget_evals: Optional[int], noise: Optional[SearchNoise],
         device) -> SearchResult:
    spec = family_spec(family)
    if not spec.knobs:
        raise ValueError(
            f"family {family!r} registers no knobs; nothing to search")
    dev = resolve_device(device)
    runner = runner if runner is not None else FleetRunner()
    draws = _Draws(noise, seed, dev, len(spec.knobs), config)
    oracle = _scenario_oracle(spec, config, draws)
    budget = (int(budget_evals) if budget_evals is not None
              else config.pop_size * config.generations)
    pop = random_population(spec, None, config.pop_size,
                            uniforms=draws.population())
    best_fit = -np.inf
    best_vf = best_inc = 0.0
    best_genome = pop[0].cpu().numpy()
    history: List[float] = []
    evals = 0
    stall = 0
    gen = 0
    while evals < budget:
        fit, vf, inc = _evaluate(runner, policy, sim, config, oracle, pop,
                                 dev)
        evals += config.pop_size
        i = int(np.argmax(fit))
        if float(fit[i]) > best_fit + config.min_delta:
            stall = 0
        else:
            stall += 1
        if float(fit[i]) > best_fit:
            best_fit = float(fit[i])
            best_vf, best_inc = float(vf[i]), float(inc[i])
            best_genome = pop[i].cpu().numpy().astype(np.float32).copy()
        history.append(best_fit)
        gen += 1
        if method == "evolution" and stall >= config.patience:
            break
        if evals < budget:
            if method == "evolution":
                pop = _evolve(spec, config, pop,
                              torch.from_numpy(fit).to(dev),
                              *draws.evolve(gen))
            else:
                pop = random_population(spec, None, config.pop_size,
                                        uniforms=draws.baseline(gen))
    return SearchResult(
        policy=policy.upper(), family=spec.name, method=method,
        best_fitness=best_fit, best_violation_frac=best_vf,
        best_incidents=best_inc, best_genome=best_genome,
        best_knobs=genome_knobs(spec, best_genome), history=history,
        evals=evals, generations_run=gen, seed=int(seed))


def attack(policy: str, *, family: str = "adversarial",
           config: SearchConfig = SearchConfig(),
           sim: LagSimConfig = LagSimConfig(), seed: int = 0,
           runner: Optional[FleetRunner] = None,
           noise: Optional[SearchNoise] = None,
           device=None) -> SearchResult:
    """Evolve the scenario genome that maximizes ``policy``'s SLO damage
    on ``device`` (``None`` = the CUDA card).  A fixed ``seed`` gives a
    bit-identical search on one device type; ``noise`` replaces every
    draw."""
    return _run(policy, family, "evolution", config, sim, seed, runner,
                None, noise, device)


def random_search(policy: str, *, family: str = "adversarial",
                  config: SearchConfig = SearchConfig(),
                  sim: LagSimConfig = LagSimConfig(), seed: int = 0,
                  runner: Optional[FleetRunner] = None,
                  evals: Optional[int] = None,
                  noise: Optional[SearchNoise] = None,
                  device=None) -> SearchResult:
    """Uniform-random baseline at an explicit eval budget (pass the
    evolution's ``result.evals`` for an eval-for-eval comparison).  With
    the same ``seed`` it shares the evolution's scenario seed and initial
    population."""
    return _run(policy, family, "random", config, sim, seed, runner,
                evals, noise, device)


__all__ = [
    "SearchConfig",
    "SearchNoise",
    "SearchResult",
    "attack",
    "family_representatives",
    "random_search",
]

"""Batched synthetic workload scenarios, made on the device.

Each family is split in two: a **draw** step that takes a
``torch.Generator`` and makes every random number the family needs on
the generator's device, and a **transform** step that turns those draws
into rates ``f32[B, T, N]`` (and a mask).  The transforms follow the
reference ``repro.core.scenarios`` operation for operation, so fed the
same draws (tests replay the reference's ``jax.random`` stream) they give
the same traces; the PRNG streams themselves never agree.  A draw
function takes the knobs that change its draws (a Bernoulli probability,
a uniform's bounds); the transform takes the rest.

Families, in the reference's registration order:

* ``random_walk`` -- the paper's Eq. 11 walk, clipped at 0 every step.
* ``diurnal``     -- day/night cycle with per-partition phase and
                     amplitude plus walk noise.
* ``ramp``        -- linear growth or decay per partition.
* ``bursty``      -- flash crowds: Bernoulli spike arrivals with
                     geometric decay riding a calm baseline.
* ``churn``       -- partitions flip between hot and idle at random
                     switch times (masked: an idle partition is absent).
* ``heavy_tail``  -- log-normal per-partition base rates with
                     multiplicative noise.
* ``topic_lifecycle`` -- partitions born and dying at random times (a
                     true mask).
* ``adversarial`` -- the composite family a scenario search evolves:
                     heavy-tailed skew under a timed burst plateau, churn
                     and lifecycle windows, rates clamped to capacity.

Every family is registered as a :class:`FamilySpec` with its knobs
(:class:`KnobSpec`: bounds and default), as the reference registers them.
``generate_scenario`` / ``generate_masked_scenario`` and the suites take
a seed (or a ``torch.Generator``) in place of the reference's key, and a
``device`` (``None`` = the CUDA card).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device


def _uniform(gen, shape, lo: float, hi: float):
    """U(lo, hi) draws on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _bernoulli(gen, shape, p: float):
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _walk(steps, step_scale, init):
    """Unclipped drift: ``init + cumsum(steps * step_scale)`` with a zero
    first step; ``steps`` are U(-1, 1) draws ``[B, T-1, N]``."""
    steps = steps * step_scale
    zero = torch.zeros_like(init).unsqueeze(1)
    return init.unsqueeze(1) + torch.cat([zero, torch.cumsum(steps, 1)], 1)


def _iota(draws_like, iters: int):
    """Step indices ``f32[1, T, 1]`` on the draws' device."""
    return torch.arange(iters, dtype=torch.float32,
                        device=draws_like.device)[None, :, None]


def _concrete_float(x) -> Optional[float]:
    """``x`` as a Python float when it is a host-side constant, ``None``
    otherwise (a tensor knob is not forced to the host)."""
    if isinstance(x, (bool, int, float, np.floating, np.integer)):
        return float(x)
    return None


def _check_lifecycle_window(birth, death, *, birth_name: str,
                            death_name: str) -> None:
    """An empty lifecycle window (death precedes birth) is rejected by
    name when both knobs are host-side constants."""
    b, d = _concrete_float(birth), _concrete_float(death)
    if b is not None and d is not None and d < b:
        raise ValueError(
            f"lifecycle window is empty: death precedes birth "
            f"({death_name}={d!r} < {birth_name}={b!r}); a partition's "
            f"death step must not precede its birth step")


def random_walk_draws(gen, batch: int, iters: int, n: int
                      ) -> Dict[str, torch.Tensor]:
    return dict(init=_uniform(gen, (batch, n), 0.0, 1.0),
                steps=_uniform(gen, (iters - 1, batch, n), -1.0, 1.0))


def random_walk(draws, *, capacity: float = 1.0, delta: float = 10.0):
    """The paper's Eq. 11 stream: ``s_i = max{0, s_{i-1} + phi}``, phi ~
    U[-delta, delta] percent of C, clipped every step in step order (the
    reference's ``lax.scan``).  ``init`` is U(0, 1) scaled by C."""
    init = draws["init"] * capacity
    phi = draws["steps"] * (delta / 100.0 * capacity)
    out = torch.empty((init.shape[0], phi.shape[0] + 1, init.shape[1]),
                      dtype=torch.float32, device=init.device)
    out[:, 0] = s = init
    for t in range(phi.shape[0]):
        s = torch.clamp(s + phi[t], min=0.0)
        out[:, t + 1] = s
    return out


def diurnal_draws(gen, batch: int, iters: int, n: int, *,
                  amplitude: float = 0.4) -> Dict[str, torch.Tensor]:
    return dict(
        mean=_uniform(gen, (batch, 1, n), 0.1, 0.6),
        phase=_uniform(gen, (batch, 1, n), 0.0, 2 * math.pi),
        amp=_uniform(gen, (batch, 1, n), 0.0, amplitude),
        steps=_uniform(gen, (batch, iters - 1, n), -1.0, 1.0))


def diurnal(draws, *, capacity: float = 1.0, period: int = 96,
            noise: float = 0.02):
    """Day/night cycle: per-partition mean, phase and amplitude plus walk
    noise; ``period`` is the cycle length in steps."""
    mean = draws["mean"] * capacity
    amp = draws["amp"] * capacity
    b, t1, n = draws["steps"].shape
    dev = mean.device
    t = torch.arange(t1 + 1, dtype=torch.float32, device=dev)[None, :, None]
    x = 2 * math.pi * t
    x = x / torch.full_like(x, period)      # exact division, as the reference
    wave = mean + amp * torch.sin(x + draws["phase"])
    drift = _walk(draws["steps"], noise * capacity,
                  torch.zeros(b, n, device=dev))
    return torch.clamp(wave + drift, min=0.0)


def ramp_draws(gen, batch: int, iters: int, n: int, *,
               max_slope: float = 1.5) -> Dict[str, torch.Tensor]:
    return dict(
        init=_uniform(gen, (batch, 1, n), 0.0, 0.8),
        slope=_uniform(gen, (batch, 1, n), -max_slope, max_slope),
        steps=_uniform(gen, (batch, iters - 1, n), -1.0, 1.0))


def ramp(draws, *, capacity: float = 1.0, noise: float = 0.02):
    """Linear ramps: each partition grows or decays toward a target over
    the trace (``max_slope``, a draw knob, bounds the total change in
    units of C), plus walk noise."""
    init = draws["init"] * capacity
    slope = draws["slope"] * capacity
    b, t1, n = draws["steps"].shape
    t = _iota(init, t1 + 1)
    t = t / torch.full_like(t, max(t1, 1))  # exact division, as the reference
    drift = _walk(draws["steps"], noise * capacity,
                  torch.zeros(b, n, device=init.device))
    return torch.clamp(init + slope * t + drift, min=0.0)


def bursty_draws(gen, batch: int, iters: int, n: int, *,
                 p_spike: float = 0.02) -> Dict[str, torch.Tensor]:
    return dict(
        floor=_uniform(gen, (batch, 1, n), 0.2, 1.0),
        arrive=torch.rand((iters, batch, n), generator=gen,
                          device=gen.device) < p_spike,
        size=_uniform(gen, (iters, batch, n), 0.3, 1.0))


def bursty(draws, *, capacity: float = 1.0, base: float = 0.15,
           spike: float = 1.0, decay: float = 0.8):
    """Flash crowds: a calm baseline plus Bernoulli spike arrivals that
    decay geometrically (``decay`` per step)."""
    floor = draws["floor"] * base * capacity
    size = draws["size"] * spike * capacity
    arrive = draws["arrive"]
    level = torch.zeros_like(size[0])
    levels = []
    for t in range(size.shape[0]):
        level = torch.maximum(level * decay,
                              torch.where(arrive[t], size[t], 0.0))
        levels.append(level)
    return floor + torch.stack(levels, 1)


def _flip_timeline(state0, flips):
    """On/off ``bool[B, T, N]``: the parity of the running flip count
    ``flips [T, B, N]`` toggles the initial state ``state0 [B, N]``."""
    parity = torch.cumsum(flips.to(torch.int32), 0) % 2
    return (state0[None] ^ (parity == 1)).permute(1, 0, 2)


def churn_draws(gen, batch: int, iters: int, n: int, *,
                p_flip: float = 0.02) -> Dict[str, torch.Tensor]:
    return dict(
        state0=_bernoulli(gen, (batch, n), 0.5),
        flips=_bernoulli(gen, (iters, batch, n), p_flip),
        level=_uniform(gen, (batch, 1, n), 0.5, 1.5),
        jitter=_uniform(gen, (batch, iters, n), -1.0, 1.0))


def _churn_state(draws, capacity, hot, noise):
    on = _flip_timeline(draws["state0"], draws["flips"])
    level = draws["level"] * hot * capacity
    jitter = 1.0 + draws["jitter"] * noise
    return on, level, jitter


def churn(draws, *, capacity: float = 1.0, hot: float = 0.5,
          idle: float = 0.01, noise: float = 0.05):
    """Consumer churn: partitions toggle between a hot rate and near-idle
    at random flip times; the legacy unmasked form fakes a dead topic as
    ``idle * capacity``."""
    on, level, jitter = _churn_state(draws, capacity, hot, noise)
    return torch.clamp(torch.where(on, level, idle * capacity) * jitter,
                       min=0.0)


def churn_masked(draws, *, capacity: float = 1.0, hot: float = 0.5,
                 noise: float = 0.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """True-mask churn: the same on/off timeline as ``churn`` (the same
    draws give the same flips), an off partition absent (speed 0,
    ``active`` False)."""
    on, level, jitter = _churn_state(draws, capacity, hot, noise)
    return torch.clamp(torch.where(on, level * jitter, 0.0), min=0.0), on


def heavy_tail_draws(gen, batch: int, iters: int, n: int
                     ) -> Dict[str, torch.Tensor]:
    return dict(
        normal=torch.randn((batch, 1, n), generator=gen, device=gen.device),
        steps=_uniform(gen, (batch, iters - 1, n), -1.0, 1.0))


def heavy_tail(draws, *, capacity: float = 1.0, sigma: float = 1.2,
               scale: float = 0.1, noise: float = 0.1):
    """Heavy-tailed skew: log-normal per-partition base rates (a few
    whales dominate) with multiplicative log-space walk noise."""
    base = torch.exp(draws["normal"] * sigma) * scale * capacity
    b, _, n = draws["steps"].shape
    wob = _walk(draws["steps"], noise,
                torch.zeros(b, n, device=base.device))
    return base * torch.exp(wob)


def topic_lifecycle_draws(gen, batch: int, iters: int, n: int, *,
                          p_alive0: float = 0.5, min_life_frac: float = 0.15
                          ) -> Dict[str, torch.Tensor]:
    if min_life_frac < 0.0:
        raise ValueError(
            f"lifecycle window is empty: death precedes birth "
            f"(min_life_frac={min_life_frac!r} < 0 allows a negative "
            f"lifetime); min_life_frac must be >= 0")
    return dict(
        alive0=torch.rand((batch, n), generator=gen,
                          device=gen.device) < p_alive0,
        birth=_uniform(gen, (batch, n), 0.0, float(iters)),
        life=_uniform(gen, (batch, n), min_life_frac * iters, float(iters)),
        level=_uniform(gen, (batch, 1, n), 0.3, 1.5),
        steps=_uniform(gen, (batch, iters - 1, n), -1.0, 1.0))


def topic_lifecycle_masked(draws, *, capacity: float = 1.0, hot: float = 0.5,
                           noise: float = 0.1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition births and deaths: one lifetime window ``[birth, death)``
    each (alive from step 0 with probability ``p_alive0``); a hot level
    with walk noise inside it, absent (speed 0, ``active`` False) outside.
    Returns ``(speeds f32[B, T, N], active bool[B, T, N])``."""
    birth = torch.where(draws["alive0"], 0.0, draws["birth"])
    death = birth + draws["life"]
    b, t1, n = draws["steps"].shape
    dev = birth.device
    t = torch.arange(t1 + 1, dtype=torch.float32, device=dev)[None, :, None]
    active = (t >= birth.unsqueeze(1)) & (t < death.unsqueeze(1))
    level = draws["level"] * hot * capacity
    drift = _walk(draws["steps"], noise * capacity,
                  torch.zeros(b, n, device=dev))
    speeds = torch.where(active, torch.clamp(level + drift, min=0.0), 0.0)
    return speeds, active


def topic_lifecycle(draws, *, capacity: float = 1.0, hot: float = 0.5,
                    noise: float = 0.1):
    """Legacy unmasked view of ``topic_lifecycle_masked``: a partition
    outside its lifetime window shows speed 0."""
    return topic_lifecycle_masked(draws, capacity=capacity, hot=hot,
                                  noise=noise)[0]


def adversarial_draws(gen, batch: int, iters: int, n: int, *,
                      churn_p: float = 0.0) -> Dict[str, torch.Tensor]:
    return dict(
        tail=torch.randn((batch, 1, n), generator=gen, device=gen.device),
        state0=_bernoulli(gen, (batch, n), 0.9),
        flips=_bernoulli(gen, (iters, batch, n), churn_p),
        select=_uniform(gen, (batch, 1, n), 0.0, 1.0),
        jitter=_uniform(gen, (batch, iters, n), -1.0, 1.0))


def adversarial_masked(draws, *, capacity: float = 1.0,
                       base_rate: float = 0.2, tail_sigma: float = 1.0,
                       burst_start_frac: float = 0.4,
                       burst_len_frac: float = 0.25, burst_amp: float = 1.5,
                       lifecycle_frac: float = 0.0, birth_frac: float = 0.0,
                       death_frac: float = 1.0, noise: float = 0.05
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composite family a scenario search evolves: log-normal
    partition weights (index ``tail_sigma``, mean-normalised so
    ``base_rate`` stays the fleet average), a burst plateau of ``burst_amp
    * capacity`` over ``[burst_start_frac, burst_start_frac +
    burst_len_frac) * iters``, churn flips at rate ``churn_p`` (a draw
    knob) and a lifecycle window ``[birth_frac, death_frac) * iters`` on a
    ``lifecycle_frac`` share of the partitions.  An empty window (death
    before birth) raises a named ``ValueError`` for host-side knobs;
    otherwise ``death >= birth`` is clamped.  Rates clamp to
    ``capacity`` (one consumer drains any single partition)."""
    _check_lifecycle_window(birth_frac, death_frac,
                            birth_name="birth_frac", death_name="death_frac")
    b, iters, n = draws["jitter"].shape
    f32 = lambda x: float(np.float32(x))  # noqa: E731  (the reference's f32 knobs)
    w = torch.exp(draws["tail"] * tail_sigma)
    w = w / w.mean(2, keepdim=True)
    t = _iota(w, iters)
    start = f32(np.float32(burst_start_frac) * np.float32(iters))
    stop = f32(np.float32(start) + np.float32(burst_len_frac)
               * np.float32(iters))
    plateau = ((t >= start) & (t < stop)).to(torch.float32)
    level = (f32(base_rate) + f32(burst_amp) * plateau) * capacity * w
    jitter = 1.0 + draws["jitter"] * noise
    on = _flip_timeline(draws["state0"], draws["flips"])
    subject = draws["select"] < lifecycle_frac
    birth = f32(np.float32(birth_frac) * np.float32(iters))
    death = f32(max(np.float32(death_frac), np.float32(birth_frac))
                * np.float32(iters))
    in_window = (t >= birth) & (t < death)
    active = on & torch.where(subject, in_window, True)
    speeds = torch.clamp(level * jitter, 0.0, capacity)
    return torch.where(active, speeds, 0.0), active


def adversarial(draws, *, capacity: float = 1.0, **knobs):
    """Legacy unmasked view of ``adversarial_masked`` (absence degraded
    to speed 0)."""
    return adversarial_masked(draws, capacity=capacity, **knobs)[0]


# ---------------------------------------------------------------------------
# the family registry
# ---------------------------------------------------------------------------

#: a generator ``(gen, batch, iters, n, *, capacity=1.0, **knobs)``:
#: rates ``f32[B, T, N]``, or ``(rates, active bool[B, T, N])`` when masked
ScenarioFn = Callable[..., torch.Tensor]
MaskedScenarioFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One genome-searchable knob of a scenario family: closed bounds
    ``[lo, hi]`` a search may explore, plus the generator's default.
    Bounds are the search space, not hard limits."""

    name: str
    lo: float
    hi: float
    default: float

    def __post_init__(self) -> None:
        if not self.lo <= self.default <= self.hi:
            raise ValueError(
                f"knob {self.name!r}: default {self.default!r} outside "
                f"bounds [{self.lo!r}, {self.hi!r}]")


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """One registered scenario family: its unmasked and masked
    generators, the knobs a genome may turn (:class:`KnobSpec` order =
    genome vector order), and ``ordered`` pairs ``(lo_knob, hi_knob)``
    whose values must satisfy ``lo <= hi``."""

    name: str
    fn: ScenarioFn
    masked_fn: MaskedScenarioFn
    knobs: Tuple[KnobSpec, ...] = ()
    ordered: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        names = {k.name for k in self.knobs}
        for lo, hi in self.ordered:
            if lo not in names or hi not in names:
                raise ValueError(
                    f"family {self.name!r}: ordered pair ({lo!r}, {hi!r}) "
                    f"names unregistered knobs; have {sorted(names)}")

    @property
    def knob_names(self) -> Tuple[str, ...]:
        return tuple(k.name for k in self.knobs)


#: the family registry, in registration order
FAMILY_SPECS: Dict[str, FamilySpec] = {}
SCENARIO_FAMILIES: Dict[str, ScenarioFn] = {}
MASKED_SCENARIO_FAMILIES: Dict[str, MaskedScenarioFn] = {}


def _all_active(fn: ScenarioFn) -> MaskedScenarioFn:
    """Lift an always-on family into the masked contract."""
    def gen(g, batch, iters, n, **kw):
        speeds = fn(g, batch, iters, n, **kw)
        return speeds, torch.ones_like(speeds, dtype=torch.bool)
    return gen


def register_family(name: str, fn: ScenarioFn, *,
                    masked_fn: Optional[MaskedScenarioFn] = None,
                    knobs: Sequence[KnobSpec] = (),
                    ordered: Sequence[Tuple[str, str]] = ()) -> FamilySpec:
    """Register a scenario family.  ``masked_fn=None`` lifts ``fn`` into
    the masked contract with an all-``True`` mask."""
    if name in FAMILY_SPECS:
        raise ValueError(f"scenario family {name!r} already registered")
    spec = FamilySpec(name=name, fn=fn,
                      masked_fn=(masked_fn if masked_fn is not None
                                 else _all_active(fn)),
                      knobs=tuple(knobs), ordered=tuple(ordered))
    FAMILY_SPECS[name] = spec
    SCENARIO_FAMILIES[name] = spec.fn
    MASKED_SCENARIO_FAMILIES[name] = spec.masked_fn
    return spec


def family_spec(name: str) -> FamilySpec:
    """The registered :class:`FamilySpec` of ``name`` (named error)."""
    if name not in FAMILY_SPECS:
        raise ValueError(f"unknown scenario family {name!r}; "
                         f"have {sorted(FAMILY_SPECS)}")
    return FAMILY_SPECS[name]


def _generator_of(draws_fn, transform):
    """A family generator: ``draws_fn``'s draws (taking the knobs that are
    its keyword parameters), then ``transform`` (taking the rest)."""
    draw_knobs = {name for name, p in
                  inspect.signature(draws_fn).parameters.items()
                  if p.kind is p.KEYWORD_ONLY}

    def generate(gen, batch, iters, n, *, capacity=1.0, **knobs):
        dk = {k: knobs.pop(k) for k in draw_knobs & set(knobs)}
        return transform(draws_fn(gen, batch, iters, n, **dk),
                         capacity=capacity, **knobs)
    return generate


K = KnobSpec
register_family("random_walk",
                _generator_of(random_walk_draws, random_walk),
                knobs=(K("delta", 1.0, 40.0, 10.0),))
register_family("diurnal", _generator_of(diurnal_draws, diurnal), knobs=(
    K("period", 16.0, 192.0, 96.0), K("amplitude", 0.0, 1.0, 0.4),
    K("noise", 0.0, 0.1, 0.02)))
register_family("ramp", _generator_of(ramp_draws, ramp), knobs=(
    K("max_slope", 0.0, 3.0, 1.5), K("noise", 0.0, 0.1, 0.02)))
register_family("bursty", _generator_of(bursty_draws, bursty), knobs=(
    K("base", 0.0, 0.5, 0.15), K("p_spike", 0.0, 0.2, 0.02),
    K("spike", 0.0, 4.0, 1.0), K("decay", 0.5, 0.99, 0.8)))
register_family("churn", _generator_of(churn_draws, churn),
                masked_fn=_generator_of(churn_draws, churn_masked), knobs=(
                    K("p_flip", 0.0, 0.2, 0.02), K("hot", 0.0, 1.5, 0.5),
                    K("noise", 0.0, 0.2, 0.05)))
register_family("heavy_tail", _generator_of(heavy_tail_draws, heavy_tail),
                knobs=(K("sigma", 0.0, 2.5, 1.2), K("scale", 0.01, 0.5, 0.1),
                       K("noise", 0.0, 0.3, 0.1)))
register_family("topic_lifecycle",
                _generator_of(topic_lifecycle_draws, topic_lifecycle),
                masked_fn=_generator_of(topic_lifecycle_draws,
                                        topic_lifecycle_masked), knobs=(
                    K("p_alive0", 0.0, 1.0, 0.5),
                    K("min_life_frac", 0.05, 1.0, 0.15),
                    K("hot", 0.0, 1.5, 0.5), K("noise", 0.0, 0.3, 0.1)))
register_family("adversarial", _generator_of(adversarial_draws, adversarial),
                masked_fn=_generator_of(adversarial_draws,
                                        adversarial_masked),
                knobs=(
                    K("base_rate", 0.05, 1.0, 0.2),
                    K("tail_sigma", 0.0, 2.5, 1.0),
                    K("burst_start_frac", 0.0, 0.9, 0.4),
                    K("burst_len_frac", 0.05, 0.6, 0.25),
                    K("burst_amp", 0.0, 4.0, 1.5),
                    K("churn_p", 0.0, 0.15, 0.0),
                    K("lifecycle_frac", 0.0, 1.0, 0.0),
                    K("birth_frac", 0.0, 1.0, 0.0),
                    K("death_frac", 0.0, 1.0, 1.0),
                    K("noise", 0.0, 0.2, 0.05)),
                ordered=(("birth_frac", "death_frac"),))
del K


# ---------------------------------------------------------------------------
# generation entry points
# ---------------------------------------------------------------------------

Seed = Union[int, torch.Generator]


def _generator(seed: Seed, device) -> torch.Generator:
    """A generator seeded ``seed`` on ``device`` (``None`` = the CUDA
    card), or ``seed`` itself when it is a ``torch.Generator`` (which
    draws on its own device)."""
    if isinstance(seed, torch.Generator):
        if device is not None and torch.device(device).type != seed.device.type:
            raise ValueError(
                f"the generator draws on {seed.device}, but device="
                f"{device!r} was asked for; pass device=None with a "
                f"generator")
        return seed
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def _lookup(table, family: str):
    if family not in table:
        raise ValueError(f"unknown scenario family {family!r}; "
                         f"have {sorted(table)}")
    return table[family]


def generate_scenario(family: str, seed: Seed, batch: int, iters: int,
                      n: int, *, capacity: float = 1.0, device=None,
                      **knobs) -> torch.Tensor:
    """One family's batch of traces ``f32[batch, iters, n]``, drawn on
    ``device`` from a generator seeded ``seed`` (or from the generator
    ``seed``).  The same seed and knobs give the same batch; ``knobs`` go
    to the family (e.g. ``delta=`` for random_walk)."""
    fn = _lookup(SCENARIO_FAMILIES, family)
    return fn(_generator(seed, device), batch, iters, n, capacity=capacity,
              **knobs).to(torch.float32)


def generate_masked_scenario(family: str, seed: Seed, batch: int,
                             iters: int, n: int, *, capacity: float = 1.0,
                             device=None, **knobs
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One family's batch under the masked contract: ``(speeds f32[B, T,
    N], active bool[B, T, N])``.  For the true-mask families (``churn``,
    ``topic_lifecycle``, ``adversarial``) the same seed gives the same
    on/off timeline as the unmasked generator; the others carry an
    all-``True`` mask."""
    fn = _lookup(MASKED_SCENARIO_FAMILIES, family)
    speeds, active = fn(_generator(seed, device), batch, iters, n,
                        capacity=capacity, **knobs)
    return speeds.to(torch.float32), active.bool()


def _split(seed: Seed, count: int, device):
    """``count`` independent generators derived from ``seed``: one seed
    each drawn from the base generator, on its device."""
    base = _generator(seed, device)
    seeds = torch.randint(0, 2 ** 62, (count,), generator=base,
                          device=base.device).tolist()
    return [torch.Generator(device=base.device).manual_seed(s)
            for s in seeds]


def scenario_suite(seed: Seed, batch: int, iters: int, n: int, *,
                   capacity: float = 1.0,
                   families: Sequence[str] = tuple(SCENARIO_FAMILIES),
                   device=None) -> Dict[str, torch.Tensor]:
    """One batch per family, each from its own generator (position ``i``
    of ``families`` takes the ``i``-th generator split from ``seed``):
    ``{family: f32[B, T, N]}``."""
    gens = _split(seed, len(families), device)
    return {f: generate_scenario(f, g, batch, iters, n, capacity=capacity)
            for f, g in zip(families, gens)}


def masked_scenario_suite(seed: Seed, batch: int, iters: int, n: int, *,
                          capacity: float = 1.0,
                          families: Sequence[str] = tuple(
                              MASKED_SCENARIO_FAMILIES),
                          device=None
                          ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Masked twin of ``scenario_suite``: ``{family: (speeds, active)}``,
    split exactly like it, so a family's draws match between the two
    suites."""
    gens = _split(seed, len(families), device)
    return {f: generate_masked_scenario(f, g, batch, iters, n,
                                        capacity=capacity)
            for f, g in zip(families, gens)}


def stack_suite(suite: Dict[str, torch.Tensor]
                ) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """Flatten a suite into ``(labels[B_total], f32[B_total, T, N])``;
    ``labels[i]`` names trace i's family."""
    labels = tuple(f for f, v in suite.items() for _ in range(v.shape[0]))
    return labels, torch.cat(list(suite.values()), 0)


def stack_masked_suite(suite: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
                       ) -> Tuple[Tuple[str, ...], torch.Tensor,
                                  torch.Tensor]:
    """Flatten a masked suite into ``(labels, speeds f32[B_total, T, N],
    active bool[B_total, T, N])``."""
    labels = tuple(f for f, (v, _) in suite.items()
                   for _ in range(v.shape[0]))
    return (labels, torch.cat([v for v, _ in suite.values()], 0),
            torch.cat([a for _, a in suite.values()], 0))

"""Built-in policies, in the reference's registration order:

  NF NFD FF FFD BF BFD WF WFD        (Sec. II-B classical, heuristic)
  MWF MBF MWFP MBFP                  (Sec. IV-B Algorithm 1, sticky)
  KEDA_LAG RATE_THRESHOLD            (idealized reactive baselines)
  KEDA_LAG_REAL CLOUD_RUN_CPU_LAG    (reactive scalers behind a control plane)
  ANNEAL ANNEAL_STICKY               (2024 follow-up optimizers)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pack import modified_any_fit, pack
from repro_torch.opt.anneal import anneal_assign

from . import register

ANNEAL_STICKY_LAMBDA = 4.0      # R-score weight of ANNEAL_STICKY
ANNEAL_CHAINS = 6               # chains per decision step
ANNEAL_STEPS = 48               # anneal steps per decision step
ANNEAL_SEED = 0x0A11EA1         # seed of each run's noise generator

# identity of each classical member: name -> (fit strategy, decreasing)
CLASSICAL_SPECS = (
    ("NF", "next", False), ("NFD", "next", True),
    ("FF", "first", False), ("FFD", "first", True),
    ("BF", "best", False), ("BFD", "best", True),
    ("WF", "worst", False), ("WFD", "worst", True),
)
# identity of each Modified Any Fit member: name -> (fit, consumer sort key)
MODIFIED_SPECS = (
    ("MWF", "worst", "cumulative"), ("MBF", "best", "cumulative"),
    ("MWFP", "worst", "max_partition"), ("MBFP", "best", "max_partition"),
)


def _packing_policy(packer, capacity, device):
    """Batched Policy over a one-shot packer: each step repacks the current
    speeds with the previous assignment as ``prev`` (sticky naming)."""

    def init(n_partitions: int):
        return torch.zeros((), dtype=torch.long, device=device)  # stateless

    def step(speeds, lag, prev_assign, state, active=None):
        res = packer(speeds, prev_assign, capacity, active=active)
        return res.bin_of, res.n_bins, state

    return init, step


def _register_classical(name: str, strategy: str, decreasing: bool) -> None:
    hyper = {"strategy": strategy, "decreasing": decreasing, "sticky": True}

    def one_shot(speeds, prev, capacity, active=None):
        return pack(speeds, prev, capacity, strategy=strategy,
                    decreasing=decreasing, active=active)

    @register(name, family="heuristic", hyperparams=hyper, packer=one_shot,
              paper_section="II-B",
              summary=f"{'offline decreasing ' if decreasing else 'online '}"
                      f"{strategy}-fit any-fit heuristic")
    def _build(n, capacity, device, *, strategy=strategy,
               decreasing=decreasing, sticky=True):
        def packer(speeds, prev, cap, active=None):
            return pack(speeds, prev, cap, strategy=strategy,
                        decreasing=decreasing, sticky=sticky, active=active)
        return _packing_policy(packer, capacity, device)


def _register_modified(name: str, fit: str, sort_key: str) -> None:
    hyper = {"fit": fit, "sort_key": sort_key}

    def one_shot(speeds, prev, capacity, active=None):
        return modified_any_fit(speeds, prev, capacity, fit=fit,
                                sort_key=sort_key, active=active)

    @register(name, family="sticky", hyperparams=hyper, packer=one_shot,
              paper_section="IV-B/IV-C",
              summary=f"Modified Any Fit: {fit}-fit insert, consumers "
                      f"sorted by {sort_key.replace('_', ' ')}")
    def _build(n, capacity, device, *, fit=fit, sort_key=sort_key):
        def packer(speeds, prev, cap, active=None):
            return modified_any_fit(speeds, prev, cap, fit=fit,
                                    sort_key=sort_key, active=active)
        return _packing_policy(packer, capacity, device)


for _name, _strategy, _dec in CLASSICAL_SPECS:
    _register_classical(_name, _strategy, _dec)
for _name, _fit, _key in MODIFIED_SPECS:
    _register_modified(_name, _fit, _key)


def _f32(x) -> float:
    """``x`` rounded to float32, as the reference's ``jnp.float32`` knobs."""
    return float(np.float32(x))


def _reactive_policy(kind: str, n: int, capacity, device, *, lag_threshold,
                     target_utilization, max_consumers, scale_down_patience):
    """KEDA-style reactive scaler: desired consumer count from a lag or
    rate threshold (``cpu_lag``: the larger of the two, KEDA's maximum over
    triggers), eager round-robin assignment (``partition % n``),
    immediate scale-up, patience-gated scale-down.  With an ``active``
    mask, dead partitions add no signal and take no round-robin seat
    (live partitions are ranked among the live set)."""
    pid = torch.arange(n, dtype=torch.long, device=device)
    if max_consumers is None:
        max_consumers = n
    if lag_threshold is None:
        lag_threshold = 2.0 * capacity
    lag_threshold = _f32(lag_threshold)
    # target_utilization * capacity is a float32 product in the reference
    rate_div = float(np.float32(target_utilization) * np.float32(capacity))
    max_c = int(max_consumers)
    patience = int(scale_down_patience)

    def init(n_partitions: int):
        one = torch.ones((), dtype=torch.long, device=device)
        return (one, torch.zeros((), dtype=torch.long, device=device))

    def step(speeds, lag, prev_assign, state, active=None):
        n_cur, under = state
        if active is not None:
            act = active.bool()
            speeds = torch.where(act, speeds, 0.0)
            lag = torch.where(act, lag, 0.0)
        # a tensor divisor: PyTorch on the card turns division by a Python
        # scalar into a multiply by its reciprocal, which rounds differently
        wants = []
        if kind in ("lag", "cpu_lag"):
            total = lag.sum(-1)
            wants.append(torch.ceil(total / torch.full_like(total,
                                                            lag_threshold)))
        if kind in ("rate", "cpu_lag"):
            total = speeds.sum(-1)
            wants.append(torch.ceil(total / torch.full_like(total,
                                                            rate_div)))
        want = wants[0] if len(wants) == 1 else torch.maximum(*wants)
        want = torch.clamp(want.long(), 1, max_c)
        under = torch.where(want < n_cur, under + 1, 0)
        go_down = under >= patience
        n_new = torch.where(want > n_cur, want,
                            torch.where(go_down, want, n_cur))
        under = torch.where(go_down, 0, under)
        if active is None:
            assign = pid % n_new.unsqueeze(-1)
        else:
            rank = torch.cumsum(act.long(), -1) - 1       # pid among live
            assign = torch.where(act, rank % n_new.unsqueeze(-1), -1)
        return assign, n_new, (n_new, under)

    return init, step


_REACTIVE_HYPER = {"lag_threshold": None, "target_utilization": 0.75,
                   "max_consumers": None, "scale_down_patience": 3}


@register("KEDA_LAG", family="reactive", hyperparams=_REACTIVE_HYPER,
          paper_section="reactive baseline",
          summary="KEDA lagThreshold rule: consumers = "
                  "ceil(total_lag / lag_threshold)")
def _build_keda_lag(n, capacity, device, **hyper):
    return _reactive_policy("lag", n, capacity, device, **hyper)


@register("RATE_THRESHOLD", family="reactive", hyperparams=_REACTIVE_HYPER,
          paper_section="reactive baseline",
          summary="consumption-rate target: consumers = "
                  "ceil(total_rate / (target_utilization * C))")
def _build_rate_threshold(n, capacity, device, **hyper):
    return _reactive_policy("rate", n, capacity, device, **hyper)


#: control-plane knobs every REAL scaler family declares (step units);
#: the lag twin overrides them from ``LagSimConfig.control_plane``
_KEDA_REAL_CP = {"polling_interval": 3, "observation_delay": 1,
                 "actuation_delay": 1, "cooldown_period": 20,
                 "min_replicas": 1, "max_replicas": None, "warmup_steps": 2}
_CLOUD_RUN_CP = {"polling_interval": 5, "observation_delay": 2,
                 "actuation_delay": 2, "cooldown_period": 10,
                 "min_replicas": 1, "max_replicas": None, "warmup_steps": 3}


def _real_reactive(kind, n, capacity, device, *, lag_threshold,
                   target_utilization, max_consumers, scale_down_patience,
                   **cp_knobs):
    """An idealized reactive scaler behind a control plane of ``cp_knobs``
    (imported here: the lag twin imports the registry)."""
    from repro_torch.lagsim.controlplane import (ControlPlaneConfig,
                                                 wrap_policy)

    inner = _reactive_policy(
        kind, n, capacity, device, lag_threshold=lag_threshold,
        target_utilization=target_utilization, max_consumers=max_consumers,
        scale_down_patience=scale_down_patience)
    return wrap_policy(*inner, ControlPlaneConfig(**cp_knobs), device=device)


@register("KEDA_LAG_REAL", family="reactive",
          hyperparams={**_REACTIVE_HYPER, **_KEDA_REAL_CP},
          paper_section="reactive baseline",
          summary="KEDA lagThreshold rule behind a faithful control plane "
                  "(pollingInterval/cooldownPeriod/warm-up storm)")
def _build_keda_lag_real(n, capacity, device, *, lag_threshold,
                         target_utilization, max_consumers,
                         scale_down_patience, **cp_knobs):
    return _real_reactive(
        "lag", n, capacity, device, lag_threshold=lag_threshold,
        target_utilization=target_utilization, max_consumers=max_consumers,
        scale_down_patience=scale_down_patience, **cp_knobs)


@register("CLOUD_RUN_CPU_LAG", family="reactive",
          hyperparams={**_REACTIVE_HYPER, **_CLOUD_RUN_CP},
          paper_section="reactive baseline",
          summary="Cloud Run style CPU+lag dual trigger (max of both) "
                  "behind a slow-polling control plane")
def _build_cloud_run_cpu_lag(n, capacity, device, *, lag_threshold,
                             target_utilization, max_consumers,
                             scale_down_patience, **cp_knobs):
    return _real_reactive(
        "cpu_lag", n, capacity, device, lag_threshold=lag_threshold,
        target_utilization=target_utilization, max_consumers=max_consumers,
        scale_down_patience=scale_down_patience, **cp_knobs)


def _anneal_policy(capacity, device, *, lam, chains, steps, noise=None):
    """Best-of-chains simulated-annealing repack once per decision step.
    The state is ``(decision index, generator)``: ``init`` seeds a fresh
    generator on ``device``, so two runs with the same inputs agree, and
    every row of a step shares the step's draws.  ``noise`` (a sequence
    of ``AnnealNoise``, one per decision) replaces the generator.
    ``active`` masks items out of the anneal: no chain moves them, they
    count toward no bin, and they come back ``-1``."""

    def init(n_partitions: int):
        if noise is not None:
            return (0, None)
        return (0, torch.Generator(device=device).manual_seed(ANNEAL_SEED))

    def step(speeds, lag, prev_assign, state, active=None):
        t, gen = state
        if noise is not None and t >= len(noise):
            raise ValueError(f"noise holds {len(noise)} decisions; decision "
                             f"{t} needs one more")
        assign, n_bins = anneal_assign(
            speeds, prev_assign, capacity, lam=lam, chains=chains,
            steps=steps, noise=None if noise is None else noise[t],
            generator=gen, active=active, device=device)
        return assign.long(), n_bins, (t + 1, gen)

    return init, step


@register("ANNEAL", family="optimizer",
          hyperparams={"lam": 0.0, "chains": ANNEAL_CHAINS,
                       "steps": ANNEAL_STEPS},
          paper_section="2024 follow-up",
          summary="batched SA minimizing consumer count alone "
                  "(rebalance-oblivious upper baseline)")
def _build_anneal(n, capacity, device, *, lam=0.0, chains=ANNEAL_CHAINS,
                  steps=ANNEAL_STEPS, noise=None):
    return _anneal_policy(capacity, device, lam=lam, chains=chains,
                          steps=steps, noise=noise)


@register("ANNEAL_STICKY", family="optimizer",
          hyperparams={"lam": ANNEAL_STICKY_LAMBDA, "chains": ANNEAL_CHAINS,
                       "steps": ANNEAL_STEPS},
          paper_section="2024 follow-up",
          summary="batched SA over bins + lambda*Rscore "
                  "(stability-priced optimizer)")
def _build_anneal_sticky(n, capacity, device, *, lam=ANNEAL_STICKY_LAMBDA,
                         chains=ANNEAL_CHAINS, steps=ANNEAL_STEPS,
                         noise=None):
    return _anneal_policy(capacity, device, lam=lam, chains=chains,
                          steps=steps, noise=noise)

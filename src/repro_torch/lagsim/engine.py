"""Closed-loop lag digital twin, batched over streams.

Per step ``t``, for every stream row at once:

  1. each partition produces ``rate[t] * dt`` bytes of backlog;
  2. the policy sees ``observed = lag + produced`` and maps the speeds and
     the previous assignment to a new assignment and a consumer count;
  3. a partition whose owner changed goes unreadable for
     ``migration_steps`` steps (``down``), others count down to 0;
  4. ``readable = (down == 0) & (assign >= 0)``;
  5. every consumer drains up to ``capacity * dt`` bytes from its readable
     partitions, proportionally to their backlog, over ``m = 2n + 2`` bin
     names (``lag_update``; the CUDA kernel with ``use_kernel=True``).

The step loop is a Python loop over T whose body never reads a device
value on the host, so the card is never stalled mid-run.  With
``fused_steps > 0`` the heuristic packers take the fused path instead
(``repro_torch.lagsim.fused``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.lag_update import (lag_update_batch,
                                            lag_update_reference)
from repro_torch.lagsim.fused import fused_mode, simulate_fused, sweep_fused
from repro_torch.registry import make_policy

NEG = -1


class NotPortedError(NotImplementedError):
    """A ``LagSimConfig`` field names a reference feature that later slices
    of the port bring (the control plane, in-loop telemetry)."""


@dataclasses.dataclass(frozen=True)
class LagSimConfig:
    """Static knobs of the twin, field for field the reference's.

    ``capacity`` is the consumer drain rate in bytes/s (the paper's C),
    ``dt`` the seconds per step.  ``lag_threshold`` / ``slo_lag`` /
    ``max_consumers`` default from capacity and the partition count when
    left ``None`` (see ``resolve``).  ``control_plane`` and ``telemetry``
    must stay ``None`` in this port: they raise :class:`NotPortedError`.
    """

    capacity: float = 1.0
    dt: float = 1.0
    migration_steps: int = 2
    lag_threshold: Optional[float] = None
    target_utilization: float = 0.75
    max_consumers: Optional[int] = None
    scale_down_patience: int = 3
    slo_lag: Optional[float] = None
    use_kernel: bool = False          # per-step drain through the CUDA kernel
    fused_steps: int = 0              # K > 0: fused path for heuristics
    fused_kernel: bool = False        # fused path launches loop_fused
    control_plane: Optional[Any] = None
    telemetry: Optional[Any] = None

    @property
    def slo_lag_or_default(self) -> float:
        """The metrics threshold; defaults to one consumer-step of drain."""
        return (self.slo_lag if self.slo_lag is not None
                else self.capacity * self.dt)

    def resolve(self, n: int) -> "LagSimConfig":
        """Validate, and fill derived defaults for ``n`` partitions."""
        for name in ("control_plane", "telemetry"):
            if getattr(self, name) is not None:
                raise NotPortedError(
                    f"LagSimConfig.{name} is not yet ported to repro_torch; "
                    f"leave it None (the JAX package repro.lagsim runs it)")
        if int(self.fused_steps) < 0:
            raise ValueError(
                f"fused_steps must be >= 0 (0 disables the fused path), "
                f"got {self.fused_steps}")
        if self.fused_kernel and not self.fused_steps:
            raise ValueError(
                "fused_kernel=True requires fused_steps > 0: the megakernel "
                "block size is fused_steps (steps advanced per launch)")
        return dataclasses.replace(
            self,
            lag_threshold=(self.lag_threshold if self.lag_threshold is not None
                           else 2.0 * self.capacity * self.dt),
            max_consumers=(self.max_consumers if self.max_consumers is not None
                           else n),
            slo_lag=self.slo_lag_or_default)


@dataclasses.dataclass
class LagTrace:
    """Per-step trajectories (axes ``[..., T]``)."""

    lag_total: torch.Tensor    # f32  total backlog after draining
    lag_max: torch.Tensor      # f32  worst single-partition backlog
    consumers: torch.Tensor    # i32  consumers billed this step
    migrations: torch.Tensor   # i32  partitions that changed owner
    unreadable: torch.Tensor   # i32  partitions in migration downtime


@dataclasses.dataclass
class LagSweepResult:
    """Stacked trajectories of a policy sweep, ``[policy, stream, t]``."""

    lag_total: torch.Tensor
    lag_max: torch.Tensor
    consumers: torch.Tensor
    migrations: torch.Tensor
    unreadable: torch.Tensor
    policies: Tuple[str, ...]

    def for_policy(self, name: str) -> LagTrace:
        p = self.policies.index(name.upper())
        return LagTrace(self.lag_total[p], self.lag_max[p], self.consumers[p],
                        self.migrations[p], self.unreadable[p])


_FIELDS = ("lag_total", "lag_max", "consumers", "migrations", "unreadable")


def _simulate(traces, initial_lag, policy: str, cfg: LagSimConfig,
              active=None, record_assign: bool = False, options=None):
    """The per-step loop: one policy over stream rows ``traces
    f32[B, T, N]`` -> a ``LagTrace`` of ``[B, T]`` tensors (and ``assigns [B, T, N]`` with
    ``record_assign``).  ``active`` (bool[B, T, N]) marks the partitions
    that exist: a masked one produces nothing, is assigned ``NEG``,
    drains no budget and ends every step at exactly 0 lag.  ``options``
    go to ``make_policy`` (an optimizer's injected ``noise``)."""
    b, t, n = traces.shape
    m = 2 * n + 2                       # packer bin-name universe
    cfg = cfg.resolve(n)
    dev = traces.device
    f32 = lambda x: float(np.float32(x))  # noqa: E731  (reference rounding)
    cap_step = f32(cfg.capacity * cfg.dt)
    dt = f32(cfg.dt)
    pol = make_policy(
        policy, n, f32(cfg.capacity), device=dev, strict=False,
        options=options, lag_threshold=f32(cfg.lag_threshold),
        target_utilization=f32(cfg.target_utilization),
        max_consumers=cfg.max_consumers,
        scale_down_patience=cfg.scale_down_patience)
    cap = torch.full((b, m), cap_step, dtype=torch.float32, device=dev)
    traces = traces.to(torch.float32)
    act_all = None if active is None else active.bool()
    lag = initial_lag.to(device=dev, dtype=torch.float32)
    assign = torch.full((b, n), NEG, dtype=torch.long, device=dev)
    down = torch.zeros((b, n), dtype=torch.long, device=dev)
    pstate = pol.init(n)
    out = {f: torch.empty((b, t), dtype=torch.float32 if f.startswith("lag")
                          else torch.int32, device=dev) for f in _FIELDS}
    assigns = (torch.empty((b, t, n), dtype=torch.int32, device=dev)
               if record_assign else None)
    for step in range(t):
        rate = traces[:, step]
        act = None if act_all is None else act_all[:, step]
        produced = rate * dt
        if act is not None:
            produced = torch.where(act, produced, 0.0)
        observed = lag + produced       # the backlog a lag scaler sees
        new_assign, n_active, pstate = pol.step(rate, observed, assign,
                                                pstate, act)
        moved = (assign >= 0) & (new_assign >= 0) & (new_assign != assign)
        down = torch.where(moved, cfg.migration_steps,
                           torch.clamp(down - 1, min=0))
        readable = (down == 0) & (new_assign >= 0)
        if cfg.use_kernel:
            lag = lag_update_batch(lag, produced, new_assign, readable, cap,
                                   active=act)
        else:
            lag = lag_update_reference(lag, produced, new_assign, readable,
                                       cap, m=m, active=act)
        blocked = down > 0
        unreadable = blocked if act is None else blocked & act
        out["lag_total"][:, step] = lag.sum(1)
        out["lag_max"][:, step] = lag.amax(1)
        out["consumers"][:, step] = n_active
        out["migrations"][:, step] = moved.sum(1)
        out["unreadable"][:, step] = unreadable.sum(1)
        if record_assign:
            assigns[:, step] = new_assign
        assign = new_assign
    trace = LagTrace(**out)
    return (trace, assigns) if record_assign else trace


def _check_shapes(traces, active, initial_lag, rank: int) -> None:
    what = "f32[T, N] (one stream)" if rank == 2 else "f32[B, T, N]"
    if traces.dim() != rank:
        raise ValueError(f"trace must be {what}; got shape "
                         f"{tuple(traces.shape)}")
    if active is not None and tuple(active.shape) != tuple(traces.shape):
        raise ValueError(
            f"active mask has shape {tuple(active.shape)} but the rates "
            f"have shape {tuple(traces.shape)}; the mask must name every "
            f"cell")
    n = traces.shape[-1]
    if initial_lag is not None and tuple(initial_lag.shape)[-1:] != (n,):
        raise ValueError(
            f"initial_lag has shape {tuple(initial_lag.shape)}, but "
            f"rates.shape[-1] gives n = {n} partitions")


def _as_tensor(x, dtype, dev):
    return None if x is None else torch.as_tensor(x).to(device=dev,
                                                        dtype=dtype)


def simulate_lag(trace, *, policy: str, cfg: LagSimConfig = LagSimConfig(),
                 initial_lag=None, active=None, record_assign: bool = False,
                 device=None, policy_options=None):
    """One policy over one stream ``f32[T, N]`` -> ``LagTrace`` of ``[T]``
    (or ``(LagTrace, assigns i32[T, N])`` with ``record_assign``).
    ``initial_lag`` (f32[N]) seeds the backlog; ``active`` (bool[T, N])
    masks partitions; ``policy_options`` maps a policy name to its
    ``make_policy`` options (see ``sweep_lag``).  ``device=None`` means
    the CUDA card."""
    dev = resolve_device(device)
    trace = _as_tensor(trace, torch.float32, dev)
    active = _as_tensor(active, torch.bool, dev)
    initial_lag = _as_tensor(initial_lag, torch.float32, dev)
    _check_shapes(trace, active, initial_lag, rank=2)
    if initial_lag is None:
        initial_lag = torch.zeros(trace.shape[1], device=dev)
    policy = policy.upper()
    n = trace.shape[1]
    if cfg.fused_steps and fused_mode(policy, cfg, n) == "fused":
        return simulate_fused(trace, initial_lag, policy, cfg, active=active,
                              record_assign=record_assign)
    res = _simulate(trace[None], initial_lag[None], policy, cfg,
                    None if active is None else active[None], record_assign,
                    (policy_options or {}).get(policy))
    if record_assign:
        tr, assigns = res
        return LagTrace(**{f: getattr(tr, f)[0] for f in _FIELDS}), assigns[0]
    return LagTrace(**{f: getattr(res, f)[0] for f in _FIELDS})


def sweep_lag(policies: Tuple[str, ...], traces,
              cfg: LagSimConfig = LagSimConfig(), active=None,
              device=None, policy_options=None) -> LagSweepResult:
    """Closed-loop sweep: every policy over a batch of streams
    ``f32[B, T, N]`` -> ``[P, B, T]`` trajectories.  The heuristic family
    runs as one family-batched fused call under ``fused_steps``; every
    other policy runs the per-step loop over all streams at once.
    ``policy_options`` maps a policy name to its ``make_policy`` options:
    ``{"ANNEAL": {"noise": [AnnealNoise, ...]}}`` injects the annealer's
    draws, one ``AnnealNoise`` per simulated step (one decision), shared
    by every stream.
    ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    traces = _as_tensor(traces, torch.float32, dev)
    active = _as_tensor(active, torch.bool, dev)
    _check_shapes(traces, active, None, rank=3)
    policies = tuple(p.upper() for p in policies)
    b, _, n = traces.shape
    cfg.resolve(n)                      # fail fast on bad knobs
    fused_fields = {}
    if cfg.fused_steps:
        group = tuple(p for p in policies
                      if fused_mode(p, cfg, n) == "fused")
        if group:
            fused_fields = sweep_fused(group, traces, cfg, active=active)
    zero = torch.zeros((b, n), dtype=torch.float32, device=dev)
    per_policy = [LagTrace(**fused_fields[p]) if p in fused_fields
                  else _simulate(traces, zero, p, cfg, active,
                                 options=(policy_options or {}).get(p))
                  for p in policies]
    return LagSweepResult(
        **{f: torch.stack([getattr(tr, f) for tr in per_policy])
           for f in _FIELDS}, policies=policies)

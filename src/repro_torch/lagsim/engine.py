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
from repro_torch.lagsim.controlplane import ControlPlaneConfig, wrap_policy
from repro_torch.lagsim.fused import fused_mode, simulate_fused, sweep_fused
from repro_torch.registry import make_policy
from repro_torch.telemetry.alerts import alert_init, alert_step
from repro_torch.telemetry.record import (TelemetryConfig, channel_names,
                                          frame_from_outputs,
                                          frame_from_ring, map_state,
                                          record_step, ring_init, ring_write)
from repro_torch.telemetry.sketch import sketch_init, sketch_update

NEG = -1


class NotPortedError(NotImplementedError):
    """A configuration names a reference feature that a later slice of the
    port brings."""


@dataclasses.dataclass(frozen=True)
class LagSimConfig:
    """Static knobs of the twin, field for field the reference's.

    ``capacity`` is the consumer drain rate in bytes/s (the paper's C),
    ``dt`` the seconds per step.  ``lag_threshold`` / ``slo_lag`` /
    ``max_consumers`` default from capacity and the partition count when
    left ``None`` (see ``resolve``).  ``control_plane`` runs every policy
    behind an emulated scaler control plane (``lagsim.controlplane``);
    ``telemetry`` turns on the in-loop recorder, sketches and alerts
    (``repro_torch.telemetry``).
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
    control_plane: Optional[ControlPlaneConfig] = None  # scaler friction
    telemetry: Optional[TelemetryConfig] = None  # in-loop flight recorder

    @property
    def telemetry_on(self) -> bool:
        """True when the in-loop recorder captures this config's runs."""
        return self.telemetry is not None and self.telemetry.enabled

    @property
    def slo_lag_or_default(self) -> float:
        """The metrics threshold; defaults to one consumer-step of drain."""
        return (self.slo_lag if self.slo_lag is not None
                else self.capacity * self.dt)

    def resolve(self, n: int) -> "LagSimConfig":
        """Validate, and fill derived defaults for ``n`` partitions."""
        if (self.control_plane is not None
                and not isinstance(self.control_plane, ControlPlaneConfig)):
            raise ValueError(
                f"control_plane must be a ControlPlaneConfig (or None), got "
                f"{type(self.control_plane).__name__}; build one via "
                f"repro_torch.api.ControlPlaneConfig(...)")
        if (self.telemetry is not None
                and not isinstance(self.telemetry, TelemetryConfig)):
            raise ValueError(
                f"telemetry must be a TelemetryConfig (or None), got "
                f"{type(self.telemetry).__name__}; build one via "
                f"repro_torch.api.TelemetryConfig(...)")
        if int(self.fused_steps) < 0:
            raise ValueError(
                f"fused_steps must be >= 0 (0 disables the fused path), "
                f"got {self.fused_steps}")
        if self.fused_kernel and not self.fused_steps:
            raise ValueError(
                "fused_kernel=True requires fused_steps > 0: the megakernel "
                "block size is fused_steps (steps advanced per launch)")
        tele = self.telemetry
        if (tele is not None and tele.sketch is not None
                and tele.sketch.hist_max is None):
            # default histogram range: eight consumer-steps of drain per
            # partition
            tele = dataclasses.replace(
                tele, sketch=dataclasses.replace(
                    tele.sketch,
                    hist_max=8.0 * self.capacity * self.dt * n))
        return dataclasses.replace(
            self,
            lag_threshold=(self.lag_threshold if self.lag_threshold is not None
                           else 2.0 * self.capacity * self.dt),
            max_consumers=(self.max_consumers if self.max_consumers is not None
                           else n),
            slo_lag=self.slo_lag_or_default,
            telemetry=tele)


@dataclasses.dataclass
class LagTrace:
    """Per-step trajectories (axes ``[..., T]``).  ``telemetry`` /
    ``sketch`` / ``incidents`` hold the recorder frame, the sketch state
    and the alert state when the config's ``TelemetryConfig`` turns them
    on (``None`` otherwise)."""

    lag_total: torch.Tensor    # f32  total backlog after draining
    lag_max: torch.Tensor      # f32  worst single-partition backlog
    consumers: torch.Tensor    # i32  consumers billed this step
    migrations: torch.Tensor   # i32  partitions that changed owner
    unreadable: torch.Tensor   # i32  partitions in migration downtime
    telemetry: Optional[Any] = None   # TelemetryFrame [..., R, K]
    sketch: Optional[Any] = None      # SketchState, leading [...]
    incidents: Optional[Any] = None   # AlertState, leading [...]


@dataclasses.dataclass
class LagSweepResult:
    """Stacked trajectories of a policy sweep, ``[policy, stream, t]``."""

    lag_total: torch.Tensor
    lag_max: torch.Tensor
    consumers: torch.Tensor
    migrations: torch.Tensor
    unreadable: torch.Tensor
    policies: Tuple[str, ...]
    telemetry: Optional[Any] = None   # frame [P, B, R, K]
    sketch: Optional[Any] = None      # leading [P, B]
    incidents: Optional[Any] = None   # leading [P, B]

    def for_policy(self, name: str) -> LagTrace:
        p = self.policies.index(name.upper())
        pick = lambda obj: map_state(lambda a: a[p], obj)  # noqa: E731
        return LagTrace(self.lag_total[p], self.lag_max[p], self.consumers[p],
                        self.migrations[p], self.unreadable[p],
                        telemetry=pick(self.telemetry),
                        sketch=pick(self.sketch),
                        incidents=pick(self.incidents))


_FIELDS = ("lag_total", "lag_max", "consumers", "migrations", "unreadable")
_OBS = ("telemetry", "sketch", "incidents")


def _simulate(traces, initial_lag, policy: str, cfg: LagSimConfig,
              active=None, record_assign: bool = False, options=None,
              valid=None):
    """The per-step loop: one policy over stream rows ``traces
    f32[B, T, N]`` -> a ``LagTrace`` of ``[B, T]`` tensors (and ``assigns
    [B, T, N]`` with ``record_assign``).  ``active`` (bool[B, T, N]) marks
    the partitions that exist: a masked one produces nothing, is assigned
    ``NEG``, drains no budget and ends every step at exactly 0 lag.
    ``options`` go to ``make_policy`` (an optimizer's injected ``noise``).

    With ``cfg.control_plane`` set, the policy runs behind it (a policy
    that built its own, a REAL scaler, takes its knobs and is not wrapped
    twice), and partitions of a warming consumer are unreadable.  With
    ``cfg.telemetry`` on, the recorder, sketch and alerts read what the
    step computed; ``valid`` (bool[B, T]) gates sketch and alert updates
    on padded steps.  Neither changes a trajectory, and with both off the
    loop dispatches no operation of theirs."""
    b, t, n = traces.shape
    m = 2 * n + 2                       # packer bin-name universe
    cfg = cfg.resolve(n)
    dev = traces.device
    f32 = lambda x: float(np.float32(x))  # noqa: E731  (reference rounding)
    cap_step = f32(cfg.capacity * cfg.dt)
    dt = f32(cfg.dt)
    cp = cfg.control_plane
    # strict=False: one uniform knob set for every policy; a REAL scaler
    # declares the control plane's knobs, so it takes the engine's
    pol = make_policy(
        policy, n, f32(cfg.capacity), device=dev, strict=False,
        options=options, lag_threshold=f32(cfg.lag_threshold),
        target_utilization=f32(cfg.target_utilization),
        max_consumers=cfg.max_consumers,
        scale_down_patience=cfg.scale_down_patience,
        **({} if cp is None else cp.knobs()))
    init, policy_step = pol.init, pol.step
    if cp is not None and not getattr(policy_step, "_controlplane_wrapped",
                                      False):
        init, policy_step = wrap_policy(init, policy_step, cp, device=dev)
    # the storm exists only behind a control plane; the marker finds the
    # REAL scalers' own even when cfg.control_plane is None
    has_cp = getattr(policy_step, "_controlplane_wrapped", False)
    tele = cfg.telemetry if cfg.telemetry_on else None
    frames_on = tele is not None and tele.record_frames
    sketch_on = tele is not None and tele.sketch is not None
    alerts_on = tele is not None and tele.alerts is not None
    ring_mode = frames_on and tele.ring is not None
    cap = torch.full((b, m), cap_step, dtype=torch.float32, device=dev)
    traces = traces.to(torch.float32)
    act_all = None if active is None else active.bool()
    lag = initial_lag.to(device=dev, dtype=torch.float32)
    assign = torch.full((b, n), NEG, dtype=torch.long, device=dev)
    down = torch.zeros((b, n), dtype=torch.long, device=dev)
    pstate = init(n)
    out = {f: torch.empty((b, t), dtype=torch.float32 if f.startswith("lag")
                          else torch.int32, device=dev) for f in _FIELDS}
    assigns = (torch.empty((b, t, n), dtype=torch.int32, device=dev)
               if record_assign else None)
    frames = sk = al = None
    if tele is not None:
        names = channel_names(tele, pstate)
        if ring_mode:
            frames = ring_init(tele, len(names), b, dev)
        elif frames_on:
            frames = torch.empty((b, t, len(names)), device=dev)
        if sketch_on:
            sk = sketch_init(tele.sketch, names, batch=(b,), device=dev)
        if alerts_on:
            al = alert_init(tele.alerts, batch=(b,), device=dev)
            no_storm = torch.zeros(b, device=dev)
        if valid is not None:
            valid = valid.to(device=dev, dtype=torch.bool)
    for step in range(t):
        rate = traces[:, step]
        act = None if act_all is None else act_all[:, step]
        produced = rate * dt
        if act is not None:
            produced = torch.where(act, produced, 0.0)
        observed = lag + produced       # the backlog a lag scaler sees
        new_assign, n_active, pstate = policy_step(rate, observed, assign,
                                                   pstate, act)
        moved = (assign >= 0) & (new_assign >= 0) & (new_assign != assign)
        down = torch.where(moved, cfg.migration_steps,
                           torch.clamp(down - 1, min=0))
        readable = (down == 0) & (new_assign >= 0)
        blocked = down > 0
        storm = None
        if has_cp:
            # rebalance storm: partitions on a warming consumer are
            # unreadable while that consumer rejoins the group
            warming = pstate.warming > 0
            readable = readable & ~warming
            storm = warming & (new_assign >= 0)
            blocked = blocked | storm
        if cfg.use_kernel:
            lag = lag_update_batch(lag, produced, new_assign, readable, cap,
                                   active=act)
        else:
            lag = lag_update_reference(lag, produced, new_assign, readable,
                                       cap, m=m, active=act)
        unreadable = blocked if act is None else blocked & act
        total = lag.sum(1)
        n_unread = unreadable.sum(1)
        out["lag_total"][:, step] = total
        out["lag_max"][:, step] = lag.amax(1)
        out["consumers"][:, step] = n_active
        out["migrations"][:, step] = moved.sum(1)
        out["unreadable"][:, step] = n_unread
        if record_assign:
            assigns[:, step] = new_assign
        assign = new_assign
        if tele is None:
            continue
        if storm is not None and act is not None:
            storm = storm & act
        ok = None if valid is None else valid[:, step]
        if frames_on or sketch_on:
            vec, _ = record_step(
                tele, speeds=rate, new_lag=lag, moved=moved,
                blocked=unreadable, storm=storm, n_consumers=n_active,
                act_t=act, capacity=cfg.capacity, pstate=pstate)
            if ring_mode:
                ring_write(frames, step, vec)
            elif frames_on:
                frames[:, step] = vec
            if sketch_on:
                sk = sketch_update(tele.sketch, sk, vec, valid=ok)
        if alerts_on:
            al = alert_step(
                tele.alerts, al, lag_total=total, consumers=n_active,
                unreadable=n_unread,
                storm_parts=(no_storm if storm is None
                             else storm.float().sum(1)),
                slo_lag=cfg.slo_lag, valid=ok)
    frame = None
    if ring_mode:
        frame = frame_from_ring(tele, names, frames, t)
    elif frames_on:
        frame = frame_from_outputs(tele, names, frames, t)
    trace = LagTrace(**out, telemetry=frame, sketch=sk, incidents=al)
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
    ``make_policy`` options (see ``sweep_lag``).  The trace's
    ``telemetry`` / ``sketch`` / ``incidents`` are one stream's when
    ``cfg.telemetry`` turns them on.  ``device=None`` means the CUDA
    card."""
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
        return _first(tr), assigns[0]
    return _first(res)


def _first(tr: LagTrace) -> LagTrace:
    """Row 0 of a one-row ``LagTrace`` (telemetry included)."""
    return LagTrace(**{f: getattr(tr, f)[0] for f in _FIELDS},
                    **{f: map_state(lambda a: a[0], getattr(tr, f))
                       for f in _OBS})


def sweep_lag(policies: Tuple[str, ...], traces,
              cfg: LagSimConfig = LagSimConfig(), active=None,
              device=None, policy_options=None,
              valid=None) -> LagSweepResult:
    """Closed-loop sweep: every policy over a batch of streams
    ``f32[B, T, N]`` -> ``[P, B, T]`` trajectories.  The heuristic family
    runs as one family-batched fused call under ``fused_steps``; every
    other policy runs the per-step loop over all streams at once.
    ``policy_options`` maps a policy name to its ``make_policy`` options:
    ``{"ANNEAL": {"noise": [AnnealNoise, ...]}}`` injects the annealer's
    draws, one ``AnnealNoise`` per simulated step (one decision), shared
    by every stream.  ``valid`` (bool[B, T], the fleet layer's) gates
    sketch and alert updates on padded steps.
    ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    traces = _as_tensor(traces, torch.float32, dev)
    active = _as_tensor(active, torch.bool, dev)
    valid = _as_tensor(valid, torch.bool, dev)
    _check_shapes(traces, active, None, rank=3)
    policies = tuple(p.upper() for p in policies)
    b, _, n = traces.shape
    cfg.resolve(n)                      # fail fast on bad knobs
    fused_fields = {}
    if cfg.fused_steps:
        group = tuple(p for p in policies
                      if fused_mode(p, cfg, n) == "fused")
        if group:
            fused_fields = sweep_fused(group, traces, cfg, active=active,
                                       valid=valid)
    zero = torch.zeros((b, n), dtype=torch.float32, device=dev)
    per_policy = [LagTrace(**fused_fields[p]) if p in fused_fields
                  else _simulate(traces, zero, p, cfg, active,
                                 options=(policy_options or {}).get(p),
                                 valid=valid)
                  for p in policies]
    for attr, what in (("telemetry", "telemetry channels"),
                       ("sketch", "sketch channels")):
        objs = [getattr(tr, attr) for tr in per_policy]
        if any(o is not None for o in objs):
            # stacking across policies needs one channel universe
            per_names = {p: (None if o is None else o.names)
                         for p, o in zip(policies, objs)}
            if len(set(per_names.values())) != 1:
                raise ValueError(
                    f"policies in one sweep must record identical {what} "
                    f"(custom CounterState counters differ): "
                    f"{per_names}; sweep them separately via simulate_lag")
    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    return LagSweepResult(
        **{f: torch.stack([getattr(tr, f) for tr in per_policy])
           for f in _FIELDS}, policies=policies,
        **{f: map_state(stack, *(getattr(tr, f) for tr in per_policy))
           for f in _OBS})

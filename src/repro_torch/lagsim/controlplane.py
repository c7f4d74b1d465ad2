"""Faithful control-plane emulation for the closed-loop lag twin, batched
over stream rows.

The reactive baselines of the registry are *idealized*: they observe the
current lag instantly, reassign instantly and never pay hysteresis.  Real
autoscalers do none of that.  KEDA evaluates its triggers every
``pollingInterval``, holds scale-downs for ``cooldownPeriod`` and clamps
to ``[minReplicaCount, maxReplicaCount]``; the Cloud Run Kafka scaler adds
metric-collection delay and slow actuation; and any consumer-group scale
event triggers a rebalance during which the touched consumers' partitions
are unreadable.

``wrap_policy`` turns any registered ``Policy`` into one that runs behind
such a control plane, for every row ``[R, N]`` of the loop at once:

* **observation delay** -- the inner policy sees speeds/lag from
  ``observation_delay`` steps ago (a ring of ``D + 1`` slots);
* **polling** -- decisions are only *taken* every ``polling_interval``
  steps; between polls the last applied assignment is held;
* **actuation delay** -- an accepted decision applies ``actuation_delay``
  steps later (one pending slot, the latest accepted decision wins);
* **cooldown** -- after a decision applies, no new decision is accepted
  for ``cooldown_period`` steps;
* **replica clamp** -- the consumer count is floored at ``min_replicas``;
  assignments that use more than ``max_replicas`` consumers are
  rank-folded onto the first ``max_replicas`` of them;
* **warm-up storm** -- when an applied decision changes any consumer's
  partition set, every partition owned by a *touched* consumer is
  unreadable for ``warmup_steps`` steps (the engine reads the ``warming``
  countdown off ``ControlPlaneState``).

With the zero-friction config the wrapped policy reproduces the bare one
bit for bit.  The state lives on the policy's device and the step reads
no device value on the host, so a step can be captured as it is.  The
inner policy's state always advances, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

NEG = -1


def _check_int(name: str, value: Any, what: str = "steps") -> None:
    if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
        raise ValueError(
            f"{name}={value!r} must be an integer number of {what}; the "
            f"control plane is a discrete-step state machine")


@dataclasses.dataclass(frozen=True)
class ControlPlaneConfig:
    """Static control-plane knobs (hashable; rides in ``LagSimConfig`` and
    so in the fleet's cache key).

    Defaults are the zero-friction identity: poll every step, no delays,
    no cooldown, no replica clamp, no warm-up.  Inconsistent knob
    combinations raise a named ``ValueError`` at construction.
    """

    polling_interval: int = 1       # KEDA pollingInterval (steps)
    observation_delay: int = 0      # metric-collection staleness (steps)
    actuation_delay: int = 0        # decision -> rebalance latency (steps)
    cooldown_period: int = 0        # KEDA cooldownPeriod (steps)
    min_replicas: int = 1           # KEDA minReplicaCount
    max_replicas: Optional[int] = None   # KEDA maxReplicaCount (None: free)
    warmup_steps: int = 0           # rebalance-storm downtime on scale

    def __post_init__(self) -> None:
        _check_int("polling_interval", self.polling_interval)
        _check_int("observation_delay", self.observation_delay)
        _check_int("actuation_delay", self.actuation_delay)
        _check_int("cooldown_period", self.cooldown_period)
        _check_int("warmup_steps", self.warmup_steps)
        _check_int("min_replicas", self.min_replicas, "replicas")
        if self.max_replicas is not None:
            _check_int("max_replicas", self.max_replicas, "replicas")
        if self.polling_interval < 1:
            raise ValueError(
                f"polling_interval={self.polling_interval} must be >= 1: "
                f"the control plane evaluates its triggers at most once "
                f"per step, never more")
        if self.observation_delay < 0:
            raise ValueError(
                f"observation_delay={self.observation_delay} must be >= 0: "
                f"the scaler cannot observe metrics from the future")
        if self.actuation_delay < 0:
            raise ValueError(
                f"actuation_delay={self.actuation_delay} must be >= 0: "
                f"a decision cannot apply before it is taken")
        if self.cooldown_period < 0:
            raise ValueError(
                f"cooldown_period={self.cooldown_period} must be >= 0 "
                f"steps; use 0 to disable the cooldown")
        if 0 < self.cooldown_period < self.polling_interval:
            raise ValueError(
                f"cooldown_period={self.cooldown_period} < polling_interval="
                f"{self.polling_interval}: the cooldown would always expire "
                f"before the next poll could observe it; use "
                f"cooldown_period=0 or >= polling_interval")
        if self.warmup_steps < 0:
            raise ValueError(
                f"warmup_steps={self.warmup_steps} must be >= 0: a replica "
                f"cannot warm up for a negative number of steps")
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas={self.min_replicas} must be >= 1: a consumer "
                f"group needs at least one member to make progress")
        if (self.max_replicas is not None
                and self.max_replicas < self.min_replicas):
            raise ValueError(
                f"max_replicas={self.max_replicas} < min_replicas="
                f"{self.min_replicas}: the replica clamp is empty")

    @property
    def is_zero_friction(self) -> bool:
        """True when the wrapper is the bit-for-bit identity."""
        return (self.polling_interval == 1 and self.observation_delay == 0
                and self.actuation_delay == 0 and self.cooldown_period == 0
                and self.min_replicas == 1 and self.max_replicas is None
                and self.warmup_steps == 0)

    def knobs(self) -> dict:
        """The hyperparameter dict a registered REAL policy family takes
        (the lag twin passes these as ``strict=False`` overrides, so one
        knob set configures self-wrapped and engine-wrapped policies
        alike)."""
        return dict(
            polling_interval=self.polling_interval,
            observation_delay=self.observation_delay,
            actuation_delay=self.actuation_delay,
            cooldown_period=self.cooldown_period,
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
            warmup_steps=self.warmup_steps)


@dataclasses.dataclass
class ControlPlaneState:
    """Carried state of a control-plane-wrapped policy over rows ``R``.

    ``tick`` is shared by every row (all rows step together); the other
    per-row leaves start without the row axis and broadcast to ``[R]`` /
    ``[R, N]`` on the first step, as the registry's other policy states
    do.  The engine type-checks for this class to find ``warming``.
    """

    tick: torch.Tensor            # i64[]         step counter
    obs_speeds: torch.Tensor      # f32[D+1, R, N] observation ring
    obs_lag: torch.Tensor         # f32[D+1, R, N]
    obs_active: torch.Tensor      # bool[D+1, R, N]
    held_n: torch.Tensor          # i64[R]  consumer count of the held decision
    pending_assign: torch.Tensor  # i64[R, N] accepted-but-not-applied
    pending_n: torch.Tensor       # i64[R]
    pending_at: torch.Tensor      # i64[R]  step at which the pending applies
    pending_valid: torch.Tensor   # bool[R]
    cooldown_until: torch.Tensor  # i64[R]  no decision accepted before this
    warming: torch.Tensor         # i64[R, N] rebalance-storm countdown
    inner: Any                    # the wrapped policy's own state


def _fold_to_max(assign, n_bins, *, k: int, m: int):
    """Clamp every row's assignment ``[R, N]`` to at most ``k`` consumers.

    Used consumer ids are ranked by id; partitions on a consumer of rank
    ``r >= k`` are folded onto the used consumer of rank ``r % k``.  When
    at most ``k`` consumers are used this is the exact identity (ids are
    ``< m``).  Scatters go into ``m + 1``-wide rows whose last column
    takes the dropped writes."""
    rows = assign.shape[0]
    valid = assign >= 0
    safe = torch.where(valid, assign, m)
    used = torch.zeros((rows, m + 1), dtype=torch.bool, device=assign.device
                       ).scatter_(1, safe, True)[:, :m]
    rank = torch.cumsum(used.long(), 1) - 1            # rank of used id i
    ids = torch.arange(m, device=assign.device).expand(rows, m)
    id_of_rank = torch.zeros((rows, m + 1), dtype=torch.long,
                             device=assign.device).scatter_(
        1, torch.where(used, rank, m), ids)[:, :m]
    r = rank.gather(1, torch.clamp(assign, 0, m - 1))
    folded = id_of_rank.gather(1, torch.clamp(r % k, max=m - 1))
    new_assign = torch.where(valid & (r >= k), folded, assign)
    return new_assign, torch.clamp(n_bins, max=k)


def wrap_policy(inner_init: Callable, inner_step: Callable,
                cp: ControlPlaneConfig, device=None
                ) -> Tuple[Callable, Callable]:
    """Wrap a batched ``(init, step)`` policy pair behind ``cp``.

    The inner policy runs on *delayed* observations every step, but only
    poll-step decisions that differ from the held assignment are
    accepted, and an accepted decision applies ``actuation_delay`` steps
    later, starting the cooldown and the warm-up storm on the consumers
    it touched.  ``device`` is where ``init`` puts the state (``None``:
    the CPU; the first step moves nothing, so pass the loop's device).
    """
    if not isinstance(cp, ControlPlaneConfig):
        raise ValueError(
            f"control plane config must be a ControlPlaneConfig, got "
            f"{type(cp).__name__}")
    d1 = cp.observation_delay + 1

    def init(n_partitions: int) -> ControlPlaneState:
        n = int(n_partitions)
        z = torch.zeros((), dtype=torch.long, device=device)
        return ControlPlaneState(
            tick=z,
            obs_speeds=torch.zeros((d1, 1, n), device=device),
            obs_lag=torch.zeros((d1, 1, n), device=device),
            obs_active=torch.ones((d1, 1, n), dtype=torch.bool,
                                  device=device),
            held_n=z,
            pending_assign=torch.full((n,), NEG, dtype=torch.long,
                                      device=device),
            pending_n=z, pending_at=z,
            pending_valid=torch.zeros((), dtype=torch.bool, device=device),
            cooldown_until=z,
            warming=torch.zeros((n,), dtype=torch.long, device=device),
            inner=inner_init(n))

    def step(speeds, lag, prev_assign, state: ControlPlaneState,
             active=None):
        rows, n = speeds.shape
        m = 2 * n + 2                   # the engine's consumer-id universe
        act_now = None if active is None else active.bool()
        tick = state.tick
        # --- observe: write now, read observation_delay steps back ------
        if d1 == 1:
            obs_speeds, obs_lag = speeds[None], lag[None]
            sp_d, lag_d = speeds, lag
            obs_active = (state.obs_active if act_now is None
                          else act_now[None])
            act_d = act_now
        else:
            idx = tick % d1
            here = (torch.arange(d1, device=speeds.device) == idx).view(
                d1, 1, 1)
            # the slot of step t - D, as a one-element index (a 0-dim
            # index tensor could be read on the host)
            rd = ((idx + 1) % d1).view(1)
            obs_speeds = torch.where(here, speeds, state.obs_speeds)
            obs_lag = torch.where(here, lag, state.obs_lag)
            sp_d = obs_speeds.index_select(0, rd)[0]
            lag_d = obs_lag.index_select(0, rd)[0]
            obs_active = state.obs_active
            act_d = None
            if act_now is not None:
                obs_active = torch.where(here, act_now, obs_active)
                act_d = obs_active.index_select(0, rd)[0]
        if act_now is None:
            cand, cand_n, inner = inner_step(sp_d, lag_d, prev_assign,
                                             state.inner)
        else:
            cand, cand_n, inner = inner_step(sp_d, lag_d, prev_assign,
                                             state.inner, act_d)
        cand, cand_n = cand.long(), cand_n.long()
        # --- clamp to [min_replicas, max_replicas] ----------------------
        if cp.max_replicas is not None:
            cand, cand_n = _fold_to_max(cand, cand_n, k=cp.max_replicas,
                                        m=m)
        if cp.min_replicas > 1:
            # the extra replicas idle, billed (KEDA minReplicaCount)
            cand_n = torch.clamp(cand_n, min=cp.min_replicas)
        if act_now is None:
            cand_out, held_out = cand, prev_assign
        else:
            cand_out = torch.where(act_now, cand, NEG)
            held_out = torch.where(act_now, prev_assign, NEG)
        # --- decide: poll gating + cooldown hysteresis ------------------
        poll = (tick % cp.polling_interval) == 0
        is_change = ((cand_n != state.held_n)
                     | (cand_out != held_out).any(-1))
        accept = poll & is_change & (tick >= state.cooldown_until)
        pending_assign = torch.where(accept[:, None], cand_out,
                                     state.pending_assign)
        pending_n = torch.where(accept, cand_n, state.pending_n)
        pending_at = torch.where(accept, tick + cp.actuation_delay,
                                 state.pending_at)
        pending_valid = accept | state.pending_valid
        # --- actuate: apply the pending decision when it matures --------
        do_apply = pending_valid & (pending_at <= tick)
        out_assign = torch.where(do_apply[:, None], pending_assign, held_out)
        out_n = torch.where(do_apply, pending_n, state.held_n)
        if cp.min_replicas > 1:
            # minReplicaCount keeps replicas alive (and billed) even
            # before the first decision applies
            out_n = torch.clamp(out_n, min=cp.min_replicas)
        if act_now is not None:
            out_assign = torch.where(act_now, out_assign, NEG)
        # --- warm-up storm on the consumers this apply touched ----------
        warm_next = torch.clamp(state.warming - 1, min=0)
        if cp.warmup_steps > 0:
            old_bin = torch.where(held_out >= 0, held_out, m)
            new_bin = torch.where(out_assign >= 0, out_assign, m)
            changed = (old_bin != new_bin).long()
            # a consumer is touched if any partition left or joined it;
            # integer adds over duplicate ids are order-free
            touched = torch.zeros((rows, m + 1), dtype=torch.long,
                                  device=speeds.device)
            touched = touched.scatter_add(1, old_bin, changed).scatter_add(
                1, new_bin, changed)
            part_touched = (out_assign >= 0) & (touched.gather(
                1, torch.clamp(out_assign, 0, m - 1)) > 0)
            warming = torch.where(do_apply[:, None] & part_touched,
                                  cp.warmup_steps, warm_next)
        else:
            warming = warm_next
        new_state = ControlPlaneState(
            tick=tick + 1, obs_speeds=obs_speeds, obs_lag=obs_lag,
            obs_active=obs_active, held_n=out_n,
            pending_assign=pending_assign, pending_n=pending_n,
            pending_at=pending_at, pending_valid=pending_valid & ~do_apply,
            cooldown_until=torch.where(do_apply, tick + cp.cooldown_period,
                                       state.cooldown_until),
            warming=warming, inner=inner)
        return out_assign, out_n, new_state

    # the engine probes this marker to avoid double-wrapping policies
    # (KEDA_LAG_REAL etc.) that already built their own control plane
    step._controlplane_wrapped = True       # type: ignore[attr-defined]
    step._controlplane_config = cp          # type: ignore[attr-defined]
    init._controlplane_wrapped = True       # type: ignore[attr-defined]
    return init, step


__all__ = [
    "ControlPlaneConfig",
    "ControlPlaneState",
    "wrap_policy",
]

"""Declarative in-loop SLO alerting of the lag twin, batched over stream
rows: burn rates, invariant violations, storms and thrash, evaluated in
O(rules) a step.

The reference's ``repro.telemetry.alerts`` carried over to the port's
per-step loop.  A declarative :class:`AlertRule` set is evaluated over
per-rule debiased EWMA windows:

* ``slo_burn``          -- multi-window burn rate on the lag-SLO
  violation fraction (a fast and a slow EWMA window must *both* burn
  error budget faster than ``burn_threshold``x);
* ``lag_growth``        -- the paper's Eq. 1 invariant as an alert: the
  EWMA of the per-step lag delta stays positive for ``sustain_steps``
  consecutive steps;
* ``rebalance_storm``   -- partitions continuously unreadable (migration
  downtime / control-plane storm) for ``storm_steps`` or longer;
* ``consumer_thrash``   -- the EWMA rate of consumer-count changes
  exceeds ``thrash_rate``.

The state is a fixed-shape :class:`AlertState` (per-rule windows and a
bounded incident table of ``max_incidents`` rows) a stream; a padded
fleet step is gated out by ``valid`` as in the sketches.  Constants are
rounded to float32 as the reference rounds them and every EWMA keeps the
reference's ``(1 - a) * x + a * v``, because ``measure > threshold``
decides the step an incident opens.  Host-side, :func:`decode_incidents`
turns the table into typed :class:`Incident` records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .record import _np, gate

ALERT_KINDS: Tuple[str, ...] = ("slo_burn", "lag_growth", "rebalance_storm",
                                "consumer_thrash")
SEVERITIES: Tuple[str, ...] = ("page", "ticket", "info")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule (hashable; rides the engine's jit key).

    ``kind`` selects which fields matter -- use the classmethod
    constructors (:meth:`slo_burn`, :meth:`lag_growth`,
    :meth:`rebalance_storm`, :meth:`consumer_thrash`) rather than
    spelling every knob.  Windows/half-lives are in simulation steps.
    """

    name: str
    kind: str
    severity: str = "page"
    # slo_burn: both EWMA windows of the violation indicator must burn
    # budget (1 - slo_target) at >= burn_threshold x the sustainable rate
    slo_target: float = 0.99
    burn_threshold: float = 2.0
    fast_halflife: float = 8.0
    slow_halflife: float = 64.0
    # lag_growth: EWMA(lag delta) > min_growth for sustain_steps steps
    growth_halflife: float = 16.0
    sustain_steps: int = 8
    min_growth: float = 0.0
    # rebalance_storm: any partition blocked for >= storm_steps steps
    storm_steps: int = 4
    # consumer_thrash: EWMA(consumer-count-changed) > thrash_rate
    thrash_halflife: float = 16.0
    thrash_rate: float = 0.25

    def __post_init__(self) -> None:
        if self.kind not in ALERT_KINDS:
            raise ValueError(
                f"unknown alert kind {self.kind!r}; have {ALERT_KINDS}")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}; have {SEVERITIES}")
        if not self.name:
            raise ValueError("alert rules need a non-empty name")
        for fld in ("fast_halflife", "slow_halflife", "growth_halflife",
                    "thrash_halflife"):
            if not float(getattr(self, fld)) > 0.0:
                raise ValueError(
                    f"{self.name}: {fld} must be > 0 steps, got "
                    f"{getattr(self, fld)!r}")
        if not 0.0 < float(self.slo_target) < 1.0:
            raise ValueError(
                f"{self.name}: slo_target must be in (0, 1) -- the error "
                f"budget is 1 - slo_target -- got {self.slo_target!r}")
        if int(self.sustain_steps) < 1 or int(self.storm_steps) < 1:
            raise ValueError(
                f"{self.name}: sustain_steps/storm_steps must be >= 1")
        if not float(self.burn_threshold) > 0.0:
            raise ValueError(
                f"{self.name}: burn_threshold must be > 0, got "
                f"{self.burn_threshold!r}")
        if not 0.0 < float(self.thrash_rate) < 1.0:
            raise ValueError(
                f"{self.name}: thrash_rate is a change *fraction* in (0, 1), "
                f"got {self.thrash_rate!r}")

    # -- constructors ---------------------------------------------------

    @classmethod
    def slo_burn(cls, name: str = "slo_burn", *, slo_target: float = 0.99,
                 burn_threshold: float = 2.0, fast_halflife: float = 8.0,
                 slow_halflife: float = 64.0,
                 severity: str = "page") -> "AlertRule":
        return cls(name=name, kind="slo_burn", severity=severity,
                   slo_target=slo_target, burn_threshold=burn_threshold,
                   fast_halflife=fast_halflife, slow_halflife=slow_halflife)

    @classmethod
    def lag_growth(cls, name: str = "lag_growth", *,
                   growth_halflife: float = 16.0, sustain_steps: int = 8,
                   min_growth: float = 0.0,
                   severity: str = "page") -> "AlertRule":
        return cls(name=name, kind="lag_growth", severity=severity,
                   growth_halflife=growth_halflife,
                   sustain_steps=sustain_steps, min_growth=min_growth)

    @classmethod
    def rebalance_storm(cls, name: str = "rebalance_storm", *,
                        storm_steps: int = 4,
                        severity: str = "ticket") -> "AlertRule":
        return cls(name=name, kind="rebalance_storm", severity=severity,
                   storm_steps=storm_steps)

    @classmethod
    def consumer_thrash(cls, name: str = "consumer_thrash", *,
                        thrash_halflife: float = 16.0,
                        thrash_rate: float = 0.25,
                        severity: str = "ticket") -> "AlertRule":
        return cls(name=name, kind="consumer_thrash", severity=severity,
                   thrash_halflife=thrash_halflife, thrash_rate=thrash_rate)


def default_rules(*, slo_target: float = 0.99) -> Tuple[AlertRule, ...]:
    """The canonical four-rule set: one rule per failure mode the paper
    prices (SLO burn, Eq. 1 invariant, rebalance downtime, flapping)."""
    return (AlertRule.slo_burn(slo_target=slo_target),
            AlertRule.lag_growth(),
            AlertRule.rebalance_storm(),
            AlertRule.consumer_thrash())


@dataclasses.dataclass(frozen=True)
class AlertConfig:
    """A rule set plus the incident-table bound (hashable).

    ``max_incidents`` bounds the per-rule open/close table carried
    through the scan; incidents past the bound still *count* (see
    ``AlertState.count``) but lose their open/close steps.
    """

    rules: Tuple[AlertRule, ...] = ()
    max_incidents: int = 32

    def __post_init__(self) -> None:
        if not self.rules:
            raise ValueError(
                "AlertConfig needs at least one AlertRule (see "
                "repro.telemetry.alerts.default_rules)")
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(
                f"alert rule names must be unique, got {names}")
        if int(self.max_incidents) < 1:
            raise ValueError(
                f"max_incidents={self.max_incidents!r} must be >= 1")

    @property
    def rule_names(self) -> Tuple[str, ...]:
        return tuple(r.name for r in self.rules)


@dataclasses.dataclass
class AlertState:
    """Alert carry: ``R`` rules x ``M = max_incidents`` table rows, every
    leaf led by the batch shape (one row a stream).  ``count`` is the
    total incidents ever opened per rule (it may exceed ``M``; overflowed
    incidents keep counting but drop their table row)."""

    tick: Any         # i32[...]       valid steps seen (absolute step)
    fast: Any         # f32[..., R]    fast EWMA accumulator (per kind)
    fast_w: Any       # f32[..., R]    its debias weight
    slow: Any         # f32[..., R]    slow EWMA accumulator
    slow_w: Any       # f32[..., R]
    consec: Any       # i32[..., R]    consecutive-condition counter
    prev_lag: Any     # f32[...]       last step's total lag
    prev_cons: Any    # f32[...]       last step's consumer count
    measure: Any      # f32[..., R]    current measured value per rule
    active: Any       # bool[..., R]   rule currently firing
    cur_start: Any    # i32[..., R]    open step of the firing incident
    cur_peak: Any     # f32[..., R]    peak measure of the firing incident
    open_step: Any    # i32[..., R, M] -1 = row unused
    close_step: Any   # i32[..., R, M] -1 = still open / unused
    peak: Any         # f32[..., R, M]
    count: Any        # i32[..., R]    incidents ever opened
    rule_names: Tuple[str, ...]


def alert_init(cfg: AlertConfig, *, batch: Tuple[int, ...] = (),
               device=None) -> AlertState:
    """Zero alert state, one row per ``batch`` entry."""
    batch = tuple(batch)
    r, m = len(cfg.rules), int(cfg.max_incidents)
    i32 = torch.int32
    zf = lambda *s: torch.zeros(batch + s, device=device)  # noqa: E731
    zi = lambda *s: torch.zeros(batch + s, dtype=i32,  # noqa: E731
                                device=device)
    return AlertState(
        tick=zi(), fast=zf(r), fast_w=zf(r), slow=zf(r), slow_w=zf(r),
        consec=zi(r), prev_lag=zf(), prev_cons=zf(), measure=zf(r),
        active=torch.zeros(batch + (r,), dtype=torch.bool, device=device),
        cur_start=zi(r) - 1, cur_peak=zf(r),
        open_step=torch.full(batch + (r, m), -1, dtype=i32, device=device),
        close_step=torch.full(batch + (r, m), -1, dtype=i32, device=device),
        peak=zf(r, m), count=zi(r), rule_names=cfg.rule_names)


def _alpha(halflife: float) -> float:
    return 1.0 - 2.0 ** (-1.0 / float(halflife))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's ``jnp.float32``."""
    return float(np.float32(x))


def _ewma(acc, w, alpha: float, v):
    """One debiased-EWMA update in the reference's float32 operations:
    ``(1 - a) * acc + a * v`` and ``(1 - a) * w + a``."""
    a = _f32(alpha)
    keep = float(np.float32(1) - np.float32(a))
    return keep * acc + a * v, keep * w + a


def _div(x, c: float):
    """``x / c`` by a tensor divisor: a Python divisor is a reciprocal
    multiply on the card, one ulp away where an incident opens."""
    return x / torch.full_like(x, _f32(c))


def alert_step(cfg: AlertConfig, state: AlertState, *, lag_total, consumers,
               unreadable, storm_parts, slo_lag,
               valid=None) -> AlertState:
    """Evaluate every rule on this step's already-computed values (one a
    row of the batch).  ``valid`` gates padded fleet steps out, like
    ``sketch_update``."""
    dev = state.tick.device
    as_f32 = lambda x: torch.as_tensor(  # noqa: E731
        x, dtype=torch.float32, device=dev)
    lag_total, consumers = as_f32(lag_total), as_f32(consumers)
    unreadable, storm_parts = as_f32(unreadable), as_f32(storm_parts)
    tick = state.tick
    started = tick > 0
    zero = state.prev_lag.new_zeros(())
    dlag = torch.where(started, lag_total - state.prev_lag, zero)
    changed = torch.where(started, (consumers != state.prev_cons).float(),
                          zero)
    cols = ([], [], [], [], [], [], [])
    for i, rule in enumerate(cfg.rules):
        fast, fw = state.fast[..., i], state.fast_w[..., i]
        slow, sw = state.slow[..., i], state.slow_w[..., i]
        consec = state.consec[..., i]
        if rule.kind == "slo_burn":
            v = (lag_total > _f32(slo_lag)).float()
            fast, fw = _ewma(fast, fw, _alpha(rule.fast_halflife), v)
            slow, sw = _ewma(slow, sw, _alpha(rule.slow_halflife), v)
            budget = 1.0 - rule.slo_target
            burn_fast = _div(fast / torch.clamp(fw, min=1e-12), budget)
            burn_slow = _div(slow / torch.clamp(sw, min=1e-12), budget)
            measure = torch.minimum(burn_fast, burn_slow)
            firing = measure > _f32(rule.burn_threshold)
        elif rule.kind == "lag_growth":
            fast, fw = _ewma(fast, fw, _alpha(rule.growth_halflife), dlag)
            measure = fast / torch.clamp(fw, min=1e-12)
            grow = measure > _f32(rule.min_growth)
            consec = torch.where(grow, consec + 1, 0)
            firing = consec >= rule.sustain_steps
        elif rule.kind == "rebalance_storm":
            blocked = (unreadable > 0) | (storm_parts > 0)
            consec = torch.where(blocked, consec + 1, 0)
            measure = consec.float()
            firing = consec >= rule.storm_steps
        else:                                   # consumer_thrash
            fast, fw = _ewma(fast, fw, _alpha(rule.thrash_halflife),
                             changed)
            measure = fast / torch.clamp(fw, min=1e-12)
            firing = measure > _f32(rule.thrash_rate)
        for col, val in zip(cols, (fast, fw, slow, sw, consec, measure,
                                   firing)):
            col.append(torch.broadcast_to(val, tick.shape))
    fast, fast_w, slow, slow_w, consec, measure, firing = (
        torch.stack(c, -1) for c in cols)
    m = state.open_step.shape[-1]
    slots = torch.arange(m, device=dev)
    opening = firing & ~state.active
    closing = ~firing & state.active
    # the firing incident's running peak (seeded by the opening measure)
    cur_peak = torch.where(opening, measure,
                           torch.where(state.active & firing,
                                       torch.maximum(state.cur_peak, measure),
                                       state.cur_peak))
    tick_r = tick[..., None]
    cur_start = torch.where(opening, tick_r, state.cur_start)
    # open: write row `count` (if it still fits the bounded table)
    o_ok = opening & (state.count < m)
    o_at = (slots == torch.clamp(state.count, 0, m - 1)[..., None]) \
        & o_ok[..., None]
    open_step = torch.where(o_at, tick_r[..., None], state.open_step)
    # close: the open incident lives at row `count - 1`
    c_ok = closing & (state.count >= 1) & (state.count <= m)
    c_at = (slots == torch.clamp(state.count - 1, 0, m - 1)[..., None]) \
        & c_ok[..., None]
    close_step = torch.where(c_at, tick_r[..., None] - 1, state.close_step)
    peak = torch.where(c_at, cur_peak[..., None], state.peak)
    new = AlertState(
        tick=tick + 1, fast=fast, fast_w=fast_w, slow=slow, slow_w=slow_w,
        consec=consec.to(torch.int32), prev_lag=torch.broadcast_to(
            lag_total, tick.shape),
        prev_cons=torch.broadcast_to(consumers, tick.shape),
        measure=measure, active=firing, cur_start=cur_start,
        cur_peak=cur_peak, open_step=open_step, close_step=close_step,
        peak=peak, count=state.count + opening.to(torch.int32),
        rule_names=state.rule_names)
    return gate(valid, new, state)


# ---------------------------------------------------------------------------
# host-side decoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Incident:
    """One decoded incident.  ``open_step``/``close_step`` are inclusive
    simulation steps; a still-open incident closes at the last step with
    ``still_open=True``.  ``index`` locates the stream in a batched
    state (e.g. ``(policy,)`` through ``api.simulate``)."""

    rule: str
    kind: str
    severity: str
    open_step: int
    close_step: int
    duration_s: float
    peak: float
    still_open: bool = False
    index: Tuple[int, ...] = ()

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "kind": self.kind,
                "severity": self.severity, "open_step": self.open_step,
                "close_step": self.close_step,
                "duration_s": round(float(self.duration_s), 6),
                "peak": round(float(self.peak), 6),
                "still_open": self.still_open, "index": list(self.index)}


def decode_incidents(state: AlertState, cfg: AlertConfig,
                     dt: float = 1.0) -> List[Incident]:
    """Typed incidents from a (possibly batched) final ``AlertState``,
    ordered by ``(index, open_step, rule)``.  Incidents past the bounded
    table are counted but carry no rows; compare ``incident_counts``
    against ``len(decode_incidents(...))`` to detect the overflow."""
    rule_of = {r.name: r for r in cfg.rules}
    counts = _np(state.count)
    lead = counts.shape[:-1]
    opens = _np(state.open_step)
    closes = _np(state.close_step)
    peaks = _np(state.peak)
    cur_peak = _np(state.cur_peak)
    active = _np(state.active)
    ticks = _np(state.tick)
    out: List[Incident] = []
    for index in (np.ndindex(*lead) if lead else [()]):
        t_end = int(ticks[index]) - 1
        for ri, name in enumerate(state.rule_names):
            rule = rule_of[name]
            n_rows = min(int(counts[index + (ri,)]), opens.shape[-1])
            for row in range(n_rows):
                o = int(opens[index + (ri, row)])
                if o < 0:
                    continue
                c = int(closes[index + (ri, row)])
                if c >= 0:
                    out.append(Incident(
                        rule=name, kind=rule.kind, severity=rule.severity,
                        open_step=o, close_step=c,
                        duration_s=(c - o + 1) * dt,
                        peak=float(peaks[index + (ri, row)]), index=index))
                elif bool(active[index + (ri,)]) and t_end >= o:
                    out.append(Incident(
                        rule=name, kind=rule.kind, severity=rule.severity,
                        open_step=o, close_step=t_end,
                        duration_s=(t_end - o + 1) * dt,
                        peak=float(cur_peak[index + (ri,)]),
                        still_open=True, index=index))
    out.sort(key=lambda e: (e.index, e.open_step, e.rule))
    return out


def incident_counts(state: AlertState) -> Dict[str, int]:
    """Total incidents per rule (overflowed ones included), summed over
    any leading batch axes."""
    counts = _np(state.count)
    flat = counts.reshape(-1, counts.shape[-1]).sum(axis=0)
    return {name: int(flat[i]) for i, name in enumerate(state.rule_names)}


def incident_matrix(state: AlertState) -> np.ndarray:
    """Per-stream total incident counts with batch axes *preserved*:
    ``state.count`` summed over its trailing rule axis only
    (``f32[...]``, e.g. ``[P]`` for one fleet scenario).  This is the
    adversarial search's fitness component -- unlike
    :func:`incident_counts` it keeps every scenario/policy stream
    separate, so a fitness oracle can credit incidents to the genome
    that caused them."""
    counts = _np(state.count)
    return counts.sum(axis=-1).astype(np.float32)


def incident_summary(state: AlertState, cfg: AlertConfig,
                     dt: float = 1.0) -> Dict[str, Dict[str, float]]:
    """Per-rule roll-up for BENCH blocks / exporters: incident count,
    total alert duration, peak measurement, and how many are still
    open."""
    incidents = decode_incidents(state, cfg, dt=dt)
    counts = incident_counts(state)
    out: Dict[str, Dict[str, float]] = {
        name: {"count": float(counts.get(name, 0)),
               "total_duration_s": 0.0, "peak": 0.0, "open": 0.0}
        for name in state.rule_names
    }
    for inc in incidents:
        row = out[inc.rule]
        row["total_duration_s"] += inc.duration_s
        row["peak"] = max(row["peak"], inc.peak)
        row["open"] += 1.0 if inc.still_open else 0.0
    return out


__all__ = [
    "ALERT_KINDS",
    "AlertConfig",
    "AlertRule",
    "AlertState",
    "Incident",
    "alert_init",
    "alert_step",
    "decode_incidents",
    "default_rules",
    "incident_counts",
    "incident_matrix",
    "incident_summary",
]

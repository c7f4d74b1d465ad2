"""In-loop flight recorder of the lag twin, batched over stream rows.

The reference's ``repro.telemetry.record`` carried over to the port's
per-step loop:

* :class:`TelemetryConfig` -- static, hashable knobs; rides inside
  ``LagSimConfig`` (and so in the fleet's cache key).  ``None`` (or
  ``enabled=False``) is the recorder-free path: the loop dispatches the
  same operations as without this module.
* a fixed vector of per-step **channels** (migrations, the per-step
  Eq. 10 R-score, unreadable/storm partition counts, replica count,
  active-partition count, total lag and lag quantiles), one row a stream,
  written into a ``[B, T, K]`` frame -- or, with ``ring`` set, into a
  ``[B, ring, K]`` ring so memory stays O(ring) on long runs;
* :class:`TelemetryFrame` -- the recorded tensors and channel names;
* :class:`CounterState` -- the custom-counter contract: a policy whose
  state is ``CounterState(counters, inner, names)`` gets its ``counters``
  appended to every recorded step;
* :func:`decode_events` / :class:`EventStream` -- host-side decoding of a
  frame into typed events (scale decisions, migrations, rebalance-storm
  windows, downtime windows, partition births/deaths).

Every function here reads values the loop already computes, so the
trajectories never depend on whether the recorder is on.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@functools.lru_cache(maxsize=64)
def _const(values: tuple, device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once and kept (a constant
    that a step would otherwise copy to the card every step)."""
    return _const(tuple(values), str(device), dtype)


def map_state(fn, *objs):
    """Apply ``fn`` leaf by leaf to one or more telemetry states of one
    dataclass type (frames, sketch and alert states): every tensor or
    array field is mapped, the static fields (channel and rule names) are
    the first object's.  ``None`` maps to ``None``."""
    if objs[0] is None:
        return None
    out = {}
    for f in dataclasses.fields(objs[0]):
        vals = [getattr(o, f.name) for o in objs]
        out[f.name] = (fn(*vals) if isinstance(vals[0],
                                               (torch.Tensor, np.ndarray))
                       else vals[0])
    return type(objs[0])(**out)


def gate(valid, new, old):
    """``where(valid, new, old)`` over every leaf of a state whose leaves
    lead with ``valid``'s batch shape (a padded step leaves the state as
    it was)."""
    if valid is None:
        return new

    def pick(a, b):
        v = valid.reshape(tuple(valid.shape) + (1,) * (a.dim()
                                                        - valid.dim()))
        return torch.where(v, a, b)

    return map_state(pick, new, old)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static recorder knobs (hashable).

    ``lag_quantiles`` adds one ``lag_q{..}`` channel per entry (a quantile
    of per-partition backlog over the *active* partitions).  ``ring``
    bounds recorder memory: ``None`` records every step (``T`` rows); an
    integer keeps only the last ``ring`` steps.  ``sketch`` carries online
    aggregators (``telemetry.sketch``) through the loop, ``alerts``
    evaluates a rule set in-loop (``telemetry.alerts``), and
    ``record_frames=False`` drops the per-step frame: sketches and alerts
    in O(1) memory with no O(T) history.
    """

    enabled: bool = True
    lag_quantiles: Tuple[float, ...] = (0.5, 0.9, 0.99)
    ring: Optional[int] = None
    record_frames: bool = True
    sketch: Optional[Any] = None       # telemetry.sketch.SketchConfig
    alerts: Optional[Any] = None       # telemetry.alerts.AlertConfig

    def __post_init__(self) -> None:
        for q in self.lag_quantiles:
            if not 0.0 <= float(q) <= 1.0:
                raise ValueError(
                    f"lag_quantiles entries must be in [0, 1], got {q!r}")
        if self.ring is not None and int(self.ring) < 1:
            raise ValueError(
                f"ring={self.ring!r} must be a positive number of steps "
                f"(or None to record every step)")
        if self.ring is not None and not self.record_frames:
            raise ValueError(
                "ring is a frame-recorder mode; record_frames=False with "
                "ring set is contradictory (drop ring, or keep frames)")
        if self.sketch is not None:
            from . import sketch as _sketch
            if not isinstance(self.sketch, _sketch.SketchConfig):
                raise TypeError(
                    f"TelemetryConfig.sketch must be a SketchConfig, got "
                    f"{type(self.sketch).__name__}")
        if self.alerts is not None:
            from . import alerts as _alerts
            if not isinstance(self.alerts, _alerts.AlertConfig):
                raise TypeError(
                    f"TelemetryConfig.alerts must be an AlertConfig, got "
                    f"{type(self.alerts).__name__}")

    @property
    def base_channels(self) -> Tuple[str, ...]:
        """Channel names this config records, before custom counters."""
        return BASE_CHANNELS + tuple(
            f"lag_q{int(round(float(q) * 100)):02d}"
            for q in self.lag_quantiles)


#: the always-recorded channels (see ``record_step`` for definitions)
BASE_CHANNELS: Tuple[str, ...] = (
    "consumers",        # replicas billed this step
    "migrations",       # partitions whose owner changed (NEG never counts)
    "rscore",           # Eq. 10 of this step's reassignment: moved speed / C
    "unreadable",       # partitions blocked (migration downtime or storm)
    "storm_parts",      # partitions blocked by a control-plane warm-up storm
    "active_parts",     # partitions that exist this step (mask contract)
    "lag_total",        # total backlog after draining
)


@dataclasses.dataclass
class CounterState:
    """Custom-counter contract for policies.

    A policy builder that wants its own per-step counters in the recorded
    stream wraps its state as ``CounterState(counters=f32[R, K],
    inner=state, names=(...))`` and updates ``counters`` in ``step``.  The
    engine probes the state type after each step and appends ``counters``
    to the channel vector; ``names`` join the frame's channel names.
    """

    counters: torch.Tensor                     # f32[R, K] (or [K])
    inner: Any                                 # the policy's own state
    names: Tuple[str, ...]


@dataclasses.dataclass
class TelemetryFrame:
    """Recorded channels of a batch of simulated streams.

    ``channels`` is ``f32[..., R, K]`` where ``R`` is the number of
    recorded rows (``T``, or ``ring`` in ring mode) and ``K ==
    len(names)``; ``steps`` (``i32[..., R]``) is the absolute step of each
    row (``-1``: slot never written, ring mode only); ``count``
    (``i32[...]``) the number of steps the recorder saw.  Leaves are
    tensors where the loop ran them, or numpy arrays once on the host.
    """

    channels: Any
    steps: Any
    count: Any
    names: Tuple[str, ...]

    def channel(self, name: str) -> np.ndarray:
        """One channel as ``[..., R]`` numpy, by name."""
        return _np(self.channels)[..., self.names.index(name)]


# ---------------------------------------------------------------------------
# in-loop recording (called from lagsim.engine inside the step loop)
# ---------------------------------------------------------------------------

def channel_names(tele: TelemetryConfig, pstate) -> Tuple[str, ...]:
    """The full channel tuple of a run whose policy state starts as
    ``pstate`` (base channels, then any custom counters)."""
    extra = tuple(pstate.names) if isinstance(pstate, CounterState) else ()
    return tele.base_channels + extra


def record_step(tele: TelemetryConfig, *, speeds, new_lag, moved, blocked,
                storm, n_consumers, act_t, capacity, pstate
                ) -> Tuple[torch.Tensor, Tuple[str, ...]]:
    """The step's channel vectors ``f32[R, K]`` (one row a stream) and
    their names.  ``storm`` may be ``None`` (no control plane)."""
    rows, n = speeds.shape
    zero = speeds.new_zeros(())
    moved_speed = torch.where(moved, speeds, zero).sum(-1)
    if act_t is None:
        active_parts = speeds.new_full((rows,), float(n))
        lag_for_q = new_lag
    else:
        active_parts = act_t.float().sum(-1)
        # quantiles over existing partitions only: a dead partition's
        # forced-zero lag must not drag the distribution down
        lag_for_q = torch.where(act_t, new_lag, float("nan"))
    vals = [
        n_consumers.float(),
        moved.float().sum(-1),
        # a tensor divisor: a Python one is a reciprocal multiply on the
        # card
        moved_speed / torch.full_like(moved_speed,
                                      float(np.float32(capacity))),
        blocked.float().sum(-1),
        (speeds.new_zeros(rows) if storm is None
         else storm.float().sum(-1)),
        active_parts,
        new_lag.sum(-1),
    ]
    names = tele.base_channels
    if tele.lag_quantiles:
        qs = torch.nanquantile(lag_for_q,
                               const(tele.lag_quantiles, speeds.device),
                               dim=-1)                       # [Q, R]
        # an all-dead step has no distribution; record 0, not NaN
        qs = torch.where(torch.isnan(qs), zero, qs)
        vals.extend(qs.unbind(0))
    if isinstance(pstate, CounterState):
        cnt = torch.broadcast_to(pstate.counters.float(),
                                 (rows, len(pstate.names)))
        vals.extend(cnt.unbind(1))
        names = names + tuple(pstate.names)
    return torch.stack(vals, -1), names


def ring_init(tele: TelemetryConfig, k: int, rows: int, device=None):
    """Ring carry ``(buf f32[rows, ring, K], steps i32[rows, ring])``."""
    r = int(tele.ring)
    return (torch.zeros((rows, r, k), device=device),
            torch.full((rows, r), -1, dtype=torch.int32, device=device))


def ring_write(carry, tick: int, vec):
    """Write ``vec [rows, K]`` at slot ``tick % ring`` (in place: the
    ring belongs to the loop); returns the carry."""
    buf, steps = carry
    slot = tick % buf.shape[1]
    buf[:, slot] = vec
    steps[:, slot] = tick
    return carry


def frame_from_outputs(tele: TelemetryConfig, names: Tuple[str, ...],
                       channels, t_total: int) -> TelemetryFrame:
    """Frame for per-step (non-ring) recording ``channels [rows, T, K]``."""
    rows = channels.shape[0]
    steps = torch.arange(t_total, dtype=torch.int32,
                         device=channels.device).expand(rows, t_total)
    count = torch.full((rows,), t_total, dtype=torch.int32,
                       device=channels.device)
    return TelemetryFrame(channels=channels, steps=steps, count=count,
                          names=names)


def frame_from_ring(tele: TelemetryConfig, names: Tuple[str, ...],
                    carry, t_total: int) -> TelemetryFrame:
    """Frame for ring mode: the final buffer plus absolute step indices."""
    buf, steps = carry
    count = torch.full((buf.shape[0],), t_total, dtype=torch.int32,
                       device=buf.device)
    return TelemetryFrame(channels=buf, steps=steps, count=count,
                          names=names)


# ---------------------------------------------------------------------------
# host-side decoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TelemetryEvent:
    """One decoded event.  ``kind`` is one of:

    * ``scale``       -- the consumer count changed (``from``/``to``);
    * ``migration``   -- >= 1 partition changed owner this step
      (``count``, ``rscore`` -- the paper's Eq. 10 price of the move);
    * ``storm``       -- a control-plane rebalance-storm window
      (``start``/``end`` steps, ``peak_parts`` concurrently blocked);
    * ``downtime``    -- a window with any partition unreadable
      (``start``/``end``, ``peak_parts``);
    * ``lifecycle``   -- the active-partition count changed (``delta``,
      ``active``).

    ``index`` locates the stream in a batched frame (``()`` for one).
    """

    kind: str
    step: int
    index: Tuple[int, ...] = ()
    data: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "step": self.step,
                "index": list(self.index),
                "data": {k: (round(float(v), 6) if isinstance(v, float)
                             else v) for k, v in self.data.items()}}


def _windows(mask: np.ndarray, steps: np.ndarray, vals: np.ndarray
             ) -> List[Tuple[int, int, float]]:
    """Contiguous True runs -> [(start_step, end_step_inclusive, peak)]."""
    out = []
    start = None
    peak = 0.0
    for i, on in enumerate(mask):
        if on and start is None:
            start, peak = int(steps[i]), float(vals[i])
        elif on:
            peak = max(peak, float(vals[i]))
        elif start is not None:
            out.append((start, int(steps[i - 1]), peak))
            start = None
    if start is not None:
        out.append((start, int(steps[-1]), peak))
    return out


def decode_events(frame: TelemetryFrame) -> List[TelemetryEvent]:
    """Decode a frame (any leading batch shape) into typed event records,
    ordered by ``(index, step)``.  Ring-mode frames decode the surviving
    window; rows never written (``step == -1``) are skipped."""
    ch = _np(frame.channels).astype(np.float64)
    steps = _np(frame.steps).astype(np.int64)
    col = {nm: i for i, nm in enumerate(frame.names)}
    events: List[TelemetryEvent] = []
    lead = ch.shape[:-2]
    for index in np.ndindex(*lead) if lead else [()]:
        c = ch[index]                       # [R, K]
        s = steps[index]                    # [R]
        order = np.argsort(s, kind="stable")  # ring mode: restore time order
        valid = s[order] >= 0
        c, s = c[order][valid], s[order][valid]
        if c.shape[0] == 0:
            continue
        cons = c[:, col["consumers"]]
        migs = c[:, col["migrations"]]
        rsc = c[:, col["rscore"]]
        act = c[:, col["active_parts"]]
        for t in np.flatnonzero(np.diff(cons) != 0):
            events.append(TelemetryEvent(
                "scale", int(s[t + 1]), index,
                {"from": float(cons[t]), "to": float(cons[t + 1])}))
        for t in np.flatnonzero(migs > 0):
            events.append(TelemetryEvent(
                "migration", int(s[t]), index,
                {"count": float(migs[t]), "rscore": float(rsc[t])}))
        for start, end, peak in _windows(c[:, col["storm_parts"]] > 0, s,
                                         c[:, col["storm_parts"]]):
            events.append(TelemetryEvent(
                "storm", start, index, {"end": float(end),
                                        "peak_parts": peak}))
        for start, end, peak in _windows(c[:, col["unreadable"]] > 0, s,
                                         c[:, col["unreadable"]]):
            events.append(TelemetryEvent(
                "downtime", start, index, {"end": float(end),
                                           "peak_parts": peak}))
        for t in np.flatnonzero(np.diff(act) != 0):
            events.append(TelemetryEvent(
                "lifecycle", int(s[t + 1]), index,
                {"delta": float(act[t + 1] - act[t]),
                 "active": float(act[t + 1])}))
    events.sort(key=lambda e: (e.index, e.step, e.kind))
    return events


def _require_pandas(caller: str):
    """Late pandas import with a named error: pandas is an optional
    dependency, and the exporters are conveniences, not core paths."""
    try:
        import pandas as pd
    except ImportError as exc:
        raise ImportError(
            f"{caller} needs pandas, which is an optional dependency and "
            f"is not installed in this environment.  Install pandas, or "
            f"use to_json()/decode_events() (stdlib + numpy only) instead."
        ) from exc
    return pd


@dataclasses.dataclass
class EventStream:
    """A decoded frame: typed events plus the raw per-step samples."""

    events: List[TelemetryEvent]
    frame: TelemetryFrame

    @classmethod
    def from_frame(cls, frame: TelemetryFrame) -> "EventStream":
        return cls(events=decode_events(frame), frame=frame)

    def counts(self) -> Dict[str, int]:
        """Events per kind."""
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def to_json(self) -> str:
        """Canonical JSON: channel names, event records, recorded-step
        count.  Floats round to 6 decimals."""
        return json.dumps({
            "channels": list(self.frame.names),
            "recorded_steps": int(np.max(_np(self.frame.count))),
            "counts": self.counts(),
            "events": [e.as_dict() for e in self.events],
        }, indent=1, sort_keys=True)

    def to_dataframe(self):
        """The per-step samples as a tidy ``pandas.DataFrame`` (one row per
        recorded (index, step), one column per channel)."""
        pd = _require_pandas("EventStream.to_dataframe")
        ch = _np(self.frame.channels).astype(np.float64)
        steps = _np(self.frame.steps).astype(np.int64)
        lead = ch.shape[:-2]
        rows = []
        for index in np.ndindex(*lead) if lead else [()]:
            c, s = ch[index], steps[index]
            for r in range(c.shape[0]):
                if s[r] < 0:
                    continue
                row = {"step": int(s[r])}
                row.update({f"i{d}": int(v) for d, v in enumerate(index)})
                row.update({nm: float(c[r, k])
                            for k, nm in enumerate(self.frame.names)})
                rows.append(row)
        return pd.DataFrame(rows).sort_values(
            [c for c in rows[0] if c.startswith("i")] + ["step"]
        ).reset_index(drop=True) if rows else pd.DataFrame()

    def events_dataframe(self):
        """The decoded events as a ``pandas.DataFrame``."""
        pd = _require_pandas("EventStream.events_dataframe")
        return pd.DataFrame([
            {"kind": e.kind, "step": e.step, "index": e.index, **e.data}
            for e in self.events])


__all__ = [
    "BASE_CHANNELS",
    "CounterState",
    "EventStream",
    "TelemetryConfig",
    "TelemetryEvent",
    "TelemetryFrame",
    "decode_events",
]

"""Host-side span profiling: where wall time goes around the card's work.

``span(name, **args)`` is a context manager that appends one timed
``SpanRecord`` to the process-wide default :class:`Tracer`;
``@traced()`` wraps a function in one.  Every record carries its
``call_index`` (the nth occurrence of that span name), so first-call and
steady-state costs separate cleanly: ``Tracer.summary()`` reports
``first_us`` vs ``steady_us`` per name, and ``Tracer.to_chrome_trace()``
exports the whole run as Chrome ``trace_event`` JSON (load it at
https://ui.perfetto.dev or ``chrome://tracing``).

A copy of the reference's ``repro.telemetry.spans`` (stdlib only), so
that the port's facade and fleet layer emit the same span names.  The
tracer is a bounded flight recorder: past ``max_spans`` records new spans
are dropped (and counted in ``dropped``), never grown without bound.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional


@dataclasses.dataclass
class SpanRecord:
    """One completed span (times in microseconds since tracer epoch)."""

    name: str
    start_us: float
    dur_us: float
    call_index: int            # nth occurrence of this name (0 = first call)
    tid: int                   # host thread id
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """Bounded, process-wide span collector with Chrome-trace export."""

    def __init__(self, max_spans: int = 100_000, enabled: bool = True):
        if max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {max_spans}")
        self.max_spans = max_spans
        self.enabled = enabled
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self.spans: List[SpanRecord] = []
        self.dropped = 0
        self._counts: Dict[str, int] = {}

    # -- recording ----------------------------------------------------------

    def reset(self) -> None:
        """Drop every record and restart the epoch and call indices."""
        with self._lock:
            self.spans.clear()
            self._counts.clear()
            self.dropped = 0
            self._epoch = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[Optional[Dict]]:
        """Time the enclosed block as one span.

        Yields the (mutable) args dict so the block can attach results
        discovered mid-span (e.g. a cache-hit flag); yields ``None`` when
        the tracer is disabled.
        """
        if not self.enabled:
            yield None
            return
        t0 = time.perf_counter()
        try:
            yield args
        finally:
            t1 = time.perf_counter()
            with self._lock:
                idx = self._counts.get(name, 0)
                self._counts[name] = idx + 1
                if len(self.spans) >= self.max_spans:
                    self.dropped += 1
                else:
                    self.spans.append(SpanRecord(
                        name=name,
                        start_us=(t0 - self._epoch) * 1e6,
                        dur_us=(t1 - t0) * 1e6,
                        call_index=idx,
                        tid=threading.get_ident(),
                        args=dict(args)))

    def instant(self, name: str, **args: Any) -> None:
        """Record a zero-duration event (cache hits/misses, evictions)."""
        with self.span(name, **args):
            pass

    def traced(self, name: Optional[str] = None) -> Callable:
        """Decorator: run the function inside ``span(name or qualname)``."""

        def deco(fn: Callable) -> Callable:
            label = name if name is not None else fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label):
                    return fn(*a, **kw)

            return wrapper

        return deco

    # -- reductions ---------------------------------------------------------

    def records(self, name: Optional[str] = None,
                **arg_filter: Any) -> List[SpanRecord]:
        """Snapshot of records, optionally filtered by name and arg values."""
        with self._lock:
            out = list(self.spans)
        if name is not None:
            out = [r for r in out if r.name == name]
        for k, v in arg_filter.items():
            out = [r for r in out if r.args.get(k) == v]
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name durations, first call split from steady state.

        ``first_us`` is the ``call_index == 0`` span (the first call pays
        the kernels' build and first launches); ``steady_us`` the mean
        over the rest; ``count`` and ``total_us`` cover both.
        """
        per: Dict[str, List[SpanRecord]] = {}
        for r in self.records():
            per.setdefault(r.name, []).append(r)
        out: Dict[str, Dict[str, float]] = {}
        for nm, rs in sorted(per.items()):
            first = [r.dur_us for r in rs if r.call_index == 0]
            rest = [r.dur_us for r in rs if r.call_index > 0]
            out[nm] = {
                "count": float(len(rs)),
                "total_us": float(sum(r.dur_us for r in rs)),
                "first_us": float(first[0]) if first else 0.0,
                "steady_us": float(sum(rest) / len(rest)) if rest else 0.0,
            }
        return out

    # -- export -------------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON (the format Perfetto ingests).

        Complete ``ph: "X"`` duration events on one process track, one
        thread row per host thread; span args ride along for the
        Perfetto details pane.
        """
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "repro_torch"},
        }]
        for r in self.records():
            events.append({
                "name": r.name,
                "cat": r.name.split(".", 1)[0],
                "ph": "X",
                "ts": r.start_us,
                "dur": r.dur_us,
                "pid": 0,
                "tid": r.tid,
                "args": {**r.args, "call_index": r.call_index},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> Dict[str, Any]:
        """Write the Chrome/Perfetto trace JSON to ``path``."""
        out = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return out


def validate_chrome_trace(trace: Dict[str, Any]) -> None:
    """Assert ``trace`` is structurally valid Chrome ``trace_event`` JSON
    (the checks Perfetto's importer performs on load); raises ``ValueError``
    naming the first offending event otherwise."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"traceEvents[{i}] has no phase ('ph') field")
        if ev["ph"] == "X":
            for k in ("name", "ts", "dur", "pid", "tid"):
                if k not in ev:
                    raise ValueError(
                        f"traceEvents[{i}] (ph=X, "
                        f"name={ev.get('name')!r}) is missing {k!r}")
            if ev["dur"] < 0:
                raise ValueError(
                    f"traceEvents[{i}] ({ev['name']!r}) has negative dur")


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer every module-level ``span`` records into."""
    return _DEFAULT


def span(name: str, **args: Any):
    """``with span("api.simulate", policies=3): ...`` on the default tracer."""
    return _DEFAULT.span(name, **args)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form of :func:`span` on the default tracer."""
    return _DEFAULT.traced(name)


def instant(name: str, **args: Any) -> None:
    """Zero-duration event on the default tracer (cache hits, evictions)."""
    _DEFAULT.instant(name, **args)


__all__ = [
    "SpanRecord",
    "Tracer",
    "default_tracer",
    "instant",
    "span",
    "traced",
    "validate_chrome_trace",
]

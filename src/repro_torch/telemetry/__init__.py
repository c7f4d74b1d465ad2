"""Telemetry of the port: in-loop capture, streaming sketches, SLO
alerting, host-side spans and standard metric export.

Five submodules, each the counterpart of the reference's module of the
same name:

* ``telemetry.record`` -- the in-loop recorder.  Put a
  :class:`TelemetryConfig` on ``LagSimConfig.telemetry`` and the loop
  records a fixed channel vector a step and returns a
  :class:`TelemetryFrame` on every trace, decodable into typed events
  (:func:`decode_events` / :class:`EventStream`).  Off (the default)
  dispatches the same operations as the recorder-free loop.
* ``telemetry.sketch`` -- constant-memory online aggregators (Welford
  moments, min/max, EWMA windows, histogram quantiles);
  ``TelemetryConfig(sketch=SketchConfig(...))``.
* ``telemetry.alerts`` -- declarative in-loop alerting (multi-window SLO
  burn rate, lag growth, rebalance storms, thrash) with fixed-shape
  incident tables; ``TelemetryConfig(alerts=AlertConfig(
  rules=default_rules()))``.
* ``telemetry.spans`` -- host-side span profiling (:func:`span`,
  :func:`traced`, :class:`Tracer`) with Chrome/Perfetto export.
* ``telemetry.export`` -- stdlib-only Prometheus text exposition and
  OTLP-style JSON for sketches, incidents and spans, plus an exposition
  linter.
"""
from .alerts import (AlertConfig, AlertRule, AlertState, Incident,
                     alert_init, alert_step, decode_incidents, default_rules,
                     incident_counts, incident_summary)
from .export import (otlp_metrics_json, otlp_spans_json,
                     prometheus_exposition, validate_exposition)
from .record import (BASE_CHANNELS, CounterState, EventStream,
                     TelemetryConfig, TelemetryEvent, TelemetryFrame,
                     decode_events)
from .sketch import (SketchConfig, SketchState, SketchSummary,
                     merge_summaries, sketch_init, sketch_update,
                     summaries_from_state)
from .spans import (SpanRecord, Tracer, default_tracer, instant, span,
                    traced, validate_chrome_trace)

__all__ = sorted((
    "BASE_CHANNELS",
    "CounterState",
    "EventStream",
    "TelemetryConfig",
    "TelemetryEvent",
    "TelemetryFrame",
    "decode_events",
    "SketchConfig",
    "SketchState",
    "SketchSummary",
    "merge_summaries",
    "sketch_init",
    "sketch_update",
    "summaries_from_state",
    "AlertConfig",
    "AlertRule",
    "AlertState",
    "Incident",
    "alert_init",
    "alert_step",
    "decode_incidents",
    "default_rules",
    "incident_counts",
    "incident_summary",
    "otlp_metrics_json",
    "otlp_spans_json",
    "prometheus_exposition",
    "validate_exposition",
    "SpanRecord",
    "Tracer",
    "default_tracer",
    "instant",
    "span",
    "traced",
    "validate_chrome_trace",
))

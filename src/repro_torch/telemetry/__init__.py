"""Host-side span profiling of the port (``telemetry.spans``).

The reference's in-loop recorder, sketches and alerts
(``repro.telemetry.record`` / ``sketch`` / ``alerts``) wait for a later
slice; ``LagSimConfig.telemetry`` raises ``NotPortedError`` until then.
"""
from .spans import (SpanRecord, Tracer, default_tracer, instant, span,
                    traced, validate_chrome_trace)

__all__ = [
    "SpanRecord",
    "Tracer",
    "default_tracer",
    "instant",
    "span",
    "traced",
    "validate_chrome_trace",
]

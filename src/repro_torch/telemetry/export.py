"""Industry-standard metric export: Prometheus text exposition and
OpenTelemetry-style JSON, stdlib only.

A copy of the reference's ``repro.telemetry.export`` (the port imports
nothing of ``repro``), so both packages render the same text for the
same summaries.  :func:`prometheus_exposition` renders a
:class:`~repro_torch.telemetry.sketch.SketchSummary`, a decoded incident
list and a :class:`~repro_torch.telemetry.spans.Tracer` summary as
`text/plain; version=0.0.4` exposition -- what a Prometheus scrape
endpoint serves -- with the sketch histogram as a native Prometheus
histogram (cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).
:func:`otlp_metrics_json` / :func:`otlp_spans_json` emit the
OpenTelemetry protocol's JSON encoding (``resourceMetrics`` /
``resourceSpans``).

:func:`validate_exposition` is a pure-python linter for the exposition
format (metric/label name grammar, ``TYPE``-before-samples, histogram
bucket monotonicity, ``+Inf`` == ``_count``).
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

_METRIC_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)(?:\s+\d+)?$")
_LABEL_PAIR_RE = re.compile(
    r'^(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"$')


def _fmt(v: float) -> str:
    """Prometheus sample values: shortest lossless float, Inf/NaN named."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels(pairs: Mapping[str, str]) -> str:
    if not pairs:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(pairs.items()))
    return "{" + body + "}"


def _sanitize(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not _METRIC_RE.match(out):
        out = "_" + out
    return out


class _Writer:
    def __init__(self) -> None:
        self.lines: List[str] = []
        self._typed: set = set()

    def header(self, name: str, mtype: str, help_text: str) -> None:
        if name in self._typed:
            return
        self._typed.add(name)
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, labels: Mapping[str, str],
               value: float) -> None:
        self.lines.append(f"{name}{_labels(labels)} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def prometheus_exposition(sketch: Optional[Any] = None,
                          incidents: Optional[Sequence[Any]] = None,
                          spans: Optional[Mapping[str, Mapping[str, float]]] = None,
                          labels: Optional[Mapping[str, str]] = None,
                          prefix: str = "repro") -> str:
    """Render a scrape body from any subset of the observability surface.

    ``sketch`` is a :class:`SketchSummary` (means/extrema/EWMAs as
    gauges, histogrammed channels as native histograms); ``incidents``
    a list of decoded :class:`Incident` records (counts and durations by
    rule/severity); ``spans`` a ``Tracer.summary()`` mapping.  ``labels``
    ride every sample (e.g. ``{"scenario": "burst"}``).
    """
    base = dict(labels or {})
    for k in base:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid Prometheus label name {k!r}")
    w = _Writer()

    if sketch is not None:
        p = f"{prefix}_sketch"
        w.header(f"{p}_steps", "gauge",
                 "Valid simulation steps aggregated by the sketch.")
        w.sample(f"{p}_steps", base, sketch.count)
        for stat, vec in (("mean", sketch.mean), ("std", sketch.stddev()),
                          ("min", sketch.vmin), ("max", sketch.vmax)):
            name = f"{p}_{stat}"
            w.header(name, "gauge",
                     f"Per-channel whole-run {stat} from the online sketch.")
            for i, ch in enumerate(sketch.names):
                v = float(vec[i])
                if sketch.count == 0 and stat in ("min", "max"):
                    v = 0.0
                w.sample(name, {**base, "channel": ch}, v)
        name = f"{p}_ewma"
        w.header(name, "gauge",
                 "Debiased EWMA window per channel (halflife in steps).")
        for h, vec in sorted(sketch.ewma.items()):
            for i, ch in enumerate(sketch.names):
                w.sample(name, {**base, "channel": ch, "halflife": f"{h:g}"},
                         float(vec[i]))
        for ci, ch in enumerate(sketch.hist_names):
            name = f"{p}_{_sanitize(ch)}"
            w.header(name, "histogram",
                     f"Fixed-bin whole-run distribution of {ch}.")
            counts = sketch.hist[ci]
            cum = 0.0
            for bi in range(len(counts)):
                cum += float(counts[bi])
                w.sample(f"{name}_bucket",
                         {**base, "le": _fmt(float(sketch.edges[bi + 1]))},
                         cum)
            w.sample(f"{name}_bucket", {**base, "le": "+Inf"}, cum)
            # bin-center mass approximation; exact _sum is not tracked
            centers = [0.5 * (float(sketch.edges[i]) + float(sketch.edges[i + 1]))
                       for i in range(len(counts))]
            w.sample(f"{name}_sum", base,
                     sum(c * float(n) for c, n in zip(centers, counts)))
            w.sample(f"{name}_count", base, cum)

    if incidents is not None:
        p = f"{prefix}_incidents"
        by_rule: Dict[Tuple[str, str], List[Any]] = {}
        for inc in incidents:
            by_rule.setdefault((inc.rule, inc.severity), []).append(inc)
        w.header(f"{p}_total", "counter",
                 "Incidents opened per alert rule over the run.")
        w.header(f"{p}_duration_seconds_total", "counter",
                 "Summed alert-firing duration per rule.")
        w.header(f"{p}_active", "gauge",
                 "Incidents still open at the end of the run.")
        for (rule, severity), incs in sorted(by_rule.items()):
            lbl = {**base, "rule": rule, "severity": severity}
            w.sample(f"{p}_total", lbl, float(len(incs)))
            w.sample(f"{p}_duration_seconds_total", lbl,
                     sum(i.duration_s for i in incs))
            w.sample(f"{p}_active", lbl,
                     float(sum(1 for i in incs if i.still_open)))

    if spans is not None:
        p = f"{prefix}_span"
        w.header(f"{p}_calls_total", "counter",
                 "Host-side span occurrences (Tracer records).")
        w.header(f"{p}_time_microseconds_total", "counter",
                 "Total wall time inside each span name.")
        w.header(f"{p}_steady_microseconds", "gauge",
                 "Mean steady-state (post-first-call) span duration.")
        for nm, row in sorted(spans.items()):
            lbl = {**base, "span": _sanitize(nm)}
            w.sample(f"{p}_calls_total", lbl, row.get("count", 0.0))
            w.sample(f"{p}_time_microseconds_total", lbl,
                     row.get("total_us", 0.0))
            w.sample(f"{p}_steady_microseconds", lbl,
                     row.get("steady_us", 0.0))

    return w.text()


def validate_exposition(text: str) -> None:
    """Lint Prometheus text exposition; raises ``ValueError`` naming the
    first offending line.

    Checks the grammar a scraper enforces: metric/label name charsets,
    ``# TYPE`` declared before its samples, parseable sample values, and
    histogram coherence (``le`` buckets cumulative and non-decreasing,
    ``+Inf`` bucket present and equal to ``_count``).
    """
    types: Dict[str, str] = {}
    hist: Dict[Tuple[str, str], Dict[str, float]] = {}

    def family(name: str) -> str:
        for suf in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suf) and name[:-len(suf)] in types:
                return name[:-len(suf)]
        return name

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(
                    f"line {ln}: malformed comment {line!r} (only '# HELP' "
                    f"and '# TYPE' comments are meaningful)")
            if not _METRIC_RE.match(parts[2]):
                raise ValueError(
                    f"line {ln}: invalid metric name {parts[2]!r}")
            if parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    raise ValueError(
                        f"line {ln}: invalid TYPE line {line!r}")
                if parts[2] in types:
                    raise ValueError(
                        f"line {ln}: duplicate TYPE for {parts[2]!r}")
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: unparseable sample {line!r}")
        name = m.group("name")
        fam = family(name)
        if fam in types and types[fam] == "histogram":
            pass
        elif name not in types and fam == name:
            raise ValueError(
                f"line {ln}: sample {name!r} has no preceding # TYPE line")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            for pair in _split_label_pairs(raw, ln):
                pm = _LABEL_PAIR_RE.match(pair)
                if not pm:
                    raise ValueError(
                        f"line {ln}: malformed label pair {pair!r}")
                labels[pm.group("key")] = pm.group("val")
        val = m.group("value")
        try:
            fval = float(val.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(f"line {ln}: non-numeric value {val!r}")
        if fam in types and types[fam] == "histogram":
            key = (fam, json.dumps(
                {k: v for k, v in labels.items() if k != "le"},
                sort_keys=True))
            h = hist.setdefault(key, {"prev": -math.inf, "inf": math.nan,
                                      "cnt": math.nan})
            if name == f"{fam}_bucket":
                if "le" not in labels:
                    raise ValueError(
                        f"line {ln}: histogram bucket without 'le' label")
                if fval < h["prev"] - 1e-9:
                    raise ValueError(
                        f"line {ln}: histogram {fam!r} buckets not "
                        f"cumulative (value decreased)")
                h["prev"] = fval
                if labels["le"] == "+Inf":
                    h["inf"] = fval
            elif name == f"{fam}_count":
                h["cnt"] = fval
    for (fam, lbl), h in hist.items():
        if math.isnan(h["inf"]):
            raise ValueError(
                f"histogram {fam!r} ({lbl}) has no '+Inf' bucket")
        if not math.isnan(h["cnt"]) and abs(h["inf"] - h["cnt"]) > 1e-9:
            raise ValueError(
                f"histogram {fam!r} ({lbl}): +Inf bucket {h['inf']} != "
                f"_count {h['cnt']}")


def _split_label_pairs(raw: str, ln: int) -> List[str]:
    out, buf, quoted, escape = [], [], False, False
    for ch in raw:
        if escape:
            buf.append(ch)
            escape = False
        elif ch == "\\":
            buf.append(ch)
            escape = True
        elif ch == '"':
            buf.append(ch)
            quoted = not quoted
        elif ch == "," and not quoted:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if quoted:
        raise ValueError(f"line {ln}: unterminated label quote")
    if buf:
        out.append("".join(buf))
    return out


# ---------------------------------------------------------------------------
# OpenTelemetry-style JSON (OTLP/JSON encoding, deterministic timestamps)
# ---------------------------------------------------------------------------

def _otlp_attrs(pairs: Mapping[str, Any]) -> List[Dict[str, Any]]:
    out = []
    for k, v in sorted(pairs.items()):
        if isinstance(v, bool):
            val: Dict[str, Any] = {"boolValue": v}
        elif isinstance(v, (int,)):
            val = {"intValue": str(v)}
        elif isinstance(v, float):
            val = {"doubleValue": v}
        else:
            val = {"stringValue": str(v)}
        out.append({"key": k, "value": val})
    return out


def _gauge(name: str, desc: str, unit: str,
           points: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {"name": name, "description": desc, "unit": unit,
            "gauge": {"dataPoints": points}}


def otlp_metrics_json(sketch: Optional[Any] = None,
                      incidents: Optional[Sequence[Any]] = None,
                      resource: Optional[Mapping[str, Any]] = None,
                      time_unix_nano: int = 0) -> Dict[str, Any]:
    """OTLP/JSON ``resourceMetrics`` for a sketch summary and incident
    list.  ``time_unix_nano`` defaults to 0 so output is deterministic;
    stamp real wall-clock time at the call site if a backend needs it.
    """
    ts = str(int(time_unix_nano))
    metrics: List[Dict[str, Any]] = []
    if sketch is not None:
        for stat, vec in (("mean", sketch.mean), ("std", sketch.stddev()),
                          ("min", sketch.vmin), ("max", sketch.vmax)):
            pts = []
            for i, ch in enumerate(sketch.names):
                v = float(vec[i])
                if sketch.count == 0 and stat in ("min", "max"):
                    v = 0.0
                pts.append({"timeUnixNano": ts, "asDouble": v,
                            "attributes": _otlp_attrs({"channel": ch})})
            metrics.append(_gauge(
                f"repro.sketch.{stat}",
                f"Whole-run per-channel {stat} from the online sketch.",
                "1", pts))
        for ci, ch in enumerate(sketch.hist_names):
            counts = sketch.hist[ci]
            total = float(sum(float(c) for c in counts))
            centers = [0.5 * (float(sketch.edges[i]) + float(sketch.edges[i + 1]))
                       for i in range(len(counts))]
            metrics.append({
                "name": f"repro.sketch.hist.{ch}",
                "description": f"Fixed-bin whole-run distribution of {ch}.",
                "unit": "1",
                "histogram": {
                    "aggregationTemporality": 2,   # CUMULATIVE
                    "dataPoints": [{
                        "timeUnixNano": ts,
                        "count": str(int(total)),
                        "sum": sum(c * float(n)
                                   for c, n in zip(centers, counts)),
                        "bucketCounts": [str(int(float(c))) for c in counts],
                        "explicitBounds": [float(e)
                                           for e in sketch.edges[1:-1]],
                        "attributes": _otlp_attrs({"channel": ch}),
                    }],
                },
            })
    if incidents is not None:
        by_rule: Dict[Tuple[str, str], List[Any]] = {}
        for inc in incidents:
            by_rule.setdefault((inc.rule, inc.severity), []).append(inc)
        pts, dur_pts = [], []
        for (rule, severity), incs in sorted(by_rule.items()):
            attrs = _otlp_attrs({"rule": rule, "severity": severity})
            pts.append({"timeUnixNano": ts, "asDouble": float(len(incs)),
                        "attributes": attrs})
            dur_pts.append({"timeUnixNano": ts,
                            "asDouble": sum(i.duration_s for i in incs),
                            "attributes": attrs})
        metrics.append({
            "name": "repro.incidents.count",
            "description": "Incidents opened per alert rule over the run.",
            "unit": "1",
            "sum": {"aggregationTemporality": 2, "isMonotonic": True,
                    "dataPoints": pts},
        })
        metrics.append({
            "name": "repro.incidents.duration",
            "description": "Summed alert-firing duration per rule.",
            "unit": "s",
            "sum": {"aggregationTemporality": 2, "isMonotonic": True,
                    "dataPoints": dur_pts},
        })
    return {"resourceMetrics": [{
        "resource": {"attributes": _otlp_attrs(
            {"service.name": "repro", **(resource or {})})},
        "scopeMetrics": [{
            "scope": {"name": "repro.telemetry", "version": "1"},
            "metrics": metrics,
        }],
    }]}


def otlp_spans_json(records: Sequence[Any],
                    resource: Optional[Mapping[str, Any]] = None,
                    epoch_unix_nano: int = 0) -> Dict[str, Any]:
    """OTLP/JSON ``resourceSpans`` from ``Tracer.records()`` --
    span times are tracer-epoch-relative microseconds, offset by
    ``epoch_unix_nano`` (default 0: deterministic output)."""
    spans = []
    for i, r in enumerate(records):
        start = int(epoch_unix_nano) + int(r.start_us * 1_000)
        spans.append({
            "traceId": "0" * 31 + "1",
            "spanId": f"{i + 1:016x}",
            "name": r.name,
            "kind": 1,                                 # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start),
            "endTimeUnixNano": str(start + int(r.dur_us * 1_000)),
            "attributes": _otlp_attrs(
                {**r.args, "call_index": r.call_index, "tid": r.tid}),
        })
    return {"resourceSpans": [{
        "resource": {"attributes": _otlp_attrs(
            {"service.name": "repro", **(resource or {})})},
        "scopeSpans": [{
            "scope": {"name": "repro.telemetry.spans", "version": "1"},
            "spans": spans,
        }],
    }]}


__all__ = [
    "otlp_metrics_json",
    "otlp_spans_json",
    "prometheus_exposition",
    "validate_exposition",
]

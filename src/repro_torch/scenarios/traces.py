"""Versioned on-disk workload traces: save, load, validate, resample (a
copy of ``repro.scenarios.traces``: the file format is the reference's
byte for byte, so a trace written by either package loads in the other).

The fleet contract is a pair of arrays -- rates ``f32[B, T, N]``
and partition existence ``active: bool[B, T, N]`` -- and everything
downstream (``sweep_lag``, ``FleetRunner``, the benchmarks) consumes
exactly that.  This module gives the pair a *file format*, so a scenario
can come from disk instead of a generator: a recorded production
workload, a seed shape from the Kafka benchmark paper
(``scenarios.seeds``), or a witness genome the adversarial search found
(``scenarios.search``).

Format (version ``TRACE_VERSION``):

* ``.json`` -- self-describing, diff-able, the golden-fixture format.
  ``rates`` round-trip exactly: every float32 is representable as a JSON
  double and numpy reads it back to the identical float32.
* ``.npz``  -- compressed binary for anything big; the same header
  rides inside as a JSON string (a 0-d array).

``load_trace`` always validates: version, shapes, dtypes, finiteness,
non-negative rates, and the mask contract (a partition that does not
exist must have rate exactly 0 -- silence where absent).

``resample_trace`` retimes a trace to a different step count.  With
``iters == trace.iters`` it returns the trace *unchanged* -- the
bit-for-bit identity the round-trip property test pins -- otherwise
zero-order hold (``"hold"``, default; mask-safe) or ``"linear"`` on the
rates with a hold mask.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

#: on-disk format version; bump on breaking layout changes
TRACE_VERSION = 1

_KIND = "repro.trace"


@dataclasses.dataclass
class Trace:
    """One fleet-contract workload batch with provenance.

    ``rates``/``active`` are host numpy (``f32``/``bool``, both
    ``[B, T, N]``); hand them straight to ``FleetRunner.simulate(...,
    active=...)`` or ``repro_torch.api.replay``.  ``meta`` carries free-form
    provenance (generator knobs, witness genome, resampling history).
    """

    rates: np.ndarray
    active: np.ndarray
    capacity: float = 1.0
    name: str = ""
    source: str = ""
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = TRACE_VERSION

    @property
    def batch(self) -> int:
        return int(self.rates.shape[0])

    @property
    def iters(self) -> int:
        return int(self.rates.shape[1])

    @property
    def n(self) -> int:
        return int(self.rates.shape[2])


def validate_trace(trace: Trace) -> Trace:
    """Check the fleet contract; -> the trace with canonical dtypes.

    Raises ``ValueError`` naming the first violated invariant: format
    version, rank/shape, finiteness, negative rates, or a rate where the
    partition does not exist.
    """
    if int(trace.version) != TRACE_VERSION:
        raise ValueError(
            f"unsupported trace format version {trace.version!r}; this "
            f"build reads version {TRACE_VERSION}")
    rates = np.asarray(trace.rates, np.float32)
    active = np.asarray(trace.active, bool)
    if rates.ndim != 3:
        raise ValueError(
            f"trace rates must be f32[B, T, N]; got shape {rates.shape}")
    if active.shape != rates.shape:
        raise ValueError(
            f"trace active mask shape {active.shape} != rates shape "
            f"{rates.shape}")
    if not float(trace.capacity) > 0.0:
        raise ValueError(
            f"trace capacity must be > 0, got {trace.capacity!r}")
    if not np.isfinite(rates).all():
        raise ValueError("trace rates contain non-finite values")
    if (rates < 0.0).any():
        raise ValueError("trace rates contain negative values")
    if rates[~active].any():
        raise ValueError(
            "trace violates the mask contract: a partition with "
            "active=False must have rate exactly 0 (silence where absent)")
    trace.rates = rates
    trace.active = active
    return trace


def trace_from_scenario(family: str, seed, batch: int, iters: int, n: int,
                        *, capacity: float = 1.0, name: Optional[str] = None,
                        device=None, **knobs) -> Trace:
    """Materialize one registered family's batch as a :class:`Trace`
    (provenance: family + knobs), drawn on ``device`` (``None`` = the CUDA
    card) from a generator seeded ``seed`` (or from the generator
    ``seed``): deterministic for a fixed seed on one device type."""
    from repro_torch.core.scenarios import generate_masked_scenario

    speeds, active = generate_masked_scenario(
        family, seed, batch, iters, n, capacity=capacity, device=device,
        **knobs)
    return validate_trace(Trace(
        rates=speeds.cpu().numpy().astype(np.float32),
        active=active.cpu().numpy().astype(bool), capacity=float(capacity),
        name=name or family, source=f"synthetic:{family}",
        meta={"family": family,
              "knobs": {k: float(v) for k, v in knobs.items()}}))


def _header(trace: Trace) -> Dict[str, Any]:
    return {"kind": _KIND, "version": int(trace.version),
            "name": trace.name, "source": trace.source,
            "capacity": float(trace.capacity),
            "shape": [trace.batch, trace.iters, trace.n],
            "meta": trace.meta}


def save_trace(trace: Trace, path: str) -> str:
    """Write a validated trace to ``path`` (format by extension:
    ``.json`` or ``.npz``); -> the path written."""
    trace = validate_trace(trace)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        doc = _header(trace)
        # float32 -> JSON double -> float32 is exact (doubles cover f32)
        doc["rates"] = trace.rates.astype(np.float32).tolist()
        doc["active"] = trace.active.astype(int).tolist()
        with open(path, "w") as f:
            json.dump(doc, f)
    elif ext == ".npz":
        np.savez_compressed(path, rates=trace.rates,
                            active=trace.active,
                            header=np.array(json.dumps(_header(trace))))
    else:
        raise ValueError(
            f"unknown trace extension {ext!r} for {path!r}; "
            f"use .json or .npz")
    return path


def load_trace(path: str) -> Trace:
    """Read + validate a trace written by :func:`save_trace`."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path) as f:
            doc = json.load(f)
        head = doc
        rates = np.asarray(doc["rates"], np.float32)
        active = np.asarray(doc["active"], bool)
    elif ext == ".npz":
        with np.load(path) as z:
            head = json.loads(str(z["header"][()]))
            rates = np.asarray(z["rates"], np.float32)
            active = np.asarray(z["active"], bool)
    else:
        raise ValueError(
            f"unknown trace extension {ext!r} for {path!r}; "
            f"use .json or .npz")
    if head.get("kind") != _KIND:
        raise ValueError(
            f"{path!r} is not a {_KIND} file (kind={head.get('kind')!r})")
    trace = Trace(rates=rates, active=active,
                  capacity=float(head.get("capacity", 1.0)),
                  name=str(head.get("name", "")),
                  source=str(head.get("source", path)),
                  meta=dict(head.get("meta", {})),
                  version=int(head.get("version", -1)))
    trace = validate_trace(trace)
    shape = head.get("shape")
    if shape is not None and tuple(shape) != trace.rates.shape:
        raise ValueError(
            f"{path!r}: header shape {tuple(shape)} != payload shape "
            f"{trace.rates.shape}")
    return trace


def resample_trace(trace: Trace, iters: int,
                   method: str = "hold") -> Trace:
    """Retime a trace to ``iters`` steps.

    ``iters == trace.iters`` returns ``trace`` itself, untouched -- the
    identity the bit-for-bit round-trip property relies on.  Otherwise:
    ``"hold"`` (zero-order hold on rates *and* mask, the mask-safe
    default) or ``"linear"`` (linear rate interpolation, hold mask,
    rates re-silenced where the held mask says absent).
    """
    if int(iters) < 1:
        raise ValueError(f"resample target iters must be >= 1, got {iters}")
    t = trace.iters
    if int(iters) == t:
        return trace
    if method not in ("hold", "linear"):
        raise ValueError(
            f"unknown resample method {method!r}; use 'hold' or 'linear'")
    idx = np.minimum((np.arange(int(iters)) * t) // int(iters), t - 1)
    active = trace.active[:, idx]
    if method == "hold":
        rates = trace.rates[:, idx]
    else:
        pos = (np.arange(int(iters), dtype=np.float64) * (t - 1)
               / max(int(iters) - 1, 1))
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, t - 1)
        frac = (pos - lo).astype(np.float32)[None, :, None]
        rates = (trace.rates[:, lo] * (1.0 - frac)
                 + trace.rates[:, hi] * frac).astype(np.float32)
        rates = np.where(active, rates, np.float32(0.0))
    meta = dict(trace.meta)
    meta["resampled"] = {"from_iters": t, "to_iters": int(iters),
                         "method": method}
    return validate_trace(Trace(
        rates=rates, active=active, capacity=trace.capacity,
        name=trace.name, source=trace.source, meta=meta,
        version=trace.version))


__all__ = [
    "TRACE_VERSION",
    "Trace",
    "load_trace",
    "resample_trace",
    "save_trace",
    "trace_from_scenario",
    "validate_trace",
]

"""Closed-loop lag twin with SLO metrics, batched over streams on the card.

See ``engine.py`` for the step semantics, ``controlplane.py`` for the
emulated scaler control plane, ``fused.py`` for the fused path of the
heuristic packers and ``metrics.py`` for the SLO reductions.
"""
from .controlplane import ControlPlaneConfig, ControlPlaneState, wrap_policy
from .engine import (
    LagSimConfig,
    LagSweepResult,
    LagTrace,
    NotPortedError,
    simulate_lag,
    sweep_lag,
)
from .fused import FUSED_MAX_PARTITIONS, FusedPathError, fused_mode
from .metrics import SLO_METRIC_NAMES, longest_excursion, slo_summary, summarize_sweep

__all__ = [
    "ControlPlaneConfig",
    "ControlPlaneState",
    "FUSED_MAX_PARTITIONS",
    "FusedPathError",
    "LagSimConfig",
    "LagSweepResult",
    "LagTrace",
    "NotPortedError",
    "SLO_METRIC_NAMES",
    "fused_mode",
    "longest_excursion",
    "simulate_lag",
    "slo_summary",
    "summarize_sweep",
    "sweep_lag",
    "wrap_policy",
]

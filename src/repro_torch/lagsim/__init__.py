"""Closed-loop lag twin with SLO metrics, batched over streams on the card.

See ``engine.py`` for the step semantics, ``policies.py`` for the policy
catalogue, ``controlplane.py`` for the emulated scaler control plane,
``fused.py`` for the fused path of the heuristic packers and
``metrics.py`` for the SLO reductions.  ``__all__`` is the reference's
(``repro.lagsim``); ``NotPortedError`` is importable here too.
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
from .policies import (
    OPTIMIZER_POLICY_NAMES,
    PACKING_POLICY_NAMES,
    REACTIVE_BASELINE_NAMES,
)


def __getattr__(name: str):
    # deprecated: forwards to the policies shim (which warns once and
    # resolves through repro_torch.registry)
    if name == "ALL_POLICY_NAMES":
        from . import policies as _policies
        return _policies.ALL_POLICY_NAMES
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ControlPlaneConfig",
    "ControlPlaneState",
    "FUSED_MAX_PARTITIONS",
    "FusedPathError",
    "LagSimConfig",
    "LagSweepResult",
    "LagTrace",
    "OPTIMIZER_POLICY_NAMES",
    "PACKING_POLICY_NAMES",
    "REACTIVE_BASELINE_NAMES",
    "SLO_METRIC_NAMES",
    "fused_mode",
    "longest_excursion",
    "simulate_lag",
    "slo_summary",
    "summarize_sweep",
    "sweep_lag",
    "wrap_policy",
]

"""Fleet execution layer: bucketed, device-split scenario runs (the
port's ``repro.fleet``)."""
from .runner import (FleetConfig, FleetFitness, FleetLagResult,
                     FleetProgress, FleetRunner, FleetSweepResult)

__all__ = [
    "FleetConfig",
    "FleetFitness",
    "FleetLagResult",
    "FleetProgress",
    "FleetRunner",
    "FleetSweepResult",
]

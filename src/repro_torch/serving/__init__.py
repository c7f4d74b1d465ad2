"""Serving/consumption data plane of the port: replicas (consumers), their
lifecycle manager, the end-to-end autoscaling simulation (paper Secs.
V-B/V-C; host code, as in the reference), and the shared model that an
LLM replica generates tokens with (on the card)."""
from .llm_replica import SharedModel
from .manager import SimulatedReplicaManager
from .replica import Replica, ReplicaConfig, Sink
from .simulation import AutoscaleSimulation, SimMetrics

__all__ = [
    "SimulatedReplicaManager",
    "Replica",
    "ReplicaConfig",
    "Sink",
    "AutoscaleSimulation",
    "SimMetrics",
    "SharedModel",
]

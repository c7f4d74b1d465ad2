"""LLM serving of the port: the shared model that generates tokens."""
from .llm_replica import SharedModel

__all__ = ["SharedModel"]

"""Dense decoder-only LLM of the port (the reference's ``repro.models``
dense branch): configs, init, prefill backbone and the serve step, with
attention on the hand-written CUDA kernels."""
from .base import ArchConfig, MambaConfig, NotPortedError
from .transformer import (backbone, init_decode_state, init_params,
                          param_bytes, serve_step)

__all__ = [
    "ArchConfig",
    "MambaConfig",
    "NotPortedError",
    "backbone",
    "init_decode_state",
    "init_params",
    "param_bytes",
    "serve_step",
]

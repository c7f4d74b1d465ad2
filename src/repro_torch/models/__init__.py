"""Decoder-only LLMs of the port (the reference's ``repro.models`` dense
and RWKV-6 branches): configs, init, prefill backbone and the serve step,
with attention and the WKV recurrence on the hand-written CUDA kernels."""
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

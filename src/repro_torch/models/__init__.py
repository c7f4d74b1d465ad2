"""LLMs of the port (the reference's ``repro.models`` dense, MoE, hybrid
Mamba, RWKV-6 and encoder-decoder branches): configs, init, prefill
backbone, the serve step and the training loss, with attention and the
WKV recurrence on the hand-written CUDA kernels."""
from .base import ArchConfig, MambaConfig, NotPortedError
from .layers import cross_entropy
from .transformer import (backbone, forward, init_decode_state, init_params,
                          param_bytes, serve_step)

__all__ = [
    "ArchConfig",
    "MambaConfig",
    "NotPortedError",
    "backbone",
    "cross_entropy",
    "forward",
    "init_decode_state",
    "init_params",
    "param_bytes",
    "serve_step",
]

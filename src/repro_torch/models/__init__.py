"""LLMs of the port (the reference's ``repro.models`` dense, MoE, hybrid
Mamba, RWKV-6, encoder-decoder and VLM branches): configs, init, prefill
backbone, the serve step (tailed or not) and the training loss, with
attention and the WKV recurrence on the hand-written CUDA kernels."""
from .attention import flush_kv_tail, init_kv_tail
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
    "flush_kv_tail",
    "forward",
    "init_decode_state",
    "init_kv_tail",
    "init_params",
    "param_bytes",
    "serve_step",
]

"""LLMs of the port (the reference's ``repro.models`` dense, MoE, hybrid
Mamba, RWKV-6, encoder-decoder and VLM branches): configs, init, prefill
backbone, the serve step (tailed or not) and the training loss, with
attention and the WKV recurrence on the hand-written CUDA kernels, and
their logical sharding specs (``models.sharding``)."""
from .attention import flush_kv_tail, init_kv_tail
from .base import ArchConfig, MambaConfig, NotPortedError
from .layers import cross_entropy
from .sharding import axis_rules, logical_spec, shard, spec_tree_to_shardings
from .transformer import (backbone, decode_state_specs, forward,
                          init_decode_state, init_params, param_bytes,
                          param_specs, serve_step)

__all__ = [
    "ArchConfig",
    "MambaConfig",
    "NotPortedError",
    "axis_rules",
    "backbone",
    "cross_entropy",
    "decode_state_specs",
    "flush_kv_tail",
    "forward",
    "init_decode_state",
    "init_kv_tail",
    "init_params",
    "logical_spec",
    "param_bytes",
    "param_specs",
    "serve_step",
    "shard",
    "spec_tree_to_shardings",
]

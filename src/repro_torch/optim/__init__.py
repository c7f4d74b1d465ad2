"""Optimizer substrate of the port: AdamW with global-norm clipping and a
warmup-cosine schedule, and error-feedback int8 gradient compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, opt_state_specs, warmup_cosine)
from .compress import ef_int8_compress_state, ef_int8_psum

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "opt_state_specs",
    "warmup_cosine",
    "ef_int8_compress_state",
    "ef_int8_psum",
]

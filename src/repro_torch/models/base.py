"""Architecture configuration and parameter initialisation.

``ArchConfig`` carries every field and default of the reference's, so a
config of either package compares with the other field for field
(``dataclasses.asdict``).  The port runs the dense, token-input family
RWKV-6 (``rwkv=True``), mixture-of-experts layers (``moe=True``), the
hybrid Mamba family (``attn_layer_period > 0``) and the encoder-decoder
family (``encoder_decoder=True``: whisper).

Parameters are drawn on the run's device from an explicit
``torch.Generator``, directly in ``param_dtype``.  Those draws never equal
the reference's (``jax.random``), so parity tests carry the reference's
weights across with ``repro_torch.convert.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.lagsim.engine import NotPortedError

__all__ = ["ArchConfig", "MambaConfig", "NotPortedError", "scaled_normal",
           "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    moe_every: int = 1
    capacity_factor: float = 1.25
    # --- attention details ---
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()
    # --- norms / mlp ---
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm | nonparametric_ln
    gated_mlp: bool = True          # SwiGLU if True else GELU MLP
    # --- hybrid (jamba) ---
    attn_layer_period: int = 0
    attn_layer_offset: int = 0
    mamba: Optional[MambaConfig] = None
    # --- rwkv ---
    rwkv: bool = False
    rwkv_head_size: int = 64
    # --- encoder-decoder (whisper) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500
    # --- io ---
    input_mode: str = "tokens"      # tokens | embeddings
    tie_embeddings: bool = False
    # --- numerics ---
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"    # stored parameter dtype (bf16 for serving)
    remat: bool = True              # no meaning without gradients
    attn_chunk: int = 1024          # the reference's jnp attention block size
    mamba_chunk: int = 128
    use_pallas: bool = False        # the port always runs its CUDA kernels
    wkv_impl: str = "scan"
    decode_tail_window: int = 0     # > 0: the tailed decode (a W-row tail)

    @property
    def head_dim(self) -> int:
        return (self.d_head if self.d_head is not None
                else self.d_model // self.n_heads)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def is_attn_layer(self, idx: int) -> bool:
        if self.attn_layer_period <= 0:
            return not self.rwkv
        return idx % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, idx: int) -> bool:
        every = max(1, self.moe_every)
        return self.moe and idx % every == every - 1

    def n_params(self) -> int:
        """Total parameter count (from the shapes)."""
        from .transformer import param_shapes   # local: avoids a cycle

        return sum(math.prod(s) for s in param_shapes(self).values())

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed-to experts count)."""
        total = self.n_params()
        if not self.moe:
            return total
        e, k = self.n_experts, self.experts_per_token
        # expert block params per MoE layer
        per_expert = 3 * self.d_model * self.expert_ff
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.is_moe_layer(i))
        return total - n_moe_layers * per_expert * (e - k)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not one of {sorted(_DTYPES)}")
    return _DTYPES[name]


_SQRT2 = math.sqrt(2.0)


def scaled_normal(shape, scale_dim: int, dtype: torch.dtype, *,
                  generator: torch.Generator) -> torch.Tensor:
    """Truncated normal in +-3 sigma with sigma = 1/sqrt(fan_in), drawn on
    ``generator``'s device in float32 by the inverse CDF (one uniform per
    value, no rejection loop) and cast to ``dtype``."""
    std = 1.0 / math.sqrt(max(1, scale_dim))
    lo = math.erf(-3.0 / _SQRT2)               # 2 * Phi(-3) - 1
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    x.uniform_(lo, -lo, generator=generator)
    x.erfinv_().mul_(_SQRT2).clamp_(-3.0, 3.0).mul_(std)
    return x.to(dtype)

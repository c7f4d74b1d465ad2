"""Assigned input shapes x applicability, the dry run's abstract inputs
and the batch's logical specs (a copy of ``repro.launch.shapes``).

LM transformer shapes are seq_len x global_batch.  ``decode_*``/``long_*``
run ``serve_step`` (one new token against a seq_len KV cache), NOT
``train_step``.  ``long_500k`` requires sub-quadratic attention: it runs for
the ssm/hybrid archs (rwkv6, jamba) and is SKIPPED for pure full-attention
archs.

``input_specs`` gives the step's batch as ``meta`` tensors (shapes and
dtypes, no storage) in the dtypes the port's steps take: token ids and
positions int64 (``launch.steps`` reads ids as ``long``) where the
reference's are int32, embeddings and frames bfloat16 as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "SKIP(full-attn): 500k decode needs sub-quadratic attention"
    return True, ""


def cells(arch_names: List[str], get_cfg) -> List[Tuple[str, str]]:
    out = []
    for a in arch_names:
        for s in SHAPES:
            out.append((a, s))
    return out


#: the dtype of token ids and positions in the port's batches (the
#: reference's are int32)
IDS = torch.int64


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing for the step function's batch argument;
    ``batch`` (default: the shape's global batch) sets the leading
    dimension, a card's share of it."""
    b, s = (shape.global_batch if batch is None else batch), shape.seq_len
    d = cfg.d_model
    out: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.encoder_decoder:
            out["inputs"] = _spec((b, cfg.encoder_seq_len, d), torch.bfloat16)
            out["decoder_tokens"] = _spec((b, s), IDS)
        elif cfg.input_mode == "embeddings":
            out["inputs"] = _spec((b, s, d), torch.bfloat16)
        else:
            out["inputs"] = _spec((b, s), IDS)
        if cfg.mrope_sections:
            out["positions"] = _spec((3, b, s), IDS)
        if shape.kind == "train":
            out["labels"] = _spec((b, s), IDS)
    else:  # decode: one new token against a seq_len cache
        if cfg.input_mode == "embeddings" and not cfg.encoder_decoder:
            out["inputs"] = _spec((b, 1, d), torch.bfloat16)
        else:
            out["inputs"] = _spec((b,), IDS)
    return out


def batch_logical_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    """Logical axis names for each batch leaf (the reference's
    in_shardings; ``models.sharding.distribute_tree`` places a batch on a
    mesh by them)."""
    specs: Dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.encoder_decoder:
            specs["inputs"] = ("batch", "seq_sp", None)
            specs["decoder_tokens"] = ("batch", "seq_sp")
        elif cfg.input_mode == "embeddings":
            specs["inputs"] = ("batch", "seq_sp", None)
        else:
            specs["inputs"] = ("batch", "seq_sp")
        if cfg.mrope_sections:
            specs["positions"] = (None, "batch", "seq_sp")
        if shape.kind == "train":
            specs["labels"] = ("batch", "seq_sp")
    else:
        if cfg.input_mode == "embeddings" and not cfg.encoder_decoder:
            specs["inputs"] = ("batch", None, None)
        else:
            specs["inputs"] = ("batch",)
    return specs


# ---------------------------------------------------------------------------
# analytic model FLOPs (roofline "useful compute" numerator)
# ---------------------------------------------------------------------------

def model_flops(cfg: ArchConfig, shape: ShapeSpec,
                batch: Optional[int] = None) -> float:
    """6*N*D for training (fwd+bwd), 2*N*D forward-only, + attention terms.

    N = active params (MoE: routed-to experts only).  D = tokens processed.
    Decode processes ``batch`` (default: the global batch) tokens per step
    against a seq_len cache.
    """
    n_active = cfg.n_active_params()
    b, s = (shape.global_batch if batch is None else batch), shape.seq_len
    hd = cfg.head_dim

    def attn_flops(tokens, kv_len, n_attn_layers, causal_factor=1.0):
        # QK^T + AV: 2 * 2 * tokens * kv_len * H * hd, causal halves it
        return (4.0 * tokens * kv_len * cfg.n_heads * hd * causal_factor
                * n_attn_layers)

    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i)) \
        if not cfg.rwkv else 0
    if cfg.encoder_decoder:
        n_attn = cfg.n_layers + cfg.n_encoder_layers  # self; cross below

    if shape.kind == "train":
        flops = 6.0 * n_active * (b * s)
        flops += 3.0 * attn_flops(b * s, s, n_attn, 0.5)
        if cfg.encoder_decoder:
            flops += 3.0 * attn_flops(b * s, cfg.encoder_seq_len, cfg.n_layers)
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * n_active * (b * s)
        flops += attn_flops(b * s, s, n_attn, 0.5)
        if cfg.encoder_decoder:
            flops += attn_flops(b * s, cfg.encoder_seq_len, cfg.n_layers)
        return flops
    # decode: one token per sequence
    flops = 2.0 * n_active * b
    flops += attn_flops(b, s, n_attn)
    if cfg.encoder_decoder:
        flops += attn_flops(b, cfg.encoder_seq_len, cfg.n_layers)
    return flops

"""Assigned input shapes x applicability (the jax-free part of
``repro.launch.shapes``).

LM transformer shapes are seq_len x global_batch.  ``decode_*``/``long_*``
lower ``serve_step`` (one new token against a seq_len KV cache), NOT
``train_step``.  ``long_500k`` requires sub-quadratic attention: it runs for
the ssm/hybrid archs (rwkv6, jamba) and is SKIPPED for pure full-attention
archs.  The reference's ``input_specs`` / ``batch_logical_specs`` (the dry
run's abstract inputs) and ``model_flops`` come with the port's dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

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

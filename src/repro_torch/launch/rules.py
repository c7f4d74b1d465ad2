"""Logical-axis -> mesh-axis rule tables.

The models annotate params/activations with logical names; these tables bind
them to the production mesh.  Named rule-set variants are the lever the perf
hillclimb sweeps (EXPERIMENTS.md records which variant each measurement
used).

Baseline (paper-faithful starting point):
* training: batch over (pod,)data; FSDP (p_embed) over data; TP over model
  for heads/ffn/vocab; sequence-parallel residual (seq_sp over model).
* serving: TP-only weights (replicated over data), batch over data, KV-cache
  sequence axis over model (flash-decoding style distributed softmax).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

AxisSpec = Union[None, str, Tuple[str, ...]]


def train_rules(multi_pod: bool = False, variant: str = "baseline"
                ) -> Dict[str, AxisSpec]:
    batch = ("pod", "data") if multi_pod else ("data",)
    base: Dict[str, AxisSpec] = {
        # activations
        "batch": batch,
        "seq_sp": "model",
        "ffn": "model",
        "heads": "model",
        "kv": "model",
        "vocab": "model",
        "exp_cap": "model",
        "cache_seq": "model",
        # params
        "p_embed": "data",          # FSDP within pod (pure DP across pods)
        "p_ffn": "model",
        "p_heads": "model",
        "p_kv": "model",            # auto-replicates when kv % 16 != 0
        "p_vocab": "model",
        "p_experts": None,          # TP-MoE baseline (EP is a variant)
    }
    if variant == "baseline":
        return base
    if variant == "no_sp":          # residual replicated over model
        return {**base, "seq_sp": None}
    if variant == "ep":             # expert parallelism over the model axis
        return {**base, "p_experts": "model", "p_ffn": None,
                "exp_cap": "model", "ffn": None}
    if variant == "moe_local":      # dispatch buffer local to the data shard
        return {**base, "exp_cap": None}
    if variant == "fsdp_model":     # FSDP over both axes (ZeRO-3 everywhere)
        return {**base, "p_embed": ("data", "model") if not multi_pod
                else ("data", "model")}
    raise ValueError(f"unknown train rules variant {variant!r}")


def serve_rules(multi_pod: bool = False, variant: str = "baseline"
                ) -> Dict[str, AxisSpec]:
    batch = ("pod", "data") if multi_pod else ("data",)
    base: Dict[str, AxisSpec] = {
        "batch": batch,
        "seq_sp": "model",
        "ffn": "model",
        "heads": "model",
        "kv": "model",
        "vocab": "model",
        "exp_cap": "model",
        "cache_seq": "model",
        "p_embed": None,            # weights TP-only for low-latency decode
        "p_ffn": "model",
        "p_heads": "model",
        "p_kv": "model",
        "p_vocab": "model",
        "p_experts": None,
    }
    if variant == "baseline":
        return base
    if variant == "cache_batch":    # cache sharded by batch only
        return {**base, "cache_seq": None, "batch": batch}
    if variant == "ep":
        return {**base, "p_experts": "model", "p_ffn": None, "ffn": None}
    if variant == "weights_2d":     # shard weights over data too (prefill)
        return {**base, "p_embed": "data"}
    raise ValueError(f"unknown serve rules variant {variant!r}")

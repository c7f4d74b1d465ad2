"""GQA attention: full-sequence (prefill, training) on the flash-attention
kernels and one-token decode over a KV cache on the decode-attention
kernel.

The reference's jnp path and its Pallas path compute the same function;
the port always takes the kernels (``kernels.flash_attention``,
``kernels.decode_attention``), which compute in float32 throughout as the
Pallas kernels do, so in bf16 the port tracks the reference's
``use_pallas=True`` path most closely.  K/V keep their KV heads: the
kernels map q head h to kv head h // (H / KV) by index.

The KV cache is kv-major, (L, B, KV, S, hd), as in the reference, so a
layer's slice is already the decode kernel's (B, KV, S, hd).  Unlike the
reference's functional update, ``decode_attention`` writes the new K/V
into the cache in place (``index_copy_`` at a device index: no host
sync) and returns the same tensors.

The tailed decode (``decode_tail_window = W > 0``) writes each new K/V
into a small tail (L, B, KV, W, hd) instead, in place, and attends
``main[0:main_len] ++ tail[0:tail_len]`` inclusive under one softmax on
the decode kernel's tailed entry; ``flush_kv_tail`` moves a full tail
into the main cache every W steps.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                  decode_attention_tailed_fwd)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)

from .base import ArchConfig, scaled_normal
from .layers import Rope, rms_norm_headwise, rope_tables, rotate


def init_attention(cfg: ArchConfig, *,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": scaled_normal((d, h, hd), d, cfg.pdtype, generator=generator),
         "wk": scaled_normal((d, kv, hd), d, cfg.pdtype, generator=generator),
         "wv": scaled_normal((d, kv, hd), d, cfg.pdtype, generator=generator),
         "wo": scaled_normal((h, hd, d), h * hd, cfg.pdtype,
                             generator=generator)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=cfg.pdtype, device=generator.device)
        p["k_norm"] = torch.ones(hd, dtype=cfg.pdtype, device=generator.device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x (B, S, d) @ w (d, heads, hd) -> (B, S, heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.to(dt).reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def _qkv(p: Dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
         rope: Optional[Rope] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd), k/v (B, S, KV, hd) in the activation dtype, with
    qk-norm and RoPE applied.  ``rope`` (``layers.rope_tables`` of
    ``positions``) saves recomputing the tables in every layer."""
    dt = cfg.adtype
    q, k, v = (_proj(x, p[w], dt) for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])
    rope = rope_tables(positions, cfg) if rope is None else rope
    return rotate(q, rope), rotate(k, rope), v


def _out(p: Dict, cfg: ArchConfig, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = p["wo"].shape
    return o.flatten(-2) @ p["wo"].to(cfg.adtype).reshape(h * hd, d)


def attention_block(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True, *,
                    rope: Optional[Rope] = None) -> torch.Tensor:
    """Full-sequence attention (prefill and training) through the flash
    kernels.  x (B, S, d); positions (B, S).  Returns (B, S, d).

    ``flash_attention`` is the differentiable ``FlashAttention``: with
    gradients on, the backward kernel computes dq, dk and dv; under
    ``torch.no_grad()`` it is one forward launch, as before.  The forward
    and backward are read from this module at each call, so a caller can
    swap their plain versions in."""
    q, k, v = _qkv(p, cfg, x, positions, rope)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          fwd=flash_attention_fwd, bwd=flash_attention_bwd)
    return _out(p, cfg, out.transpose(1, 2))


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, n_layers: int,
                  *, device=None) -> Dict[str, torch.Tensor]:
    """KV cache, kv-head-major (L, B, KV, S, hd), in the activation dtype,
    over ``n_layers`` attention layers (a hybrid model's are fewer than
    its layers)."""
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def decode_attention(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, positions: torch.Tensor, *,
                     rope: Optional[Rope] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x (B, 1, d); k/v_cache (B, KV, S, hd); cache_len
    an int32 tensor of one element on the device (the fill before this
    token); positions (B, 1).

    Writes the new token's K/V at ``cache_len`` in place (clamped to
    ``S - 1``, as the reference's ``dynamic_update_slice`` clamps) and
    attends to the first ``cache_len + 1`` entries.  Returns (y,
    k_cache, v_cache) with the caches the same tensors as given.
    """
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, positions, rope)
    at = cache_len.reshape(1).clamp(max=k_cache.shape[2] - 1).long()
    k_cache.index_copy_(2, at, k_new.transpose(1, 2).to(k_cache.dtype))
    v_cache.index_copy_(2, at, v_new.transpose(1, 2).to(v_cache.dtype))
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    o = decode_attention_fwd(q.reshape(b, kv, cfg.n_heads // kv, hd),
                             k_cache, v_cache, cache_len)
    return _out(p, cfg, o.reshape(b, 1, cfg.n_heads, hd)), k_cache, v_cache


# ---------------------------------------------------------------------------
# tailed decode (block-buffered writes)
# ---------------------------------------------------------------------------


def init_kv_tail(cfg: ArchConfig, batch: int, window: int, n_layers: int,
                 *, device=None) -> Dict[str, torch.Tensor]:
    """The tailed decode's write buffer, (L, B, KV, W, hd) in the
    activation dtype: kv-major like the cache, so a layer's slice is the
    kernel's tail and the flush a copy along the sequence axis."""
    shape = (n_layers, batch, cfg.n_kv_heads, window, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def decode_attention_tailed(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                            k_main: torch.Tensor, v_main: torch.Tensor,
                            k_tail: torch.Tensor, v_tail: torch.Tensor,
                            cache_len: torch.Tensor, positions: torch.Tensor,
                            *, rope: Optional[Rope] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One-token decode with a tail.  x (B, 1, d); k/v_main (B, KV, S, hd),
    read only; k/v_tail (B, KV, W, hd); cache_len an int32 tensor of one
    element on the device; positions (B, 1) or (3, B, 1).

    With ``main_len = (cache_len // W) * W`` and ``tail_len = cache_len -
    main_len`` (both on the device: the step never syncs the host), writes
    the new token's K/V at ``tail[tail_len]`` in place and attends
    ``main[0:main_len]`` and ``tail[0:tail_len]`` inclusive under one
    softmax.  Returns (y, k_tail, v_tail), the tails the same tensors."""
    b, w = x.shape[0], cfg.decode_tail_window
    q, k_new, v_new = _qkv(p, cfg, x, positions, rope)
    at = cache_len.reshape(1).remainder(w).long()
    k_tail.index_copy_(2, at, k_new.transpose(1, 2).to(k_tail.dtype))
    v_tail.index_copy_(2, at, v_new.transpose(1, 2).to(v_tail.dtype))
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    o = decode_attention_tailed_fwd(q.reshape(b, kv, cfg.n_heads // kv, hd),
                                    k_main, v_main, k_tail, v_tail,
                                    cache_len, w)
    return _out(p, cfg, o.reshape(b, 1, cfg.n_heads, hd)), k_tail, v_tail


def flush_kv_tail(cfg: ArchConfig, state: Dict) -> Dict:
    """Move a full tail (W rows) into the main cache at ``cache_len - W``,
    then zero the tail; in place, on the device (no host sync: a CUDA
    graph can hold it).  The start is placed as the reference's
    ``dynamic_update_slice`` places it: a negative start counts from the
    cache's end, then it is clamped into the cache.  Call when
    ``cache_len % W == 0`` and ``cache_len > 0``.  Returns the state, its
    tensors the same."""
    w = cfg.decode_tail_window
    kv, tail = state["kv"], state["tail"]
    s = kv["k"].shape[3]
    if not 0 < w <= s:
        raise ValueError(f"flush_kv_tail: window {w} must be in 1..{s}, the "
                         f"cache's length")
    dst = state["cache_len"].reshape(1).long() - w
    dst = torch.where(dst < 0, dst + s, dst).clamp(0, s - w)
    idx = dst + torch.arange(w, device=dst.device)
    for name in ("k", "v"):
        kv[name].index_copy_(3, idx, tail[name])
        tail[name].zero_()
    return state

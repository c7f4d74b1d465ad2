"""Whisper-large-v3 backbone: the encoder-decoder family, the counterpart
of the reference's ``models/whisper.py`` function for function.

The conv/mel front end is a stub, as in the reference: ``inputs`` are
precomputed frame embeddings (B, T_enc, d) that enter through one linear
adapter.  The encoder is bidirectional attention over those frames plus
fixed sinusoids; the decoder is causal self-attention, cross-attention
to the encoder output and a learned position table of 448 entries;
LayerNorm and a GELU MLP, pre-norm.  What the reference does that
OpenAI's whisper does not, kept here:

- RoPE (``rope_theta``) in the encoder's and the decoder's
  self-attention (the reference's ``attention_block`` applies it);
  cross-attention has none;
- decoder positions above 447 clip to 447 in the position table (RoPE
  takes them unclipped);
- ``make_prefill_step`` leaves the decode caches empty: serving encodes,
  calls :func:`precompute_cross_kv`, then feeds the prompt token by
  token through ``serve_step``.

Every attention runs a hand-written kernel: the encoder's self-attention
and every full-sequence cross-attention the flash kernel without the
causal mask (q (B, H, S, hd) over k/v (B, KV, T_enc, hd)), the decoder's
self-attention the flash kernel (prefill, training) or the decode kernel
(``serve_step``), and the serve step's cross-attention the decode kernel
over the precomputed K/V at the fill ``T_enc - 1``, which the decode
state holds on the device (``cross_len``), so a step never reads the
host.  The kernels are read from ``models.attention`` at each call, so a
caller can swap their plain versions in there.

Layers are lists of per-layer dicts: ``enc_layers[i] = {ln1, attn, ln2,
mlp}``, ``layers[i] = {ln1, self_attn, ln2, cross_attn, ln3, mlp}``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .base import ArchConfig, scaled_normal
from .layers import (apply_mlp, apply_norm, cross_entropy, init_mlp,
                     init_norm, logits_fn, mlp_specs, norm_specs,
                     rope_tables, sinusoidal_positions, vocab_embedding)
from .sharding import distribute_like, is_dtensor, mm, shard

WHISPER_MAX_TARGET_POSITIONS = 448


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_whisper(cfg: ArchConfig, gen: torch.Generator,
                 dev: torch.device) -> Dict[str, Any]:
    """Random parameters in the reference's tree layout, drawn on ``dev``
    from ``gen`` in ``cfg.param_dtype``."""
    d, pd = cfg.d_model, cfg.pdtype

    def norm():
        return init_norm(cfg, device=dev)

    def att():
        return attn.init_attention(cfg, generator=gen)

    params: Dict[str, Any] = {
        "embedding": {"adapter": scaled_normal((d, d), d, pd,
                                               generator=gen)}}
    params["enc_layers"] = [
        {"ln1": norm(), "attn": att(), "ln2": norm(),
         "mlp": init_mlp(cfg, generator=gen)}
        for _ in range(cfg.n_encoder_layers)]
    params["enc_norm"] = norm()
    params["dec_embed"] = scaled_normal((cfg.vocab_size, d), d, pd,
                                        generator=gen)
    params["dec_pos"] = scaled_normal((WHISPER_MAX_TARGET_POSITIONS, d), d,
                                      pd, generator=gen)
    params["layers"] = [
        {"ln1": norm(), "self_attn": att(), "ln2": norm(),
         "cross_attn": att(), "ln3": norm(),
         "mlp": init_mlp(cfg, generator=gen)}
        for _ in range(cfg.n_layers)]
    params["final_norm"] = norm()
    params["lm_head"] = {"w": scaled_normal((d, cfg.vocab_size), d, pd,
                                            generator=gen)}
    return params


def whisper_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Logical axis names of every parameter, in ``init_whisper``'s tree
    (the layer lists a spec a layer)."""
    enc = {"ln1": norm_specs(cfg), "attn": attn.attention_specs(cfg),
           "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    dec = {"ln1": norm_specs(cfg), "self_attn": attn.attention_specs(cfg),
           "ln2": norm_specs(cfg), "cross_attn": attn.attention_specs(cfg),
           "ln3": norm_specs(cfg), "mlp": mlp_specs(cfg)}
    return {"embedding": {"adapter": (None, "p_embed")},
            "enc_layers": [enc for _ in range(cfg.n_encoder_layers)],
            "enc_norm": norm_specs(cfg),
            "dec_embed": ("p_vocab", "p_embed"),
            "dec_pos": (None, "p_embed"),
            "layers": [dec for _ in range(cfg.n_layers)],
            "final_norm": norm_specs(cfg),
            "lm_head": {"w": ("p_embed", "p_vocab")}}


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _enc_block(lp: Dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, rope) -> torch.Tensor:
    h = apply_norm(lp["ln1"], cfg, x)
    x = x + attn.attention_block(lp["attn"], cfg, h, positions,
                                 causal=False, rope=rope)
    h = apply_norm(lp["ln2"], cfg, x)
    return shard(x + apply_mlp(lp["mlp"], cfg, h), "batch", "seq_sp", None)


def encode(params: Dict, cfg: ArchConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, T_enc, d), precomputed embeddings (the front-end stub)
    -> the encoder output (B, T_enc, d) in the activation dtype.  With
    gradients on and ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint``."""
    dt = cfg.adtype
    x = mm(frames.to(dt), params["embedding"]["adapter"].to(dt))
    b, t, d = x.shape
    x = x + sinusoidal_positions(t, d, x.device).to(dt)[None]
    x = shard(x, "batch", "seq_sp", None)
    positions = distribute_like(
        x, torch.arange(t, device=x.device).expand(b, t), "batch", None)
    rope = rope_tables(positions, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["enc_layers"]:
        x = (checkpoint(_enc_block, lp, cfg, x, positions, rope,
                        use_reentrant=False)
             if remat else _enc_block(lp, cfg, x, positions, rope))
    return apply_norm(params["enc_norm"], cfg, x)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_embed(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the learned positions, clipped to 0..447."""
    dt = cfg.adtype
    if is_dtensor(params["dec_embed"]):     # vocab-parallel embeddings
        # each table's rows reduced to the residual's layout before the sum
        pos = positions.long().clamp(0, WHISPER_MAX_TARGET_POSITIONS - 1)
        rows = [shard(vocab_embedding(i, t).to(dt), "batch", "seq_sp", None)
                for i, t in ((tokens, params["dec_embed"]),
                             (pos, params["dec_pos"]))]
        return rows[0] + rows[1]
    x = params["dec_embed"][tokens.long()].to(dt)
    pos = positions.long().clamp(0, WHISPER_MAX_TARGET_POSITIONS - 1)
    return shard(x + params["dec_pos"][pos].to(dt), "batch", "seq_sp", None)


def cross_attention(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                    enc: torch.Tensor) -> torch.Tensor:
    """Full (non-causal) cross-attention of x (B, S, d) over the encoder
    output (B, T_enc, d), no RoPE, on the flash kernels (``causal=False``,
    Sq = S over Skv = T_enc).  Returns (B, S, d)."""
    dt = cfg.adtype
    q = attn._proj(x, p["wq"], dt)
    k = attn._proj(enc, p["wk"], dt)
    v = attn._proj(enc, p["wv"], dt)
    return attn._out(p, cfg, attn.flash(q, k, v, causal=False))


def _dec_block(lp: Dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, rope, enc: torch.Tensor
               ) -> torch.Tensor:
    h = apply_norm(lp["ln1"], cfg, x)
    x = x + attn.attention_block(lp["self_attn"], cfg, h, positions,
                                 rope=rope)
    h = apply_norm(lp["ln2"], cfg, x)
    x = x + cross_attention(lp["cross_attn"], cfg, h, enc)
    h = apply_norm(lp["ln3"], cfg, x)
    return shard(x + apply_mlp(lp["mlp"], cfg, h), "batch", "seq_sp", None)


def decoder(params: Dict, cfg: ArchConfig, enc: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) over the encoder output ->
    the final norm's output (B, S, d).  With gradients on and
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``."""
    b, s = tokens.shape
    positions = distribute_like(
        tokens, torch.arange(s, device=tokens.device).expand(b, s),
        "batch", None)
    x = _dec_embed(params, cfg, tokens, positions)
    rope = rope_tables(positions, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        x = (checkpoint(_dec_block, lp, cfg, x, positions, rope, enc,
                        use_reentrant=False)
             if remat else _dec_block(lp, cfg, x, positions, rope, enc))
    return apply_norm(params["final_norm"], cfg, x)


def whisper_forward(params: Dict, cfg: ArchConfig, batch: Dict
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced training loss.  ``batch``: ``inputs`` (B, T_enc, d)
    frame embeddings, ``decoder_tokens`` (B, S), ``labels`` (B, S),
    optional ``mask`` (B, S).  Returns ``(loss, {"ce": loss, "aux":
    0})``."""
    enc = encode(params, cfg, batch["inputs"])
    h = decoder(params, cfg, enc, batch["decoder_tokens"])
    logits = logits_fn(params, cfg, h)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=loss.device)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_whisper_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                              dev: torch.device) -> Dict[str, Any]:
    """``{"cache_len", "kv": {"k", "v"}, "cross_k", "cross_v",
    "cross_len"}`` on ``dev``: the self-attention cache (L, B, KV,
    max_len, hd) as ``attention.init_kv_cache`` makes it; the cross K/V
    kv-major (L, B, KV, T_enc, hd), so that a layer's slice is the decode
    kernel's cache (the reference stores them (L, B, T_enc, KV, hd));
    ``cross_len`` the int32 fill ``T_enc - 1`` the cross-attention's
    decode kernel reads."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (cfg.n_layers, batch, kv, cfg.encoder_seq_len, hd)
    return {
        "cache_len": torch.zeros((), dtype=torch.int32, device=dev),
        "kv": attn.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                 device=dev),
        "cross_k": torch.zeros(shape, dtype=cfg.adtype, device=dev),
        "cross_v": torch.zeros(shape, dtype=cfg.adtype, device=dev),
        "cross_len": torch.full((), cfg.encoder_seq_len - 1,
                                dtype=torch.int32, device=dev),
    }


def whisper_decode_state_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Logical axis names of the decode state: the reference's, the cross
    K/V's read onto the port's kv-major (L, B, KV, T_enc, hd) layout, and
    the replicated ``cross_len``."""
    return {"cache_len": (),
            "kv": attn.kv_cache_specs(),
            "cross_k": (None, "batch", "p_kv", "cache_seq", None),
            "cross_v": (None, "batch", "p_kv", "cache_seq", None),
            "cross_len": ()}


def precompute_cross_kv(params: Dict, cfg: ArchConfig, enc: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder output (B, T_enc, d) -> every layer's cross K and V, each
    (L, B, KV, T_enc, hd) in the activation dtype, computed once a
    request."""
    dt = cfg.adtype
    b, t, _ = enc.shape
    shape = (cfg.n_layers, b, cfg.n_kv_heads, t, cfg.head_dim)
    ck = torch.empty(shape, dtype=dt, device=enc.device)
    cv = torch.empty(shape, dtype=dt, device=enc.device)
    for i, lp in enumerate(params["layers"]):
        ck[i] = attn._proj(enc, lp["cross_attn"]["wk"], dt).transpose(1, 2)
        cv[i] = attn._proj(enc, lp["cross_attn"]["wv"], dt).transpose(1, 2)
    return ck, cv


def whisper_serve_step(params: Dict, cfg: ArchConfig, state: Dict,
                       batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step: token ids (B,) or (B, 1) -> logits (B, V).  Each
    layer's self-attention appends the token's K/V to the cache in place
    (``attention.decode_attention``, RoPE at ``cache_len``) and its
    cross-attention reads the precomputed K/V through the decode kernel.
    Returns ``(logits, new_state)`` with ``cache_len`` one more."""
    tokens = batch["inputs"]
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    b = tokens.shape[0]
    clen = state["cache_len"]
    positions = clen.reshape(1, 1).expand(b, 1)
    x = _dec_embed(params, cfg, tokens, positions)
    rope = rope_tables(positions, cfg)
    dt = cfg.adtype
    h_, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kc, vc = state["kv"]["k"], state["kv"]["v"]
    ck, cv, cross_len = state["cross_k"], state["cross_v"], state["cross_len"]
    for i, lp in enumerate(params["layers"]):
        h = apply_norm(lp["ln1"], cfg, x)
        y, _, _ = attn.decode_attention(lp["self_attn"], cfg, h, kc[i], vc[i],
                                        clen, positions, rope=rope)
        x = x + y
        h = apply_norm(lp["ln2"], cfg, x)
        p = lp["cross_attn"]
        if is_dtensor(h):
            o = attn._sharded_decode(attn._proj(h, p["wq"], dt), None, None,
                                     (ck[i], cv[i]), (), cross_len, 0)
            x = x + attn._out(p, cfg, o)
        else:
            q = attn._proj(h, p["wq"], dt).reshape(b, kv, h_ // kv, hd)
            o = attn.decode_attention_fwd(q, ck[i], cv[i], cross_len)
            x = x + attn._out(p, cfg, o.reshape(b, 1, h_, hd))
        h = apply_norm(lp["ln3"], cfg, x)
        x = x + apply_mlp(lp["mlp"], cfg, h)
    h = apply_norm(params["final_norm"], cfg, x)
    logits = logits_fn(params, cfg, h)[:, 0, :]
    return logits, dict(state, cache_len=clen + 1)


__all__ = ["WHISPER_MAX_TARGET_POSITIONS", "cross_attention", "decoder",
           "encode", "init_whisper", "init_whisper_decode_state",
           "precompute_cross_kv", "whisper_decode_state_specs",
           "whisper_forward", "whisper_serve_step", "whisper_specs"]

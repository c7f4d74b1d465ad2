"""Decoder-only model assembly, dense and RWKV-6: init, the prefill
backbone and the one-token serve step.

The reference scans one stacked set of layer weights; the port keeps the
layers as a list of per-layer dicts and loops over them (PyTorch runs
eagerly; a list saves indexing every stacked leaf every step).  The dense
layers are [attention + MLP] on the attention kernels, the RWKV layers
[time-mix + channel-mix] on the WKV kernel.  The MoE, hybrid (Mamba) and
encoder-decoder branches raise :class:`NotPortedError`, as do the tailed
decode and RWKV's ``wkv_impl="kernel_stub"``.

``forward`` is the training loss of a dense or an RWKV model; with
``cfg.remat`` its backbone checkpoints each layer
(``torch.utils.checkpoint``), as the reference's
``jax.checkpoint(nothing_saveable)`` does over its scan body.  An RWKV
layer's recurrence takes its gradient from the WKV backward kernel
(``kernels.rwkv6_scan.WKV``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device

from .attention import (attention_block, decode_attention, init_attention,
                        init_kv_cache)
from .base import ArchConfig, NotPortedError
from .layers import (apply_mlp, apply_norm, cross_entropy, embed_inputs,
                     init_embedding, init_lm_head, init_mlp, init_norm,
                     logits_fn, rope_tables)
from .rwkv6 import (LORA_RANK, _dims, init_rwkv_channel_mix,
                    init_rwkv_state, init_rwkv_time_mix, rwkv_channel_mix,
                    rwkv_time_mix)

#: the weight of the MoE auxiliary loss in the training loss (0 for the
#: dense models the port trains)
AUX_LOSS_COEF = 0.01


def check_ported(cfg: ArchConfig) -> None:
    """Raise :class:`NotPortedError` naming the first option of ``cfg``
    that this slice does not carry."""
    for flag, what in ((cfg.encoder_decoder, "the encoder-decoder family "
                        "(whisper)"),
                       (cfg.rwkv and cfg.wkv_impl != "scan",
                        f"wkv_impl={cfg.wkv_impl!r} (the reference's roofline "
                        f"stand-in for the WKV kernel)"),
                       (cfg.attn_layer_period > 0, "the hybrid Mamba family"),
                       (cfg.moe, "mixture-of-experts layers"),
                       (cfg.input_mode != "tokens", f"input_mode="
                        f"{cfg.input_mode!r}"),
                       (bool(cfg.mrope_sections), "M-RoPE"),
                       (cfg.decode_tail_window > 0, "the tailed decode "
                        "(decode_tail_window > 0)")):
        if flag:
            raise NotPortedError(f"{cfg.name}: {what} is not yet ported to "
                                 f"repro_torch")


def check_trainable(cfg: ArchConfig) -> None:
    """Raise :class:`NotPortedError` for what the port cannot train: what
    it does not carry at all (:func:`check_ported`).  Everything it
    serves, dense and RWKV-6, it trains."""
    check_ported(cfg)


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape by dotted name (layer ``i`` as
    ``layers.i.``), the counterpart of the reference's ``eval_shape``."""
    check_ported(cfg)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    norm = {"rmsnorm": {"scale": (d,)},
            "layernorm": {"scale": (d,), "bias": (d,)},
            "nonparametric_ln": {}}[cfg.norm_type]
    if cfg.rwkv:
        rh, rhd = _dims(cfg)
        layer = {f"tm.w_{n}": (d, d) for n in "rkvgo"}
        layer.update({"tm.decay_w0": (d,), "tm.decay_w1": (d, LORA_RANK),
                      "tm.decay_w2": (LORA_RANK, d), "tm.bonus_u": (rh, rhd),
                      "tm.mix": (5, d), "tm.ln_x": (d,),
                      "cm.w_k": (d, f), "cm.w_v": (f, d), "cm.w_r": (d, d),
                      "cm.mix": (2, d)})
    else:
        layer = {"attn.wq": (d, h, hd), "attn.wk": (d, kv, hd),
                 "attn.wv": (d, kv, hd), "attn.wo": (h, hd, d),
                 "ffn.wi": (d, f), "ffn.wo": (f, d)}
        if cfg.qk_norm:
            layer.update({"attn.q_norm": (hd,), "attn.k_norm": (hd,)})
        if cfg.gated_mlp:
            layer["ffn.wg"] = (d, f)
    for ln in ("ln1", "ln2"):
        layer.update({f"{ln}.{k}": s for k, s in norm.items()})
    out = {"embedding.table": (v, d)}
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    out.update({f"final_norm.{k}": s for k, s in norm.items()})
    if not cfg.tie_embeddings:
        out["lm_head.w"] = (d, v)
    return out


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` (``None`` = the CUDA card) from
    a ``torch.Generator`` seeded with ``seed``, directly in
    ``cfg.param_dtype``.  ``params["layers"]`` is a list of per-layer
    dicts ``{"ln1", "attn", "ln2", "ffn"}`` (dense) or ``{"ln1", "tm",
    "ln2", "cm"}`` (RWKV)."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {"embedding": init_embedding(cfg, generator=gen)}
    mix, ffn = ((("tm", init_rwkv_time_mix), ("cm", init_rwkv_channel_mix))
                if cfg.rwkv else (("attn", init_attention), ("ffn", init_mlp)))
    params["layers"] = [
        {"ln1": init_norm(cfg, device=dev),
         mix[0]: mix[1](cfg, generator=gen),
         "ln2": init_norm(cfg, device=dev),
         ffn[0]: ffn[1](cfg, generator=gen)}
        for _ in range(cfg.n_layers)]
    params["final_norm"] = init_norm(cfg, device=dev)
    params["lm_head"] = init_lm_head(cfg, generator=gen)
    return params


def param_bytes(params) -> int:
    """Bytes held by a parameter tree."""
    if torch.is_tensor(params):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return sum(param_bytes(v) for v in params)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _dense_block(lp: Dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, rope) -> torch.Tensor:
    h = apply_norm(lp["ln1"], cfg, x)
    x = x + attention_block(lp["attn"], cfg, h, positions, rope=rope)
    h = apply_norm(lp["ln2"], cfg, x)
    return x + apply_mlp(lp["ffn"], cfg, h)


def _rwkv_block(lp: Dict, cfg: ArchConfig, x: torch.Tensor,
                st: Optional[Dict] = None) -> torch.Tensor:
    """One RWKV layer.  ``st``, the layer's decode state ``{"tm_shift",
    "wkv", "cm_shift"}``, is written in place; ``None`` (prefill) starts
    from zeros and drops the state, as the reference does."""
    tm = None if st is None else {"shift": st["tm_shift"], "wkv": st["wkv"]}
    cm = None if st is None else {"shift": st["cm_shift"]}
    h = apply_norm(lp["ln1"], cfg, x)
    x = x + rwkv_time_mix(lp["tm"], cfg, h, tm)[0]
    h = apply_norm(lp["ln2"], cfg, x)
    return x + rwkv_channel_mix(lp["cm"], cfg, h, cm)[0]


def backbone(params: Dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S, d) -> final norm output (B, S, d).  The
    reference also returns the MoE auxiliary loss, which neither a dense
    model nor an RWKV one has.  RWKV reads no positions.

    Differentiable: with gradients on and ``cfg.remat``, each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant), so the backward
    keeps only each layer's input and recomputes the layer, its attention
    or WKV forward included."""
    check_ported(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    if cfg.rwkv:
        block, args = _rwkv_block, ()
    else:
        block, args = _dense_block, (positions, rope_tables(positions, cfg))
    for lp in params["layers"]:
        if remat:
            x = checkpoint(block, lp, cfg, x, *args, use_reentrant=False)
        else:
            x = block(lp, cfg, x, *args)
    return apply_norm(params["final_norm"], cfg, x)


def forward(params: Dict, cfg: ArchConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss of a dense or an RWKV model: ``batch["inputs"]``
    token ids (B, S), ``batch["labels"]`` (B, S), optional
    ``batch["positions"]`` (B, S; RWKV reads none) and ``batch["mask"]``
    (B, S), all tensors on the parameters' device.  Returns ``(loss,
    {"ce", "aux"})``: the token-mean cross-entropy plus ``AUX_LOSS_COEF``
    times the MoE auxiliary loss, which is 0 for both."""
    check_trainable(cfg)
    inputs = batch["inputs"]
    b, s = inputs.shape[0], inputs.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=inputs.device).expand(b, s)
    x = embed_inputs(params["embedding"], cfg, inputs)
    h = backbone(params, cfg, x, positions)
    logits = logits_fn(params, cfg, h)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> Dict[str, Any]:
    """``{"cache_len": int32 scalar, "kv": {"k", "v"}}`` sized for
    ``max_len`` tokens (dense), or ``{"cache_len", "rwkv": [per layer
    {"tm_shift", "wkv", "cm_shift"}]}`` (RWKV: a constant-size state;
    ``max_len`` is unused), on ``device`` (``None`` = the CUDA card)."""
    check_ported(cfg)
    dev = resolve_device(device)
    state: Dict[str, Any] = {
        "cache_len": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.rwkv:
        state["rwkv"] = [init_rwkv_state(cfg, batch, dev)
                         for _ in range(cfg.n_layers)]
    else:
        state["kv"] = init_kv_cache(cfg, batch, max_len, device=dev)
    return state


def serve_step(params: Dict, cfg: ArchConfig, state: Dict, batch: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: new token ids (B,) or (B, 1) -> logits (B, V).

    The KV cache holds ``state["cache_len"]`` tokens; the step appends one,
    writing the cache in place, and returns ``(logits, new_state)`` with
    ``new_state["cache_len"]`` one more.  An RWKV model instead writes
    each layer's shift and WKV state in place.  ``cache_len`` stays on the
    device: the step never syncs the host.
    """
    check_ported(cfg)
    inputs = batch["inputs"]
    if inputs.dim() == 1:
        inputs = inputs[:, None]
    x = embed_inputs(params["embedding"], cfg, inputs)      # (B, 1, d)
    clen = state["cache_len"]
    if cfg.rwkv:
        for lp, st in zip(params["layers"], state["rwkv"]):
            x = _rwkv_block(lp, cfg, x, st)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = clen.reshape(1, 1).expand(x.shape[0], 1)
        rope = rope_tables(positions, cfg)
        kc, vc = state["kv"]["k"], state["kv"]["v"]
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(lp["ln1"], cfg, x)
            y, _, _ = decode_attention(lp["attn"], cfg, h, kc[i], vc[i],
                                       clen, positions, rope=rope)
            x = x + y
            h = apply_norm(lp["ln2"], cfg, x)
            x = x + apply_mlp(lp["ffn"], cfg, h)
    h = apply_norm(params["final_norm"], cfg, x)
    logits = logits_fn(params, cfg, h)[:, 0, :]
    return logits, dict(state, cache_len=clen + 1)


__all__ = ["AUX_LOSS_COEF", "backbone", "check_ported", "check_trainable",
           "forward", "init_decode_state", "init_params", "param_bytes",
           "param_shapes", "serve_step"]

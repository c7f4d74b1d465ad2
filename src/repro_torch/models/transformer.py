"""Model assembly: init, the prefill backbone, the one-token serve step
and the training loss of the dense, MoE, hybrid Mamba and RWKV-6
families, and the dispatch to the encoder-decoder family
(``models.whisper``) where ``cfg.encoder_decoder``, as the reference
dispatches.

The reference scans one stacked set of layer weights (jamba: one stacked
set of 8-layer periods); the port keeps the layers as a flat list of
per-layer dicts and loops over them (PyTorch runs eagerly; a list saves
indexing every stacked leaf every step).  Layer ``i`` of a hybrid model is
the reference's ``sub{i % period}`` of period ``i // period``.
- dense and MoE: ``{ln1, attn, ln2, ffn}``, attention on the attention
  kernels, ``ffn`` an MLP or (``moe``) a mixture of experts;
- hybrid (jamba): ``{ln1, mix, ln2, ffn}``, ``mix`` attention on one
  layer of each period (``is_attn_layer``), a Mamba block on the others,
  ``ffn`` a mixture of experts on every ``moe_every``-th layer;
- RWKV-6: ``{ln1, tm, ln2, cm}``, the recurrence on the WKV kernels.
A decoder-only model with ``input_mode="embeddings"`` (the VLM) reads
(B, S, d) embeddings through a (d, d) adapter, and takes (3, B, S)
M-RoPE positions where ``mrope_sections`` is set.  With
``decode_tail_window > 0`` a dense or MoE model decodes through a tail
(``attention.decode_attention_tailed``; hybrid and RWKV models ignore
the window, as the reference's do).  RWKV's ``wkv_impl="kernel_stub"``
runs the reference's one-pass traffic stand-in for the WKV kernel (the
dry run's ``wkv_kernel`` variant): nothing the reference builds is
refused.

``forward`` is the training loss (the token-mean cross-entropy plus
``AUX_LOSS_COEF`` times the summed MoE auxiliary loss); with
``cfg.remat`` its backbone checkpoints each layer
(``torch.utils.checkpoint``), as the reference's
``jax.checkpoint(nothing_saveable)`` does over its scan body.  The
reference checkpoints a hybrid model a period at a time; a layer at a
time recomputes the same arithmetic and keeps less.  An RWKV layer's
recurrence takes its gradient from the WKV backward kernel
(``kernels.rwkv6_scan.WKV``); an MoE layer's from autograd of the
dispatch (the router through the renormalised gate and the auxiliary
loss's mean probability), a Mamba layer's from autograd of the chunked
scan.  Every family the port carries trains (``check_trainable``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device

from .attention import (attention_block, decode_attention,
                        decode_attention_tailed, init_attention,
                        init_kv_cache, init_kv_tail)
from .base import ArchConfig
from .layers import (apply_mlp, apply_norm, cross_entropy, embed_inputs,
                     init_embedding, init_lm_head, init_mlp, init_norm,
                     logits_fn, rope_tables, tied_head)
from .mamba import (init_mamba, init_mamba_state, mamba_block,
                    mamba_decode_step, mamba_shapes)
from .moe import apply_moe, init_moe
from .rwkv6 import (LORA_RANK, _dims, init_rwkv_channel_mix,
                    init_rwkv_state, init_rwkv_time_mix, rwkv_channel_mix,
                    rwkv_time_mix)
from .whisper import (WHISPER_MAX_TARGET_POSITIONS, init_whisper,
                      init_whisper_decode_state, whisper_forward,
                      whisper_serve_step)

#: the weight of the MoE auxiliary loss in the training loss
AUX_LOSS_COEF = 0.01


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` / ``NotImplementedError`` for layouts the
    reference cannot build either.  The port carries every option of the
    reference's model code, RWKV's ``wkv_impl="kernel_stub"`` included,
    so it refuses nothing the reference builds."""
    if _hybrid(cfg) and cfg.n_layers % cfg.attn_layer_period:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"whole number of periods of "
                         f"{cfg.attn_layer_period}")
    if cfg.moe and cfg.moe_every != 1 and not _hybrid(cfg) and not cfg.rwkv:
        raise NotImplementedError("interleaved MoE only via attn_layer_period")


def check_trainable(cfg: ArchConfig) -> None:
    """Raise what :func:`check_ported` raises: the port trains every
    family it carries (dense, MoE, hybrid Mamba, RWKV-6 with the WKV
    kernels or ``kernel_stub``, whisper, the VLM), so it refuses nothing
    the reference builds."""
    check_ported(cfg)


def _hybrid(cfg: ArchConfig) -> bool:
    return cfg.attn_layer_period > 0 and not cfg.rwkv


def _kinds(cfg: ArchConfig, i: int) -> Tuple[str, str]:
    """Layer ``i``'s mixer (``attn`` or ``mamba``) and feed-forward
    (``mlp`` or ``moe``) in a non-RWKV model; a hybrid model picks both by
    the layer's index in its period, as the reference does."""
    j = i % cfg.attn_layer_period if _hybrid(cfg) else i
    return ("attn" if cfg.is_attn_layer(j) else "mamba",
            "moe" if cfg.is_moe_layer(j) else "mlp")


def _mix_key(cfg: ArchConfig) -> str:
    """The mixer's key in a layer dict: the reference names it ``mix`` in
    a hybrid period, ``attn`` in a homogeneous stack."""
    return "mix" if _hybrid(cfg) else "attn"


def attention_layers(cfg: ArchConfig) -> List[int]:
    """The indices of the attention layers (each holds one slice of the
    KV cache and launches the attention kernels): every layer of a dense
    or MoE model, one a period of a hybrid one, none of RWKV, every
    decoder layer of whisper."""
    if cfg.encoder_decoder:
        return list(range(cfg.n_layers))
    if cfg.rwkv:
        return []
    return [i for i in range(cfg.n_layers) if _kinds(cfg, i)[0] == "attn"]


def _mlp_shapes(cfg: ArchConfig, f: int, prefix: str):
    d = cfg.d_model
    out = {f"{prefix}wi": (d, f), f"{prefix}wo": (f, d)}
    if cfg.gated_mlp:
        out[f"{prefix}wg"] = (d, f)
    return out


def _attn_shapes(cfg: ArchConfig, prefix: str):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {f"{prefix}wq": (d, h, hd), f"{prefix}wk": (d, kv, hd),
           f"{prefix}wv": (d, kv, hd), f"{prefix}wo": (h, hd, d)}
    if cfg.qk_norm:
        out.update({f"{prefix}q_norm": (hd,), f"{prefix}k_norm": (hd,)})
    return out


def _norm_shapes(cfg: ArchConfig, prefix: str):
    d = cfg.d_model
    names = {"rmsnorm": ("scale",), "layernorm": ("scale", "bias"),
             "nonparametric_ln": ()}[cfg.norm_type]
    return {f"{prefix}{k}": (d,) for k in names}


def _layer_shapes(cfg: ArchConfig, i: int) -> Dict[str, Tuple[int, ...]]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.rwkv:
        rh, rhd = _dims(cfg)
        layer = {f"tm.w_{n}": (d, d) for n in "rkvgo"}
        layer.update({"tm.decay_w0": (d,), "tm.decay_w1": (d, LORA_RANK),
                      "tm.decay_w2": (LORA_RANK, d), "tm.bonus_u": (rh, rhd),
                      "tm.mix": (5, d), "tm.ln_x": (d,),
                      "cm.w_k": (d, f), "cm.w_v": (f, d), "cm.w_r": (d, d),
                      "cm.mix": (2, d)})
        return layer
    mixer, ffn = _kinds(cfg, i)
    if mixer == "attn":
        layer = _attn_shapes(cfg, f"{_mix_key(cfg)}.")
    else:
        layer = {f"mix.{k}": s for k, s in mamba_shapes(cfg).items()}
    if ffn == "moe":
        e, ef = cfg.n_experts, cfg.expert_ff
        layer.update({"ffn.router": (d, e), "ffn.wi": (e, d, ef),
                      "ffn.wg": (e, d, ef), "ffn.wo": (e, ef, d)})
        if cfg.n_shared_experts > 0:
            layer.update(_mlp_shapes(cfg, cfg.n_shared_experts * ef,
                                     "ffn.shared."))
    else:
        layer.update(_mlp_shapes(cfg, f, "ffn."))
    return layer


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape by dotted name (layer ``i`` as
    ``layers.i.``), the counterpart of the reference's ``eval_shape``."""
    check_ported(cfg)
    if cfg.encoder_decoder:
        return _whisper_shapes(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    out = ({"embedding.table": (v, d)} if cfg.input_mode == "tokens"
           else {"embedding.adapter": (d, d)})
    for i in range(cfg.n_layers):
        layer = _layer_shapes(cfg, i)
        for ln in ("ln1.", "ln2."):
            layer.update(_norm_shapes(cfg, ln))
        out.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    out.update(_norm_shapes(cfg, "final_norm."))
    if not tied_head(cfg):
        out["lm_head.w"] = (d, v)
    return out


def _whisper_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Whisper's shapes (``enc_layers.i.`` and ``layers.i.`` for layer
    ``i``), as the reference's ``init_whisper`` draws them."""
    d, v = cfg.d_model, cfg.vocab_size
    enc = {**_norm_shapes(cfg, "ln1."), **_attn_shapes(cfg, "attn."),
           **_norm_shapes(cfg, "ln2."), **_mlp_shapes(cfg, cfg.d_ff, "mlp.")}
    dec = {**_norm_shapes(cfg, "ln1."), **_attn_shapes(cfg, "self_attn."),
           **_norm_shapes(cfg, "ln2."), **_attn_shapes(cfg, "cross_attn."),
           **_norm_shapes(cfg, "ln3."), **_mlp_shapes(cfg, cfg.d_ff, "mlp.")}
    out = {"embedding.adapter": (d, d)}
    for i in range(cfg.n_encoder_layers):
        out.update({f"enc_layers.{i}.{k}": s for k, s in enc.items()})
    out.update(_norm_shapes(cfg, "enc_norm."))
    out["dec_embed"] = (v, d)
    out["dec_pos"] = (WHISPER_MAX_TARGET_POSITIONS, d)
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": s for k, s in dec.items()})
    out.update(_norm_shapes(cfg, "final_norm."))
    out["lm_head.w"] = (d, v)
    return out


def _init_layer(cfg: ArchConfig, i: int, gen: torch.Generator,
                dev: torch.device) -> Dict[str, Any]:
    if cfg.rwkv:
        return {"ln1": init_norm(cfg, device=dev),
                "tm": init_rwkv_time_mix(cfg, generator=gen),
                "ln2": init_norm(cfg, device=dev),
                "cm": init_rwkv_channel_mix(cfg, generator=gen)}
    mixer, ffn = _kinds(cfg, i)
    return {"ln1": init_norm(cfg, device=dev),
            _mix_key(cfg): (init_attention if mixer == "attn"
                            else init_mamba)(cfg, generator=gen),
            "ln2": init_norm(cfg, device=dev),
            "ffn": (init_moe if ffn == "moe" else init_mlp)(cfg,
                                                            generator=gen)}


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` (``None`` = the CUDA card) from
    a ``torch.Generator`` seeded with ``seed``, directly in
    ``cfg.param_dtype`` (a MoE router in float32).  ``params["layers"]``
    is a list of per-layer dicts ``{"ln1", "attn", "ln2", "ffn"}`` (dense,
    MoE), ``{"ln1", "mix", "ln2", "ffn"}`` (hybrid) or ``{"ln1", "tm",
    "ln2", "cm"}`` (RWKV); whisper's tree is ``models.whisper``'s."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.encoder_decoder:
        return init_whisper(cfg, gen, dev)
    params: Dict[str, Any] = {"embedding": init_embedding(cfg, generator=gen)}
    params["layers"] = [_init_layer(cfg, i, gen, dev)
                        for i in range(cfg.n_layers)]
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


def _block(lp: Dict, cfg: ArchConfig, i: int, x: torch.Tensor,
           positions: torch.Tensor, rope
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``i`` of a dense, MoE or hybrid model: ``(x, aux)``, aux the
    layer's MoE auxiliary loss (``None`` for an MLP layer)."""
    mixer, ffn = _kinds(cfg, i)
    h = apply_norm(lp["ln1"], cfg, x)
    if mixer == "attn":
        x = x + attention_block(lp[_mix_key(cfg)], cfg, h, positions,
                                rope=rope)
    else:
        x = x + mamba_block(lp["mix"], cfg, h)
    h = apply_norm(lp["ln2"], cfg, x)
    if ffn == "moe":
        y, aux = apply_moe(lp["ffn"], cfg, h)
    else:
        y, aux = apply_mlp(lp["ffn"], cfg, h), None
    return x + y, aux


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


def _backbone(params: Dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final norm output, the f32 MoE auxiliary loss summed over the
    layers: 0 without MoE layers)."""
    check_ported(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.rwkv:
        for lp in params["layers"]:
            x = (checkpoint(_rwkv_block, lp, cfg, x, use_reentrant=False)
                 if remat else _rwkv_block(lp, cfg, x))
    else:
        rope = rope_tables(positions, cfg)
        for i, lp in enumerate(params["layers"]):
            x, a = (checkpoint(_block, lp, cfg, i, x, positions, rope,
                               use_reentrant=False)
                    if remat else _block(lp, cfg, i, x, positions, rope))
            if a is not None:
                aux = aux + a
    return apply_norm(params["final_norm"], cfg, x), aux


def backbone(params: Dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Input embeddings (B, S, d) -> final norm output (B, S, d);
    positions (B, S), or (3, B, S) for M-RoPE.  The reference also
    returns the MoE auxiliary loss; ``forward`` reads it (from the same
    layers).  RWKV reads no positions.

    Differentiable: with gradients on and ``cfg.remat``, each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant), so the backward
    keeps only each layer's input and recomputes the layer, its attention
    or WKV forward included.  Whisper's decoder reads the encoder's
    output besides: ``models.whisper.decoder``."""
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name}: an encoder-decoder model has no "
                         f"decoder-only backbone; use "
                         f"models.whisper.decoder")
    return _backbone(params, cfg, x, positions)[0]


def forward(params: Dict, cfg: ArchConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss: ``batch["inputs"]`` token ids (B, S) or, with
    ``input_mode="embeddings"``, embeddings (B, S, d); ``batch["labels"]``
    (B, S), optional ``batch["positions"]`` ((B, S), or (3, B, S) for
    M-RoPE; RWKV reads none) and ``batch["mask"]`` (B, S), all tensors on
    the parameters' device.  Returns ``(loss, {"ce", "aux"})``: the
    token-mean cross-entropy plus ``AUX_LOSS_COEF`` times the MoE
    auxiliary loss summed over the layers (0 without MoE layers).
    Whisper's batch and loss are ``models.whisper.whisper_forward``'s."""
    check_ported(cfg)
    if cfg.encoder_decoder:
        return whisper_forward(params, cfg, batch)
    inputs = batch["inputs"]
    b, s = inputs.shape[0], inputs.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=inputs.device).expand(b, s)
    x = embed_inputs(params["embedding"], cfg, inputs)
    h, aux = _backbone(params, cfg, x, positions)
    logits = logits_fn(params, cfg, h)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> Dict[str, Any]:
    """On ``device`` (``None`` = the CUDA card): ``{"cache_len": int32
    scalar, "kv": {"k", "v"}}``, the cache sized for ``max_len`` tokens
    over the attention layers (every layer of a dense or MoE model, one a
    period of a hybrid one), a hybrid model's ``"mamba"``: a list of
    ``{"h", "conv"}``, one a Mamba layer in layer order; or RWKV's
    ``{"cache_len", "rwkv": [per layer {"tm_shift", "wkv", "cm_shift"}]}``
    (a constant-size state; ``max_len`` is unused); whisper's is
    ``models.whisper.init_whisper_decode_state``'s.  A dense or MoE model
    with ``decode_tail_window = W > 0`` also holds ``"tail": {"k", "v"}``,
    (L, B, KV, W, hd) (``attention.init_kv_tail``); hybrid and RWKV
    models ignore the window, as the reference's do."""
    check_ported(cfg)
    dev = resolve_device(device)
    if cfg.encoder_decoder:
        return init_whisper_decode_state(cfg, batch, max_len, dev)
    state: Dict[str, Any] = {
        "cache_len": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.rwkv:
        state["rwkv"] = [init_rwkv_state(cfg, batch, dev)
                         for _ in range(cfg.n_layers)]
        return state
    state["kv"] = init_kv_cache(cfg, batch, max_len,
                                len(attention_layers(cfg)), device=dev)
    if _hybrid(cfg):
        state["mamba"] = [init_mamba_state(cfg, batch, dev)
                          for i in range(cfg.n_layers)
                          if _kinds(cfg, i)[0] == "mamba"]
    elif cfg.decode_tail_window > 0:
        state["tail"] = init_kv_tail(cfg, batch, cfg.decode_tail_window,
                                     cfg.n_layers, device=dev)
    return state


def serve_step(params: Dict, cfg: ArchConfig, state: Dict, batch: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: new token ids (B,) or (B, 1), or embeddings (B, 1,
    d) -> logits (B, V); optional ``batch["positions"]`` (B, 1), or (3, B,
    1) for M-RoPE (default: ``cache_len`` for every row).

    The KV cache holds ``state["cache_len"]`` tokens; the step appends one,
    writing the cache in place (a tailed state: its tail, at ``cache_len %
    W``; the main cache is written only by ``attention.flush_kv_tail``),
    and returns ``(logits, new_state)`` with ``new_state["cache_len"]``
    one more.  A Mamba layer writes its SSM
    state and conv window in place, an RWKV layer its shift and WKV
    state.  ``cache_len`` stays on the device: the step never syncs the
    host (the MoE dispatch included).  Whisper's step is
    ``models.whisper.whisper_serve_step``.
    """
    check_ported(cfg)
    if cfg.encoder_decoder:
        return whisper_serve_step(params, cfg, state, batch)
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
        tail = state.get("tail")
        mamba_states = iter(state.get("mamba", ()))
        key, a = _mix_key(cfg), 0
        for i, lp in enumerate(params["layers"]):
            mixer, ffn = _kinds(cfg, i)
            h = apply_norm(lp["ln1"], cfg, x)
            if mixer == "attn":
                caches = (kc[a], vc[a]) if tail is None else (
                    kc[a], vc[a], tail["k"][a], tail["v"][a])
                y = (decode_attention if tail is None
                     else decode_attention_tailed)(
                    lp[key], cfg, h, *caches, clen, positions, rope=rope)[0]
                a += 1
            else:
                y, _ = mamba_decode_step(lp["mix"], cfg, h,
                                         next(mamba_states))
            x = x + y
            h = apply_norm(lp["ln2"], cfg, x)
            x = x + (apply_moe(lp["ffn"], cfg, h)[0] if ffn == "moe"
                     else apply_mlp(lp["ffn"], cfg, h))
    h = apply_norm(params["final_norm"], cfg, x)
    logits = logits_fn(params, cfg, h)[:, 0, :]
    return logits, dict(state, cache_len=clen + 1)


__all__ = ["AUX_LOSS_COEF", "attention_layers", "backbone", "check_ported",
           "check_trainable", "forward", "init_decode_state", "init_params",
           "param_bytes", "param_shapes", "serve_step"]

"""Step-function builders: ``make_train_step`` (forward, backward and
AdamW), ``make_prefill_step`` (full-sequence forward, last-token logits)
and ``make_serve_step`` (one decode step).

Each builder resolves its device once (``None`` = the CUDA card; a host
without CUDA raises ``CudaUnavailableError`` unless ``device="cpu"``) and
the step moves its batch there.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import items, unflatten
from repro_torch.models import (ArchConfig, forward,
                                serve_step as model_serve_step)
from repro_torch.models.layers import embed_inputs, logits_fn
from repro_torch.models.transformer import (backbone, check_ported,
                                            check_trainable)
from repro_torch.models.whisper import decoder, encode
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def _ids(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).long()


def _inputs(x, dev: torch.device) -> torch.Tensor:
    """Token ids as int64; float embeddings (the VLM's, whisper's frames)
    as they are."""
    x = torch.as_tensor(x, device=dev)
    return x if x.is_floating_point() else x.long()


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    device=None, *, donate: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of any model the port carries (dense, MoE, hybrid Mamba,
    RWKV-6, whisper, the VLM): the loss and its gradient with respect to
    every parameter (``models.forward``, one backward pass), then
    ``adamw_update``.
    ``batch`` holds ``inputs`` (B, S) token ids (or (B, S, d) embeddings
    where ``input_mode="embeddings"``) and ``labels`` (B, S), tensors or
    arrays (the data pipeline's numpy batches), and optionally
    ``positions`` ((B, S), or (3, B, S) for M-RoPE) and ``mask``;
    whisper's holds ``inputs`` (B, T_enc, d) frame embeddings,
    ``decoder_tokens`` and ``labels`` (B, S) and optionally ``mask``; the
    step moves them to the device.
    ``metrics`` holds ``loss``, ``ce``, ``aux``, ``lr`` and ``grad_norm``
    as tensors on the device (the step never syncs the host).  The given
    parameters and state are left as they were, unless ``donate``: then,
    like the reference driver's ``donate_argnums=(0, 1)``, they are
    updated in place and returned (the same bits), so that the step holds
    no second copy of them.  On the card every attention layer (each
    layer of a dense or MoE model, one a period of a hybrid one) runs the
    flash forward kernel (twice with ``cfg.remat``: once more when the
    backward recomputes the layer) and the flash backward kernel once: a
    MoE model of L layers launches 2L forward and L backward a step (the
    expert dispatch and products are plain PyTorch, as the reference's
    are jnp, and so is a Mamba layer's scan); every RWKV layer's
    recurrence the WKV forward kernel (twice with ``cfg.remat``) and the
    WKV backward kernel once.  Whisper
    launches three flash forwards a layer pair (the encoder layer's
    self-attention without the mask, the decoder layer's causal
    self-attention and its cross-attention without the mask), each twice
    with ``cfg.remat``, and three flash backwards: at whisper-large-v3's
    32 + 32 layers, 192 forward and 96 backward launches a step."""
    check_trainable(cfg)
    dev = resolve_device(device)

    def train_step(params: Dict, opt_state: Dict, batch: Dict):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        keyed = dict(items(params))
        trainable = {k: p.detach().requires_grad_(True)
                     for k, p in keyed.items()}
        with torch.enable_grad():
            loss, metrics = forward(unflatten(params, trainable), cfg, batch)
            grads = torch.autograd.grad(loss, list(trainable.values()))
        grads = unflatten(params, dict(zip(trainable, grads)))
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, opt_cfg, in_place=donate)
        return params, opt_state, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
    return train_step


def make_prefill_step(cfg: ArchConfig, device=None) -> Callable:
    """``prefill(params, batch) -> logits (B, V)`` of the last position:
    ``batch["inputs"]`` token ids (B, S) or, where
    ``input_mode="embeddings"``, float embeddings (B, S, d) (a tensor or
    an array), optional ``batch["positions"]`` ((B, S), or (3, B, S) for
    M-RoPE; RWKV reads none).  On the card every
    attention layer (each layer of a dense or MoE model, one a period of
    a hybrid one) runs on the flash-attention kernel, every RWKV layer's
    recurrence on the WKV kernel (one launch a layer); the expert
    dispatch and the Mamba scan are plain PyTorch, as the reference's are
    jnp.

    Whisper's batch is ``inputs`` (B, T_enc, d) frame embeddings and
    ``decoder_tokens`` (B, S): the encoder, then the teacher-forced
    decoder over the prompt, three flash launches a layer pair (encoder
    self-attention and cross-attention without the mask, decoder
    self-attention causal).  Like the reference's, it leaves the decode
    caches empty."""
    check_ported(cfg)
    dev = resolve_device(device)

    if cfg.encoder_decoder:
        @torch.no_grad()
        def prefill_whisper(params: Dict, batch: Dict) -> torch.Tensor:
            frames = torch.as_tensor(batch["inputs"], device=dev)
            enc = encode(params, cfg, frames)
            h = decoder(params, cfg, enc, _ids(batch["decoder_tokens"], dev))
            return logits_fn(params, cfg, h[:, -1:, :])[:, 0, :]
        return prefill_whisper

    @torch.no_grad()
    def prefill(params: Dict, batch: Dict) -> torch.Tensor:
        inputs = _inputs(batch["inputs"], dev)
        b, s = inputs.shape[:2]
        positions = batch.get("positions")
        positions = (torch.arange(s, device=dev).expand(b, s)
                     if positions is None else _ids(positions, dev))
        x = embed_inputs(params["embedding"], cfg, inputs)
        h = backbone(params, cfg, x, positions)
        return logits_fn(params, cfg, h[:, -1:, :])[:, 0, :]
    return prefill


def make_serve_step(cfg: ArchConfig, device=None) -> Callable:
    """``step(params, state, batch) -> (logits (B, V), new_state)``: one
    decode step (``models.serve_step``); on the card every attention
    layer's cache attention runs on the decode-attention kernel, every
    RWKV layer's one-token recurrence on the WKV kernel, in place (a
    Mamba layer's state is written in place too; a tailed state's tail
    too, on the decode kernel's tailed entry).  ``batch["inputs"]`` token
    ids (B,) or embeddings (B, 1, d), optional ``batch["positions"]``."""
    check_ported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params: Dict, state: Dict, batch: Dict):
        batch = {k: _inputs(v, dev) for k, v in batch.items()}
        return model_serve_step(params, cfg, state, batch)
    return step

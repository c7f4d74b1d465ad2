"""Step-function builders: ``make_prefill_step`` (full-sequence forward,
last-token logits) and ``make_serve_step`` (one decode step).

Each builder resolves its device once (``None`` = the CUDA card; a host
without CUDA raises ``CudaUnavailableError`` unless ``device="cpu"``) and
the step moves its token ids there.  ``make_train_step`` waits for the
training slice.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch._device import resolve_device
from repro_torch.models import ArchConfig, serve_step as model_serve_step
from repro_torch.models.layers import embed_inputs, logits_fn
from repro_torch.models.transformer import backbone, check_ported


def _ids(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).long()


def make_prefill_step(cfg: ArchConfig, device=None) -> Callable:
    """``prefill(params, batch) -> logits (B, V)`` of the last position:
    ``batch["inputs"]`` token ids (B, S) (a tensor or an array), optional
    ``batch["positions"]`` (B, S; RWKV reads none).  On the card every
    dense layer's attention runs on the flash-attention kernel, every
    RWKV layer's recurrence on the WKV kernel (one launch a layer)."""
    check_ported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params: Dict, batch: Dict) -> torch.Tensor:
        inputs = _ids(batch["inputs"], dev)
        b, s = inputs.shape
        positions = batch.get("positions")
        positions = (torch.arange(s, device=dev).expand(b, s)
                     if positions is None else _ids(positions, dev))
        x = embed_inputs(params["embedding"], cfg, inputs)
        h = backbone(params, cfg, x, positions)
        return logits_fn(params, cfg, h[:, -1:, :])[:, 0, :]
    return prefill


def make_serve_step(cfg: ArchConfig, device=None) -> Callable:
    """``step(params, state, batch) -> (logits (B, V), new_state)``: one
    decode step (``models.serve_step``); on the card every dense layer's
    cache attention runs on the decode-attention kernel, every RWKV
    layer's one-token recurrence on the WKV kernel, in place."""
    check_ported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params: Dict, state: Dict, batch: Dict):
        batch = {k: _ids(v, dev) for k, v in batch.items()}
        return model_serve_step(params, cfg, state, batch)
    return step

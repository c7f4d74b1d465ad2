"""RWKV-6 "Finch" block: time-mix with data-dependent decay, and
channel-mix.

Per head (size ``rwkv_head_size``), the WKV state S (hd x hd) evolves as

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t          (w_t data-dependent)
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

The recurrence runs on the ``rwkv6_wkv`` CUDA kernel at every T (a whole
prompt is one launch a layer, a decode step too); the reference's model
runs the same function as a ``lax.scan`` (``wkv_impl="scan"``).  Where
autograd records (training), the recurrence is the ``WKV`` autograd
function: the forward kernel, and the ``rwkv6_wkv_bwd`` kernel for its
gradient, where the reference differentiates its scan.  Its
traffic stand-in ``wkv_impl="kernel_stub"`` computes another function and
serves only the reference's roofline dry runs: it is not ported.

Each function keeps the reference's dtypes step by step: the token-shift
lerps in the activation dtype, the decay LoRA and ``exp(-exp(.))`` in
float32, the r/k/v streams cast to float32 for the recurrence.  ``ln_x``
normalises each token over the whole ``d_model``, as the reference does
(its comment says per head).

A given state is updated in place and returned: the WKV kernel writes
the last state over the incoming one, and the shift rows are copied into
theirs, so a decode step allocates no state.  Where autograd records,
nothing is written in place (the recurrence's inputs are saved for the
backward) and a new state is returned.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import (WKV, records, rwkv6_wkv_bwd,
                                            rwkv6_wkv_fwd)

from .base import ArchConfig, scaled_normal

LORA_RANK = 32


def _dims(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_size
    if cfg.d_model % hd:
        raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a "
                         f"multiple of rwkv_head_size {hd}")
    return cfg.d_model // hd, hd


def _uniform(shape, cfg: ArchConfig, gen: torch.Generator) -> torch.Tensor:
    """Uniform on [0, 1), drawn in the parameter dtype."""
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=cfg.pdtype)


def init_rwkv_time_mix(cfg: ArchConfig, *,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h, hd = _dims(cfg)
    gen, dt, dev = generator, cfg.pdtype, generator.device
    p = {f"w_{n}": scaled_normal((d, d), d, dt, generator=gen)
         for n in "rkvgo"}
    p.update({
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x W1) W2))
        "decay_w0": torch.full((d,), -6.0, dtype=dt, device=dev),
        "decay_w1": scaled_normal((d, LORA_RANK), d, dt, generator=gen),
        "decay_w2": scaled_normal((LORA_RANK, d), LORA_RANK, dt,
                                  generator=gen),
        "bonus_u": torch.zeros((h, hd), dtype=dt, device=dev),
        "mix": _uniform((5, d), cfg, gen),
        "ln_x": torch.ones(d, dtype=dt, device=dev),
    })
    return p


def init_rwkv_channel_mix(cfg: ArchConfig, *, generator: torch.Generator
                          ) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    gen, dt = generator, cfg.pdtype
    return {"w_k": scaled_normal((d, f), d, dt, generator=gen),
            "w_v": scaled_normal((f, d), f, dt, generator=gen),
            "w_r": scaled_normal((d, d), d, dt, generator=gen),
            "mix": _uniform((2, d), cfg, gen)}


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; position 0 takes ``last`` (the decode carry)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_time_mix(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                  state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, T, d).  ``state``: ``{"shift": (B, d), "wkv": (B, H, hd, hd)
    float32}`` or ``None`` (zeros).  Returns ``(y, state)`` with the state
    written in place, or, where autograd records, a new state."""
    b, t, d = x.shape
    h, hd = _dims(cfg)
    f32, dt = torch.float32, cfg.adtype
    if state is None:
        state = {"shift": torch.zeros((b, d), dtype=x.dtype, device=x.device),
                 "wkv": torch.zeros((b, h, hd, hd), dtype=torch.float32,
                                    device=x.device)}
    dx = _token_shift(x, state["shift"]) - x
    mix = p["mix"].to(x.dtype)                          # (5, d)
    xr, xk, xv, xg, xw = (x + dx * mix[i] for i in range(5))

    r, k, v, g = (xi @ p[n].to(dt) for xi, n in
                  ((xr, "w_r"), (xk, "w_k"), (xv, "w_v"), (xg, "w_g")))
    # data-dependent decay (f32; exp(-exp(.)) in (0, 1))
    lo = torch.tanh(xw.float() @ p["decay_w1"].float())
    wlog = p["decay_w0"].float() + lo @ p["decay_w2"].float()
    w = torch.exp(-torch.exp(wlog))

    shp = (b, t, h, hd)
    ins = [z.to(f32).reshape(shp) for z in (r, k, v, w)]
    ins += [p["bonus_u"].float(), state["wkv"]]
    grad = records(*ins)
    if grad:
        out, s_last = WKV.apply(*ins, rwkv6_wkv_fwd, rwkv6_wkv_bwd)
    else:
        out, _ = rwkv6_wkv_fwd(*ins, s_last=state["wkv"])
    out = out.reshape(b, t, d)
    # ln_x over the whole d_model, then the gate
    mean = out.mean(-1, keepdim=True)
    var = (out - mean).square().mean(-1, keepdim=True)
    out = (out - mean) * torch.rsqrt(var + 1e-5) * p["ln_x"].float()
    out = out.to(dt) * F.silu(g.float()).to(dt)
    y = out @ p["w_o"].to(dt)
    if grad:
        return y, {"shift": x[:, -1, :], "wkv": s_last}
    state["shift"].copy_(x[:, -1, :])
    return y, state


def rwkv_channel_mix(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                     state: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, T, d).  ``state``: ``{"shift": (B, d)}`` or ``None`` (zeros).
    Returns ``(y, state)`` with the shift written in place."""
    if state is None:
        state = {"shift": torch.zeros((x.shape[0], x.shape[2]),
                                      dtype=x.dtype, device=x.device)}
    dx = _token_shift(x, state["shift"]) - x
    mix = p["mix"].to(x.dtype)
    xk = x + dx * mix[0]
    xr = x + dx * mix[1]
    dt = cfg.adtype
    k = torch.square(torch.relu((xk @ p["w_k"].to(dt)).float())).to(dt)
    v = k @ p["w_v"].to(dt)
    r = torch.sigmoid((xr @ p["w_r"].to(dt)).float())
    state["shift"].copy_(x[:, -1, :])
    return v * r.to(dt), state


def init_rwkv_state(cfg: ArchConfig, batch: int, device
                    ) -> Dict[str, torch.Tensor]:
    """Zero decode state of one layer: the shifts (B, d) in the activation
    dtype, the WKV state (B, H, hd, hd) in float32."""
    h, hd = _dims(cfg)
    shift = (batch, cfg.d_model)
    return {"tm_shift": torch.zeros(shift, dtype=cfg.adtype, device=device),
            "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                               device=device),
            "cm_shift": torch.zeros(shift, dtype=cfg.adtype, device=device)}

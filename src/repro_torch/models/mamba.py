"""Mamba-1 block (jamba's 7-of-8 non-attention layers), as
``repro.models.mamba`` computes it.

Selective SSM with input-dependent (dt, B, C); the recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

runs chunk by chunk (``cfg.mamba_chunk`` steps; the sequence zero-padded
to whole chunks, as in the reference) with a parallel scan inside each
chunk: :func:`_associative_scan` is ``jax.lax.associative_scan``'s own
recursion (pairs combined, the odd half scanned, the even half filled
in), so the port combines the same pairs in the same order.  dA and dBx
are built a chunk at a time: the reference builds them for the whole
sequence ((B, S, d_in, n) float32 each, 4.3 GB a layer at jamba's full
width and 8 x 1024 tokens), the values are the same.

Decode keeps a constant-size state: ``h`` (B, d_in, n) float32 and the
conv window ``conv`` (B, d_conv - 1, d_in), the last pre-conv inputs in
the activation dtype.  :func:`mamba_decode_step` writes both in place.
The projections are plain matrix products, as the reference's einsums.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .base import ArchConfig, MambaConfig, scaled_normal
from .sharding import (distribute_like, is_dtensor, local_call, mm, shard,
                       spec_placements)


def _mcfg(cfg: ArchConfig) -> MambaConfig:
    return cfg.mamba or MambaConfig()


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_in, d_state, d_conv, dt_rank)."""
    m = _mcfg(cfg)
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or math.ceil(cfg.d_model / 16)
    return d_in, m.d_state, m.d_conv, dt_rank


def mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every Mamba parameter's shape by name."""
    d = cfg.d_model
    d_in, n, d_conv, dt_rank = _dims(cfg)
    return {"w_in": (d, 2 * d_in), "conv": (d_conv, d_in), "conv_b": (d_in,),
            "w_x": (d_in, dt_rank + 2 * n), "w_dt": (dt_rank, d_in),
            "dt_bias": (d_in,), "A_log": (d_in, n), "D": (d_in,),
            "w_out": (d_in, d)}


def mamba_specs(cfg: ArchConfig) -> Dict:
    return {"w_in": ("p_embed", "p_ffn"), "conv": (None, "p_ffn"),
            "conv_b": ("p_ffn",), "w_x": ("p_ffn", None),
            "w_dt": (None, "p_ffn"), "dt_bias": ("p_ffn",),
            "A_log": ("p_ffn", None), "D": ("p_ffn",),
            "w_out": ("p_ffn", "p_embed")}


def mamba_state_specs() -> Dict:
    return {"h": ("batch", "p_ffn", None), "conv": ("batch", None, "p_ffn")}


def init_mamba(cfg: ArchConfig, *,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The reference's laws: truncated scaled normals for the projections
    and the conv, zero conv bias, ``dt_bias`` -4.6 (softplus^-1(0.01)),
    ``A_log`` log(1..n) on every channel, ``D`` ones."""
    d = cfg.d_model
    d_in, n, d_conv, dt_rank = _dims(cfg)
    pdt, dev = cfg.pdtype, generator.device

    def normal(shape, fan_in):
        return scaled_normal(shape, fan_in, pdt, generator=generator)

    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {
        "w_in": normal((d, 2 * d_in), d),
        "conv": normal((d_conv, d_in), d_conv),
        "conv_b": torch.zeros(d_in, dtype=pdt, device=dev),
        "w_x": normal((d_in, dt_rank + 2 * n), d_in),
        "w_dt": normal((dt_rank, d_in), dt_rank),
        "dt_bias": torch.full((d_in,), -4.6, dtype=pdt, device=dev),
        "A_log": torch.log(a)[None, :].expand(d_in, n).to(pdt).clone(),
        "D": torch.ones(d_in, dtype=pdt, device=dev),
        "w_out": normal((d_in, d), d_in),
    }


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along dim 1 (len(a) - len(b) is 0 or
    1)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under
    (a1, b1) o (a2, b2) = (a1 a2, b1 a2 + b2), by the recursion of
    ``jax.lax.associative_scan``."""
    def combine(x, y):
        (a1, b1), (a2, b2) = x, y
        return a1 * a2, b1 * a2 + b2

    def scan(elems):
        num = elems[0].shape[1]
        if num < 2:
            return elems
        reduced = combine([e[:, 0:-1:2] for e in elems],
                          [e[:, 1::2] for e in elems])
        odd = scan(reduced)
        if num % 2 == 0:
            even = combine([e[:, :-1] for e in odd],
                           [e[:, 2::2] for e in elems])
        else:
            even = combine(odd, [e[:, 2::2] for e in elems])
        even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
        return [_interleave(ev, od) for ev, od in zip(even, odd)]

    return tuple(scan([a, b]))


def _ssm_chunk_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk scan of h_t = dA_t * h_{t-1} + dBx_t.  dA/dBx (B, c,
    d_in, n); h0 (B, d_in, n).  Returns (h_all, h_last)."""
    a_all, b_all = _associative_scan(dA, dBx)
    h_all = a_all * h0[:, None] + b_all
    return h_all, h_all[:, -1]


def _selective_ssm(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d_in) post-conv activations; h0 (B, d_in, n) float32.
    Returns (y (B, S, d_in) in x's dtype, h_last (B, d_in, n) float32);
    h_last has passed the zero padding of the last chunk, as in the
    reference."""
    b, s, d_in = x.shape
    _, n, _, dt_rank = _dims(cfg)
    c = min(cfg.mamba_chunk, s)
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    if not is_dtensor(x):
        xf = F.pad(x.float(), (0, 0, 0, pad))
    elif pad:           # DTensor (torch 2.11) has no padding rule here
        xf = torch.cat([x.float(), distribute_like(x, torch.zeros(
            (b, pad, d_in), device=x.device.type), "batch", None, "ffn")],
            dim=1)
    else:
        xf = x.float()

    proj = mm(xf, p["w_x"].float())
    dt_r, B_, C_ = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = F.softplus(mm(dt_r, p["w_dt"].float())
                    + p["dt_bias"].float())                    # (B, S, d_in)
    A = -torch.exp(p["A_log"].float())                         # (d_in, n)

    chunks = functools.partial(_scan_chunks, c=c, n_chunks=n_chunks)
    if is_dtensor(x):
        # the recurrence is independent per (batch row, channel): it runs
        # per shard of the batch and of d_in (``ffn``), B and C gathered
        ch = spec_placements(xf, "batch", None, "ffn")
        row = spec_placements(B_, "batch", None, None)
        chunks = local_call(chunks, (ch, spec_placements(h0, "batch", "ffn",
                                                          None)),
                            (ch, row, row, ch, spec_placements(
                                A, "ffn", None), spec_placements(
                                h0, "batch", "ffn", None)), x.device_mesh)
    ys, h = chunks(dt, B_, C_, xf, A, h0)
    y = ys[:, :s] + xf[:, :s] * p["D"].float()
    return y.to(x.dtype), h


def _scan_chunks(dt, B_, C_, xf, A, h0, *, c: int, n_chunks: int):
    """The selective scan a chunk at a time: dt, xf (B, S, d_in), B_, C_
    (B, S, n), A (d_in, n), h0 (B, d_in, n).  Returns (the C-read states
    (B, S, d_in), the last state)."""
    h = h0.float()
    ys = []
    for i in range(n_chunks):
        t = slice(i * c, (i + 1) * c)
        dt_c = dt[:, t, :, None]
        dA = torch.exp(dt_c * A)                     # (B, c, d_in, n)
        dBx = dt_c * B_[:, t, None, :] * xf[:, t, :, None]
        h_all, h = _ssm_chunk_scan(dA, dBx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, C_[:, t]))
    return torch.cat(ys, dim=1), h


def _causal_conv(p: Dict, x: torch.Tensor,
                 ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x (B, S, d_in); ctx (B, d_conv - 1, d_in),
    the carried window for decode (zeros for a fresh sequence)."""
    w = p["conv"].float()                                      # (d_conv, d_in)
    d_conv, s = w.shape[0], x.shape[1]
    xf = x.float()
    if ctx is None:
        ctx = xf.new_zeros((x.shape[0], d_conv - 1, x.shape[2]))
    xp = torch.cat([ctx.float(), xf], dim=1)
    out = 0
    for i in range(d_conv):
        out = out + xp[:, i:i + s] * w[i]
    return (out + p["conv_b"].float()).to(x.dtype)


def _in_proj(p: Dict, cfg: ArchConfig, x: torch.Tensor):
    xz = mm(x, p["w_in"].to(cfg.adtype))
    return torch.chunk(xz, 2, dim=-1)


def _out_proj(p: Dict, cfg: ArchConfig, y: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    dt = cfg.adtype
    y = y * F.silu(z.float()).to(dt)
    return mm(y, p["w_out"].to(dt))


def mamba_block(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba mixer.  x (B, S, d) -> (B, S, d)."""
    d_in, n, _, _ = _dims(cfg)
    dt = cfg.adtype
    xs, z = _in_proj(p, cfg, x)
    xs = shard(xs, "batch", None, "ffn")
    xs = F.silu(_causal_conv(p, xs).float()).to(dt)
    h0 = distribute_like(xs, torch.zeros((x.shape[0], d_in, n),
                                         dtype=torch.float32,
                                         device=x.device),
                         "batch", "ffn", None)
    y, _ = _selective_ssm(p, cfg, xs, h0)
    return _out_proj(p, cfg, y, z)


def init_mamba_state(cfg: ArchConfig, batch: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """``{"h": (B, d_in, n) float32, "conv": (B, d_conv - 1, d_in)}`` in
    the activation dtype, zeros."""
    d_in, n, d_conv, _ = _dims(cfg)
    return {"h": torch.zeros((batch, d_in, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, d_conv - 1, d_in), dtype=cfg.adtype,
                                device=device)}


def mamba_decode_step(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode.  x (B, 1, d).  Writes the new ``h`` and conv
    window into ``state``'s tensors (the window keeps the pre-conv inputs
    in its own dtype) and returns (y (B, 1, d), state)."""
    dt = cfg.adtype
    xs, z = _in_proj(p, cfg, x)
    conv_ctx = state["conv"]
    xs_act = F.silu(_causal_conv(p, xs, ctx=conv_ctx).float()).to(dt)
    y, h_new = _selective_ssm(p, cfg, xs_act, state["h"])
    if conv_ctx.shape[1] > 0:
        conv_ctx.copy_(torch.cat([conv_ctx[:, 1:], xs.to(conv_ctx.dtype)],
                                 dim=1))
    state["h"].copy_(h_new)
    return _out_proj(p, cfg, y, z), state


__all__ = ["init_mamba", "init_mamba_state", "mamba_block",
           "mamba_decode_step", "mamba_shapes", "mamba_specs",
           "mamba_state_specs"]

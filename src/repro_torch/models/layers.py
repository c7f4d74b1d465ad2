"""Shared building blocks: norms, RoPE, MLPs, embeddings, logits and the
training loss.

Each function computes what its counterpart in the reference's
``models/layers.py`` computes, in the same dtypes: norms and RoPE in
float32, cast back to the activation dtype; weights cast to the
activation dtype at each use (a no-op when ``param_dtype == dtype``).
The projections are plain matrix products (``torch.matmul``), as the
reference leaves them to XLA.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .base import ArchConfig, scaled_normal

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, *, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=cfg.pdtype, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(d, dtype=cfg.pdtype, device=device),
                "bias": torch.zeros(d, dtype=cfg.pdtype, device=device)}
    if cfg.norm_type == "nonparametric_ln":   # olmo: no affine params
        return {}
    raise ValueError(cfg.norm_type)


def _rms(xf: torch.Tensor) -> torch.Tensor:
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)


def apply_norm(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        return (_rms(xf) * p["scale"].float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    if cfg.norm_type == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    elif cfg.norm_type != "nonparametric_ln":
        raise ValueError(cfg.norm_type)
    return y.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """qk-norm (qwen3): RMS norm over head_dim."""
    return (_rms(x.float()) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE + qwen2-vl's multimodal M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ArchConfig, device=None) -> torch.Tensor:
    """f32 (hd/2,) inverse frequencies ``1 / theta ** (2i / hd)``.  They are
    computed on the host (``pow`` in float32) and cached per device, so
    the card uses the same values as the CPU: PyTorch's CUDA ``pow`` with
    a scalar base runs ``exp(x * log(base))``, ulps away."""
    return _freqs(cfg.head_dim, float(cfg.rope_theta),
                  str(torch.device("cpu" if device is None else device)))


@functools.lru_cache(maxsize=None)
def _freqs(hd: int, theta: float, device: str) -> torch.Tensor:
    exp = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    return (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exp)
            ).to(device)


@functools.lru_cache(maxsize=None)
def _sections(sections: Tuple[int, ...], device: str) -> torch.Tensor:
    """The position stream of each of the hd/2 frequency slots: for
    (16, 24, 24), slots 0-15 read t, 16-39 h and 40-63 w."""
    return torch.repeat_interleave(torch.arange(len(sections)),
                                   torch.tensor(sections)).to(device)


Rope = Tuple[torch.Tensor, torch.Tensor]


def rope_tables(positions: torch.Tensor, cfg: ArchConfig) -> Rope:
    """``(cos, sin)``, each f32 (B, S, 1, hd/2), for positions (B, S), or
    (3, B, S) for M-RoPE.  Every layer of one call shares them, so callers
    compute them once.

    M-RoPE (qwen2-vl): with 3-stream positions and ``mrope_sections``,
    each frequency slot takes its angle from the stream of its section
    (t, h, w); text has t == h == w, where M-RoPE is 1-D RoPE.  As in the
    reference, 3-stream positions without sections read stream 0, and
    (B, S) positions with sections (a decode step's default) give 1-D
    RoPE."""
    freqs = rope_freqs(cfg, positions.device)
    pos = positions.float()
    if positions.dim() == 3 and cfg.mrope_sections:
        sec = _sections(tuple(cfg.mrope_sections), str(positions.device))
        theta = pos[sec].permute(1, 2, 0) * freqs     # (B, S, hd/2)
    else:
        if positions.dim() == 3:
            pos = pos[0]
        theta = pos[..., None] * freqs
    return torch.cos(theta)[:, :, None, :], torch.sin(theta)[:, :, None, :]


def rotate(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """Rotate x (B, S, H, hd) by precomputed ``rope_tables``."""
    cos, sin = rope
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    return rotate(x, rope_tables(positions, cfg))


def sinusoidal_positions(seq_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-encoder style fixed sinusoids (T, d) in float32 on
    ``device``: the sines of ``pos / 10000 ** (2i / d)`` for the d / 2
    frequencies, then their cosines."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10000.0) * torch.arange(
        0, d, 2, dtype=torch.float32, device=device) / d)
    ang = pos * div[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, *, generator: torch.Generator,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """SwiGLU (or GELU) weights of width ``d_ff`` (default ``cfg.d_ff``;
    a MoE layer's shared expert passes its own)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": scaled_normal((d, f), d, cfg.pdtype, generator=generator),
         "wo": scaled_normal((f, d), f, cfg.pdtype, generator=generator)}
    if cfg.gated_mlp:
        p["wg"] = scaled_normal((d, f), d, cfg.pdtype, generator=generator)
    return p


def apply_mlp(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.adtype
    h = x @ p["wi"].to(dt)
    if cfg.gated_mlp:
        g = x @ p["wg"].to(dt)
        h = F.silu(g.float()).to(dt) * h
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(dt)
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# embeddings + logits
# ---------------------------------------------------------------------------


def init_embedding(cfg: ArchConfig, *,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A token table (V, d), or for an embeddings front end (the VLM's
    stub) a (d, d) adapter over precomputed patch embeddings."""
    if cfg.input_mode == "tokens":
        return {"table": scaled_normal((cfg.vocab_size, cfg.d_model),
                                       cfg.d_model, cfg.pdtype,
                                       generator=generator)}
    return {"adapter": scaled_normal((cfg.d_model, cfg.d_model), cfg.d_model,
                                     cfg.pdtype, generator=generator)}


def embed_inputs(p: Dict, cfg: ArchConfig, inputs: torch.Tensor
                 ) -> torch.Tensor:
    """Token ids (...) -> embeddings (..., d) in the activation dtype (the
    rows are gathered first, then cast: the same values as the reference's
    cast-then-gather); or embeddings (..., d) through the adapter, both
    cast to the activation dtype first, as the reference's
    cast-then-einsum."""
    if cfg.input_mode == "tokens":
        return p["table"][inputs.long()].to(cfg.adtype)
    return inputs.to(cfg.adtype) @ p["adapter"].to(cfg.adtype)


def tied_head(cfg: ArchConfig) -> bool:
    """Whether the logits read the embedding table: ``tie_embeddings`` ties
    the head only where the inputs are tokens, as in the reference (an
    embeddings front end has no table; whisper's head is its own)."""
    return cfg.tie_embeddings and cfg.input_mode == "tokens"


def init_lm_head(cfg: ArchConfig, *,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    if tied_head(cfg):
        return {}
    return {"w": scaled_normal((cfg.d_model, cfg.vocab_size), cfg.d_model,
                               cfg.pdtype, generator=generator)}


def logits_fn(params: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.adtype
    if tied_head(cfg):
        return x @ params["embedding"]["table"].to(dt).T
    return x @ params["lm_head"]["w"].to(dt)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross-entropy in float32 with a stable logsumexp.
    logits (..., V); labels (...) int; ``mask`` (...), optional: the mean
    over masked-in tokens (at least one in the divisor)."""
    lf = logits.float()
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = torch.logsumexp(lf, dim=-1) - gold
    if mask is not None:
        m = mask.to(nll.dtype)
        return (nll * m).sum() / m.sum().clamp(min=1.0)
    return nll.mean()

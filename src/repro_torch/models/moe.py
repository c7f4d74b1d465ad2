"""Mixture-of-Experts block: softmax top-k routing, a shared expert and the
reference's sort-based capacity dispatch (``repro.models.moe``).

The dispatch keeps the reference's static shapes: every batch row (one
dispatch group) routes its own S*k (token, expert) entries into a
(B, E, C, d) capacity buffer, the experts run as batched products over
that buffer, and the outputs are gathered back gate-weighted.  Only int
index tensors are sorted and scattered; nothing in it reads a value on
the host (no boolean-mask indexing, no ``nonzero``, no ``.item()``), so a
decode step that runs it can be captured in a CUDA graph.  Entries past
an expert's capacity are dropped, as in the reference.

The expert products are ``torch.einsum`` (batched matmuls), as the
reference leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .base import ArchConfig, scaled_normal
from .layers import apply_mlp, init_mlp


def init_moe(cfg: ArchConfig, *,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Router (d, E) in float32 whatever ``param_dtype`` is (the reference
    draws it so), experts ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d),
    and the shared expert's MLP of width ``n_shared_experts * f``."""
    d, f, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    p = {"router": scaled_normal((d, e), d, torch.float32,
                                 generator=generator),
         "wi": scaled_normal((e, d, f), d, cfg.pdtype, generator=generator),
         "wg": scaled_normal((e, d, f), d, cfg.pdtype, generator=generator),
         "wo": scaled_normal((e, f, d), f, cfg.pdtype, generator=generator)}
    if cfg.n_shared_experts > 0:
        p["shared"] = init_mlp(cfg, generator=generator,
                               d_ff=cfg.n_shared_experts * cfg.expert_ff)
    return p


def _capacity(cfg: ArchConfig, group_tokens: int) -> int:
    """Per-dispatch-group expert capacity (group = one batch row)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = int(cfg.capacity_factor * group_tokens * k / e)
    if group_tokens * k <= 128:          # decode-sized groups: no 128 padding
        return max(1, cap)
    return max(128, -(-cap // 128) * 128)  # 128-aligned


def route(p: Dict, cfg: ArchConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 routing of x (B, S, d): ``(probs (B, S, E), gate (B, S, k),
    experts (B, S, k))``, the top k by probability with ties to the lower
    expert index (``jax.lax.top_k``'s order, which ``torch.topk`` does not
    promise: a stable descending sort gives it), the gates renormalised
    to sum to 1."""
    k = cfg.experts_per_token
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[..., :k], idx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, eidx


def apply_moe(p: Dict, cfg: ArchConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), the f32 Switch-style auxiliary loss).

    A decode batch (S = 1, B > 1) is regrouped first: its rows form
    groups of the first of 16, 8, 4, 2 that divides B, each routed as one
    row, so capacity amortises over the group as in the reference."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    if s == 1 and b > 1:
        g_rows = next((g for g in (16, 8, 4, 2) if b % g == 0), 1)
        if g_rows > 1:
            y, aux = apply_moe(p, cfg, x.reshape(b // g_rows, g_rows, d))
            return y.reshape(b, s, d), aux
    n = s * k                                   # dispatch entries per row
    cap = _capacity(cfg, s)
    dt = cfg.adtype

    probs, gate, eidx = route(p, cfg, x)
    me = probs.mean(dim=(0, 1))                               # (E,)
    # the mean of the entries' one-hot rows: each expert's count (exact
    # in float32) over the entries, with no (B, S, k, E) tensor and none
    # of one_hot's host-side range checks
    flat_e = eidx.reshape(b, n)
    ce = probs.new_zeros(e).scatter_add_(
        0, flat_e.reshape(-1), probs.new_ones(b * n)) / (b * n)
    aux = e * (me * ce).sum()

    # per-row sort-based dispatch: entry j of a row is (token j // k, its
    # (j % k)-th expert); a stable sort by expert keeps token order inside
    # each expert's group, and an entry's position in its group picks its
    # capacity slot
    order = torch.argsort(flat_e, dim=1, stable=True)         # (B, n)
    arange = torch.arange(n, device=x.device).expand(b, n)
    inv_order = torch.empty_like(order).scatter_(1, order, arange)
    sorted_e = flat_e.gather(1, order).contiguous()
    first_of = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_grp = arange - first_of
    slot = torch.where(pos_in_grp < cap, sorted_e * cap + pos_in_grp,
                       e * cap)                               # (B, n)
    # slot -> source token; every dropped entry goes to the one overflow
    # column e * cap.  Duplicate indices make a CUDA scatter's winner
    # arbitrary, which is harmless only because that column is cut off
    # below; every kept slot has exactly one entry.
    src_token = torch.full((b, e * cap + 1), s, dtype=torch.long,
                           device=x.device)
    src_token.scatter_(1, slot, order // k)
    x_pad = torch.cat([x.to(dt), x.new_zeros((b, 1, d), dtype=dt)], dim=1)
    buf = x_pad.gather(1, src_token[:, :e * cap, None].expand(-1, -1, d))
    buf = buf.reshape(b, e, cap, d)

    h = torch.einsum("becd,edf->becf", buf, p["wi"].to(dt))
    g = torch.einsum("becd,edf->becf", buf, p["wg"].to(dt))
    h = F.silu(g.float()).to(dt) * h
    y_e = torch.einsum("becf,efd->becd", h, p["wo"].to(dt))

    # combine: gather per entry, gate-weight, unsort, sum over k
    y_flat = torch.cat([y_e.reshape(b, e * cap, d),
                        y_e.new_zeros((b, 1, d))], dim=1)
    per_entry = y_flat.gather(1, slot[..., None].expand(-1, -1, d))
    gate_sorted = gate.reshape(b, n).gather(1, order)
    per_entry = per_entry * gate_sorted[..., None].to(dt)
    per_entry = per_entry.gather(1, inv_order[..., None].expand(-1, -1, d))
    y = per_entry.reshape(b, s, k, d).sum(dim=2)

    if cfg.n_shared_experts > 0:
        y = y + apply_mlp(p["shared"], cfg, x)
    return y, aux


__all__ = ["apply_moe", "init_moe", "route"]

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

Sharded (DTensors inside a rules context), the routing, the sort and the
dispatch run per batch shard through ``local_map`` (a row's dispatch is
local to the data shard that holds it, which is why the reference
dispatches a row at a time), the expert products are DTensor products
between the reference's annotations, and the auxiliary loss's means are
all-reduced.  Where the rules shard ``p_experts`` over an axis E does not
divide (60 experts over 16), E is padded to a multiple of the axis: the
weights and the (B, E, C, d) buffer get zero experts, whose outputs are
cut off before the combine, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .base import ArchConfig, scaled_normal
from .layers import apply_mlp, init_mlp, mlp_specs
from .sharding import (is_dtensor, local_call, mm, reshape, rule_axis_size,
                       shard, spec_placements)


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


def moe_specs(cfg: ArchConfig) -> Dict:
    s = {"router": ("p_embed", None),
         "wi": ("p_experts", "p_embed", "p_ffn"),
         "wg": ("p_experts", "p_embed", "p_ffn"),
         "wo": ("p_experts", "p_ffn", "p_embed")}
    if cfg.n_shared_experts > 0:
        s["shared"] = mlp_specs(cfg)
    return s


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
    logits = mm(x.float(), p["router"].float())
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
        if g_rows > 1 and is_dtensor(x):      # groups may span shards
            y, aux = apply_moe(p, cfg, reshape(x, (b // g_rows, g_rows, d)))
            return reshape(y, (b, s, d)), aux
        if g_rows > 1:
            y, aux = apply_moe(p, cfg, x.reshape(b // g_rows, g_rows, d))
            return y.reshape(b, s, d), aux
    n = s * k                                   # dispatch entries per row
    cap = _capacity(cfg, s)
    dt = cfg.adtype
    if is_dtensor(x):
        return _sharded_moe(p, cfg, x, cap)

    probs, gate, eidx = route(p, cfg, x)
    me = probs.mean(dim=(0, 1))                               # (E,)
    # the mean of the entries' one-hot rows: each expert's count (exact
    # in float32) over the entries, with no (B, S, k, E) tensor and none
    # of one_hot's host-side range checks
    flat_e = eidx.reshape(b, n)
    ce = probs.new_zeros(e).scatter_add_(
        0, flat_e.reshape(-1), probs.new_ones(b * n)) / (b * n)
    aux = e * (me * ce).sum()

    buf, slot, order, inv_order = _dispatch(flat_e, x, cap, e, k, dt)
    y_e = _experts(buf, p["wi"], p["wg"], p["wo"], dt)
    y = _combine(y_e, slot, gate.reshape(b, n).gather(1, order), inv_order,
                 k)

    if cfg.n_shared_experts > 0:
        y = y + apply_mlp(p["shared"], cfg, x)
    return y, aux


def _experts(buf, wi, wg, wo, dt):
    """The experts' SwiGLU over the capacity buffer (B, E, C, d) as
    batched products: (B, E, C, d)."""
    h = torch.einsum("becd,edf->becf", buf, wi.to(dt))
    g = torch.einsum("becd,edf->becf", buf, wg.to(dt))
    h = F.silu(g.float()).to(dt) * h
    return torch.einsum("becf,efd->becd", h, wo.to(dt))


def _dispatch(flat_e, x, cap: int, e: int, k: int, dt):
    """The (B, E, C, d) capacity buffer of x (B, S, d), routed by the
    entries' experts ``flat_e`` (B, S*k): ``(buf, slot, order,
    inv_order)``, each entry's slot (``E * C`` where dropped), the stable
    sort by expert and its inverse."""
    b, s, d = x.shape
    n = flat_e.shape[1]
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
    return buf.reshape(b, e, cap, d), slot, order, inv_order


def _combine(y_e, slot, gate_sorted, inv_order, k: int):
    """The experts' outputs y_e (B, E, C, d) back to the tokens: gather
    per entry, gate-weight (``gate_sorted``, the gates in sorted order),
    unsort, sum over the k entries of a token.  Returns (B, S, d)."""
    b, e, cap, d = y_e.shape
    y_flat = torch.cat([y_e.reshape(b, e * cap, d),
                        y_e.new_zeros((b, 1, d))], dim=1)
    per_entry = y_flat.gather(1, slot[..., None].expand(-1, -1, d))
    per_entry = per_entry * gate_sorted[..., None].to(y_e.dtype)
    per_entry = per_entry.gather(1, inv_order[..., None].expand(-1, -1, d))
    return per_entry.reshape(b, -1, k, d).sum(dim=2)


def _sharded_experts(buf, ws, dt):
    """The expert products per shard (``local_map``), laid out as the
    reference annotates the buffer and the hidden activation ``h`` ((B,
    E, C, f) by ``batch``, ``p_experts``, ``exp_cap``, ``ffn``): on a
    mesh axis that shards E the weights are split by expert; on one that
    shards f (``ffn``) they are split by f and the output is a partial
    sum; on every other axis they are gathered (FSDP), and their gradient
    is a partial sum over the axes that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = buf.device_mesh
    rep, part = Replicate(), Partial()
    cols = []       # per mesh dim: buf, wi/wg, wo, out, their gradients
    for j, pl in enumerate(_h_placements(buf, ws[0].shape[2])):
        p_ = part if mesh.size(j) > 1 else rep
        if pl == Shard(1):                      # experts split
            cols.append((pl, Shard(0), Shard(0), pl, Shard(0), Shard(0), pl))
        elif pl == Shard(3):                    # f split: partial output
            cols.append((rep, Shard(2), Shard(1), part, Shard(2), Shard(1),
                         p_))
        elif pl == rep:
            cols.append((rep,) * 7)
        else:                                   # tokens split
            cols.append((pl, rep, rep, pl, p_, p_, pl))
    buf_pl, w_in, w_out, out_pl, g_in, g_out, g_buf = zip(*cols)
    return local_call(lambda *a: _experts(*a, dt), out_pl,
                      (buf_pl, w_in, w_in, w_out), mesh,
                      in_grad_placements=(g_buf, g_in, g_in, g_out))(
        buf, *ws)


def _h_placements(buf, f: int):
    """The placements the reference's annotation of ``h`` (B, E, C, f)
    resolves to, for the buffer ``buf`` (B, E, C, d)."""
    from .sharding import _current, logical_spec, placements

    mesh, rules = _current()
    return placements(logical_spec(("batch", "p_experts", "exp_cap", "ffn"),
                                   tuple(buf.shape[:3]) + (f,), mesh, rules),
                      mesh)


def _sharded_moe(p: Dict, cfg: ArchConfig, x, cap: int):
    """``apply_moe`` on DTensors: the dispatch and the combine per batch
    shard (``local_map``), the expert products between the reference's
    annotations, E padded where ``p_experts`` shards an axis it does not
    divide."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n, dt, mesh = s * k, cfg.adtype, x.device_mesh
    x_pl = spec_placements(x, "batch", None, None)
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if pl == Shard(0) else Replicate() for pl in x_pl)

    def dispatch(x_, router):
        probs, gate, eidx = route({"router": router}, cfg, x_)
        flat_e = eidx.reshape(x_.shape[0], n)
        counts = probs.new_zeros(e).scatter_add_(
            0, flat_e.reshape(-1), probs.new_ones(flat_e.numel()))
        buf, slot, order, inv_order = _dispatch(flat_e, x_, cap, e, k, dt)
        gate_sorted = gate.reshape(x_.shape[0], n).gather(1, order)
        return (buf, slot, gate_sorted, inv_order, probs.sum(dim=(0, 1)),
                counts)

    buf, slot, gate_sorted, inv_order, prob_sum, counts = local_call(
        dispatch, (x_pl,) * 4 + (part, part), (x_pl, rep), mesh,
        in_grad_placements=(x_pl, part))(x, p["router"])
    aux = e * ((prob_sum / (b * s)) * (counts / (b * n))).sum()

    # expert parallelism: pad E up to a multiple of the p_experts axis
    ep = rule_axis_size("p_experts")
    e_pad = -(-e // ep) * ep if ep > 1 else e
    ws = [p[name].to(dt) for name in ("wi", "wg", "wo")]
    if e_pad != e:
        ws = [torch.cat([w, torch.zeros((e_pad - e,) + tuple(w.shape[1:]),
                                        dtype=dt, device=w.device.type)])
              for w in ws]
        buf = torch.cat([buf, torch.zeros((b, e_pad - e, cap, d), dtype=dt,
                                          device=buf.device.type)], dim=1)
    buf = shard(buf, "batch", "p_experts", "exp_cap", None)   # a2a in
    y_e = _sharded_experts(buf, ws, dt)
    y_e = shard(y_e, "batch", None, None, None)         # a2a out
    if e_pad != e:
        y_e = y_e[:, :e]
    y = local_call(lambda *a: _combine(*a, k), x_pl, (x_pl,) * 4, mesh)(
        y_e, slot, gate_sorted, inv_order)
    y = shard(y, "batch", "seq_sp", None)      # back to the SP residual
    if cfg.n_shared_experts > 0:
        y = y + apply_mlp(p["shared"], cfg, x)
    return y, aux


__all__ = ["apply_moe", "init_moe", "moe_specs", "route"]

"""GQA attention: full-sequence (prefill, training) on the flash-attention
kernels and one-token decode over a KV cache on the decode-attention
kernel.

The reference's jnp path and its Pallas path compute the same function;
the port always takes the kernels (``kernels.flash_attention``,
``kernels.decode_attention``), which compute in float32 throughout as the
Pallas kernels do, so in bf16 the port tracks the reference's
``use_pallas=True`` path most closely.  K/V keep their KV heads: the
kernels map q head h to kv head h // (H / KV) by index.

The KV cache is kv-major, (L, B, KV, S, hd), as in the reference, so a
layer's slice is already the decode kernel's (B, KV, S, hd).  Unlike the
reference's functional update, ``decode_attention`` writes the new K/V
into the cache in place (``index_copy_`` at a device index: no host
sync) and returns the same tensors.

The tailed decode (``decode_tail_window = W > 0``) writes each new K/V
into a small tail (L, B, KV, W, hd) instead, in place, and attends
``main[0:main_len] ++ tail[0:tail_len]`` inclusive under one softmax on
the decode kernel's tailed entry; ``flush_kv_tail`` moves a full tail
into the main cache every W steps.

Sharded (DTensor tensors inside a ``sharding.axis_rules`` context), each
kernel runs per shard through ``local_map``, so the kernels and their
wrappers see plain local tensors:

- the flash calls take q sharded by ``batch`` and ``heads``, K/V by
  ``batch`` and ``kv``.  Where the KV heads fall back to replication
  while q's heads stay sharded (8 kv heads over a 16-way model axis), a
  rank's local call reads the KV heads its own q heads belong to: global
  q head h reads kv head ``h // (H / KV)`` (what GSPMD does for the
  reference), and their gradients are partial sums over that axis;
- a decode writes the new K/V only on the rank that owns position
  ``cache_len`` of the cache's sequence (the write lands locally, never
  as a gather of the cache); over a cache sharded along its sequence
  (``cache_seq``), q is gathered over that axis, each rank attends its
  slice, and the slices merge by log-sum-exp rescaling (an all-reduce of
  the row max, then of the rescaled sums and outputs), as flash-decoding
  does.  Each rank's slice (and, tailed, its local tail) runs on the
  decode kernel's partial entry (``decode_attention_partial``), which
  returns the slice's f32 ``(m, l, acc)`` undivided.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                  decode_attention_partial,
                                                  decode_attention_tailed_fwd)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)

from .base import ArchConfig, scaled_normal
from .layers import Rope, rms_norm_headwise, rope_tables, rotate
from .sharding import (is_dtensor, local_call, mm, reshape, shard,
                       spec_placements)


def init_attention(cfg: ArchConfig, *,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": scaled_normal((d, h, hd), d, cfg.pdtype, generator=generator),
         "wk": scaled_normal((d, kv, hd), d, cfg.pdtype, generator=generator),
         "wv": scaled_normal((d, kv, hd), d, cfg.pdtype, generator=generator),
         "wo": scaled_normal((h, hd, d), h * hd, cfg.pdtype,
                             generator=generator)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=cfg.pdtype, device=generator.device)
        p["k_norm"] = torch.ones(hd, dtype=cfg.pdtype, device=generator.device)
    return p


def attention_specs(cfg: ArchConfig) -> Dict:
    s = {"wq": ("p_embed", "p_heads", None),
         "wk": ("p_embed", "p_kv", None),
         "wv": ("p_embed", "p_kv", None),
         "wo": ("p_heads", None, "p_embed")}
    if cfg.qk_norm:
        s["q_norm"] = (None,)
        s["k_norm"] = (None,)
    return s


def kv_cache_specs() -> Dict:
    return {"k": (None, "batch", "p_kv", "cache_seq", None),
            "v": (None, "batch", "p_kv", "cache_seq", None)}


def kv_tail_specs() -> Dict:
    return {"k": (None, "batch", "p_kv", None, None),
            "v": (None, "batch", "p_kv", None, None)}


def _proj(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x (B, S, d) @ w (d, heads, hd) -> (B, S, heads, hd)."""
    d, heads, hd = w.shape
    if is_dtensor(x):
        y = mm(x, reshape(w.to(dt), (d, heads * hd)))
        return reshape(y, tuple(y.shape[:-1]) + (heads, hd))
    return (x @ w.to(dt).reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def _qkv(p: Dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
         rope: Optional[Rope] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd), k/v (B, S, KV, hd) in the activation dtype, with
    qk-norm and RoPE applied.  ``rope`` (``layers.rope_tables`` of
    ``positions``) saves recomputing the tables in every layer."""
    dt = cfg.adtype
    q, k, v = (_proj(x, p[w], dt) for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])
    rope = rope_tables(positions, cfg) if rope is None else rope
    q, k = rotate(q, rope), rotate(k, rope)
    return (shard(q, "batch", None, "heads", None),
            shard(k, "batch", None, "kv", None),
            shard(v, "batch", None, "kv", None))


def _out(p: Dict, cfg: ArchConfig, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = p["wo"].shape
    if is_dtensor(o):
        return mm(reshape(o, tuple(o.shape[:-2]) + (h * hd,)),
                  reshape(p["wo"].to(cfg.adtype), (h * hd, d)))
    return o.flatten(-2) @ p["wo"].to(cfg.adtype).reshape(h * hd, d)


def attention_block(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True, *,
                    rope: Optional[Rope] = None) -> torch.Tensor:
    """Full-sequence attention (prefill and training) through the flash
    kernels.  x (B, S, d); positions (B, S).  Returns (B, S, d).

    ``flash_attention`` is the differentiable ``FlashAttention``: with
    gradients on, the backward kernel computes dq, dk and dv; under
    ``torch.no_grad()`` it is one forward launch, as before.  The forward
    and backward are read from this module at each call, so a caller can
    swap their plain versions in."""
    q, k, v = _qkv(p, cfg, x, positions, rope)
    out = shard(flash(q, k, v, causal), "batch", None, "heads", None)
    return shard(_out(p, cfg, out), "batch", "seq_sp", None)


def _flash_local(q, k, v, causal: bool, sel=None):
    """The flash call on local tensors q (B, S, H, hd), k/v (B, T, KV,
    hd), the KV heads first narrowed to ``sel`` (:func:`_kv_select`)."""
    k, v = _select_heads(k, 2, sel), _select_heads(v, 2, sel)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          fwd=flash_attention_fwd, bwd=flash_attention_bwd)
    return out.transpose(1, 2)


def flash(q, k, v, causal: bool = True):
    """Attention of q (B, S, H, hd) over k/v (B, T, KV, hd) on the flash
    kernels (differentiable); DTensors run it per (batch, heads) shard
    through ``local_map``."""
    if not is_dtensor(q):
        return _flash_local(q, k, v, causal)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    q_pl = spec_placements(q, "batch", None, "heads", None)
    kv_pl = list(spec_placements(k, "batch", None, "kv", None))
    grad_pl = list(kv_pl)
    for j, (a, b) in enumerate(zip(q_pl, kv_pl)):
        if a == Shard(2) and b != Shard(2):
            kv_pl[j] = grad_pl[j] = Replicate()
            if mesh.size(j) > 1:
                grad_pl[j] = Partial()   # each rank's heads' share
    sel = _kv_select(q, q_pl, tuple(kv_pl), k.shape[2])
    fn = local_call(lambda q_, k_, v_: _flash_local(q_, k_, v_, causal, sel),
                    q_pl, (q_pl, kv_pl, kv_pl), mesh,
                    in_grad_placements=(q_pl, grad_pl, grad_pl))
    return fn(q, k, v)


def _dim_offset(pl, mesh, dim: int, size: int) -> Tuple[int, int, bool]:
    """``(offset, local size, split)`` of tensor dim ``dim`` (global
    ``size``) on this rank under placements ``pl``: the mesh dims that
    shard it split it in mesh-dim order, the first the major one;
    ``split`` whether any of them holds more than one rank."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    idx, n, split = 0, 1, False
    for j, p in enumerate(pl):
        if p == Shard(dim):
            idx = idx * mesh.size(j) + coord[j]
            n *= mesh.size(j)
            split = split or mesh.size(j) > 1
    return idx * (size // n), size // n, split


def _kv_select(q, q_pl, kv_pl, n_kv: int):
    """The local KV heads this rank's q heads read, as a slice ``(lo,
    hi)`` or a list of indices (``None``: the local KV heads as they
    are).  Global q head h reads kv head ``h // (H / KV)``."""
    h = q.shape[2]
    h0, h_l, q_split = _dim_offset(q_pl, q.device_mesh, 2, h)
    k0, kv_l, _ = _dim_offset(kv_pl, q.device_mesh, 2, n_kv)
    if not q_split:
        return None
    grp = h // n_kv
    idx = [(h0 + j) // grp - k0 for j in range(h_l)]
    if kv_l * (h // h_l) == n_kv and idx == [j * kv_l // h_l
                                             for j in range(h_l)]:
        return None                      # kv sharded alongside q
    lo, hi = idx[0], idx[-1] + 1
    n = hi - lo
    if h_l % n == 0 and idx == [lo + j // (h_l // n) for j in range(h_l)]:
        return (lo, hi)
    return idx


def _select_heads(x, dim: int, sel):
    if sel is None:
        return x
    if isinstance(sel, tuple):
        return x.narrow(dim, sel[0], sel[1] - sel[0])
    return x.index_select(dim, torch.tensor(sel, device=x.device))


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, n_layers: int,
                  *, device=None) -> Dict[str, torch.Tensor]:
    """KV cache, kv-head-major (L, B, KV, S, hd), in the activation dtype,
    over ``n_layers`` attention layers (a hybrid model's are fewer than
    its layers)."""
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def decode_attention(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, positions: torch.Tensor, *,
                     rope: Optional[Rope] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x (B, 1, d); k/v_cache (B, KV, S, hd); cache_len
    an int32 tensor of one element on the device (the fill before this
    token); positions (B, 1).

    Writes the new token's K/V at ``cache_len`` in place (clamped to
    ``S - 1``, as the reference's ``dynamic_update_slice`` clamps) and
    attends to the first ``cache_len + 1`` entries.  Returns (y,
    k_cache, v_cache) with the caches the same tensors as given.
    """
    q, k_new, v_new = _qkv(p, cfg, x, positions, rope)
    if is_dtensor(q):
        k_cache = shard(k_cache, "batch", "p_kv", "cache_seq", None)
        v_cache = shard(v_cache, "batch", "p_kv", "cache_seq", None)
        o = _sharded_decode(q, k_new, v_new, (k_cache, v_cache), (),
                            cache_len, 0)
    else:
        b = x.shape[0]
        at = cache_len.reshape(1).clamp(max=k_cache.shape[2] - 1).long()
        k_cache.index_copy_(2, at, k_new.transpose(1, 2).to(k_cache.dtype))
        v_cache.index_copy_(2, at, v_new.transpose(1, 2).to(v_cache.dtype))
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        o = decode_attention_fwd(q.reshape(b, kv, cfg.n_heads // kv, hd),
                                 k_cache, v_cache, cache_len
                                 ).reshape(b, 1, cfg.n_heads, hd)
    y = shard(_out(p, cfg, o), "batch", None, None)
    return y, k_cache, v_cache


def _write_row(cache, new, at, offset: int = 0, split: bool = False):
    """Write ``new`` (B, KV, 1, hd) into ``cache`` (B, KV, S, hd) at
    position ``at`` (an int tensor of one element, clamped to ``S - 1``
    as ``dynamic_update_slice`` clamps).  A shard of a sequence-sharded
    cache (``split``, its first position ``offset``) writes only where it
    owns the position; elsewhere it writes the row it reads back."""
    s = cache.shape[2]
    if not split:
        cache.index_copy_(2, at.reshape(1).clamp(max=s - 1).long(),
                          new.to(cache.dtype))
        return
    local = at.reshape(1).long() - offset
    owns = (local >= 0) & (local < s)
    i = local.clamp(0, s - 1)
    row = torch.where(owns, new.to(cache.dtype), cache.index_select(2, i))
    cache.index_copy_(2, i, row)


def _merge(parts, groups):
    """Log-sum-exp merge of ``(m, l, acc)`` partials over the process
    groups ``groups`` (all-reduce of the max, then one of the rescaled
    sums and outputs together): the merged ``(m, l, acc)``."""
    import torch.distributed._functional_collectives as funcol

    m, l_, acc = parts
    for g in groups:
        mg = funcol.all_reduce(m, "max", g)
        scale = torch.exp(m - mg)
        both = torch.cat([acc * scale[..., None], (l_ * scale)[..., None]],
                         dim=-1)
        for_all = funcol.all_reduce(both, "sum", g)
        m, acc, l_ = mg, for_all[..., :-1], for_all[..., -1]
    return m, l_, acc


def _combine(parts_a, parts_b):
    """Two ``(m, l, acc)`` partials of one softmax -> its output (f32)."""
    (m1, l1, o1), (m2, l2, o2) = parts_a, parts_b
    m = torch.maximum(m1, m2)
    e1, e2 = torch.exp(m1 - m)[..., None], torch.exp(m2 - m)[..., None]
    denom = l1[..., None] * e1 + l2[..., None] * e2
    return (o1 * e1 + o2 * e2) / denom.clamp(min=1e-30)


def _sharded_decode(q, k_new, v_new, caches, tails, cache_len, window: int):
    """A decode step's write and attention per shard (``local_map``): q
    (B, 1, H, hd) and the new K/V (B, 1, KV, hd) DTensors (``None``: a
    read-only cache, whisper's cross K/V), ``caches`` the layer's (B, KV,
    S, hd) main K/V DTensors, ``tails`` its (B, KV, W, hd) tails (``()``
    untailed), ``cache_len`` the fill.  The writes go into the local
    shards in place; returns the output (B, 1, H, hd)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    c_pl = tuple(caches[0].placements)
    # the cache's layout (B, KV, S, hd) read onto q's (B, 1, H, hd) and the
    # new K/V's (B, 1, KV, hd): batch stays, kv heads shard q's heads, a
    # sequence shard gathers q
    to_q = {Shard(0): Shard(0), Shard(1): Shard(2)}
    q_pl = list(spec_placements(q, "batch", None, "heads", None))
    for j, p in enumerate(c_pl):
        if not (p == Replicate() and q_pl[j] == Shard(2)):
            q_pl[j] = to_q.get(p, Replicate())
    q_pl = tuple(q_pl)
    new_pl = tuple(to_q.get(p, Replicate()) for p in c_pl)
    t_pl = tuple(tails[0].placements) if tails else ()
    s_total = caches[0].shape[2]
    off, _, split = _dim_offset(c_pl, mesh, 2, s_total)
    seq_groups = [(mesh, j) for j, p in enumerate(c_pl)
                  if p == Shard(2) and mesh.size(j) > 1]
    sel = _kv_select(q, q_pl, new_pl, caches[0].shape[1])
    write = k_new is not None

    def local(q_, clen, *bufs):
        b, _, h, hd = q_.shape
        if write:
            kn, vn, *bufs = bufs
            kn, vn = kn.transpose(1, 2), vn.transpose(1, 2)
        kc, vc = bufs[0], bufs[1]
        kt, vt = (bufs[2], bufs[3]) if window else (None, None)
        if write and window:
            at = clen.reshape(1).remainder(window)
            _write_row(kt, kn, at)
            _write_row(vt, vn, at)
        elif write:
            _write_row(kc, kn, clen, off, split)
            _write_row(vc, vn, clen, off, split)
        kc, vc = _select_heads(kc, 1, sel), _select_heads(vc, 1, sel)
        kv = kc.shape[1]
        q4 = q_.reshape(b, kv, h // kv, hd)
        if not split:
            o = (decode_attention_tailed_fwd(
                q4, kc, vc, _select_heads(kt, 1, sel),
                _select_heads(vt, 1, sel), clen, window) if window
                 else decode_attention_fwd(q4, kc, vc, clen))
            return o.reshape(b, 1, h, hd)
        if window:
            main_len = (clen.reshape(()) // window) * window
            fill = main_len - 1 - off
        else:
            fill = clen.reshape(()) - off
        m, l_, acc = _merge(decode_attention_partial(q4, kc, vc, fill),
                            seq_groups)
        if window:
            tail = decode_attention_partial(
                q4, _select_heads(kt, 1, sel), _select_heads(vt, 1, sel),
                clen.reshape(()) - main_len)
            o = _combine((m, l_, acc), tail)
        else:
            o = acc / l_.clamp(min=1e-30)[..., None]
        return o.to(q_.dtype).reshape(b, 1, h, hd)

    news = (k_new, v_new) if write else ()
    in_pl = ((q_pl, (Replicate(),) * mesh.ndim) + (new_pl,) * len(news)
             + (c_pl,) * len(caches) + (t_pl,) * len(tails))
    return local_call(local, q_pl, in_pl, mesh)(q, cache_len, *news,
                                                *caches, *tails)


# ---------------------------------------------------------------------------
# tailed decode (block-buffered writes)
# ---------------------------------------------------------------------------


def init_kv_tail(cfg: ArchConfig, batch: int, window: int, n_layers: int,
                 *, device=None) -> Dict[str, torch.Tensor]:
    """The tailed decode's write buffer, (L, B, KV, W, hd) in the
    activation dtype: kv-major like the cache, so a layer's slice is the
    kernel's tail and the flush a copy along the sequence axis."""
    shape = (n_layers, batch, cfg.n_kv_heads, window, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def decode_attention_tailed(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                            k_main: torch.Tensor, v_main: torch.Tensor,
                            k_tail: torch.Tensor, v_tail: torch.Tensor,
                            cache_len: torch.Tensor, positions: torch.Tensor,
                            *, rope: Optional[Rope] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One-token decode with a tail.  x (B, 1, d); k/v_main (B, KV, S, hd),
    read only; k/v_tail (B, KV, W, hd); cache_len an int32 tensor of one
    element on the device; positions (B, 1) or (3, B, 1).

    With ``main_len = (cache_len // W) * W`` and ``tail_len = cache_len -
    main_len`` (both on the device: the step never syncs the host), writes
    the new token's K/V at ``tail[tail_len]`` in place and attends
    ``main[0:main_len]`` and ``tail[0:tail_len]`` inclusive under one
    softmax.  Returns (y, k_tail, v_tail), the tails the same tensors."""
    b, w = x.shape[0], cfg.decode_tail_window
    q, k_new, v_new = _qkv(p, cfg, x, positions, rope)
    if is_dtensor(q):
        o = _sharded_decode(q, k_new, v_new, (k_main, v_main),
                            (k_tail, v_tail), cache_len, w)
        return shard(_out(p, cfg, o), "batch", None, None), k_tail, v_tail
    at = cache_len.reshape(1).remainder(w).long()
    k_tail.index_copy_(2, at, k_new.transpose(1, 2).to(k_tail.dtype))
    v_tail.index_copy_(2, at, v_new.transpose(1, 2).to(v_tail.dtype))
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    o = decode_attention_tailed_fwd(q.reshape(b, kv, cfg.n_heads // kv, hd),
                                    k_main, v_main, k_tail, v_tail,
                                    cache_len, w)
    y = _out(p, cfg, o.reshape(b, 1, cfg.n_heads, hd))
    return shard(y, "batch", None, None), k_tail, v_tail


def flush_kv_tail(cfg: ArchConfig, state: Dict) -> Dict:
    """Move a full tail (W rows) into the main cache at ``cache_len - W``,
    then zero the tail; in place, on the device (no host sync: a CUDA
    graph can hold it).  The start is placed as the reference's
    ``dynamic_update_slice`` places it: a negative start counts from the
    cache's end, then it is clamped into the cache.  Call when
    ``cache_len % W == 0`` and ``cache_len > 0``.  Returns the state, its
    tensors the same."""
    w = cfg.decode_tail_window
    kv, tail = state["kv"], state["tail"]
    s = kv["k"].shape[3]
    if not 0 < w <= s:
        raise ValueError(f"flush_kv_tail: window {w} must be in 1..{s}, the "
                         f"cache's length")
    dst = state["cache_len"].reshape(1).long() - w
    dst = torch.where(dst < 0, dst + s, dst).clamp(0, s - w)
    if is_dtensor(kv["k"]):
        _sharded_flush(kv, tail, dst, w)
        return state
    idx = dst + torch.arange(w, device=dst.device)
    for name in ("k", "v"):
        kv[name].index_copy_(3, idx, tail[name])
        tail[name].zero_()
    return state


def _sharded_flush(kv: Dict, tail: Dict, dst, w: int) -> None:
    """The flush per shard: each rank of a sequence-sharded main cache
    writes the tail's rows into its own slice where it owns them (a
    window of W rows starting at a multiple of W lies in one slice when
    W divides the slice) and writes back the rows it reads elsewhere."""
    from torch.distributed.tensor import Replicate

    mesh = kv["k"].device_mesh
    c_pl, t_pl = tuple(kv["k"].placements), tuple(tail["k"].placements)
    s = kv["k"].shape[3]
    off, s_l, split = _dim_offset(c_pl, mesh, 3, s)
    if split and s_l % w:
        raise ValueError(f"flush_kv_tail: window {w} does not divide the "
                         f"cache's shard of {s_l} positions")

    def local(dst_, kc, vc, kt, vt):
        start = dst_.reshape(1) - off
        owns = (start >= 0) & (start < s_l)
        idx = start.clamp(0, s_l - w) + torch.arange(w, device=kc.device)
        for c, t in ((kc, kt), (vc, vt)):
            rows = torch.where(owns, t, c.index_select(3, idx)) if split else t
            c.index_copy_(3, idx, rows)
            t.zero_()
        return dst_

    rep = (Replicate(),) * mesh.ndim
    local_call(local, rep, (rep, c_pl, c_pl, t_pl, t_pl), mesh)(
        dst, kv["k"], kv["v"], tail["k"], tail["v"])

"""Plain PyTorch oracles shared by the kernels' plain versions."""
from __future__ import annotations

import torch


def select_slot_ref(loads, w, k, capacity, *, strategy: str = "best"):
    """Fit-strategy selection over rows: loads f32[N, M]; w, k, capacity
    [N].  Returns i32[N]: the chosen slot (ties to the lowest), or ``M``
    when nothing fits."""
    n, m = loads.shape
    idx = torch.arange(m, device=loads.device)
    fits = (idx[None, :] < k[:, None]) & (loads + w[:, None]
                                          <= capacity[:, None])
    inf = float("inf")      # a Python scalar: no host-to-device copy
    if strategy == "first":
        best = torch.where(fits, idx[None, :].float(), inf).argmin(1)
    elif strategy == "best":
        # max load among fitting slots, lowest slot on a tie
        score = torch.where(fits, loads, -inf)
        best = torch.where(score == score.amax(1, keepdim=True), idx,
                           m).amin(1)
    elif strategy == "worst":
        score = torch.where(fits, loads, inf)
        best = torch.where(score == score.amin(1, keepdim=True), idx,
                           m).amin(1)
    else:
        raise ValueError(strategy)
    return torch.where(fits.any(1), best, m).to(torch.int32)


NEG_INF = -1e30


def attention_scores(q, k, *, causal: bool = True):
    """Scaled, masked scores in float32: (B, KV, G*Sq, Skv), the G = H /
    KV query heads of a group stacked over one kv head, ``NEG_INF`` where
    ``causal`` masks ``k_pos > q_pos`` (absolute positions)."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, (h // kvh) * sq, hd)
    s = (qg @ k.float().transpose(-1, -2)) * hd ** -0.5
    if causal:
        q_pos = torch.arange(sq, device=q.device).repeat(h // kvh)
        mask = q_pos[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    return s


def attention_ref(q, k, v, *, causal: bool = True, return_lse: bool = False):
    """Full-softmax attention in float32.  q: (B, H, Sq, hd); k/v: (B, KV,
    Skv, hd) with H % KV == 0, q head h reading kv head h // (H / KV) (the
    G query heads of a group share one matrix product: nothing is
    repeated).  ``causal`` masks ``k_pos > q_pos`` by absolute position.
    Returns (B, H, Sq, hd) in q.dtype; with ``return_lse`` also each
    row's logsumexp of the scaled, masked scores, (B, H, Sq) float32
    (natural log)."""
    b, h, sq, hd = q.shape
    s = attention_scores(q, k, causal=causal)          # (B, KV, G*Sq, Skv)
    o = (torch.softmax(s, dim=-1) @ v.float()).reshape(b, h, sq, hd).to(
        q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def decode_attention_ref(q, k_cache, v_cache, cache_len):
    """One query token per sequence against a cache, in float32.  q: (B, KV,
    G, hd); caches: (B, KV, S, hd); ``cache_len`` an int or an integer
    tensor of one element (on q's device): positions ``[0, cache_len]``
    are attended.  Returns (B, KV, G, hd) in q.dtype."""
    hd, s_len = q.shape[-1], k_cache.shape[2]
    s = (q.float() @ k_cache.float().transpose(-1, -2)) * hd ** -0.5
    if torch.is_tensor(cache_len):
        cache_len = cache_len.reshape(())
    valid = torch.arange(s_len, device=q.device) <= cache_len
    s = torch.where(valid, s, NEG_INF)
    o = torch.softmax(s, dim=-1) @ v_cache.float()
    return o.to(q.dtype)


def decode_attention_partial_ref(q, k, v, fill):
    """One shard's part of a decode over a cache split along its sequence
    (flash-decoding): q (B, KV, G, hd) over the shard's K/V (B, KV, S_l,
    hd), positions ``0 .. fill`` of the shard attended (``fill`` an int
    or an integer tensor of one element; below 0 none is).  Returns the
    float32 ``(m, l, acc)``: the row max (B, KV, G) of the masked scores
    (``NEG_INF`` where none is attended), the sum of ``exp(s - m)`` and
    the unnormalised output (B, KV, G, hd), which shards merge by
    log-sum-exp rescaling."""
    hd, s_len = q.shape[-1], k.shape[2]
    if torch.is_tensor(fill):
        fill = fill.reshape(())
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    valid = torch.arange(s_len, device=q.device) <= fill
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), p @ v.float()


def decode_attention_tailed_ref(q, k_main, v_main, k_tail, v_tail,
                                cache_len, window: int):
    """The tailed decode's attention in float32, the reference's two-part
    online-softmax merge (``decode_attention_tailed`` in
    ``src/repro/models/attention.py``): q (B, KV, G, hd) over
    ``main[0:main_len]`` (caches (B, KV, S, hd)) and ``tail[0:tail_len]``
    inclusive (tails (B, KV, W, hd)), with ``main_len = (cache_len // W)
    * W`` and ``tail_len = cache_len - main_len``; each part masked with
    ``NEG_INF`` (finite, as the reference's: an empty main part gets the
    weight ``exp(NEG_INF - m) = 0`` in the merge).  ``cache_len`` an int
    or an integer tensor of one element.  Returns (B, KV, G, hd) in
    q.dtype."""
    hd, s_len = q.shape[-1], k_main.shape[2]
    if torch.is_tensor(cache_len):
        cache_len = cache_len.reshape(())
    main_len = (cache_len // window) * window
    tail_len = cache_len - main_len
    qf = q.float()

    def part(k, v, valid):
        s = (qf @ k.float().transpose(-1, -2)) * hd ** -0.5
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        return m, p.sum(-1), p @ v.float()

    m1, l1, o1 = part(k_main, v_main,
                      torch.arange(s_len, device=q.device) < main_len)
    m2, l2, o2 = part(k_tail, v_tail,
                      torch.arange(window, device=q.device) <= tail_len)
    m = torch.maximum(m1, m2)
    e1, e2 = torch.exp(m1 - m)[..., None], torch.exp(m2 - m)[..., None]
    denom = l1[..., None] * e1 + l2[..., None] * e2
    return ((o1 * e1 + o2 * e2) / denom.clamp(min=1e-30)).to(q.dtype)


def rwkv6_wkv_ref(r, k, v, w, u, s0):
    """The RWKV-6 WKV recurrence, a sequential loop over T, all float32.
    r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd), indexed
    (k index, v index).  Per step, with kv = k_tᵀ v_t:

        o_t = r_t (S + u ⊙ kv)        (summed over the k index)
        S  <- w_t ⊙_rows S + kv

    Returns ``(out (B, T, H, hd), s_last (B, H, hd, hd))``."""
    s = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B, H, hd, hd)
        outs.append((r[:, t, :, :, None] * (s + u[None, :, :, None] * kv)
                     ).sum(-2))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, 1), s

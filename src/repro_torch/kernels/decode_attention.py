"""Decode attention (one new token per sequence against a KV cache): a
CUDA kernel and its plain version.

``decode_attention_fwd(q, k_cache, v_cache, cache_len)`` with q (B, KV,
G, hd) -- the G query heads of each kv group together -- and caches (B,
KV, S, hd), the layer slice of the model's kv-major cache.  Positions
``0 .. cache_len`` (inclusive: the new token's K/V is already written at
``cache_len``) are attended.  The result is (B, KV, G, hd) in q's dtype,
computed in float32 throughout, as the Pallas kernel does.  The kernel
splits the cache over several blocks and merges their partial softmaxes
by log-sum-exp rescaling; ``decode_splits`` picks the split count.

``decode_attention_plain`` is the plain PyTorch version (the CPU path,
and the yardstick the kernel is held against on the card): the
full-softmax ``ref.decode_attention_ref``.

``decode_attention_tailed_fwd(q, k_main, v_main, k_tail, v_tail,
cache_len, window)`` is the tailed decode's call (``decode_tail_window >
0``): q over ``main[0:main_len] ++ tail[0:tail_len]`` inclusive under one
softmax, ``main_len = (cache_len // W) * W``.  The same kernel runs it
(its own entry points); ``decode_attention_tailed_plain`` is
``ref.decode_attention_tailed_ref``, the reference's two-part merge.

``decode_attention_partial(q, k, v, fill)`` is one shard's part of a
decode over a cache sharded along its sequence: the f32 row max, sum and
unnormalised output that the shards merge by log-sum-exp rescaling
(``models.attention``).  The same kernel runs it (its partial entry
points: the merge of its splits writes ``(m, l, acc)`` undivided);
``decode_attention_partial_plain`` is ``ref.decode_attention_partial_ref``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import check_attention_inputs
from .ref import (decode_attention_partial_ref, decode_attention_ref,
                  decode_attention_tailed_ref)

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
_TAILED_ENTRY = {torch.float32: "decode_attention_tailed_f32",
                 torch.bfloat16: "decode_attention_tailed_bf16"}
_PARTIAL_ENTRY = {torch.float32: "decode_attention_partial_f32",
                  torch.bfloat16: "decode_attention_partial_bf16"}


#: the plain version: masked softmax over the whole cache in float32
decode_attention_plain = decode_attention_ref
#: the tailed call's plain version: the reference's two-part merge in f32
decode_attention_tailed_plain = decode_attention_tailed_ref
#: one shard's (m, l, acc) in f32: the masked scores' max, exp-sum, P @ V
decode_attention_partial_plain = decode_attention_partial_ref

#: blocks a decode call aims for: two on each of the H100's 132 SMs
SPLIT_BLOCKS = 2 * 132
#: positions a split holds at least, at a full cache
MIN_SPLIT = 32


def decode_splits(b: int, kvh: int, s: int) -> int:
    """Blocks that share one (batch row, kv head)'s cache: enough for
    ``SPLIT_BLOCKS`` blocks in all, at most one per ``MIN_SPLIT``
    positions of the cache (so at least 1 and at most ``s``).  It depends
    on the shapes alone, never on the fill, so one captured call replays
    at any ``cache_len``."""
    return max(1, min(math.ceil(SPLIT_BLOCKS / (b * kvh)),
                      math.ceil(s / MIN_SPLIT)))


@_build.counted
def decode_attention_fwd(q, k_cache, v_cache, cache_len):
    """q (B, KV, G, hd); caches (B, KV, S, hd); ``cache_len`` an int32
    tensor of one element on q's device (or an int, copied there).
    Returns (B, KV, G, hd) in q.dtype.

    Replaces the Pallas kernel ``src/repro/kernels/decode_attention.py``
    (``decode_attention_fwd`` over ``_decode_kernel``).  The kernel reads
    ``cache_len`` from device memory, so a decode step never syncs the
    host.  On the H100 it is bound by bytes: the ``cache_len + 1`` K and
    V rows read once.  Each (batch row, kv head)'s cache is split over
    ``decode_splits(B, KV, S)`` blocks, each taking an equal share of the
    filled positions with the next tile in flight (``cp.async``) while it
    computes; each writes an f32 partial (m, l, acc), and a second kernel
    merges them (see ``csrc/decode_attention.cu``).  A call is two
    launches and counts one.  The partials live in the same allocation as
    the output.

    CPU tensors run ``decode_attention_plain``; CUDA tensors launch the
    kernel or raise.
    """
    b, kvh, g, hd = q.shape
    s = k_cache.shape[2]
    if k_cache.shape != (b, kvh, s, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: want q (B, KV, G, hd) and "
                         f"caches (B, KV, S, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    check_attention_inputs(q, k_cache, v_cache, what="decode_attention")
    clen = _clen(cache_len, q, "decode_attention")
    out, ws, splits = _alloc(q, s)
    _build.launch(_ENTRY[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), clen.data_ptr(), out.data_ptr(), ws, b,
                  kvh, g, s, hd, splits,
                  _build.stream_ptr(q.device))
    decode_attention_fwd.launches += 1
    return out


def _clen(cache_len, q, what: str) -> torch.Tensor:
    """``cache_len`` as an int32 tensor of one element on q's device (the
    caller keeps it until the launch is queued)."""
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.numel() != 1:
        raise ValueError(f"{what}: cache_len must hold one value; got shape "
                         f"{tuple(clen.shape)}")
    return clen.to(torch.int32).contiguous()


def _alloc(q, s: int):
    """``(out, the address of the f32 partials, splits)`` for a decode
    call over a cache of ``s`` positions: one allocation, the output, then
    the partials 16-byte aligned."""
    b, kvh, g, hd = q.shape
    splits = decode_splits(b, kvh, s)
    size = q.element_size()
    ws_at = -(-q.numel() * size // 16) * 16
    ws_bytes = 4 * b * kvh * splits * g * (hd + 2)
    buf = torch.empty(-(-(ws_at + ws_bytes) // size), dtype=q.dtype,
                      device=q.device)
    return buf.as_strided(q.shape, q.stride()), buf.data_ptr() + ws_at, splits


def _alloc_partial(q, s: int):
    """``(m, l, acc, the address of the f32 partials, splits)`` for a
    partial call over a shard of ``s`` positions: one f32 allocation, acc,
    m and l, then the partials 16-byte aligned."""
    b, kvh, g, hd = q.shape
    splits = decode_splits(b, kvh, s)
    rows = b * kvh * g
    ws_at = -(-rows * (hd + 2) // 4) * 4
    buf = torch.empty(ws_at + rows * splits * (hd + 2), dtype=torch.float32,
                      device=q.device)
    acc = buf[:rows * hd].view(b, kvh, g, hd)
    m = buf[rows * hd:rows * (hd + 1)].view(b, kvh, g)
    l_ = buf[rows * (hd + 1):rows * (hd + 2)].view(b, kvh, g)
    return m, l_, acc, buf.data_ptr() + 4 * ws_at, splits


@_build.counted
def decode_attention_partial(q, k, v, fill):
    """One shard's part of a decode over a cache sharded along its
    sequence: q (B, KV, G, hd) over the shard's K/V (B, KV, S_l, hd),
    positions ``0 .. fill`` of the shard attended (``fill`` an int32
    tensor of one element on q's device, or an int; below 0 none is, at
    ``S_l`` or above all are).  Returns the float32 ``(m, l, acc)``: the
    row max (B, KV, G) of the scaled scores (``ref.NEG_INF``, finite,
    where none is attended), the sum of ``exp(s - m)`` and the
    unnormalised output (B, KV, G, hd), which the shards merge by
    log-sum-exp rescaling.

    Replaces the reference's jnp ``decode_attention`` under GSPMD with its
    K/V sharded along ``cache_seq`` (``src/repro/models/attention.py:263``),
    which has no Pallas kernel: the decode kernel
    (``csrc/decode_attention.cu``) runs it through its partial entry
    points, ``fill`` read on the card (no host sync: a step replays in a
    CUDA graph), its splits merged into the shard's ``(m, l, acc)``
    without the division.  Bound by bytes, as the whole-cache call.  A
    call is two launches and counts one.

    CPU tensors run ``decode_attention_partial_plain``; CUDA tensors launch
    the kernel or raise.
    """
    b, kvh, g, hd = q.shape
    s = k.shape[2]
    if k.shape != (b, kvh, s, hd) or v.shape != k.shape or s < 1:
        raise ValueError(f"decode_attention_partial: want q (B, KV, G, hd) "
                         f"and a shard's K/V (B, KV, S_l, hd), S_l >= 1; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return decode_attention_partial_plain(q, k, v, fill)
    what = "decode_attention_partial"
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_attention_inputs(q, k, v, what=what)
    fill = _clen(fill, q, what)
    m, l_, acc, ws, splits = _alloc_partial(q, s)
    _build.launch(_PARTIAL_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), fill.data_ptr(), m.data_ptr(), l_.data_ptr(),
                  acc.data_ptr(), ws, b, kvh, g, s, hd, splits,
                  _build.stream_ptr(q.device))
    decode_attention_partial.launches += 1
    return m, l_, acc


@_build.counted
def decode_attention_tailed_fwd(q, k_main, v_main, k_tail, v_tail,
                                cache_len, window: int):
    """The tailed decode's attention: q (B, KV, G, hd); caches (B, KV, S,
    hd); tails (B, KV, W, hd) with ``W = window``; ``cache_len`` an int32
    tensor of one element on q's device (or an int).  Attends
    ``main[0:main_len]`` and ``tail[0:tail_len]`` inclusive, ``main_len =
    (cache_len // W) * W`` and ``tail_len = cache_len - main_len`` (the new
    token's K/V already written at ``tail[tail_len]``).  Returns (B, KV,
    G, hd) in q.dtype.

    Replaces the reference's jnp ``decode_attention_tailed``
    (``src/repro/models/attention.py:185``), which has no Pallas kernel:
    the decode kernel (``csrc/decode_attention.cu``) runs it through its
    tailed entry points, the splits taking equal shares of the joined
    ``main_len + tail_len + 1`` positions; ``main_len`` and ``tail_len``
    are computed on the card from ``cache_len``, so a step never syncs
    the host and replays in a CUDA graph across flushes.  Bound by bytes,
    as the untailed call.  A call is two launches and counts one.

    CPU tensors run ``decode_attention_tailed_plain``; CUDA tensors launch
    the kernel or raise.
    """
    b, kvh, g, hd = q.shape
    s = k_main.shape[2]
    want = ((b, kvh, s, hd), (b, kvh, s, hd), (b, kvh, window, hd),
            (b, kvh, window, hd))
    got = tuple(tuple(x.shape) for x in (k_main, v_main, k_tail, v_tail))
    if window < 1 or got != want:
        raise ValueError(f"decode_attention_tailed: want q (B, KV, G, hd), "
                         f"caches (B, KV, S, hd) and tails (B, KV, W, hd) "
                         f"with W = window >= 1; got q {tuple(q.shape)}, "
                         f"{got}, window {window}")
    if q.device.type == "cpu":
        return decode_attention_tailed_plain(q, k_main, v_main, k_tail,
                                             v_tail, cache_len, window)
    what = "decode_attention_tailed"
    q = q.contiguous()
    k_main, v_main = k_main.contiguous(), v_main.contiguous()
    k_tail, v_tail = k_tail.contiguous(), v_tail.contiguous()
    check_attention_inputs(q, k_main, v_main, k_tail, v_tail, what=what)
    clen = _clen(cache_len, q, what)
    out, ws, splits = _alloc(q, s)
    _build.launch(_TAILED_ENTRY[q.dtype], q.data_ptr(), k_main.data_ptr(),
                  v_main.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
                  clen.data_ptr(), out.data_ptr(), ws, b, kvh, g, s, window,
                  hd, splits, _build.stream_ptr(q.device))
    decode_attention_tailed_fwd.launches += 1
    return out

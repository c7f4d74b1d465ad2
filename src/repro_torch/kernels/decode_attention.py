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
"""
from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import check_attention_inputs
from .ref import decode_attention_ref

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}


#: the plain version: masked softmax over the whole cache in float32
decode_attention_plain = decode_attention_ref

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
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.numel() != 1:
        raise ValueError(f"decode_attention: cache_len must hold one value; "
                         f"got shape {tuple(clen.shape)}")
    clen = clen.to(torch.int32).contiguous()
    splits = decode_splits(b, kvh, s)
    # one allocation: the output, then the f32 partials 16-byte aligned
    size = q.element_size()
    ws_at = -(-q.numel() * size // 16) * 16
    ws_bytes = 4 * b * kvh * splits * g * (hd + 2)
    buf = torch.empty(-(-(ws_at + ws_bytes) // size), dtype=q.dtype,
                      device=q.device)
    out = buf.as_strided(q.shape, q.stride())
    _build.launch(_ENTRY[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), clen.data_ptr(), out.data_ptr(),
                  buf.data_ptr() + ws_at, b, kvh, g, s, hd, splits,
                  _build.stream_ptr(q.device))
    decode_attention_fwd.launches += 1
    return out

"""Decode attention (one new token per sequence against a KV cache): a
CUDA kernel and its plain version.

``decode_attention_fwd(q, k_cache, v_cache, cache_len)`` with q (B, KV,
G, hd) -- the G query heads of each kv group together -- and caches (B,
KV, S, hd), the layer slice of the model's kv-major cache.  Positions
``0 .. cache_len`` (inclusive: the new token's K/V is already written at
``cache_len``) are attended.  The result is (B, KV, G, hd) in q's dtype,
computed in float32 throughout, as the Pallas kernel does.

``decode_attention_plain`` is the plain PyTorch version (the CPU path,
and the yardstick the kernel is held against on the card): the
full-softmax ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import torch

from . import _build
from .flash_attention import check_attention_inputs
from .ref import decode_attention_ref

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}


#: the plain version: masked softmax over the whole cache in float32
decode_attention_plain = decode_attention_ref


@_build.counted
def decode_attention_fwd(q, k_cache, v_cache, cache_len):
    """q (B, KV, G, hd); caches (B, KV, S, hd); ``cache_len`` an int32
    tensor of one element on q's device (or an int, copied there).
    Returns (B, KV, G, hd) in q.dtype.

    Replaces the Pallas kernel ``src/repro/kernels/decode_attention.py``
    (``decode_attention_fwd`` over ``_decode_kernel``).  The kernel reads
    ``cache_len`` from device memory, so a decode step never syncs the
    host.  On the H100 it is bound by bytes: the ``cache_len + 1`` K and
    V rows read once.  The simple design is one block per (kv head, batch
    row), tiles of 64 positions staged in shared memory; see
    ``csrc/decode_attention.cu``.

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
    out = torch.empty_like(q)
    _build.launch(_ENTRY[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), clen.data_ptr(), out.data_ptr(), b, kvh,
                  g, s, hd, _build.stream_ptr(q.device))
    decode_attention_fwd.launches += 1
    return out

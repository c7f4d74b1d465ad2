"""The RWKV-6 WKV recurrence: a CUDA kernel, its plain version and the
chunked entry point.

``rwkv6_wkv_fwd(r, k, v, w, u, s0)`` with r, k, v, w (B, T, H, hd), u
(H, hd) and s0 (B, H, hd, hd), all float32; w is the per-step decay in
(0, 1) (already ``exp(-exp(.))``).  Per step, with kv = k_tᵀ v_t:
``o_t = r_t (S + u ⊙ kv)`` and ``S <- w_t ⊙_rows S + kv``.  Returns
``(out (B, T, H, hd), s_last (B, H, hd, hd))``.

``rwkv6_wkv_plain`` is the plain PyTorch version (the CPU path, and the
yardstick the kernel is held against on the card): the sequential loop
``ref.rwkv6_wkv_ref``.  ``rwkv6_wkv`` is the counterpart of the
reference's chunked wrapper (``repro.kernels.ops.rwkv6_wkv``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import rwkv6_wkv_ref

#: head sizes the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: the reference wrapper's default chunk (its VMEM budget)
CHUNK = 4096


def rwkv6_wkv_plain(r, k, v, w, u, s0, s_last=None):
    """``ref.rwkv6_wkv_ref``; a given ``s_last`` receives the last state
    (it may be ``s0``) and is returned."""
    out, s = rwkv6_wkv_ref(r, k, v, w, u, s0)
    return out, (s if s_last is None else s_last.copy_(s))


def _check(r, k, v, w, u, s0, s_last) -> None:
    b, t, h, hd = r.shape
    if (t < 1 or any(x.shape != r.shape for x in (k, v, w))
            or u.shape != (h, hd) or s0.shape != (b, h, hd, hd)
            or (s_last is not None and s_last.shape != s0.shape)):
        raise ValueError(
            f"rwkv6_wkv: want r, k, v, w (B, T >= 1, H, hd), u (H, hd) and "
            f"s0 (B, H, hd, hd); got {[tuple(x.shape) for x in (r, k, v, w)]}"
            f", {tuple(u.shape)}, {tuple(s0.shape)}"
            + ("" if s_last is None else f", s_last {tuple(s_last.shape)}"))
    ins = (r, k, v, w, u, s0) + (() if s_last is None else (s_last,))
    for x in ins:
        if x.dtype != torch.float32 or x.device != r.device:
            raise ValueError(f"rwkv6_wkv: every input must be float32 on "
                             f"r's device ({r.device}); got {x.dtype}, "
                             f"{x.device}")


def _aligned(x):
    """x contiguous and on a 16-byte boundary (the kernel's bulk copies and
    float4 accesses need both), copied only where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@_build.counted
def rwkv6_wkv_fwd(r, k, v, w, u, s0, s_last: Optional[torch.Tensor] = None):
    """r, k, v, w (B, T, H, hd); u (H, hd); s0 (B, H, hd, hd); all float32.
    Returns ``(out, s_last)``.  A given ``s_last`` (contiguous, the shape of
    s0; it may be s0 itself) receives the last state in place.

    Replaces the Pallas kernel ``src/repro/kernels/rwkv6_scan.py``
    (``rwkv6_wkv_fwd`` over ``_wkv_kernel``), at any T >= 1 (no chunking
    is needed: the state never leaves the SM).  On the H100 both the
    prefill's call and a decode step's are bound by bytes (the streams;
    the state).
    The state's columns are split over one-warp blocks (4 a head at hd =
    64) and its rows over the lanes of a warp (8 rows and 4 columns a
    lane, partial outputs summed by shuffles); the step rows of r, k, v,
    w stream in through a three-stage ring of bulk copies; see
    ``csrc/rwkv6_wkv.cu``.  Every tensor must start on a 16-byte boundary
    (an input that does not is copied; an ``s_last`` that does not
    raises).

    CPU tensors run ``rwkv6_wkv_plain``; CUDA tensors launch the kernel or
    raise.
    """
    _check(r, k, v, w, u, s0, s_last)
    if r.device.type == "cpu":
        return rwkv6_wkv_plain(r, k, v, w, u, s0, s_last)
    b, t, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv: head size {hd} is not one of "
                         f"{HEAD_DIMS}")
    if s_last is None:
        s_last = torch.empty_like(s0, memory_format=torch.contiguous_format)
    elif not s_last.is_contiguous() or s_last.data_ptr() % 16:
        raise ValueError("rwkv6_wkv: s_last must be contiguous and start on "
                         "a 16-byte boundary")
    r, k, v, w, u, s0 = (_aligned(x) for x in (r, k, v, w, u, s0))
    out = torch.empty_like(r)
    _build.launch("rwkv6_wkv_f32", r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(), s0.data_ptr(), out.data_ptr(),
                  s_last.data_ptr(), b, t, h, hd,
                  _build.stream_ptr(r.device))
    rwkv6_wkv_fwd.launches += 1
    return out, s_last


def rwkv6_wkv(r, k, v, w, u, s0, chunk: Optional[int] = None):
    """The reference wrapper's contract (``repro.kernels.ops.rwkv6_wkv``):
    ``chunk`` defaults to ``min(T, 4096)``; a longer T must be a multiple
    of it and runs one ``rwkv6_wkv_fwd`` launch a chunk, the state carried
    from one to the next."""
    t = r.shape[1]
    chunk = min(t, CHUNK) if chunk is None else chunk
    if t <= chunk:
        return rwkv6_wkv_fwd(r, k, v, w, u, s0)
    if t % chunk:
        raise ValueError(f"rwkv6_wkv: T = {t} is not a multiple of the chunk "
                         f"{chunk}")
    outs, s = [], s0
    for c in range(0, t, chunk):
        out, s = rwkv6_wkv_fwd(*(x[:, c:c + chunk] for x in (r, k, v, w)),
                               u, s)
        outs.append(out)
    return torch.cat(outs, 1), s

"""Flash attention forward (prefill): a CUDA kernel and its plain version.

``flash_attention_fwd(q, k, v, causal)`` with q (B, H, Sq, hd) and k/v
(B, KV, Skv, hd), H % KV == 0: q head h attends with kv head
h // (H / KV), by index, so grouped K/V are never repeated.  ``causal``
masks key positions above the query's by absolute position (``q_pos >=
k_pos``).  The result is (B, H, Sq, hd) in q's dtype, computed in float32
throughout, as the Pallas kernel does.

``flash_attention_plain`` is the plain PyTorch version (the CPU path, and
the yardstick the kernel is held against on the card): the full-softmax
``ref.attention_ref``.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import attention_ref

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


#: the plain version: softmax over the whole row in float32
flash_attention_plain = attention_ref


def check_attention_inputs(q, *rest, what: str) -> None:
    """The kernels' contract: one dtype (f32 or bf16), one device, a head
    dim the kernel is built for, 16-byte aligned storage."""
    for x in rest:
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{what}: every input must share q's dtype and "
                             f"device ({q.dtype}, {q.device}); got {x.dtype}, "
                             f"{x.device}")
    if q.dtype not in _ENTRY:
        raise ValueError(f"{what}: dtype {q.dtype} is not float32 or bfloat16")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[-1]} is not one of "
                         f"{HEAD_DIMS}")
    if any(x.data_ptr() % 16 for x in (q, *rest)):
        raise ValueError(f"{what}: inputs must be 16-byte aligned")


@_build.counted
def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q (B, H, Sq, hd); k/v (B, KV, Skv, hd).  Returns (B, H, Sq, hd) in
    q.dtype.

    Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``
    (``flash_attention_fwd`` over ``_flash_kernel``), and handles any Sq
    and Skv (the Pallas wrapper asserts that its blocks divide them).  On
    the H100 the prefill's call is bound by operations, which only the
    tensor cores' ``wgmma`` reaches.  bfloat16 runs on them
    (``csrc/flash_attention_bf16.cu``): one block per 128 query rows, two
    consumer warpgroups of 64 rows and a producer warp that keeps K/V
    tiles in flight by TMA in a two-stage ring; both products on
    ``wgmma`` with f32 sums, the softmax in registers, P rounded to
    bfloat16 only as the operand of P.V (as the reference's model path
    does).  float32 stays on the CUDA cores (``csrc/flash_attention.cu``),
    since no tensor-core type keeps a full f32 product.

    CPU tensors run ``flash_attention_plain``; CUDA tensors launch the
    kernel or raise.
    """
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if (k.shape != (b, kvh, skv, hd) or v.shape != k.shape or kvh == 0
            or h % kvh):
        raise ValueError(f"flash_attention: want q (B, H, Sq, hd) and k/v "
                         f"(B, KV, Skv, hd) with H % KV == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_attention_inputs(q, k, v, what="flash_attention")
    out = torch.empty_like(q)
    _build.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, h, kvh, sq, skv, hd, int(causal),
                  _build.stream_ptr(q.device))
    flash_attention_fwd.launches += 1
    return out

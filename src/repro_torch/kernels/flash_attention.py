"""Flash attention forward (prefill) and backward (training): CUDA kernels,
their plain versions, and the autograd ``Function`` that joins them.

``flash_attention_fwd(q, k, v, causal)`` with q (B, H, Sq, hd) and k/v
(B, KV, Skv, hd), H % KV == 0: q head h attends with kv head
h // (H / KV), by index, so grouped K/V are never repeated.  ``causal``
masks key positions above the query's by absolute position (``q_pos >=
k_pos``).  The result is (B, H, Sq, hd) in q's dtype, computed in float32
throughout, as the Pallas kernel does.  With ``return_lse=True`` it also
returns each row's logsumexp of the scaled, masked scores, ``lse`` (B, H,
Sq) float32 in natural-log units, which the backward reads; without it
(serving, and every call under ``torch.no_grad()``) the kernel stores
nothing more and its output is the same bits.

``flash_attention_plain`` is the plain PyTorch version (the CPU path, and
the yardstick the kernel is held against on the card): the full-softmax
``ref.attention_ref``, its lse ``torch.logsumexp`` of the same scores.

``flash_attention_bwd(q, k, v, o, do, lse, causal)`` returns ``(dq, dk,
dv)`` in the forward's layout; dk/dv are (B, KV, Skv, hd), summed over the
H / KV query heads of each group.  ``flash_attention_bwd_plain`` is its
plain version, the explicit formula with P = exp(S - lse).  The two pairs
``(flash_attention_fwd, flash_attention_bwd)`` and
``(flash_attention_plain, flash_attention_bwd_plain)`` share one
signature, so either can stand in for the other.  ``FlashAttention`` (a
``torch.autograd.Function``) runs the forward and saves q, k, v, the
output and lse for the backward; ``flash_attention`` applies it.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import attention_ref, attention_scores

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ENTRY_BWD = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
#: head dims of the bfloat16 backward on the tensor cores
WGMMA_BWD_HEAD_DIMS = (64, 128)
_WGMMA_BWD = "flash_attention_bwd_bf16_wgmma"


#: the plain version: softmax over the whole row in float32
flash_attention_plain = attention_ref


def bwd_entry(dtype: torch.dtype, hd: int) -> str:
    """The C entry point ``flash_attention_bwd`` launches for inputs of
    ``dtype`` and head dim ``hd``: bfloat16 at hd 64 and 128 takes the
    tensor-core kernels (``csrc/flash_attention_bwd_bf16.cu``); float32,
    and bfloat16 at the other head dims, the CUDA-core kernels
    (``csrc/flash_attention_bwd.cu``)."""
    if dtype == torch.bfloat16 and hd in WGMMA_BWD_HEAD_DIMS:
        return _WGMMA_BWD
    return _ENTRY_BWD[dtype]


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


def _check_shapes(q, k, v) -> None:
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if (k.shape != (b, kvh, skv, hd) or v.shape != k.shape or kvh == 0
            or h % kvh):
        raise ValueError(f"flash_attention: want q (B, H, Sq, hd) and k/v "
                         f"(B, KV, Skv, hd) with H % KV == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


@_build.counted
def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        return_lse: bool = False):
    """q (B, H, Sq, hd); k/v (B, KV, Skv, hd).  Returns (B, H, Sq, hd) in
    q.dtype, and with ``return_lse`` also each row's logsumexp (B, H, Sq)
    float32, natural log, which the kernel stores beside its output.

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
    _check_shapes(q, k, v)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     return_lse=return_lse)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_attention_inputs(q, k, v, what="flash_attention")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _build.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), None if lse is None else lse.data_ptr(), b,
                  h, kvh, sq, skv, hd, int(causal),
                  _build.stream_ptr(q.device))
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True):
    """The backward's plain version, the explicit formula in float32 (not
    autograd of ``attention_ref``): with s = hd^-0.5, P = exp(Q K^T s -
    lse) under the forward's mask, then D = rowsum(dO o O), dV = P^T dO,
    dS = P o (dO V^T - D), dQ = dS K s, dK = dS^T Q s.  ``lse`` (B, H, Sq)
    is the forward's row logsumexp (``return_lse=True``).  The G = H / KV
    query heads of a group share one product with their kv head, so dK
    and dV come out summed over the group.  Returns ``(dq, dk, dv)`` in
    the inputs' dtypes."""
    b, h, sq, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = hd ** -0.5
    qf = q.float().reshape(b, kvh, g * sq, hd)
    kf, vf = k.float(), v.float()
    s = attention_scores(q, k, causal=causal)            # (B, KV, G*Sq, Skv)
    p = torch.exp(s - lse.float().reshape(b, kvh, g * sq, 1))
    dof = do.float().reshape(b, kvh, g * sq, hd)
    d = (dof * o.float().reshape(b, kvh, g * sq, hd)).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - d)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return (dq.reshape(b, h, sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@_build.counted
def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True):
    """q, o, do (B, H, Sq, hd); k/v (B, KV, Skv, hd); lse (B, H, Sq)
    float32, the forward's (``return_lse=True``).  Returns ``(dq (B, H,
    Sq, hd), dk, dv (B, KV, Skv, hd))`` in the inputs' dtype.

    The backward of the reference's ``kernels/ops.py::flash_attention``
    (a ``custom_vjp`` that recomputes through its jnp online softmax), as
    hand-written kernels, deterministic (no atomics), tiles the causal
    mask empties skipped.  Routes (``bwd_entry``):

    * bfloat16 at head dim 64 or 128 (every model the port serves):
      ``csrc/flash_attention_bwd_bf16.cu``, every product on ``wgmma``
      from bf16 tiles loaded by TMA.  A block per (128 query rows, head)
      computes D = rowsum(dO o O), writes D and lse to scratch, and sums
      dQ; a block per (128 keys, kv head) loops over the group's heads
      and q tiles and sums dK and dV.  P and dS are rounded to bf16 as
      the operands of dV, dQ and dK; every sum is f32.
    * float32 (no tensor-core type keeps a full f32 product), and
      bfloat16 at head dims 16, 32 and 256 (at 256 dK and dV alone would
      fill a thread's registers): ``csrc/flash_attention_bwd.cu``, on the
      CUDA cores in f32, whose dq kernel recomputes each row's logsumexp
      itself (``lse`` is not read there).

    CPU tensors run ``flash_attention_bwd_plain``; CUDA tensors launch the
    kernels (one count a call) or raise.
    """
    _check_shapes(q, k, v)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o and do must have q's shape "
                         f"{tuple(q.shape)}; got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 of shape "
                         f"{(b, h, sq)}; got {lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    q, k, v, o, do, lse = (x.contiguous() for x in (q, k, v, o, do, lse))
    check_attention_inputs(q, k, v, o, do, what="flash_attention_bwd")
    if lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse is on {lse.device}, q on "
                         f"{q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    entry = bwd_entry(q.dtype, hd)
    stream = _build.stream_ptr(q.device)
    if entry == _WGMMA_BWD:
        sq_pad = -(-sq // 64) * 64
        scratch = torch.empty(2 * b * h * sq_pad, dtype=torch.float32,
                              device=q.device)
        _build.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      scratch.data_ptr(), b, h, kvh, sq, skv, hd,
                      int(causal), stream)
    else:
        scratch = torch.empty(2 * b * h * sq, dtype=torch.float32,
                              device=q.device)
        _build.launch(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, h,
                      kvh, sq, skv, hd, int(causal), stream)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward runs ``fwd`` (the
    forward kernel by default) with ``return_lse=True`` and saves q, k, v,
    the output and lse; the backward runs ``bwd`` (the backward kernel by
    default) on them.  The pair is an argument so that a caller can hold
    the kernels against their plain versions through the same graph."""

    @staticmethod
    def forward(ctx, q, k, v, causal, fwd, bwd):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = fwd(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bwd = causal, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, do, lse, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    fwd=flash_attention_fwd, bwd=flash_attention_bwd):
    """Differentiable flash attention, q (B, H, Sq, hd) over k/v (B, KV,
    Skv, hd): ``FlashAttention``.  Under ``torch.no_grad()`` it is one
    call of ``fwd`` that asks for no lse, and saves nothing."""
    if not torch.is_grad_enabled():
        return fwd(q, k, v, causal=causal)
    return FlashAttention.apply(q, k, v, causal, fwd, bwd)

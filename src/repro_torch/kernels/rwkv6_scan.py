"""The RWKV-6 WKV recurrence: CUDA kernels for its forward and its
backward, their plain versions, the autograd ``Function`` that joins them
and the chunked entry point.

``rwkv6_wkv_fwd(r, k, v, w, u, s0)`` with r, k, v, w (B, T, H, hd), u
(H, hd) and s0 (B, H, hd, hd), all float32; w is the per-step decay in
[0, 1) (already ``exp(-exp(.))``).  Per step, with kv = k_tᵀ v_t:
``o_t = r_t (S + u ⊙ kv)`` and ``S <- w_t ⊙_rows S + kv``.  Returns
``(out (B, T, H, hd), s_last (B, H, hd, hd))``; with ``checkpoints=True``
(training) also the state before every ``BWD_CHUNK[hd]``-th step,
``ckpt (B, H, ceil(T / BWD_CHUNK[hd]), hd, hd)`` (``ckpt[:, :, 0]`` is
s0), which the backward sweeps from.

``rwkv6_wkv_bwd(r, k, v, w, u, ckpt, do, ds_last)`` is its backward: the
gradients ``(dr, dk, dv, dw, du, ds0)`` of a loss whose gradients with
respect to ``out`` and ``s_last`` are ``do`` and ``ds_last``, from the
forward's checkpoints.  The reference has no Pallas backward: it
differentiates its ``lax.scan`` (``repro.models.rwkv6._wkv_scan``) by
autodiff.

``rwkv6_wkv_plain`` and ``rwkv6_wkv_bwd_plain`` are the plain PyTorch
versions (the CPU path, and the yardsticks the kernels are held against
on the card).  The pairs ``(rwkv6_wkv_fwd, rwkv6_wkv_bwd)`` and
``(rwkv6_wkv_plain, rwkv6_wkv_bwd_plain)`` share one signature, so
either can stand in for the other.  ``WKV`` (a
``torch.autograd.Function``) runs the forward with checkpoints and saves
them beside its inputs for the backward; ``wkv`` applies it where
autograd records, and is one forward call elsewhere.  ``rwkv6_wkv`` is
the counterpart of the reference's chunked wrapper
(``repro.kernels.ops.rwkv6_wkv``).
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
#: steps between the checkpoints the training forward writes and the
#: backward reads, by head size: every launch passes them, and the kernels
#: (``kBwdChunk`` and ``kBwdRows`` in ``csrc/rwkv6_chunk.cuh``) refuse
#: others.  The backward keeps a chunk's recomputed states in shared
#: memory, (chunk - 1) x 16 rows x (hd + 4) floats, ~32 KB
BWD_CHUNK = {16: 16, 32: 16, 64: 8, 128: 4}
#: rows of the state a block of the backward kernel holds (a head's
#: hd / BWD_ROWS blocks form one thread block cluster)
BWD_ROWS = 16


def ckpt_shape(b: int, t: int, h: int, hd: int):
    """Shape of the checkpoints of a forward on r (b, t, h, hd): the state
    before every ``BWD_CHUNK[hd]``-th step; raises ValueError at a head
    size outside ``HEAD_DIMS``."""
    if hd not in BWD_CHUNK:
        raise ValueError(f"rwkv6_wkv: checkpoints need a head size in "
                         f"{HEAD_DIMS}; got {hd}")
    return (b, h, -(-t // BWD_CHUNK[hd]), hd, hd)


def rwkv6_wkv_plain(r, k, v, w, u, s0, s_last=None, checkpoints=False):
    """``ref.rwkv6_wkv_ref``; a given ``s_last`` receives the last state
    (it may be ``s0``) and is returned.  With ``checkpoints`` the loop runs
    ``BWD_CHUNK[hd]`` steps at a time (the same bits) and also returns the
    state before each such run, ``(out, s_last, ckpt)`` with ckpt
    ``ckpt_shape(...)``."""
    if not checkpoints:
        out, s = rwkv6_wkv_ref(r, k, v, w, u, s0)
        return out, (s if s_last is None else s_last.copy_(s))
    ckpt_shape(*r.shape)            # raises at a head size without a stride
    chunk = BWD_CHUNK[r.shape[3]]
    outs, saved, s = [], [], s0.float()
    for t0 in range(0, r.shape[1], chunk):
        saved.append(s)
        out, s = rwkv6_wkv_ref(*(x[:, t0:t0 + chunk] for x in (r, k, v, w)),
                               u, s)
        outs.append(out)
    ckpt = torch.stack(saved, 2)
    return (torch.cat(outs, 1), s if s_last is None else s_last.copy_(s),
            ckpt)


def rwkv6_wkv_bwd_plain(r, k, v, w, u, ckpt, do, ds_last):
    """The backward of ``rwkv6_wkv_plain`` as an explicit reverse sweep.
    With G_t = dL/dS_t (the state after step t), G_T = ``ds_last``, and
    a_t = sum_i r_t[i] u[i] k_t[i], going back over t::

        dr_t = S_{t-1} do_t + u ⊙ k_t (do_t · v_t)
        dk_t = G_t v_t + u ⊙ r_t (do_t · v_t)
        dv_t = G_tᵀ k_t + a_t do_t
        dw_t = sum_j G_t[:, j] ⊙ S_{t-1}[:, j]
        du  += r_t ⊙ k_t (do_t · v_t)          (summed over batch rows)
        G_{t-1} = w_t ⊙_rows G_t + r_tᵀ do_t

    and ds0 = G_0.  The sweep needs S_{t-1} going back: ``ckpt`` holds the
    state before every ``BWD_CHUNK[hd]``-th step, as the forward with
    ``checkpoints=True`` returns it, and each chunk's
    states are recomputed forward from its checkpoint.  They are never
    rebuilt by dividing by w_t, which is exactly 0 in float32 once wlog
    passes ~4.65 (``exp(-exp(4.65))`` underflows) while the gradient
    there is finite.  Returns ``(dr, dk, dv, dw, du, ds0)``, float32."""
    b, t_len, h, hd = r.shape
    if tuple(ckpt.shape) != ckpt_shape(b, t_len, h, hd):
        raise ValueError(f"rwkv6_wkv_bwd: ckpt must have shape "
                         f"{ckpt_shape(b, t_len, h, hd)} (the state every "
                         f"{BWD_CHUNK[hd]} steps); got {tuple(ckpt.shape)}")
    chunk = BWD_CHUNK[hd]
    step = lambda s, t: (w[:, t, :, :, None] * s  # noqa: E731
                         + k[:, t, :, :, None] * v[:, t, :, None, :])
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    g = ds_last.float()
    for c in reversed(range(ckpt.shape[2])):
        t0 = c * chunk
        states = [ckpt[:, :, c].float()]
        for t in range(t0, min(t0 + chunk, t_len) - 1):
            states.append(step(states[-1], t))
        for t in reversed(range(t0, t0 + len(states))):
            sp = states[t - t0]
            dr[:, t] = (sp @ do[:, t, :, :, None])[..., 0]
            dk[:, t] = (g @ v[:, t, :, :, None])[..., 0]
            dv[:, t] = (k[:, t, :, None, :] @ g)[..., 0, :]
            dw[:, t] = (g * sp).sum(-1)
            g = (w[:, t, :, :, None] * g
                 + r[:, t, :, :, None] * do[:, t, :, None, :])
    dot = (do * v).sum(-1, keepdim=True)                  # (B, T, H, 1)
    a = (r * u * k).sum(-1, keepdim=True)
    return (dr + u * k * dot, dk + u * r * dot, dv + a * do, dw,
            (r * k * dot).sum((0, 1)), g)


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
def rwkv6_wkv_fwd(r, k, v, w, u, s0, s_last: Optional[torch.Tensor] = None,
                  checkpoints: bool = False):
    """r, k, v, w (B, T, H, hd); u (H, hd); s0 (B, H, hd, hd); all float32.
    Returns ``(out, s_last)``.  A given ``s_last`` (contiguous, the shape of
    s0; it may be s0 itself) receives the last state in place.  With
    ``checkpoints`` (training) returns ``(out, s_last, ckpt)``: the kernel's
    variant that also writes the state before every ``BWD_CHUNK[hd]``-th
    step (``ckpt_shape(...)``) for ``rwkv6_wkv_bwd``; out and s_last have
    the same bits either way.

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
        return rwkv6_wkv_plain(r, k, v, w, u, s0, s_last, checkpoints)
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
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, s0, out, s_last)]
    if checkpoints:
        ckpt = torch.empty(ckpt_shape(b, t, h, hd), dtype=torch.float32,
                           device=r.device)
        _build.launch("rwkv6_wkv_ckpt_f32", *ptrs, ckpt.data_ptr(),
                      BWD_CHUNK[hd], b, t, h, hd,
                      _build.stream_ptr(r.device))
    else:
        _build.launch("rwkv6_wkv_f32", *ptrs, b, t, h, hd,
                      _build.stream_ptr(r.device))
    rwkv6_wkv_fwd.launches += 1
    return (out, s_last, ckpt) if checkpoints else (out, s_last)


def _check_bwd(r, k, v, w, u, ckpt, do, ds_last) -> None:
    b, t, h, hd = r.shape
    _check(r, k, v, w, u, ds_last, None)
    if do.shape != r.shape or tuple(ckpt.shape) != ckpt_shape(b, t, h, hd):
        raise ValueError(f"rwkv6_wkv_bwd: do must have r's shape "
                         f"{tuple(r.shape)} and ckpt "
                         f"{ckpt_shape(b, t, h, hd)} (the state every "
                         f"{BWD_CHUNK[hd]} steps); got {tuple(do.shape)}, "
                         f"{tuple(ckpt.shape)}")
    for x in (do, ckpt):
        if x.dtype != torch.float32 or x.device != r.device:
            raise ValueError(f"rwkv6_wkv_bwd: do and ckpt must be "
                             f"float32 on r's device ({r.device}); got "
                             f"{x.dtype}, {x.device}")


def bwd_scratch_floats(b: int, t: int, h: int, hd: int) -> int:
    """Float32 scratch of one ``rwkv6_wkv_bwd`` launch: du's partial sums
    of each batch row (the checkpoints come from the forward, and dv's
    row-block partials stay on chip)."""
    return b * h * hd


@_build.counted
def rwkv6_wkv_bwd(r, k, v, w, u, ckpt, do, ds_last):
    """The backward of ``rwkv6_wkv_fwd``: r, k, v, w, do (B, T, H, hd), u
    (H, hd), ckpt (``ckpt_shape(B, T, H, hd)``, from the forward with
    ``checkpoints=True``) and ds_last (B, H, hd, hd), all float32.  Returns
    ``(dr, dk, dv, dw, du, ds0)``: the gradients with respect to r, k, v,
    w (B, T, H, hd), u (H, hd) and s0 (B, H, hd, hd) of a loss whose
    gradients with respect to the forward's ``out`` and ``s_last`` are
    ``do`` and ``ds_last`` (``rwkv6_wkv_bwd_plain`` gives the formulas).

    Replaces no Pallas kernel: the reference differentiates its
    ``lax.scan`` (``src/repro/models/rwkv6.py:88``).  On the H100 it is
    bound by operations (recomputing the states, the state gradient and
    four products with it, ~14 hd² a step and head, on the CUDA cores in
    float32).  One reverse sweep: the rows of each head's state are split
    over blocks of ``BWD_ROWS`` (rows are independent in S and in its
    gradient), a head's blocks form a thread block cluster, and each
    block recomputes a chunk's states from its checkpoint into shared
    memory and sweeps the chunk back while the next chunk's rows arrive
    by bulk copies; row threads form dr, dk, dw, column threads run the
    state gradient a second time to form dv's partials, which the cluster
    sums in rank order through distributed shared memory; du's partials
    over the batch rows are summed in order by a second kernel, so that
    two calls give the same bits (no atomics); see
    ``csrc/rwkv6_wkv_bwd.cu``.

    CPU tensors run ``rwkv6_wkv_bwd_plain``; CUDA tensors launch the
    kernels (one count a call) or raise.
    """
    _check_bwd(r, k, v, w, u, ckpt, do, ds_last)
    if r.device.type == "cpu":
        return rwkv6_wkv_bwd_plain(r, k, v, w, u, ckpt, do, ds_last)
    b, t, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv_bwd: head size {hd} is not one of "
                         f"{HEAD_DIMS}")
    r, k, v, w, u, ckpt, do, ds_last = (_aligned(x) for x in (
        r, k, v, w, u, ckpt, do, ds_last))
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du, ds0 = torch.empty_like(u), torch.empty_like(ds_last)
    n_scratch = bwd_scratch_floats(b, t, h, hd)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=r.device)
    _build.launch("rwkv6_wkv_bwd_f32", *(x.data_ptr() for x in (
        r, k, v, w, u, ckpt, do, ds_last, dr, dk, dv, dw, du, ds0, scratch)),
        n_scratch, BWD_CHUNK[hd], BWD_ROWS, b, t, h, hd,
        _build.stream_ptr(r.device))
    rwkv6_wkv_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


class WKV(torch.autograd.Function):
    """The WKV recurrence with a gradient: the forward runs ``fwd`` (the
    forward kernel by default) with ``checkpoints=True`` into a new last
    state and saves its inputs and the checkpoints (not s0: the first
    checkpoint is s0); the backward runs ``bwd`` (the backward kernel by
    default) on them.  It never writes into a tensor it saved.  The pair
    is an argument so that a caller can hold the kernels against their
    plain versions through the same graph."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, fwd, bwd):
        r, k, v, w = (x.contiguous() for x in (r, k, v, w))
        out, s_last, ckpt = fwd(r, k, v, w, u, s0, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.bwd = bwd
        return out, s_last

    @staticmethod
    def backward(ctx, dout, ds_last):
        grads = ctx.bwd(*ctx.saved_tensors, dout.contiguous(),
                        ds_last.contiguous())
        return (*grads, None, None)


def records(*xs) -> bool:
    """Whether autograd records an operation on ``xs``: grad mode is on
    and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def wkv(r, k, v, w, u, s0, *, fwd=rwkv6_wkv_fwd, bwd=rwkv6_wkv_bwd):
    """The differentiable recurrence: ``WKV`` where autograd records
    (:func:`records`), else one call of ``fwd`` that saves nothing.
    Returns ``(out, s_last)``, s_last a new tensor."""
    if not records(r, k, v, w, u, s0):
        return fwd(r, k, v, w, u, s0)
    return WKV.apply(r, k, v, w, u, s0, fwd, bwd)


def rwkv6_wkv(r, k, v, w, u, s0, chunk: Optional[int] = None):
    """The reference wrapper's contract (``repro.kernels.ops.rwkv6_wkv``):
    ``chunk`` defaults to ``min(T, 4096)``; a longer T must be a multiple
    of it and runs one ``rwkv6_wkv_fwd`` launch a chunk, the state carried
    from one to the next.  Differentiable: each chunk is one :func:`wkv`
    (under autograd one ``WKV``)."""
    t = r.shape[1]
    chunk = min(t, CHUNK) if chunk is None else chunk
    if t <= chunk:
        return wkv(r, k, v, w, u, s0)
    if t % chunk:
        raise ValueError(f"rwkv6_wkv: T = {t} is not a multiple of the chunk "
                         f"{chunk}")
    outs, s = [], s0
    for c in range(0, t, chunk):
        out, s = wkv(*(x[:, c:c + chunk] for x in (r, k, v, w)), u, s)
        outs.append(out)
    return torch.cat(outs, 1), s

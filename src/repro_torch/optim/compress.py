"""Error-feedback int8 gradient compression for a data-parallel hop.

The reference's ``optim/compress.py``: each pod quantizes its gradient
plus its residual to int8 with one scale shared by all pods (the max of
their maxima), the int8 values are summed in int32, dequantized and
averaged, and each pod keeps what its quantization lost as the next
step's residual.  The reference reduces over a named mesh axis inside
``shard_map``.  ``ef_int8_psum(grads, residuals, group=g)`` is that
collective over a ``torch.distributed`` process group (the pod axis's
group of a mesh): per leaf an all-reduce MAX of ``max|g + r|``, the int8
quantization, an int32 all-reduce SUM and the division by the group's
size.  Without a group it takes the pods stacked on each leaf's leading
dim and reduces over it, which is what the reference's own test builds
with ``jax.vmap(..., axis_name="pod")``; a rank's outputs over a group
are bit for bit its row of the stacked form.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch._tree import tree_map, unzip


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 values, float32 scale)`` with ``scale = max|x| / 127``."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_int8_compress_state(params) -> Any:
    """A residual tree of float32 zeros, one per parameter leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_int8_psum(grads, residuals, group=None):
    """Per-leaf int8-quantized mean over the pods, with error feedback.

    Without ``group``, each leaf of ``grads`` and ``residuals`` is (P,
    ...): pod ``i``'s partial gradient and residual in row ``i``.  Returns
    ``(reduced, new residuals)``, both (P, ...): every pod's row of
    ``reduced`` is the same dequantized mean, and a pod's new residual is
    its ``g + r`` less what it sent.  With a process group ``group``, each
    rank passes its own leaves and gets its own row of each."""
    if group is not None:
        return _ef_int8_collective(grads, residuals, group)

    def one(g, r):
        x = g.float() + r
        q, scale = _quantize(x)       # one scale: the max over every pod
        qsum = q.to(torch.int32).sum(0, keepdim=True)
        g_hat = qsum.float() * scale / x.shape[0]
        return g_hat.expand_as(x).clone(), x - _dequantize(q, scale)

    return unzip(tree_map(one, grads, residuals), 2)


def _ef_int8_collective(grads, residuals, group):
    """``ef_int8_psum`` over ``group``: one all-reduce MAX of the scale's
    maximum and one int32 all-reduce SUM a leaf."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def one(g, r):
        x = g.float() + r
        amax = x.abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        q, scale = _quantize_at(x, amax)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        return qsum.float() * scale / n, x - _dequantize(q, scale)

    return unzip(tree_map(one, grads, residuals), 2)


def _quantize_at(x: torch.Tensor, amax: torch.Tensor):
    """``_quantize`` with the maximum given (the group's)."""
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale

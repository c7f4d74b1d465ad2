"""AdamW (decoupled weight decay) with float32 moments over the port's
parameter tree (nested dicts and lists of tensors).

The reference's ``optim/adamw.py`` in plain tensor ops, as the reference
leaves it to XLA.  The state mirrors the parameter tree; parameters are
updated in float32 and cast back to their own dtype.  Every function
returns new tensors and leaves its inputs as they were, except
``adamw_update(..., in_place=True)``: the counterpart of the reference's
donated buffers (``jax.jit(..., donate_argnums=(0, 1))`` in its training
driver), which overwrites the parameters, the state and the gradients
with the same bits and so never holds a second copy of them.
``opt_state_specs`` gives the state's logical sharding specs, the
parameters' own, as the reference's does.  On DTensor parameters every
op runs per shard and the global norm's sum is all-reduced.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch._tree import leaves, tree_map, unzip


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def opt_state_specs(param_spec_tree) -> Dict[str, Any]:
    """The optimizer state's logical specs: the moments mirror the
    parameters' specs, the step is a replicated scalar."""
    return {"mu": param_spec_tree, "nu": param_spec_tree, "step": ()}


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32: linear
    warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    s = step.float()
    warm = s / max(1.0, cfg.warmup_steps)
    prog = ((s - cfg.warmup_steps)
            / max(1.0, cfg.total_steps - cfg.warmup_steps)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> Dict[str, Any]:
    """``{"mu", "nu"}`` float32 zeros shaped like ``params``, and ``"step"``
    an int32 zero, on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _clip_scale(grads, max_norm: float):
    """``(the factor that scales grads to a global norm of at most
    max_norm, the global norm)``."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """``(grads in float32 scaled to a global norm of at most max_norm,
    the global norm before scaling)``."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, *,
                 in_place: bool = False
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: clip ``grads`` by their global norm, then update
    the moments and the parameters.  Returns ``(new params, new state,
    {"lr", "grad_norm"})``.  With ``in_place`` the given parameters,
    moments, step and float32 gradients are overwritten and returned,
    leaf by leaf, with the same bits as the new tensors would hold."""
    if in_place:
        scale, gnorm = _clip_scale(grads, cfg.clip_norm)
        step = state["step"].add_(1)
    else:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        step = state["step"] + 1
    lr = warmup_cosine(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def delta(pf, mu, nu):
        return (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) \
            + cfg.weight_decay * pf

    metrics = {"lr": lr, "grad_norm": gnorm}
    if in_place:
        for p, g, mu, nu in zip(leaves(params), leaves(grads),
                                leaves(state["mu"]), leaves(state["nu"])):
            g = g.float().mul_(scale)
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            pf = p.float()
            p.copy_(pf - lr * delta(pf, mu, nu))
        return params, state, metrics

    def upd(p, g, mu, nu):
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g.square()
        pf = p.float()
        return (pf - lr * delta(pf, mu, nu)).to(p.dtype), mu, nu

    new_p, mu, nu = unzip(tree_map(upd, params, grads, state["mu"],
                                   state["nu"]), 3)
    return new_p, {"mu": mu, "nu": nu, "step": step}, metrics

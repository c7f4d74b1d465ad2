"""Batched stochastic packing optimizer: heat-bath annealing chains over
partition -> bin assignments, batched over rows and chains.

A row is one packing instance (``speeds [R, N]``, ``prev [R, N]``); each
row runs ``K`` chains, one per entry of ``lam``, so one call anneals
``R * K`` chains.  Each chain carries a feasible assignment of the N
partitions to bin names in ``[0, 2N+2)`` (the packers' name universe, so a
sticky match against any heuristic's previous assignment is
representable).  Per anneal step every chain

  1. evaluates the cost change of every single-partition relocation, the
     ``f32[R*K, N, M]`` plane of ``kernels.move_eval``;
  2. samples its next state from the heat-bath distribution
     ``softmax(-delta / T)`` over all allowed moves plus "stay" (the last
     column), via Gumbel-max, with a geometric temperature schedule
     ``t0 -> t1``;
  3. keeps the best assignment seen so far.

The objective is ``bins + lam * Rscore`` (the R-score already carries the
1/C of Eq. 10).  Chains start from the identity assignment (partition
``p`` alone in bin ``p``) and only make capacity-feasible moves, so every
state visited is feasible.

Noise is an argument: ``AnnealNoise`` holds the Gumbel draws
``f32[steps, K, N*M+1]`` and the temperatures ``f32[steps]``; without it
the draws come one anneal step at a time from an explicit
``torch.Generator`` on the run's device.  Either way a step's draws have
shape ``[K, N*M+1]`` and are shared by every row, so a row's result never
depends on its batch-mates.

Each anneal step updates every chain in place through
``kernels.move_eval.anneal_step_launcher``: on a CUDA tensor one
``anneal_step`` kernel launch (the delta plane never leaves the chip), on
a CPU tensor its plain version ``anneal_step_reference``;
``use_kernel=False`` runs the plain version on the card too.  The JAX
package's annealer evaluates moves with its jnp oracle by default; both
compute the same function, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.move_eval import (ChainState, anneal_step_launcher,
                                           anneal_step_reference)

NEG = -1    # masked-out items report this bin name (the packers' NEG)
_TINY = float(np.finfo(np.float32).tiny)


def name_universe(n: int) -> int:
    """Bin-name universe size, the packers' ``2n + 2``."""
    return 2 * n + 2


@dataclasses.dataclass
class AnnealResult:
    """Best state per chain after annealing (trailing axis = chain)."""

    assign: torch.Tensor   # i32[..., K, N] best assignment (bin names)
    bins: torch.Tensor     # i64[..., K]    bins used by it
    rscore: torch.Tensor   # f32[..., K]    its Eq. 10 cost against prev
    cost: torch.Tensor     # f32[..., K]    bins + lam * rscore
    lam: torch.Tensor      # f32[..., K]    each chain's lambda


@dataclasses.dataclass(frozen=True)
class AnnealNoise:
    """The randomness of one anneal: Gumbel draws ``f32[steps, K,
    N*M+1]`` (column ``N*M`` is "stay") and temperatures ``f32[steps]``."""

    gumbel: torch.Tensor
    temps: torch.Tensor

    @classmethod
    def draw(cls, steps: int, chains: int, n: int, *,
             generator: torch.Generator, t0: float = 1.0, t1: float = 0.02,
             device=None) -> "AnnealNoise":
        """The draws ``anneal_chains`` makes from ``generator`` when given
        no noise, materialized."""
        dev = generator.device if device is None else torch.device(device)
        g = _default_draws(steps, chains, n * name_universe(n) + 1,
                           generator, dev)
        return cls(gumbel=torch.stack(list(g)),
                   temps=_temperature_schedule(steps, t0, t1, dev))


def _default_draws(steps, chains, width, generator, device):
    """Each anneal step's Gumbel draws ``f32[chains, width]`` from
    ``generator``, one step at a time: the one rule behind
    ``anneal_chains``'s default noise and ``AnnealNoise.draw`` (whose
    temperatures are ``_temperature_schedule``'s)."""
    for _ in range(steps):
        yield _gumbel((chains, width), generator, device)


def _gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.log(torch.clamp(u, min=_TINY)).neg_().log_().neg_()


def _temperature_schedule(steps: int, t0: float, t1: float,
                          device=None) -> torch.Tensor:
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    frac = (torch.arange(steps, dtype=torch.float32, device=device)
            / f(max(steps - 1, 1)))
    return f(t0) * (f(t1) / f(t0)) ** frac


def _index_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order: the same bits on every
    device (and the reference's at small N)."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def assignment_cost(assign, speeds, prev, capacity, lam, *, m: int,
                    active=None):
    """Exact objective of assignments ``int[..., N]`` (names in [0, m)).

    Returns ``(cost, bins, rscore)`` of shape ``[...]``: the open-bin count
    (zero-speed partitions hold bins open), the Eq. 10 R-score against
    ``prev`` (-1 entries never count as moved) and ``bins + lam *
    rscore``.  ``active`` (bool[..., N]) masks partitions that do not
    exist: they open no bin and price no move.  ``capacity`` and ``lam``
    are tensors broadcastable to ``[...]``."""
    names = torch.arange(m, device=assign.device)
    onehot = assign.unsqueeze(-1) == names                      # (..., N, M)
    moved = (prev >= 0) & (assign != prev)
    if active is not None:
        act = active.bool()
        onehot = onehot & act.unsqueeze(-1)
        moved = moved & act
    bins = (onehot.any(-2)).sum(-1)
    r = _index_order_sum(torch.where(moved, speeds, 0.0)) / capacity
    return bins.float() + lam * r, bins, r


def anneal_chains(speeds, prev, capacity, lam, *, steps: int = 200,
                  t0: float = 1.0, t1: float = 0.02,
                  noise: Optional[AnnealNoise] = None,
                  generator: Optional[torch.Generator] = None,
                  use_kernel: bool = True, active=None,
                  device=None) -> AnnealResult:
    """Run ``K = len(lam)`` chains on each row.

    speeds f32[R, N] or f32[N]; prev int[R, N] or int[N] (-1 =
    unassigned); lam f32[K] per-chain R-score weight; capacity a float;
    active optional bool[R, N] / bool[N]: an inactive item is frozen (no
    chain moves it, it loads and opens no bin) and comes back ``NEG``.
    ``noise`` injects the draws; else they come from ``generator`` (a
    generator seeded 0 on the run's device when ``None``).
    ``use_kernel=False`` runs each step's plain version even on the
    card.  Inputs go to ``device`` (``None`` = the CUDA card).
    Results carry a leading ``R`` axis iff ``speeds`` has one.
    """
    dev = resolve_device(device)
    speeds = torch.as_tensor(speeds, device=dev)
    single = speeds.dim() == 1
    rows = (lambda x: None if x is None else x[None]) if single else (
        lambda x: x)
    speeds = rows(speeds).to(torch.float32)
    prev = rows(torch.as_tensor(prev, device=dev)).to(torch.int32)
    act = rows(None if active is None
               else torch.as_tensor(active, device=dev).bool())
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    r_, n = speeds.shape
    m = name_universe(n)
    k = lam.shape[0]
    c = r_ * k
    nm = n * m
    if act is not None:
        # an inactive item weighs nothing and prices no move; it keeps its
        # identity seat, which reads as empty (count 0)
        speeds = torch.where(act, speeds, 0.0)
        prev = torch.where(act, prev, NEG)
        count0 = act.to(torch.int32)
    else:
        count0 = torch.ones((r_, n), dtype=torch.int32, device=dev)
    chain = lambda x: x.repeat_interleave(k, 0)  # noqa: E731  [R*K, ...]
    speeds_k, prev_k = chain(speeds), chain(prev)
    act_k = None if act is None else chain(act)
    act_i = None if act is None else act_k.to(torch.int32)   # no copy a step
    lam_k = lam.repeat(r_)
    cap_k = torch.full((c,), float(np.float32(capacity)), device=dev)

    assign = torch.arange(n, dtype=torch.int32, device=dev).expand(
        c, n).contiguous()
    pad = lambda x: torch.cat([x, x.new_zeros(c, m - n)], 1)  # noqa: E731
    cost, _, _ = assignment_cost(assign, speeds_k, prev_k, cap_k, lam_k, m=m,
                                 active=act_k)
    state = ChainState(assign=assign, loads=pad(speeds_k),
                       counts=pad(chain(count0)), cost=cost,
                       best_cost=cost.clone(), best_assign=assign.clone())
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        draws = _default_draws(steps, k, nm + 1, generator, dev)
        temps = _temperature_schedule(steps, t0, t1, dev)
    else:
        if noise.gumbel.shape != (steps, k, nm + 1):
            raise ValueError(f"noise.gumbel must have shape [{steps}, {k}, "
                             f"{nm + 1}]; got {list(noise.gumbel.shape)}")
        gumbel = noise.gumbel.to(device=dev,
                                 dtype=torch.float32).contiguous()
        draws = (gumbel[s] for s in range(steps))
        temps = noise.temps.to(device=dev, dtype=torch.float32).contiguous()
    if use_kernel:
        step = anneal_step_launcher(state, speeds_k, prev_k, lam_k, cap_k,
                                    temps, k, active=act_i)
    else:
        def step(g, s):
            anneal_step_reference(state, speeds_k, prev_k, lam_k, cap_k, g,
                                  temps, s, active=act_i)
    for s, g in enumerate(draws):
        step(g, s)
    best_assign = state.best_assign
    if act_k is not None:
        best_assign = torch.where(act_k, best_assign, NEG)
    # the loop tracks cost incrementally; re-derive the best state's cost
    cost, bins, r = assignment_cost(best_assign, speeds_k, prev_k, cap_k,
                                    lam_k, m=m, active=act_k)
    shape = (k,) if single else (r_, k)
    return AnnealResult(assign=best_assign.view(*shape, n),
                        bins=bins.view(shape), rscore=r.view(shape),
                        cost=cost.view(shape), lam=lam_k.view(shape))


def anneal_assign(speeds, prev, capacity, *, lam: float = 0.0,
                  chains: int = 8, steps: int = 64, t0: float = 1.0,
                  t1: float = 0.02, noise: Optional[AnnealNoise] = None,
                  generator: Optional[torch.Generator] = None,
                  active=None, device=None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Single-lambda convenience: each row's best chain, ``(assign
    i32[..., N], bins i64[...])`` (the first chain of least cost).  The
    ``ANNEAL`` / ``ANNEAL_STICKY`` policies call it once per decision.
    ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    lam_vec = torch.full((chains,), float(lam), dtype=torch.float32,
                         device=dev)
    res = anneal_chains(speeds, prev, capacity, lam_vec, steps=steps, t0=t0,
                        t1=t1, noise=noise, generator=generator,
                        active=active, device=dev)
    i = res.cost.argmin(-1, keepdim=True)
    return (res.assign.gather(-2, i.unsqueeze(-1).expand(
                *i.shape, res.assign.shape[-1])).squeeze(-2),
            res.bins.gather(-1, i).squeeze(-1))


anneal_pack = anneal_chains   # the reference's standalone name

"""Batched synthetic workload scenarios, made on the device.

Each family is split in two: a **draw** step that takes a
``torch.Generator`` and makes every random number the family needs on
the generator's device, and a **transform** step that turns those draws
into rates ``f32[B, T, N]`` (and a mask).  The transforms follow the reference
``repro.core.scenarios`` operation for operation, so fed the same draws
(tests replay the reference's ``jax.random`` stream) they give the same
traces; the PRNG streams themselves never agree.

Families ported so far: ``diurnal`` (day/night cycle), ``bursty``
(flash crowds) and ``topic_lifecycle`` (partitions born and dying, a
true mask).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def _uniform(gen, shape, lo: float, hi: float):
    """U(lo, hi) draws on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _walk(steps, step_scale, init):
    """Unclipped drift: ``init + cumsum(steps * step_scale)`` with a zero
    first step; ``steps`` are U(-1, 1) draws ``[B, T-1, N]``."""
    steps = steps * step_scale
    zero = torch.zeros_like(init).unsqueeze(1)
    return init.unsqueeze(1) + torch.cat([zero, torch.cumsum(steps, 1)], 1)


def diurnal_draws(gen, batch: int, iters: int, n: int, *,
                  amplitude: float = 0.4) -> Dict[str, torch.Tensor]:
    return dict(
        mean=_uniform(gen, (batch, 1, n), 0.1, 0.6),
        phase=_uniform(gen, (batch, 1, n), 0.0, 2 * math.pi),
        amp=_uniform(gen, (batch, 1, n), 0.0, amplitude),
        steps=_uniform(gen, (batch, iters - 1, n), -1.0, 1.0))


def diurnal(draws, *, capacity: float = 1.0, period: int = 96,
            noise: float = 0.02):
    """Day/night cycle: per-partition mean, phase and amplitude plus walk
    noise; ``period`` is the cycle length in steps."""
    mean = draws["mean"] * capacity
    amp = draws["amp"] * capacity
    b, t1, n = draws["steps"].shape
    dev = mean.device
    t = torch.arange(t1 + 1, dtype=torch.float32, device=dev)[None, :, None]
    x = 2 * math.pi * t
    x = x / torch.full_like(x, period)      # exact division, as the reference
    wave = mean + amp * torch.sin(x + draws["phase"])
    drift = _walk(draws["steps"], noise * capacity,
                  torch.zeros(b, n, device=dev))
    return torch.clamp(wave + drift, min=0.0)


def bursty_draws(gen, batch: int, iters: int, n: int, *,
                 p_spike: float = 0.02) -> Dict[str, torch.Tensor]:
    return dict(
        floor=_uniform(gen, (batch, 1, n), 0.2, 1.0),
        arrive=torch.rand((iters, batch, n), generator=gen,
                          device=gen.device) < p_spike,
        size=_uniform(gen, (iters, batch, n), 0.3, 1.0))


def bursty(draws, *, capacity: float = 1.0, base: float = 0.15,
           spike: float = 1.0, decay: float = 0.8):
    """Flash crowds: a calm baseline plus Bernoulli spike arrivals that
    decay geometrically (``decay`` per step)."""
    floor = draws["floor"] * base * capacity
    size = draws["size"] * spike * capacity
    arrive = draws["arrive"]
    level = torch.zeros_like(size[0])
    levels = []
    for t in range(size.shape[0]):
        level = torch.maximum(level * decay,
                              torch.where(arrive[t], size[t], 0.0))
        levels.append(level)
    return floor + torch.stack(levels, 1)


def topic_lifecycle_draws(gen, batch: int, iters: int, n: int, *,
                          p_alive0: float = 0.5, min_life_frac: float = 0.15
                          ) -> Dict[str, torch.Tensor]:
    if min_life_frac < 0.0:
        raise ValueError(
            f"lifecycle window is empty: death precedes birth "
            f"(min_life_frac={min_life_frac!r} < 0 allows a negative "
            f"lifetime); min_life_frac must be >= 0")
    return dict(
        alive0=torch.rand((batch, n), generator=gen,
                          device=gen.device) < p_alive0,
        birth=_uniform(gen, (batch, n), 0.0, float(iters)),
        life=_uniform(gen, (batch, n), min_life_frac * iters, float(iters)),
        level=_uniform(gen, (batch, 1, n), 0.3, 1.5),
        steps=_uniform(gen, (batch, iters - 1, n), -1.0, 1.0))


def topic_lifecycle_masked(draws, *, capacity: float = 1.0, hot: float = 0.5,
                           noise: float = 0.1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition births and deaths: one lifetime window ``[birth, death)``
    each (alive from step 0 with probability ``p_alive0``); a hot level
    with walk noise inside it, absent (speed 0, ``active`` False) outside.
    Returns ``(speeds f32[B, T, N], active bool[B, T, N])``."""
    birth = torch.where(draws["alive0"], 0.0, draws["birth"])
    death = birth + draws["life"]
    b, t1, n = draws["steps"].shape
    dev = birth.device
    t = torch.arange(t1 + 1, dtype=torch.float32, device=dev)[None, :, None]
    active = (t >= birth.unsqueeze(1)) & (t < death.unsqueeze(1))
    level = draws["level"] * hot * capacity
    drift = _walk(draws["steps"], noise * capacity,
                  torch.zeros(b, n, device=dev))
    speeds = torch.where(active, torch.clamp(level + drift, min=0.0), 0.0)
    return speeds, active


def generate(family: str, batch: int, iters: int, n: int, *, seed: int = 0,
             capacity: float = 1.0, device=None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One family at its default knobs, drawn on ``device`` (``None`` =
    the CUDA card) from a generator seeded with ``seed``.  Returns
    ``(speeds f32[B, T, N], active bool[B, T, N] or None)``."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    if family == "diurnal":
        return diurnal(diurnal_draws(gen, batch, iters, n),
                       capacity=capacity), None
    if family == "bursty":
        return bursty(bursty_draws(gen, batch, iters, n),
                      capacity=capacity), None
    if family == "topic_lifecycle":
        return topic_lifecycle_masked(
            topic_lifecycle_draws(gen, batch, iters, n),
            capacity=capacity)
    raise ValueError(f"unknown or not yet ported scenario family {family!r}; "
                     f"have ('diurnal', 'bursty', 'topic_lifecycle')")

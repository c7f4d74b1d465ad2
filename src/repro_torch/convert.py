"""Carry the reference's state across to the port.

The lag twin has no weights: its counterparts are the configuration and
the loop's state.  ``config_from_reference`` takes
``dataclasses.asdict`` of a reference ``LagSimConfig``;
``state_from_numpy`` takes the loop state as numpy arrays;
``anneal_noise_from_numpy`` takes an anneal's random draws (the state of
a stochastic policy).  All are plain data in, port objects out, so a test
can feed one set of inputs to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.lagsim.engine import LagSimConfig, NotPortedError
from repro_torch.opt.anneal import AnnealNoise


def config_from_reference(fields: Mapping[str, Any]) -> LagSimConfig:
    """The port's ``LagSimConfig`` from a reference config's field dict.
    Unknown fields raise ``ValueError``; a set ``control_plane`` or
    ``telemetry`` raises :class:`NotPortedError`."""
    known = {f.name for f in dataclasses.fields(LagSimConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"fields {sorted(unknown)} are not LagSimConfig "
                         f"fields; have {sorted(known)}")
    for name in ("control_plane", "telemetry"):
        if fields.get(name) is not None:
            raise NotPortedError(
                f"LagSimConfig.{name} is not yet ported to repro_torch")
    return LagSimConfig(**dict(fields))


class LoopState(NamedTuple):
    """The twin's carry on the port's device."""

    lag: torch.Tensor                       # f32[..., N]
    prev_assign: torch.Tensor               # i64[..., N] (-1 = unassigned)
    reactive_state: Optional[Tuple[torch.Tensor, ...]]  # (n_cur, under)


def state_from_numpy(initial_lag, prev_assign=None, reactive_state=None,
                     device=None) -> LoopState:
    """Numpy loop state -> port tensors on ``device`` (``None`` = the CUDA
    card).  ``prev_assign`` defaults to all ``-1``; ``reactive_state`` is
    the reactive scalers' ``(n_current, under_count)`` pair."""
    dev = resolve_device(device)
    lag = torch.as_tensor(np.asarray(initial_lag, np.float32), device=dev)
    if prev_assign is None:
        prev = torch.full(lag.shape, -1, dtype=torch.long, device=dev)
    else:
        prev = torch.as_tensor(np.asarray(prev_assign, np.int64), device=dev)
        if prev.shape != lag.shape:
            raise ValueError(f"prev_assign has shape {tuple(prev.shape)}, "
                             f"initial_lag {tuple(lag.shape)}")
    react = None
    if reactive_state is not None:
        react = tuple(torch.as_tensor(np.asarray(x, np.int64), device=dev)
                      for x in reactive_state)
    return LoopState(lag=lag, prev_assign=prev, reactive_state=react)


def anneal_noise_from_numpy(gumbel, temps, device=None) -> AnnealNoise:
    """Numpy draws -> the annealer's ``AnnealNoise`` on ``device`` (``None``
    = the CUDA card): ``gumbel`` f32[steps, K, N*M+1] with "stay" last,
    ``temps`` f32[steps].  The reference's draws, made by a test with its
    own key chain, enter the port this way."""
    dev = resolve_device(device)
    g = torch.tensor(np.asarray(gumbel, np.float32), device=dev)
    t = torch.tensor(np.asarray(temps, np.float32), device=dev)
    if g.dim() != 3 or t.shape != (g.shape[0],):
        raise ValueError(f"gumbel must be f32[steps, K, N*M+1] and temps "
                         f"f32[steps]; got {list(g.shape)} and "
                         f"{list(t.shape)}")
    return AnnealNoise(gumbel=g, temps=t)

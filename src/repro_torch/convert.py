"""Carry the reference's state across to the port.

The lag twin has no weights: its counterparts are the configuration and
the loop's state.  ``config_from_reference`` takes
``dataclasses.asdict`` of a reference ``LagSimConfig``;
``state_from_numpy`` takes the loop state as numpy arrays;
``anneal_noise_from_numpy`` takes an anneal's random draws (the state of
a stochastic policy).  The LLM's weights come across with
``params_from_numpy``.  All are plain data in, port objects out, so a
test can feed one set of inputs to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.lagsim.engine import LagSimConfig, NotPortedError
from repro_torch.models import ArchConfig
from repro_torch.models.transformer import param_shapes
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


def params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                      device=None) -> dict:
    """The reference's parameter pytree (nested dicts of numpy arrays, any
    float dtype, bf16 included) -> the port's params on ``device`` (``None``
    = the CUDA card) in ``cfg.param_dtype``.

    The reference stacks the layers on a leading dim (``layers.attn.wq``
    is (L, d, H, hd)); the port keeps a list of per-layer dicts.  Leaf
    shapes are checked against ``cfg``: ``wq`` (d, H, hd), ``wo`` (H, hd,
    d) and so on.
    """
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def leaf(name, arr):
        t = torch.tensor(np.asarray(arr, np.float32), device=dev)
        if name not in shapes or tuple(t.shape) != shapes[name]:
            raise ValueError(f"parameter {name}: shape {tuple(t.shape)}, "
                             f"want {shapes.get(name, 'no such parameter')}")
        return t.to(cfg.pdtype)

    def walk(prefix, node, layer=None):
        """The subtree's leaves as tensors; ``layer`` picks one layer out
        of the stacked leaves."""
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = walk(f"{prefix}{k}.", v, layer)
            else:
                out[k] = leaf(f"{prefix}{k}", v if layer is None else v[layer])
        return out

    out = {k: walk(f"{k}.", v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [walk(f"layers.{i}.", tree["layers"], i)
                     for i in range(cfg.n_layers)]
    missing = set(shapes) - set(_names(out))
    if missing:
        raise ValueError(f"parameters missing from the tree: "
                         f"{sorted(missing)[:5]}")
    return out


def _names(node, prefix=""):
    if isinstance(node, Mapping):
        for k, v in node.items():
            yield from _names(v, f"{prefix}{k}.")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _names(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1]

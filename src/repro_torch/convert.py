"""Carry the reference's state across to the port.

The lag twin has no weights: its counterparts are the configuration and
the loop's state.  ``config_from_reference`` takes
``dataclasses.asdict`` of a reference ``LagSimConfig`` (its control
plane and telemetry included); ``state_from_numpy`` takes the loop state
as numpy arrays; ``anneal_noise_from_numpy`` takes an anneal's random
draws (the state of a stochastic policy); ``controlplane_state_from_numpy``,
``sketch_state_from_numpy`` and ``alert_state_from_numpy`` take a
control-plane-wrapped policy's state, a sketch state and an alert state
with numpy leaves, one stream or a batch of them.  The LLM's weights come
across with ``params_from_numpy``, its optimizer state with
``opt_state_from_numpy``, a dense or MoE model's decode state (the KV
cache, the tailed decode's tail and ``cache_len``) with
``decode_state_from_numpy``.  All are plain data in, port objects
out, so a test can feed one set of inputs to both packages, compare
their states leaf by leaf, and resume a port run from a reference state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.lagsim.controlplane import (ControlPlaneConfig,
                                             ControlPlaneState)
from repro_torch.lagsim.engine import LagSimConfig
from repro_torch.models import ArchConfig
from repro_torch.models.transformer import attention_layers, param_shapes
from repro_torch.opt.anneal import AnnealNoise
from repro_torch.telemetry.alerts import AlertConfig, AlertRule, AlertState
from repro_torch.telemetry.record import TelemetryConfig
from repro_torch.telemetry.sketch import SketchConfig, SketchState


def config_from_reference(fields: Mapping[str, Any]) -> LagSimConfig:
    """The port's ``LagSimConfig`` from a reference config's field dict
    (``dataclasses.asdict``, which turns the nested control plane and
    telemetry configs into dicts too).  Unknown fields raise
    ``ValueError``; a control plane or telemetry that is not a mapping is
    passed on as it is, for ``resolve`` to judge."""
    known = {f.name for f in dataclasses.fields(LagSimConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"fields {sorted(unknown)} are not LagSimConfig "
                         f"fields; have {sorted(known)}")
    fields = dict(fields)
    if isinstance(fields.get("control_plane"), Mapping):
        fields["control_plane"] = ControlPlaneConfig(
            **fields["control_plane"])
    if isinstance(fields.get("telemetry"), Mapping):
        fields["telemetry"] = _telemetry_config(fields["telemetry"])
    return LagSimConfig(**fields)


def _telemetry_config(d: Mapping[str, Any]) -> TelemetryConfig:
    d = dict(d)
    if isinstance(d.get("sketch"), Mapping):
        d["sketch"] = SketchConfig(**d["sketch"])
    if isinstance(d.get("alerts"), Mapping):
        al = dict(d["alerts"])
        al["rules"] = tuple(AlertRule(**r) if isinstance(r, Mapping) else r
                            for r in al["rules"])
        d["alerts"] = AlertConfig(**al)
    return TelemetryConfig(**d)


def _leaf(state, name):
    return state[name] if isinstance(state, Mapping) else getattr(state,
                                                                  name)


def _batched(state, names, lead: str):
    """The numpy leaves ``names`` of ``state``, given a leading batch axis
    when the state is one stream's (its ``lead`` leaf is a scalar)."""
    one = np.ndim(_leaf(state, lead)) == 0
    return {k: (np.asarray(_leaf(state, k))[None] if one
                else np.asarray(_leaf(state, k))) for k in names}


def controlplane_state_from_numpy(state, inner=None,
                                  device=None) -> ControlPlaneState:
    """A reference ``ControlPlaneState`` (one stream, or ``B`` streams
    stacked on a leading axis; numpy leaves, or a mapping of them) -> the
    port's, over rows ``B`` on ``device`` (``None`` = the CUDA card).

    The rows must share one ``tick`` (the port steps all rows together);
    the observation ring moves its slot axis in front of the rows.
    ``inner`` is the wrapped policy's state in the port's form; by
    default a tuple of integer arrays (the reactive scalers' ``(n_cur,
    under)``) becomes int64 tensors."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(ControlPlaneState)
             if f.name != "inner"]
    leaves = _batched(state, names, "tick")
    tick = leaves["tick"]
    if (tick != tick[0]).any():
        raise ValueError(f"the rows' ticks differ ({np.unique(tick)}); the "
                         f"port's rows share one step counter")
    out = {}
    for k, v in leaves.items():
        if k == "tick":
            v = v[0]
        elif k.startswith("obs_"):
            v = np.moveaxis(v, 1, 0)                 # [D+1, B, N]
        dtype = (torch.float32 if v.dtype.kind == "f" else torch.bool
                 if v.dtype == bool else torch.long)
        out[k] = torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                 device=dev)
    if inner is None:
        ref_inner = _leaf(state, "inner")
        if isinstance(ref_inner, (tuple, list)):
            inner = tuple(torch.as_tensor(np.asarray(x, np.int64).reshape(
                tick.shape), device=dev) for x in ref_inner)
        else:
            inner = ref_inner
    return ControlPlaneState(**out, inner=inner)


def sketch_state_from_numpy(state, device=None) -> SketchState:
    """A reference ``SketchState`` (numpy leaves, any leading batch shape,
    or a mapping of them with ``names`` and ``hist_names``) -> the port's
    on ``device`` (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    leaves = {f.name: torch.as_tensor(
        np.asarray(_leaf(state, f.name), np.float32), device=dev)
        for f in dataclasses.fields(SketchState)
        if f.name not in ("names", "hist_names")}
    return SketchState(**leaves, names=tuple(_leaf(state, "names")),
                       hist_names=tuple(_leaf(state, "hist_names")))


def alert_state_from_numpy(state, device=None) -> AlertState:
    """A reference ``AlertState`` (numpy leaves, any leading batch shape,
    or a mapping of them with ``rule_names``) -> the port's on ``device``
    (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    leaves = {}
    for f in dataclasses.fields(AlertState):
        if f.name == "rule_names":
            continue
        v = np.asarray(_leaf(state, f.name))
        dtype = (torch.float32 if v.dtype.kind == "f" else torch.bool
                 if v.dtype == bool else torch.int32)
        leaves[f.name] = torch.as_tensor(v, dtype=dtype, device=dev)
    return AlertState(**leaves, rule_names=tuple(_leaf(state,
                                                       "rule_names")))


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
    is (L, d, H, hd); a hybrid model's ``layers.sub{j}.mix.w_in`` is
    stacked over its periods; whisper's ``enc_layers.*`` over its encoder
    layers); the port keeps a list of per-layer dicts, layer ``p * period
    + j`` for period ``p``'s ``sub{j}``.  Leaf shapes
    are checked against ``cfg``: ``wq`` (d, H, hd), ``wo`` (H, hd, d), a
    MoE layer's ``wi`` (E, d, f) and so on.  A MoE router stays float32
    whatever ``param_dtype`` is, as the reference draws it: routing on
    rounded router weights would pick other experts.
    """
    return _layers_from_numpy(tree, cfg, resolve_device(device), cfg.pdtype)


def opt_state_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                         device=None) -> dict:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy leaves;
    the moments stacked over layers like its parameters) -> the port's
    (``optim.adamw_init``'s form) on ``device`` (``None`` = the CUDA
    card): float32 moments in the port's parameter tree, an int32
    ``step``.  With ``params_from_numpy`` it turns a reference checkpoint,
    read by ``checkpoint.restore_checkpoint`` without a target, into port
    state."""
    dev = resolve_device(device)
    return {"mu": _layers_from_numpy(tree["mu"], cfg, dev, torch.float32),
            "nu": _layers_from_numpy(tree["nu"], cfg, dev, torch.float32),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}


def decode_state_from_numpy(state: Mapping[str, Any], cfg: ArchConfig,
                            device=None) -> dict:
    """The reference's decode state of a dense or MoE model (numpy leaves:
    ``cache_len`` (), ``kv`` {k, v} (L, B, KV, S, hd) and, with
    ``decode_tail_window = W > 0``, ``tail`` {k, v} (L, B, KV, W, hd)) ->
    the port's on ``device`` (``None`` = the CUDA card): the same layout
    (both kv-major) in the activation dtype, ``cache_len`` an int32
    scalar, so that a port run resumes from a reference state mid-run
    (between flushes included).  Shapes are checked against ``cfg``."""
    if cfg.rwkv or cfg.encoder_decoder or cfg.attn_layer_period > 0:
        raise ValueError(f"{cfg.name}: decode_state_from_numpy takes the KV "
                         f"cache state of a dense or MoE model")
    dev = resolve_device(device)
    names = ("kv", "tail") if cfg.decode_tail_window > 0 else ("kv",)
    if set(state) != {"cache_len", *names}:
        raise ValueError(f"decode state keys {sorted(state)}, want "
                         f"{sorted(['cache_len', *names])}")
    out = {"cache_len": torch.tensor(int(np.asarray(state["cache_len"])),
                                     dtype=torch.int32, device=dev)}
    layers = len(attention_layers(cfg))
    for name in names:
        out[name] = {}
        rows = cfg.decode_tail_window if name == "tail" else None
        for k in ("k", "v"):
            t = torch.tensor(np.asarray(state[name][k], np.float32),
                             device=dev).to(cfg.adtype)
            if (t.dim() != 5 or t.shape[0] != layers
                    or t.shape[2] != cfg.n_kv_heads
                    or t.shape[4] != cfg.head_dim
                    or rows not in (None, t.shape[3])):
                raise ValueError(
                    f"decode state {name}.{k}: shape {tuple(t.shape)}, want "
                    f"(L, B, KV, {'W' if rows else 'S'}, hd) with L = "
                    f"{layers}, KV = {cfg.n_kv_heads}, hd = {cfg.head_dim}"
                    + (f", W = {rows}" if rows else ""))
            out[name][k] = t
    return out


def _layers_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig,
                       dev: torch.device, dtype: torch.dtype) -> dict:
    """A tree shaped like the reference's parameters (stacked layers) ->
    the port's (a list of per-layer dicts), each leaf checked against
    ``cfg``'s shapes and cast to ``dtype``."""
    shapes = param_shapes(cfg)

    def leaf(name, arr):
        t = torch.tensor(np.asarray(arr, np.float32), device=dev)
        if name not in shapes or tuple(t.shape) != shapes[name]:
            raise ValueError(f"parameter {name}: shape {tuple(t.shape)}, "
                             f"want {shapes.get(name, 'no such parameter')}")
        return t.to(torch.float32 if name.endswith(".ffn.router") else dtype)

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

    stacked = ("layers", "enc_layers")
    out = {k: walk(f"{k}.", v) if isinstance(v, Mapping) else leaf(k, v)
           for k, v in tree.items() if k not in stacked}
    if cfg.encoder_decoder:
        out["enc_layers"] = [walk(f"enc_layers.{i}.", tree["enc_layers"], i)
                             for i in range(cfg.n_encoder_layers)]
    period = (cfg.attn_layer_period
              if cfg.attn_layer_period > 0 and not cfg.rwkv else 0)
    if period:      # layers.sub{j}.*[p] -> layer p * period + j
        out["layers"] = [walk(f"layers.{i}.",
                              tree["layers"][f"sub{i % period}"], i // period)
                         for i in range(cfg.n_layers)]
    else:
        out["layers"] = [walk(f"layers.{i}.", tree["layers"], i)
                         for i in range(cfg.n_layers)]
    # subtrees without leaves (a non-parametric norm, a tied head) are not
    # in a checkpoint; the port's tree keeps them as empty dicts
    for k in ("final_norm", "lm_head"):
        out.setdefault(k, {})
    for lp in out["layers"] + out.get("enc_layers", []):
        for ln in ("ln1", "ln2") + (("ln3",) if "cross_attn" in lp else ()):
            lp.setdefault(ln, {})
    if cfg.encoder_decoder:
        out.setdefault("enc_norm", {})
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

"""Fused multi-step path of the lag twin for the heuristic packer family.

The heuristic bin STRUCTURE of a step -- the creation slot of each item,
the item that created each slot, the bin count -- depends only on that
step's speeds, never on the previous assignment.  So it is computed
WIDE over all T steps and all ``R = policies x streams`` rows at once,
and only the Sec. IV-C sticky NAMING plus the lag/downtime carry run
step by step (``_fused_wide``, the ``fused_kernel=False`` path).  With
``fused_kernel=True`` the ``loop_fused`` CUDA kernel runs the whole loop
instead, one thread per row across all T steps.

Routing (``LagSimConfig.fused_steps > 0``):

=====================  ==========================================
policy / config        fused path behavior
=====================  ==========================================
heuristic family       fused (``fused_kernel=True`` launches the
                       ``loop_fused`` kernel when no sketch or alert
                       is on; otherwise ``_fused_wide`` runs them)
sticky family          falls back to the per-step loop (the Modified
                       Any Fit schedule depends on the carry)
reactive (idealized)   falls back to the per-step loop
reactive (REAL)        raises :class:`FusedPathError` (control-plane
                       wrapped)
optimizer family       raises :class:`FusedPathError`
control_plane set      raises :class:`FusedPathError`
telemetry frames/ring  falls back (per-step frames are recorded by
                       the per-step loop only; sketch and alert
                       states come from ``_fused_wide``)
n > 14 partitions      falls back (32-bit name-mask limit)
use_kernel=True        falls back (the reference routes per-step drain
                       kernel runs to the unfused loop)
=====================  ==========================================

``_fused_wide`` computes each step's channel vector inside its loop and
feeds it to the same ``sketch_update`` / ``alert_step`` sequence as the
per-step loop (the reference replays the vectors after its scan); the
``loop_fused`` kernel carries no telemetry, as the reference's
megakernel carries none.

Results do not depend on ``fused_steps`` (K): ``LagSimConfig.resolve``
validates it (>= 1 with ``fused_kernel``), and otherwise it only names the
reference's block size; neither fused path takes it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.loop_fused import (MAX_PARTITIONS, NEG, _consts,
                                            _name_drain, _order, _outputs,
                                            _per_policy, _record,
                                            _select_consts, _struct,
                                            loop_fused)
from repro_torch.registry import get_spec
from repro_torch.telemetry.alerts import alert_init, alert_step
from repro_torch.telemetry.record import map_state, record_step
from repro_torch.telemetry.sketch import sketch_init, sketch_update

FUSED_MAX_PARTITIONS = MAX_PARTITIONS


class FusedPathError(ValueError):
    """``fused_steps`` was combined with a policy or config whose state
    cannot live inside the fused loop (an optimizer, a control plane).
    Drop ``fused_steps`` or the offending piece."""


def _controlplane_wrapped(spec) -> bool:
    """True for self-wrapped REAL scaler families: their hyperparams carry
    the control-plane knob set (``ControlPlaneConfig.knobs()``)."""
    from repro_torch.lagsim.controlplane import ControlPlaneConfig

    return bool(set(ControlPlaneConfig().knobs()) & set(spec.hyperparams))


def fused_mode(policy: str, cfg, n: int) -> str:
    """Route one policy under ``cfg.fused_steps > 0``: ``"fused"`` or
    ``"unfused"`` (documented fallback); raises :class:`FusedPathError`
    for a combination the fused path refuses (see the module table)."""
    spec = get_spec(policy)
    if spec.family == "optimizer":
        raise FusedPathError(
            f"fused_steps is incompatible with optimizer policy "
            f"{spec.name!r}: its PRNG-carrying anneal state cannot run "
            f"inside the fused loop; drop fused_steps or the policy")
    if cfg.control_plane is not None:
        raise FusedPathError(
            "fused_steps is incompatible with control_plane: scaler "
            "friction (polling/delay/cooldown/rebalance storm) wraps every "
            "policy in state the fused loop does not model; drop "
            "fused_steps or control_plane")
    if spec.family == "reactive" and _controlplane_wrapped(spec):
        raise FusedPathError(
            f"fused_steps is incompatible with control-plane-wrapped "
            f"policy {spec.name!r}; drop fused_steps or use the idealized "
            f"variant of the scaler")
    if spec.family != "heuristic" or n > FUSED_MAX_PARTITIONS:
        return "unfused"
    tele = cfg.telemetry
    if tele is not None and tele.enabled and tele.record_frames:
        # per-step frame recording (ring mode included) is the per-step
        # loop's only
        return "unfused"
    if cfg.use_kernel:
        return "unfused"
    return "fused"


def _heuristics(policies: Sequence[str]) -> Tuple[list, list]:
    hyper = [get_spec(p).hyperparams for p in policies]
    return ([h["strategy"] for h in hyper],
            [bool(h["decreasing"]) for h in hyper])


def _prep(traces, decreasing: Sequence[bool], active):
    """Traversal-ordered per-step views ``[T, R, N]`` for every (policy,
    stream) row ``p * B + b``: speeds and item index in traversal order,
    each item's position, and the active mask in traversal order."""
    b, t, n = traces.shape
    p = len(decreasing)
    wide = lambda x: x.transpose(0, 1).repeat(1, p, 1)  # noqa: E731  [T, R, N]
    speeds = wide(traces)
    order_d, rank_d = _order(speeds)
    dec = torch.tensor(decreasing, device=traces.device
                       ).repeat_interleave(b).unsqueeze(1)
    iota = torch.arange(n, device=traces.device)
    order = torch.where(dec, order_d, iota)
    pos = torch.where(dec, rank_d, iota)
    act_ord = None if active is None else wide(active).gather(2, order)
    return speeds.gather(2, order), order, pos, act_ord


def _fused_wide(policies: Tuple[str, ...], traces, cfg, active,
                initial_lag, record_assign: bool, tele=None, valid=None):
    """Structure wide over T, then one lean loop over naming + drain.
    Returns ``loop_fused``'s outputs with a leading ``[P, B]``, then the
    sketch and alert states of rows ``p * B + b`` (``None`` unless
    ``tele`` turns them on; ``valid`` bool[B, T] gates their updates)."""
    b, t, n = traces.shape
    p = len(policies)
    dev = traces.device
    strategies, decreasing = _heuristics(policies)
    cap, cap_step, dt = _consts(cfg.capacity, cfg.dt)
    is_next, a_sgn, b_first = _select_consts(strategies, b, dev)
    sp_ord, order, pos, act_ord = _prep(traces, decreasing, active)
    slot_ord, creator, kk = _struct(sp_ord, order, act_ord, cap, is_next,
                                    a_sgn, b_first)
    slot_of = slot_ord.gather(2, pos)                          # [T, R, N]
    rates = traces.repeat(p, 1, 1)                             # [R, T, N]
    act_r = None if active is None else active.bool().repeat(p, 1, 1)
    lag = (torch.zeros(p * b, n, device=dev) if initial_lag is None
           else initial_lag.float().repeat(p, 1))
    prev = torch.full((p * b, n), NEG, dtype=torch.long, device=dev)
    down = torch.zeros_like(prev)
    out = _outputs(p * b, t, n, record_assign, dev)
    sketch_on = tele is not None and tele.sketch is not None
    alerts_on = tele is not None and tele.alerts is not None
    sk = al = None
    if sketch_on:
        sk = sketch_init(tele.sketch, tele.base_channels, batch=(p * b,),
                         device=dev)
    if alerts_on:
        al = alert_init(tele.alerts, batch=(p * b,), device=dev)
        no_storm = torch.zeros(p * b, device=dev)
    ok_r = None if valid is None else valid.bool().repeat(p, 1)
    for step in range(t):
        act = None if act_r is None else act_r[:, step]
        produced = rates[:, step] * dt
        if act is not None:
            produced = torch.where(act, produced, 0.0)
        lag, prev, down, moved, unread = _name_drain(
            lag, prev, down, produced, act, slot_of[step], creator[step],
            kk[step], cap_step=cap_step, mig=int(cfg.migration_steps))
        _record(out, step, lag, kk[step], moved, unread, prev)
        ok = None if ok_r is None else ok_r[:, step]
        if sketch_on:
            vec, _ = record_step(
                tele, speeds=rates[:, step], new_lag=lag, moved=moved,
                blocked=unread, storm=None, n_consumers=kk[step], act_t=act,
                capacity=cfg.capacity, pstate=None)
            sk = sketch_update(tele.sketch, sk, vec, valid=ok)
        if alerts_on:
            al = alert_step(tele.alerts, al, lag_total=out[0][:, step],
                            consumers=kk[step], unreadable=out[4][:, step],
                            storm_parts=no_storm, slo_lag=cfg.slo_lag,
                            valid=ok)
    return _per_policy(out, p, b), sk, al


def sweep_fused(policies: Tuple[str, ...], traces, cfg,
                active: Optional[torch.Tensor] = None,
                initial_lag: Optional[torch.Tensor] = None,
                record_assign: bool = False,
                valid: Optional[torch.Tensor] = None) -> Dict[str, dict]:
    """Family-batched fused sweep of heuristic ``policies`` over ``traces
    f32[B, T, N]``.  Returns ``{policy: LagTrace field dict}`` of ``[B, T]``
    tensors (plus ``assigns [B, T, N]`` with ``record_assign``, and the
    ``[B]``-led ``sketch`` / ``incidents`` states when a sketch or alerts
    are on).  ``valid`` (bool[B, T]) gates the sketch and alert updates
    on padded steps."""
    traces = traces.to(torch.float32)
    b = traces.shape[0]
    cfg = cfg.resolve(traces.shape[2])
    tele = cfg.telemetry if cfg.telemetry_on else None
    obs_on = tele is not None and (tele.sketch is not None
                                   or tele.alerts is not None)
    sk = al = None
    if cfg.fused_kernel and not obs_on:
        # the kernel carries no telemetry: with a sketch or alerts on,
        # _fused_wide runs the loop and emits them
        strategies, decreasing = _heuristics(policies)
        outs = loop_fused(traces, strategies=strategies,
                          decreasing=decreasing, capacity=cfg.capacity,
                          dt=cfg.dt, migration_steps=cfg.migration_steps,
                          active=active,
                          initial_lag=initial_lag,
                          record_assign=record_assign)
    else:
        outs, sk, al = _fused_wide(policies, traces, cfg, active,
                                   initial_lag, record_assign, tele, valid)
    names = ("lag_total", "lag_max", "consumers", "migrations",
             "unreadable", "assigns")
    out = {name: dict(zip(names, (o[pi] for o in outs)))
           for pi, name in enumerate(policies)}
    if obs_on:
        for pi, name in enumerate(policies):
            rows = slice(pi * b, (pi + 1) * b)
            out[name].update(
                sketch=map_state(lambda a: a[rows], sk),
                incidents=map_state(lambda a: a[rows], al))
    return out


def simulate_fused(trace, initial_lag, policy: str, cfg,
                   active: Optional[torch.Tensor] = None,
                   record_assign: bool = False):
    """Single-stream fused run: ``trace f32[T, N]`` -> ``LagTrace`` of
    ``[T]`` tensors, or ``(LagTrace, assigns [T, N])``."""
    from repro_torch.lagsim.engine import LagTrace, _first

    fields = sweep_fused(
        (policy,), trace[None], cfg,
        active=None if active is None else active[None],
        initial_lag=None if initial_lag is None else initial_lag[None],
        record_assign=record_assign)[policy]
    assigns = fields.pop("assigns", None)
    out = _first(LagTrace(**fields))
    return (out, assigns[0]) if record_assign else out

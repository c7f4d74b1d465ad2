"""The port's policy registry: every assignment policy it can run.

The reference registry (``repro.registry``) is closed to its ``py`` and
``jax`` backends, so the port keeps its own.  Its names, families and
hyperparameters equal the reference's for every policy ported so far
(a test holds them equal).

* ``PolicySpec``  -- name, family (``heuristic|sticky|optimizer|
  reactive``), hyperparams, builder, one-shot packer and paper section.
* ``Policy``      -- the batched protocol every policy satisfies::

      init(n) -> state
      step(speeds, lag, prev, state, active=None)
          -> (assign i64[R, N], n_consumers i64[R], state')

  over rows ``R`` (one row = one stream).  ``active`` (bool[R, N]) marks
  the partitions that exist: an inactive one comes back ``-1``, adds no
  load and never raises the consumer count.  State may start as 0-dim
  tensors and broadcast to ``[R]`` on the first step.

  A policy may publish custom per-step counters to the in-loop flight
  recorder by wrapping its state as
  ``repro_torch.telemetry.CounterState(counters=f32[R, K], inner=state,
  names=(...))``: when ``LagSimConfig.telemetry`` is on, the engine
  appends those named counters to every recorded step's channel vector
  (see ``repro_torch.telemetry.record``).  Policies that do not care
  return their plain state, and the recorder records its base channels.
* ``register`` / ``make_policy`` / ``get_spec`` / ``list_policies`` /
  ``packer_for`` -- publication and discovery, in registration order.
"""
from __future__ import annotations

import dataclasses
import types
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Sequence, Tuple, Union)

FAMILIES: Tuple[str, ...] = ("heuristic", "sticky", "optimizer", "reactive")
#: the families whose members are one-shot bin packers (have a ``packer``)
PACKER_FAMILIES: Tuple[str, ...] = ("heuristic", "sticky")


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Registered metadata of one policy."""

    name: str                       # canonical upper-case name
    family: str                     # heuristic | sticky | optimizer | reactive
    hyperparams: Mapping[str, Any]  # default knobs, overridable
    builder: Callable               # (n, capacity, device, **hyper) -> (init, step)
    packer: Optional[Callable] = None   # one-shot packer (packer families)
    paper_section: str = ""
    summary: str = ""


class Policy(NamedTuple):
    """A built policy: the batched ``(init, step)`` pair plus its spec."""

    init: Callable[[int], Any]
    step: Callable[..., Tuple[Any, Any, Any]]
    spec: PolicySpec


_REGISTRY: Dict[str, PolicySpec] = {}
_BUILTINS_LOADED = False
_BUILTINS_LOADING = False       # reentrancy guard: builtin.py calls register()


def _ensure_builtins() -> None:
    global _BUILTINS_LOADED, _BUILTINS_LOADING
    if _BUILTINS_LOADED or _BUILTINS_LOADING:
        return
    _BUILTINS_LOADING = True
    try:
        from . import builtin  # noqa: F401  (registers on import)
    except BaseException:
        _REGISTRY.clear()
        raise
    finally:
        _BUILTINS_LOADING = False
    _BUILTINS_LOADED = True


def register(name: str, *, family: str, hyperparams: Optional[dict] = None,
             packer: Optional[Callable] = None, paper_section: str = "",
             summary: str = "") -> Callable:
    """Decorator: publish ``builder(n, capacity, device, **hyperparams)``
    as policy ``name``.  A duplicate name is an error."""
    _ensure_builtins()
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; have {FAMILIES}")
    canonical = name.upper()

    def deco(builder: Callable) -> Callable:
        if canonical in _REGISTRY:
            raise ValueError(f"policy {canonical!r} already registered")
        _REGISTRY[canonical] = PolicySpec(
            name=canonical, family=family,
            hyperparams=types.MappingProxyType(dict(hyperparams or {})),
            builder=builder, packer=packer, paper_section=paper_section,
            summary=summary)
        return builder

    return deco


def list_policies(family: Union[None, str, Sequence[str]] = None
                  ) -> Tuple[str, ...]:
    """Registered names in registration order, optionally filtered by
    ``family`` (a name or a tuple of names)."""
    _ensure_builtins()
    if family is None:
        return tuple(_REGISTRY)
    fams = (family,) if isinstance(family, str) else tuple(family)
    for f in fams:
        if f not in FAMILIES:
            raise ValueError(f"unknown family {f!r}; have {FAMILIES}")
    return tuple(n for n, s in _REGISTRY.items() if s.family in fams)


def get_spec(name: str) -> PolicySpec:
    """The ``PolicySpec`` of ``name`` (case-insensitive)."""
    _ensure_builtins()
    spec = _REGISTRY.get(name.upper())
    if spec is None:
        raise ValueError(
            f"unknown policy {name!r}; the port has {sorted(_REGISTRY)}")
    return spec


def make_policy(name: str, n: int, capacity: float = 1.0, *, device=None,
                strict: bool = True, options: Optional[Mapping] = None,
                **overrides) -> Policy:
    """Build the ``Policy`` for ``name`` over ``n`` partitions of consumer
    capacity ``capacity`` on ``device`` (``None`` = the CUDA card).
    ``strict=False`` ignores overrides the spec does not declare, so the
    lag twin can pass one uniform knob set to every policy.  ``options``
    are run-time builder arguments that are not hyperparameters: only the
    optimizer family takes one, ``noise`` (a sequence of
    ``opt.AnnealNoise``, one per decision, in place of its generator)."""
    from repro_torch._device import resolve_device

    spec = get_spec(name)
    hyper = dict(spec.hyperparams)
    unknown = set(overrides) - set(hyper)
    if unknown and strict:
        raise ValueError(
            f"policy {spec.name!r} does not take hyperparams "
            f"{sorted(unknown)}; declared: {sorted(hyper)}")
    hyper.update({k: v for k, v in overrides.items() if k in hyper})
    options = dict(options or {})
    if options and (spec.family != "optimizer" or set(options) - {"noise"}):
        raise ValueError(
            f"policy {spec.name!r} ({spec.family}) does not take options "
            f"{sorted(options)}; only the optimizer family takes 'noise'")
    init, step = spec.builder(n, capacity, resolve_device(device), **hyper,
                              **options)
    return Policy(init=init, step=step, spec=spec)


def packer_for(name: str) -> Callable:
    """The one-shot packer registered for ``name``: ``fn(speeds f32[R, N],
    prev int[R, N], capacity, active=None) -> PackedRows``, batched over
    rows.  Policies outside the packer families have none and raise
    ``ValueError``."""
    spec = get_spec(name)
    if spec.packer is None:
        raise ValueError(
            f"policy {spec.name!r} ({spec.family}) has no one-shot packer")
    return spec.packer


__all__ = [
    "FAMILIES",
    "PACKER_FAMILIES",
    "Policy",
    "PolicySpec",
    "get_spec",
    "list_policies",
    "make_policy",
    "packer_for",
    "register",
]

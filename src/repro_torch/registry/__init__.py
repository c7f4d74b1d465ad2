"""The port's policy registry: every assignment policy it can run.

The reference registry (``repro.registry``) is closed to its ``py`` and
``jax`` backends, so the port keeps its own, with the backends
``BACKENDS = ("py", "torch")``: ``torch`` is the port's counterpart of
the reference's ``jax`` (the batched tensor path, on the card), and
``py`` holds the same pure-Python packers as the reference's ``py``.
Names, families and hyperparameters equal the reference's, backend for
backend (a test holds them equal).

* ``PolicySpec``  -- name, family (``heuristic|sticky|optimizer|
  reactive``), backend, hyperparams, builder, one-shot packer and paper
  section.
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

  ``py``-backend policies satisfy the reference's ``py`` protocol on one
  stream's numpy arrays (``assign i32[N]``, ``n_consumers``).
* ``register`` / ``make_policy`` / ``get_spec`` / ``list_policies`` /
  ``packer_for`` -- publication and discovery, filterable by family and
  backend, in registration order.
"""
from __future__ import annotations

import dataclasses
import types
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple, Union)

FAMILIES: Tuple[str, ...] = ("heuristic", "sticky", "optimizer", "reactive")
#: ``torch`` is the port's counterpart of the reference's ``jax`` backend
BACKENDS: Tuple[str, ...] = ("py", "torch")
#: the families whose members are one-shot bin packers (have a ``packer``)
PACKER_FAMILIES: Tuple[str, ...] = ("heuristic", "sticky")


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Registered metadata of one (name, backend) policy variant."""

    name: str                       # canonical upper-case name
    family: str                     # heuristic | sticky | optimizer | reactive
    backend: str                    # py | torch
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


_REGISTRY: Dict[Tuple[str, str], PolicySpec] = {}
_ORDER: List[str] = []          # canonical names in first-registration order
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
        _ORDER.clear()
        raise
    finally:
        _BUILTINS_LOADING = False
    _BUILTINS_LOADED = True


def _check_backend(backend: Optional[str]) -> None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")


def register(name: str, *, family: str, backend: str = "torch",
             hyperparams: Optional[dict] = None,
             packer: Optional[Callable] = None, paper_section: str = "",
             summary: str = "") -> Callable:
    """Decorator: publish ``builder(n, capacity, device, **hyperparams)``
    as policy ``name`` on ``backend``.  A duplicate (name, backend) pair
    is an error."""
    _ensure_builtins()
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; have {FAMILIES}")
    _check_backend(backend)
    canonical = name.upper()

    def deco(builder: Callable) -> Callable:
        key = (canonical, backend)
        if key in _REGISTRY:
            raise ValueError(
                f"policy {canonical!r} already registered for backend "
                f"{backend!r}")
        _REGISTRY[key] = PolicySpec(
            name=canonical, family=family, backend=backend,
            hyperparams=types.MappingProxyType(dict(hyperparams or {})),
            builder=builder, packer=packer, paper_section=paper_section,
            summary=summary)
        if canonical not in _ORDER:
            _ORDER.append(canonical)
        return builder

    return deco


def list_policies(family: Union[None, str, Sequence[str]] = None,
                  backend: Optional[str] = None) -> Tuple[str, ...]:
    """Registered names in registration order, optionally filtered by
    ``family`` (a name or a tuple of names) and/or ``backend``."""
    _ensure_builtins()
    fams = None
    if family is not None:
        fams = (family,) if isinstance(family, str) else tuple(family)
        for f in fams:
            if f not in FAMILIES:
                raise ValueError(f"unknown family {f!r}; have {FAMILIES}")
    _check_backend(backend)
    out = []
    for name in _ORDER:
        for bk in BACKENDS if backend is None else (backend,):
            spec = _REGISTRY.get((name, bk))
            if spec is not None and (fams is None or spec.family in fams):
                out.append(name)
                break
    return tuple(out)


def get_spec(name: str, backend: Optional[str] = None) -> PolicySpec:
    """The ``PolicySpec`` of ``name`` (case-insensitive); with
    ``backend=None`` the ``torch`` variant is preferred and ``py`` is the
    fallback, as the reference prefers ``jax``."""
    _ensure_builtins()
    _check_backend(backend)
    canonical = name.upper()
    for bk in (backend,) if backend is not None else ("torch", "py"):
        spec = _REGISTRY.get((canonical, bk))
        if spec is not None:
            return spec
    registered_on = tuple(bk for bk in BACKENDS
                          if (canonical, bk) in _REGISTRY)
    if registered_on:
        raise ValueError(
            f"policy {canonical!r} is not registered for backend "
            f"{backend!r} (available backends: {registered_on})")
    raise ValueError(
        f"unknown policy {name!r}; the port has {sorted(_ORDER)}")


def make_policy(name: str, n: int, capacity: float = 1.0, *,
                backend: Optional[str] = None, device=None,
                strict: bool = True, options: Optional[Mapping] = None,
                **overrides) -> Policy:
    """Build the ``Policy`` for ``name`` over ``n`` partitions of consumer
    capacity ``capacity`` on ``device`` (``None`` = the CUDA card; a
    ``py`` policy runs on the host and takes no device).
    ``strict=False`` ignores overrides the spec does not declare, so the
    lag twin can pass one uniform knob set to every policy.  ``options``
    are run-time builder arguments that are not hyperparameters: only the
    optimizer family takes one, ``noise`` (a sequence of
    ``opt.AnnealNoise``, one per decision, in place of its generator)."""
    from repro_torch._device import resolve_device

    spec = get_spec(name, backend=backend)
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
    dev = resolve_device(device) if spec.backend == "torch" else None
    init, step = spec.builder(n, capacity, dev, **hyper, **options)
    return Policy(init=init, step=step, spec=spec)


def packer_for(name: str, backend: str = "torch") -> Callable:
    """The one-shot packer registered for ``name`` on ``backend``.

    ``torch``: ``fn(speeds f32[R, N], prev int[R, N], capacity,
    active=None) -> PackedRows``, batched over rows.  ``py``: ``fn(speeds,
    capacity, prev=None, ...) -> PackResult`` on dicts (the reference's
    ``py`` packers; a masked partition is absent from the ``speeds``
    map).  Policies outside the packer families have none and raise
    ``ValueError``."""
    _ensure_builtins()
    _check_backend(backend)
    spec = _REGISTRY.get((name.upper(), backend))
    if spec is None:
        raise ValueError(
            f"unknown algorithm {name!r} for backend {backend!r}; have "
            f"{sorted(list_policies(family=PACKER_FAMILIES, backend=backend))}")
    if spec.packer is None:
        raise ValueError(
            f"policy {spec.name!r} ({spec.family}) has no one-shot packer")
    return spec.packer


__all__ = [
    "BACKENDS",
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

"""Scaling-policy catalogue of the closed-loop lag twin: the lag-twin
view of the registry, as ``repro.lagsim.policies`` keeps it.

Every policy -- the paper's 12 packers, the ``ANNEAL``/``ANNEAL_STICKY``
optimizers and the reactive scalers -- is registered in one place
(``repro_torch.registry.builtin``) behind the batched protocol::

  init(n) -> state0
  step(speeds, lag, prev_assign, state, active=None)
      -> (assign i64[R, N], n_consumers i64[R], state')

The family name tables below are derived from the registry, and the old
``make_policy`` entry point forwards to ``repro_torch.registry.make_policy``
(which is what ``engine.py`` calls directly).  ``ALL_POLICY_NAMES`` is
deprecated -- use ``repro_torch.registry.list_policies(backend="torch")``.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.registry import PACKER_FAMILIES, list_policies
from repro_torch.registry import make_policy as _registry_make_policy
from repro_torch.registry.builtin import (  # noqa: F401  (re-exported constants)
    ANNEAL_CHAINS,
    ANNEAL_STEPS,
    ANNEAL_STICKY_LAMBDA,
)

PACKING_POLICY_NAMES: Tuple[str, ...] = list_policies(
    family=PACKER_FAMILIES, backend="torch")
REACTIVE_BASELINE_NAMES: Tuple[str, ...] = list_policies(family="reactive")
OPTIMIZER_POLICY_NAMES: Tuple[str, ...] = list_policies(family="optimizer")


def __getattr__(name: str):
    # deprecation shim: the concatenated name table is now the registry's
    # torch-backend listing
    if name == "ALL_POLICY_NAMES":
        from repro_torch.registry.compat import warn_deprecated

        warn_deprecated(__name__, "ALL_POLICY_NAMES",
                        "repro_torch.registry.list_policies(backend='torch')")
        return list_policies(backend="torch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_policy(name: str, n: int, capacity, *, lag_threshold,
                target_utilization, max_consumers, scale_down_patience,
                device=None):
    """Build ``(init, step)`` for ``name`` over ``n`` partitions on
    ``device`` (``None`` = the CUDA card).

    Compatibility wrapper over ``repro_torch.registry.make_policy``:
    ``capacity``/``lag_threshold`` are in bytes *per step* (the engine
    pre-multiplies by dt).  Unknown names raise ValueError.
    """
    policy = _registry_make_policy(
        name, n, capacity, backend="torch", device=device, strict=False,
        lag_threshold=lag_threshold, target_utilization=target_utilization,
        max_consumers=max_consumers, scale_down_patience=scale_down_patience)
    return policy.init, policy.step

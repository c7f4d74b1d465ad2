"""Deprecation shims for the pre-registry policy name tables, as the
reference keeps them.

``core.modified.ALL_ALGORITHMS``, ``core.pack.ALL_ALGORITHM_NAMES`` and
``lagsim.policies.ALL_POLICY_NAMES`` keep working through module
``__getattr__`` hooks that forward to the registry and emit one
``DeprecationWarning`` per attribute per process.  New code should call
``repro_torch.registry.list_policies`` / ``packer_for`` instead.
"""
from __future__ import annotations

import warnings
from typing import Set, Tuple

_WARNED: Set[Tuple[str, str]] = set()


def warn_deprecated(module: str, attr: str, replacement: str) -> None:
    """Emit the deprecation warning for ``module.attr`` exactly once per
    process (repeat accesses stay silent so hot loops cannot spam)."""
    key = (module, attr)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(
        f"{module}.{attr} is deprecated; use {replacement} "
        f"(see repro_torch.registry)", DeprecationWarning, stacklevel=3)


def _reset_deprecation_warnings() -> None:
    """Test hook: make the next access of every shimmed attribute warn
    again."""
    _WARNED.clear()

"""Evaluation metrics of the paper (Sec. VI-B), over per-iteration traces.

* Cardinal Bin Score  CBS_delta(a)  -- Eq. 12: mean relative excess bins of
  algorithm ``a`` over the per-iteration best algorithm.  Encodes
  operational cost; lower is better.
* Pareto front over (CBS, E[R])     -- Fig. 9.

Copies of ``repro.core.metrics.cbs_from_bins`` and ``pareto_front``
(numpy and plain Python).
"""
from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np


def cbs_from_bins(z) -> np.ndarray:
    """Eq. 12 on a per-iteration bin-count matrix ``(A, N)`` (algorithms x
    iterations): mean relative excess over the per-iteration best."""
    z = np.asarray(z, dtype=np.float64)
    zmin = z.min(axis=0)
    zmin = np.maximum(zmin, 1.0)  # guard: zero bins only if zero load for all
    return ((z - zmin) / zmin).mean(axis=1)


def pareto_front(points: Mapping[str, Tuple[float, float]]) -> List[str]:
    """Names of non-dominated points, minimizing both coordinates.

    ``a`` dominates ``b`` iff a.x <= b.x and a.y <= b.y with at least one
    strict inequality.
    """
    front: List[str] = []
    for a, (ax, ay) in points.items():
        dominated = any(
            (bx <= ax and by <= ay) and (bx < ax or by < ay)
            for b, (bx, by) in points.items()
            if b != a
        )
        if not dominated:
            front.append(a)
    return sorted(front)

"""Evaluation metrics of the paper (Sec. VI-B) and the stream-evaluation
driver, over per-iteration traces.

* Cardinal Bin Score  CBS_delta(a)  -- Eq. 12: mean relative excess bins of
  algorithm ``a`` over the per-iteration best algorithm.  Encodes
  operational cost; lower is better.
* Average Rscore      E_delta^a(R)  -- Eq. 13: mean Rscore over a stream.
  Encodes rebalance cost; lower is better.
* Pareto front over (CBS, E[R])     -- Fig. 9.

Host code (numpy and plain Python) over the ``py`` packers, copies of
``repro.core.metrics``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from .assignment import PackResult
from .rscore import rscore


@dataclasses.dataclass
class StreamRun:
    """Per-iteration trace of one algorithm over one stream."""

    name: str
    bins: List[int] = dataclasses.field(default_factory=list)
    rscores: List[float] = dataclasses.field(default_factory=list)

    @property
    def average_rscore(self) -> float:  # Eq. 13
        return float(np.mean(self.rscores)) if self.rscores else 0.0


def run_stream(
    algorithms: Mapping[str, Callable],
    stream: np.ndarray,
    capacity: float,
    partition_ids: Sequence | None = None,
    active: np.ndarray | None = None,
) -> Dict[str, StreamRun]:
    """Evolve every algorithm independently over a (N, P) stream.

    Each algorithm sees its *own* previous assignment when packing
    iteration i (the controller keeps one group per algorithm in the
    paper's tests).

    ``active`` (bool (N, P), optional) is the partition-existence mask: a
    dead partition is dropped from the iteration's speed map entirely, its
    hand-off is never priced by the R-score, and on rebirth it re-enters
    with no sticky memory -- the semantics of the masked batched packers
    in ``pack``.
    """
    n_iter, n_parts = stream.shape
    pids = list(partition_ids) if partition_ids is not None else list(range(n_parts))
    assert len(pids) == n_parts
    if active is not None:
        active = np.asarray(active, bool)
        assert active.shape == stream.shape, (active.shape, stream.shape)
    runs = {name: StreamRun(name) for name in algorithms}
    prev: Dict[str, Dict] = {name: {} for name in algorithms}
    for i in range(n_iter):
        live = (range(n_parts) if active is None
                else [j for j in range(n_parts) if active[i, j]])
        speeds = {pids[j]: float(stream[i, j]) for j in live}
        for name, algo in algorithms.items():
            prev_live = {p: c for p, c in prev[name].items() if p in speeds}
            res: PackResult = algo(speeds, capacity, prev=prev_live)
            runs[name].bins.append(res.n_bins)
            runs[name].rscores.append(
                rscore(prev[name], res.pid_to_bin, speeds, capacity,
                       active=None if active is None else set(speeds)))
            prev[name] = res.pid_to_bin
    return runs


def cbs_from_bins(z) -> np.ndarray:
    """Eq. 12 on a per-iteration bin-count matrix ``(A, N)`` (algorithms x
    iterations): mean relative excess over the per-iteration best."""
    z = np.asarray(z, dtype=np.float64)
    zmin = z.min(axis=0)
    zmin = np.maximum(zmin, 1.0)  # guard: zero bins only if zero load for all
    return ((z - zmin) / zmin).mean(axis=1)


def cardinal_bin_score(runs: Mapping[str, StreamRun]) -> Dict[str, float]:
    """Eq. 12 over a family of runs on the same stream."""
    names = list(runs)
    cbs = cbs_from_bins([runs[n].bins for n in names])
    return {n: float(c) for n, c in zip(names, cbs)}


def average_rscores(runs: Mapping[str, StreamRun]) -> Dict[str, float]:
    """Eq. 13 of each run."""
    return {n: r.average_rscore for n, r in runs.items()}


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


def evaluate_deltas(
    algorithms: Mapping[str, Callable],
    streams_by_delta: Mapping[float, np.ndarray],
    capacity: float,
) -> Dict[float, Dict[str, Tuple[float, float]]]:
    """(CBS, E[R]) per algorithm per delta -- the inputs to Figs. 6-9."""
    out: Dict[float, Dict[str, Tuple[float, float]]] = {}
    for delta, stream in streams_by_delta.items():
        runs = run_stream(algorithms, stream, capacity)
        cbs = cardinal_bin_score(runs)
        er = average_rscores(runs)
        out[delta] = {n: (cbs[n], er[n]) for n in runs}
    return out

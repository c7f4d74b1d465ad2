"""Pareto frontiers over (consumer cost, rebalance cost) and the metrics
that score heuristics against them.

The frontier trades consumer count against rebalance (R-score) cost; it
is traced with the batched annealer, one chain per (lambda, restart), all
in one anneal.  The reductions are plain numpy:

* ``pareto_front``     -- non-dominated subset, both objectives minimized;
* ``hypervolume_2d``   -- dominated area w.r.t. a reference point;
* ``anneal_frontier``  -- lambda sweep -> ``FrontierResult`` per instance;
* ``optimality_gap``   -- (heuristic - optimal) / optimal bin counts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

from .anneal import AnnealNoise, anneal_pack

Point = Tuple[float, float]


def _packer(name: str):
    from repro_torch.registry import packer_for

    return packer_for(name)


def heuristic_point(name: str, speeds, prev, capacity, *,
                    device=None) -> Point:
    """One heuristic's (bins, rscore) on an instance: repack ``speeds``
    with ``prev`` through the registered packer and price the moved set by
    Eq. 10 (in float64, from the float64 speeds)."""
    dev = resolve_device(device)
    speeds = np.asarray(speeds, np.float64)
    prev = np.asarray(prev)
    res = _packer(name)(
        torch.tensor(speeds[None], dtype=torch.float32, device=dev),
        torch.tensor(prev[None], dtype=torch.long, device=dev), capacity)
    bin_of = res.bin_of[0].cpu().numpy()
    moved = (prev >= 0) & (bin_of != prev)
    return (float(int(res.n_bins[0])),
            float(speeds[moved].sum()) / float(capacity))


def incumbent_assignment(trace, capacity, t: int, algorithm: str = "BFD", *,
                         device=None) -> np.ndarray:
    """Sticky assignment after iterations ``[0, t)`` of one stream
    ``[T, N]`` under ``algorithm``: the canonical ``prev`` of a mid-trace
    frontier instance."""
    dev = resolve_device(device)
    trace = torch.as_tensor(np.asarray(trace), dtype=torch.float32,
                            device=dev)
    packer = _packer(algorithm)
    prev = torch.full((1, trace.shape[1]), -1, dtype=torch.long, device=dev)
    for s in range(t):
        prev = packer(trace[s][None], prev, capacity).bin_of
    return prev[0].cpu().numpy().astype(np.int32)


def pareto_front(points: Sequence[Point]) -> List[Point]:
    """Non-dominated subset of ``points`` (minimize both coordinates),
    sorted by the first coordinate.  Duplicate points collapse."""
    pts = sorted(set((float(x), float(y)) for x, y in points))
    front: List[Point] = []
    best_y = np.inf
    for x, y in pts:
        if y < best_y:
            front.append((x, y))
            best_y = y
    return front


def dominated(p: Point, front: Sequence[Point]) -> bool:
    """True iff some frontier point is <= ``p`` in both coordinates and
    strictly better in at least one."""
    px, py = float(p[0]), float(p[1])
    return any(x <= px and y <= py and (x < px or y < py) for x, y in front)


def hypervolume_2d(points: Sequence[Point], ref: Point) -> float:
    """Area dominated by ``points`` inside the box ``[.., ref]`` (both
    objectives minimized; points at or beyond ``ref`` contribute 0)."""
    rx, ry = float(ref[0]), float(ref[1])
    front = pareto_front([(x, y) for x, y in points if x < rx and y < ry])
    hv = 0.0
    prev_y = ry
    for x, y in front:
        hv += (rx - x) * (prev_y - y)
        prev_y = y
    return hv


@dataclasses.dataclass
class FrontierResult:
    """Annealed lambda-sweep frontier for one packing instance."""

    lambdas: List[float]            # the swept lambda grid
    per_lambda: List[Point]         # best (bins, rscore) per lambda
    front: List[Point]              # Pareto front over *all* chains
    ref: Point                      # reference point used for hypervolume
    hypervolume: float              # HV(front, ref)

    def heuristic_metrics(self, point: Point) -> dict:
        """Score one heuristic's (bins, rscore) point against the frontier:
        hypervolume ratio (its single-point HV over the front's) and
        domination status."""
        hv = hypervolume_2d([point], self.ref)
        return {
            "bins": float(point[0]),
            "rscore": float(point[1]),
            "dominated": bool(dominated(point, self.front)),
            "hv_ratio": float(hv / self.hypervolume)
            if self.hypervolume > 0 else 1.0,
        }


def reference_point(speeds, prev, capacity) -> Point:
    """Canonical HV reference for an instance: one bin more than
    partitions, one unit of R more than moving every assigned partition."""
    speeds = np.asarray(speeds, np.float64)
    prev = np.asarray(prev)
    r_all = float(speeds[prev >= 0].sum()) / float(capacity)
    return (float(speeds.shape[0]) + 1.0, r_all + 1.0)


def anneal_frontier(speeds, prev, capacity, *,
                    lambdas: Sequence[float] = (0.0, 0.25, 0.5, 1.0, 2.0,
                                                4.0, 8.0),
                    restarts: int = 4, steps: int = 250, seed: int = 0,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[AnnealNoise] = None,
                    use_kernel: bool = True, device=None) -> FrontierResult:
    """Trace the cost-vs-R-score frontier of one instance by sweeping
    ``lambdas``, ``restarts`` chains each, in one batched anneal.  The
    draws come from ``noise``, else ``generator``, else a generator
    seeded ``seed`` on ``device`` (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    if noise is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    lam_vec = torch.tensor(lambdas, dtype=torch.float32,
                           device=dev).repeat_interleave(restarts)
    res = anneal_pack(
        torch.tensor(np.asarray(speeds), dtype=torch.float32, device=dev),
        torch.tensor(np.asarray(prev), dtype=torch.int32, device=dev),
        capacity, lam_vec, steps=steps, noise=noise, generator=generator,
        use_kernel=use_kernel, device=dev)
    bins = res.bins.cpu().numpy().astype(np.int64)
    rs = res.rscore.cpu().numpy().astype(np.float64)
    cost = res.cost.cpu().numpy().astype(np.float64)
    pts = [(float(b), float(r)) for b, r in zip(bins, rs)]
    per_lambda: List[Point] = []
    for i in range(len(lambdas)):
        sl = slice(i * restarts, (i + 1) * restarts)
        j = i * restarts + int(np.argmin(cost[sl]))
        per_lambda.append((float(bins[j]), float(rs[j])))
    ref = reference_point(speeds, prev, capacity)
    front = pareto_front(pts)
    return FrontierResult(lambdas=[float(lam) for lam in lambdas],
                          per_lambda=per_lambda, front=front, ref=ref,
                          hypervolume=hypervolume_2d(front, ref))


def optimality_gap(heuristic_bins, optimal_bins) -> np.ndarray:
    """Relative gap ``(heuristic - optimal) / max(optimal, 1)``,
    elementwise over arrays of bin counts."""
    h = np.asarray(heuristic_bins, np.float64)
    o = np.asarray(optimal_bins, np.float64)
    return (h - o) / np.maximum(o, 1.0)

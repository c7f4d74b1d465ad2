"""Exact bin-packing oracle: branch-and-bound with Martello-Toth L2 lower
bounds (pure Python, oracle-grade; the port keeps its own copy).

The paper's heuristics are never measured against the true optimum; this
module supplies it for small instances.  ``branch_and_bound`` does a DFS
over the decreasing item list, branching each item into every open bin
with a *distinct* load (symmetry breaking) plus one fresh bin, pruning
with the continuous completion bound; the search is exhaustive, so a run
that finishes within the node limit is provably optimal.  ``brute_force``
enumerates all set partitions (restricted-growth strings) and is the
independent comparator the tests pin the oracle against for N <= 8.

Conventions shared with the packers (``core/pack.py``):

* oversized items (w > C) each take a dedicated overflow bin that nothing
  else ever joins;
* zero-speed items occupy no capacity but do hold bins open;
* feasibility uses a small relative slack ``EPS_REL * C`` so that float32
  packings produced by the float32 packers are never judged infeasible by
  the float64 oracle -- the slack makes every bound a valid *lower* bound
  for the heuristics' arithmetic, keeping reported optimality gaps >= 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

EPS_REL = 1e-6


def _eps(capacity: float) -> float:
    return EPS_REL * capacity


def _ceil_slack(x: float) -> int:
    """ceil with a tolerance so 2.0000001 (float noise) stays 2."""
    return max(0, int(math.ceil(x - 1e-9)))


def _split_oversized(weights: Sequence[float], capacity: float
                     ) -> Tuple[List[float], int]:
    eps = _eps(capacity)
    regular = [float(w) for w in weights if w <= capacity + eps]
    return regular, len(weights) - len(regular)


def lower_bound_l1(weights: Sequence[float], capacity: float) -> int:
    """Continuous bound: oversized items count one bin each, the rest
    ceil(sum w / C)."""
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    regular, n_over = _split_oversized(weights, capacity)
    return n_over + _ceil_slack(sum(regular) / capacity - EPS_REL)


def lower_bound_l2(weights: Sequence[float], capacity: float) -> int:
    """Martello-Toth L2: max over alpha in [0, C/2] of

        |J1| + |J2| + max(0, ceil((sum_{J3} w - (|J2| C - sum_{J2} w)) / C))

    with J1 = {w > C - alpha}, J2 = {C - alpha >= w > C/2},
    J3 = {C/2 >= w >= alpha}.  Dominates L1; valid for any packing that
    respects capacity up to the shared EPS slack.
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    regular, n_over = _split_oversized(weights, capacity)
    ws = [w for w in regular if w > 0.0]
    best = lower_bound_l1(weights, capacity)
    half = capacity / 2.0
    # L(alpha) is piecewise constant; its breakpoints are the item sizes
    # <= C/2, their complements C - w for big items, and 0 (which counts
    # every item above C/2 as a dedicated bin)
    alphas = sorted({0.0} | {w for w in ws if w <= half}
                    | {capacity - w for w in ws
                       if 0.0 <= capacity - w <= half})
    for alpha in alphas:
        j1 = j2 = 0
        j2_sum = j3_sum = 0.0
        for w in ws:
            if w > capacity - alpha:
                j1 += 1
            elif w > half:
                j2 += 1
                j2_sum += w
            elif w >= alpha:
                j3_sum += w
        free = j2 * capacity - j2_sum
        extra = _ceil_slack((j3_sum - free) / capacity - EPS_REL)
        best = max(best, n_over + j1 + j2 + extra)
    return best


@dataclasses.dataclass
class BnBResult:
    """Outcome of one oracle run.

    ``optimal`` is True iff the search completed, i.e. ``n_bins`` is the
    exact optimum; otherwise ``n_bins`` is the best feasible packing found
    (an upper bound) and ``lower_bound`` a certified lower bound.
    ``assignment[i]`` is the bin index of item ``i`` in the best packing.
    """

    n_bins: int
    lower_bound: int
    optimal: bool
    assignment: List[int]
    nodes: int


def _ffd_seed(order: List[int], weights: Sequence[float], capacity: float,
              eps: float) -> Tuple[int, List[int]]:
    """First-Fit-Decreasing upper bound (order is already decreasing)."""
    loads: List[float] = []
    assign = [0] * len(weights)
    for i in order:
        w = weights[i]
        for b, load in enumerate(loads):
            if load + w <= capacity + eps:
                loads[b] += w
                assign[i] = b
                break
        else:
            assign[i] = len(loads)
            loads.append(w)
    return len(loads), assign


def branch_and_bound(weights: Sequence[float], capacity: float, *,
                     node_limit: Optional[int] = 2_000_000) -> BnBResult:
    """Exact minimum-bin packing of ``weights`` into bins of size
    ``capacity`` (small N; exponential worst case).

    Returns a :class:`BnBResult`; with the default node limit every
    instance the test-suite and benchmarks feed it (N <= ~16) completes,
    i.e. ``optimal`` is True.  Oversized items are pre-assigned dedicated
    overflow bins, zero-weight items are packed greedily at the end (they
    never change the bin count), and the DFS runs over the remaining items
    in non-increasing order with distinct-load symmetry breaking.
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    n = len(weights)
    eps = _eps(capacity)
    weights = [float(w) for w in weights]
    over = [i for i, w in enumerate(weights) if w > capacity + eps]
    zero = [i for i, w in enumerate(weights) if w <= 0.0]
    rest = [i for i in range(n) if i not in set(over) and weights[i] > 0.0]
    rest.sort(key=lambda i: (-weights[i], i))

    lb_root = lower_bound_l2(weights, capacity)
    ub, seed_assign = _ffd_seed(rest, weights, capacity, eps)
    best_bins = ub
    best_assign = list(seed_assign)
    nodes = 0
    complete = True

    rem_suffix = [0.0] * (len(rest) + 1)
    for d in range(len(rest) - 1, -1, -1):
        rem_suffix[d] = rem_suffix[d + 1] + weights[rest[d]]

    loads: List[float] = []
    assign = [0] * n

    def dfs(d: int) -> None:
        nonlocal best_bins, best_assign, nodes, complete
        if node_limit is not None and nodes > node_limit:
            complete = False
            return
        nodes += 1
        if d == len(rest):
            if len(loads) < best_bins:
                best_bins = len(loads)
                best_assign = list(assign)
            return
        # completion bound: bins already open plus the continuous bound on
        # the overflow of remaining weight past the open free space
        free = len(loads) * capacity - sum(loads)
        need = len(loads) + _ceil_slack(
            (rem_suffix[d] - free) / capacity - EPS_REL)
        if max(need, len(loads)) >= best_bins:
            return
        i = rest[d]
        w = weights[i]
        seen = set()
        for b in range(len(loads)):
            load = loads[b]
            if load + w > capacity + eps:
                continue
            key = round(load, 12)
            if key in seen:
                continue            # symmetric branch: same load, same future
            seen.add(key)
            loads[b] += w
            assign[i] = b
            dfs(d + 1)
            loads[b] -= w
        if len(loads) + 1 < best_bins:
            loads.append(w)
            assign[i] = len(loads) - 1
            dfs(d + 1)
            loads.pop()

    dfs(0)

    # zero-weight items ride along in regular bin 0 (they may not join an
    # overflow bin: its load already exceeds C); open one regular bin for
    # them if the DFS used none.  Oversized items then get dedicated
    # overflow bins after the regular ones.
    k_reg = best_bins
    if zero and k_reg == 0:
        k_reg = 1
    for i in zero:
        best_assign[i] = 0
    k = k_reg
    for i in over:
        best_assign[i] = k
        k += 1
    total = k
    return BnBResult(n_bins=total,
                     lower_bound=total if complete else lb_root,
                     optimal=complete, assignment=best_assign, nodes=nodes)


def brute_force(weights: Sequence[float], capacity: float) -> int:
    """Exact optimum by set-partition enumeration (restricted-growth
    strings); the independent comparator for the oracle tests.  O(Bell(N))
    -- use only for N <= ~10.

    A block is feasible iff its weight sum fits the capacity (with the
    shared EPS slack) or it is a singleton oversized item.
    """
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    n = len(weights)
    if n == 0:
        return 0
    eps = _eps(capacity)
    weights = [float(w) for w in weights]
    best = n

    sums: List[float] = []

    def rec(i: int) -> None:
        nonlocal best
        if len(sums) >= best:
            return
        if i == n:
            best = min(best, len(sums))
            return
        w = weights[i]
        for b in range(len(sums)):
            sums[b] += w
            if sums[b] <= capacity + eps:
                rec(i + 1)
            sums[b] -= w
        sums.append(w)
        rec(i + 1)                  # singleton block: always legal (oversized)
        sums.pop()

    rec(0)
    return best

"""Trace the bins-vs-R-score Pareto frontier of one packing instance and
place every heuristic against it, on the port.

The counterpart of the reference's ``examples/pareto_frontier.py``.  For
one stream of a chosen scenario family it

  1. builds the mid-trace instance: current speeds plus the sticky-BFD
     incumbent assignment from the preceding iterations;
  2. sweeps lambda over the batched annealer (``repro_torch.opt``) --
     every (lambda, restart) chain in one anneal, one ``anneal_step``
     launch a step on the card -- and extracts the non-dominated (bins,
     R-score) front, with the exact branch-and-bound bin floor for
     reference;
  3. repacks the same instance with all 12 heuristics and reports each
     one's position: on/off the front, and its single-point hypervolume
     share of the annealed front's.

  PYTHONPATH=src python -m repro_torch.examples.pareto_frontier [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.pareto_frontier \\
      --family heavy_tail --n 10

:func:`frontier_report` takes the trace and the anneal's draws
(``AnnealNoise``), so that another caller (a test) can give it the
reference's: torch and JAX draws never agree.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.scenarios import SCENARIO_FAMILIES, generate_scenario
from repro_torch.opt import (AnnealNoise, anneal_frontier, branch_and_bound,
                             heuristic_point, incumbent_assignment)
from repro_torch.registry import PACKER_FAMILIES, list_policies

CAPACITY = 1.0


def frontier_report(trace, family: str, *, lambdas: Sequence[float],
                    restarts: int, steps: int, seed: int = 0,
                    noise: Optional[AnnealNoise] = None, device=None):
    """Print the report of one stream ``trace`` (``f32[T, N]``) at its
    middle iteration; the anneal draws from ``noise``, else from a
    generator seeded ``seed`` on ``device``.  Returns the frontier
    (``FrontierResult``) and each heuristic's ``(name, point,
    metrics)``."""
    trace = np.asarray(trace, np.float32)
    iters, n = trace.shape
    t_rep = iters // 2
    prev = incumbent_assignment(trace, CAPACITY, t_rep, device=device)
    speeds = trace[t_rep]

    opt = branch_and_bound(speeds.tolist(), CAPACITY)
    print(f"{family}: iteration {t_rep} of a {iters}-step stream, "
          f"{n} partitions, sum(speeds)={speeds.sum():.2f} C")
    print(f"exact bin floor (branch-and-bound, "
          f"{'proven optimal' if opt.optimal else 'upper bound'}): "
          f"{opt.n_bins} consumers\n")

    fr = anneal_frontier(speeds, prev, CAPACITY, lambdas=lambdas,
                         restarts=restarts, steps=steps, seed=seed,
                         noise=noise, device=device)
    print("annealed lambda sweep (best chain per lambda):")
    for lam, (b, r) in zip(fr.lambdas, fr.per_lambda):
        print(f"  lambda={lam:<5g} -> {int(b)} consumers, Rscore {r:.3f}")
    print(f"\nPareto front (over all {len(lambdas) * restarts} "
          f"chains), hypervolume {fr.hypervolume:.3f}:")
    for b, r in fr.front:
        print(f"  {int(b)} consumers, Rscore {r:.3f}")

    print(f"\n{'algorithm':<8} {'consumers':>9} {'Rscore':>8} "
          f"{'vs frontier':>12} {'HV share':>9}")
    points = []
    for name in list_policies(family=PACKER_FAMILIES, backend="torch"):
        pt = heuristic_point(name, speeds, prev, CAPACITY, device=device)
        met = fr.heuristic_metrics(pt)
        points.append((name, pt, met))
        tag = "dominated" if met["dominated"] else "on front"
        print(f"{name:<8} {int(pt[0]):>9} {pt[1]:>8.3f} {tag:>12} "
              f"{met['hv_ratio']:>8.1%}")
    print("\n(HV share = the heuristic point's own hypervolume over the "
          "annealed front's; 100% = it matches the whole frontier)")
    return fr, points


def main(argv=None):
    """Run the report; returns :func:`frontier_report`'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", default="diurnal",
                    choices=sorted(SCENARIO_FAMILIES))
    ap.add_argument("--n", type=int, default=8, help="partitions")
    ap.add_argument("--iters", type=int, default=16, help="trace length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lambdas", type=float, nargs="+",
                    default=[0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0])
    ap.add_argument("--restarts", type=int, default=4)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    trace = generate_scenario(args.family, args.seed, 1, args.iters, args.n,
                              capacity=CAPACITY, device=dev)[0]
    return frontier_report(trace.cpu().numpy(), args.family,
                           lambdas=args.lambdas, restarts=args.restarts,
                           steps=args.steps, seed=args.seed, device=dev)


if __name__ == "__main__":
    main()

"""Batched scenario sweep: every packing algorithm x a fleet of workloads,
on the port.

The counterpart of the reference's ``examples/scenario_sweep.py``.
Generates a batch of synthetic partition write-speed trajectories from
several scenario families (diurnal cycles, launch ramps, flash crowds,
topic churn, heavy-tailed skew), stacks them into one ``f32[B, T, N]``
tensor, and evaluates all 12 packing algorithms over the whole fleet,
one ``pack_rows`` launch an algorithm a step on the card.

Prints, per (family, algorithm): mean consumers used, mean Rscore (Eq.
10) and total partition migrations -- the same cost/disruption trade-off
as the paper's Figs. 6-9, across workload shapes the paper never tested.

  PYTHONPATH=src python -m repro_torch.examples.scenario_sweep [--device cpu]

:func:`sweep_table` takes the suite, so that another caller (a test) can
give it traces of its own: torch and JAX draws never agree.
"""
from __future__ import annotations

import argparse
import collections
from typing import Dict, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.pack import sweep_streams
from repro_torch.core.scenarios import scenario_suite, stack_suite
from repro_torch.registry import PACKER_FAMILIES, list_policies

ALGORITHMS = list_policies(family=PACKER_FAMILIES, backend="torch")

FAMILIES = ("diurnal", "ramp", "bursty", "churn", "heavy_tail")
BATCH = 3          # streams per family
ITERS = 48         # measurements per stream
N_PARTITIONS = 16
CAPACITY = 1.0


def sweep_table(suite, algorithms: Sequence[str] = ALGORITHMS,
                capacity: float = CAPACITY, device=None
                ) -> Dict[str, Dict[str, tuple]]:
    """``{family: {algorithm: (mean bins, mean Rscore, migrations)}}`` of
    ``suite`` (``{family: f32[B, T, N]}``) under every algorithm, in one
    ``sweep_streams`` call over the stacked suite."""
    labels, batch = stack_suite(suite)
    print(f"sweeping {len(algorithms)} algorithms over "
          f"{batch.shape[0]} streams ({len(suite)} families x "
          f"{batch.shape[0] // len(suite)}) "
          f"of {batch.shape[1]} iterations x {batch.shape[2]} partitions ...")
    res = sweep_streams(algorithms, batch, capacity, device=device)
    rows = collections.defaultdict(dict)
    bins = res.bins.cpu().numpy()          # (A, B, T)
    rscores = res.rscores.cpu().numpy()
    migs = res.migrations.cpu().numpy()
    fam_idx = {f: [i for i, lab in enumerate(labels) if lab == f]
               for f in suite}
    for a, algo in enumerate(res.algorithms):
        for fam, idx in fam_idx.items():
            rows[fam][algo] = (bins[a, idx].mean(), rscores[a, idx].mean(),
                               int(migs[a, idx].sum()))
    return dict(rows)


def print_table(rows, algorithms: Sequence[str]) -> None:
    """The reference example's table, a block a family."""
    hdr = (f"{'family':<11} {'algo':<5} {'mean bins':>9} {'mean R':>8} "
           f"{'migrations':>10}")
    for fam in rows:
        print(f"\n{hdr}")
        best = min(rows[fam], key=lambda a: rows[fam][a][0])
        for algo in algorithms:
            b, r, m = rows[fam][algo]
            star = " *" if algo == best else ""
            print(f"{fam:<11} {algo:<5} {b:>9.2f} {r:>8.4f} {m:>10d}{star}")
    print("\n(* = fewest mean consumers in that family)")


def main(argv=None):
    """Run the sweep; returns the table (:func:`sweep_table`)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    suite = scenario_suite(0, BATCH, ITERS, N_PARTITIONS, capacity=CAPACITY,
                           families=FAMILIES, device=dev)
    rows = sweep_table(suite, device=dev)
    print_table(rows, tuple(a.upper() for a in ALGORITHMS))
    return rows


if __name__ == "__main__":
    main()

"""Closed-loop lag sweep: scaling policies x scenario families, with SLO
metrics, on the port.

The counterpart of the reference's ``examples/lag_slo_sweep.py``.  Where
``scenario_sweep`` *scores* packings (bins, R-score, migrations), this
example closes the loop: the lag twin (``repro_torch.lagsim``) evolves
per-partition backlog under each policy -- including migration
downtime, the paper's rebalancing cost made physical -- and reports what
operators page on: SLO violation fraction, peak lag, time-to-drain, and
consumer-seconds cost.

Policies cover the paper's bin-packing algorithms and the reactive
baselines (KEDA-style lag threshold, consumption-rate threshold).
Scenarios run through the masked generators: ``churn`` and
``topic_lifecycle`` partitions disappear (``active == False``,
unreadable and empty) rather than idling near zero.

``--trace PATH`` swaps the generated suite for one recorded trace
(``repro_torch.scenarios`` ``.json``/``.npz``, a seed-library shape or an
adversarial witness), replayed through the same loop at the trace's own
capacity.  ``--use-kernel`` drains each step through the ``lag_update``
kernel on the card (the packers' ``pack_rows`` kernel runs either way).

  PYTHONPATH=src python -m repro_torch.examples.lag_slo_sweep [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.lag_slo_sweep --smoke
  PYTHONPATH=src python -m repro_torch.examples.lag_slo_sweep --trace w.npz

:func:`slo_table` takes the suite, so that another caller (a test) can
give it traces of its own: torch and JAX draws never agree.
"""
from __future__ import annotations

import argparse
from typing import Dict, Sequence

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.scenarios import masked_scenario_suite
from repro_torch.lagsim import LagSimConfig, summarize_sweep, sweep_lag

FULL = dict(policies=("BFD", "MBFP", "MWFP", "KEDA_LAG", "RATE_THRESHOLD"),
            families=("diurnal", "ramp", "bursty", "churn", "heavy_tail",
                      "topic_lifecycle"),
            batch=3, iters=64, n=12)
SMOKE = dict(policies=("BFD", "MBFP", "KEDA_LAG"),
             families=("bursty", "churn", "topic_lifecycle"),
             batch=2, iters=24, n=6)


def slo_table(suite, policies: Sequence[str], cfg: LagSimConfig,
              device=None) -> Dict[str, list]:
    """``{family: [(policy, violation %, peak lag, time to drain,
    consumer-seconds, migrations), ...]}``, each a mean over the family's
    streams, and the index of the lowest mean violation fraction last:
    one ``sweep_lag`` a family of ``suite`` (``{family: (speeds f32[B, T,
    N], active bool[B, T, N])}``)."""
    out = {}
    for fam, (speeds, active) in suite.items():
        res = sweep_lag(policies, speeds, cfg, active=active, device=device)
        s = summarize_sweep(res, cfg)
        rows = [(pol, 100 * s["violation_frac"][i].mean(),
                 s["peak_lag"][i].mean(), s["time_to_drain"][i].mean(),
                 s["consumer_seconds"][i].mean(),
                 s["total_migrations"][i].mean())
                for i, pol in enumerate(res.policies)]
        out[fam] = (rows, int(np.argmin(s["violation_frac"].mean(axis=1))))
    return out


def print_table(table) -> None:
    """The reference example's table, a block a family."""
    hdr = (f"{'family':<15} {'policy':<15} {'viol%':>6} {'peak lag':>9} "
           f"{'drain(s)':>9} {'cost(c*s)':>10} {'migrations':>10}")
    for fam, (rows, best) in table.items():
        print(f"\n{hdr}")
        for i, (pol, viol, peak, drain, cost, migs) in enumerate(rows):
            star = " *" if i == best else ""
            print(f"{fam:<15} {pol:<15} {viol:>6.1f} {peak:>9.2f} "
                  f"{drain:>9.1f} {cost:>10.0f} {migs:>10.0f}{star}")
    print("\n(* = lowest mean SLO-violation fraction in that family; "
          "lag in units of one consumer-step of capacity)")


def main(argv=None):
    """Run the sweep; returns the table (:func:`slo_table`)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI")
    ap.add_argument("--use-kernel", action="store_true",
                    help="drain each step through the lag_update CUDA "
                         "kernel (its plain version on the CPU) instead of "
                         "the torch ops of the per-step loop")
    ap.add_argument("--trace", metavar="PATH",
                    help="replay a recorded trace (.json/.npz from "
                         "repro_torch.scenarios) instead of the generated "
                         "suite")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    p = dict(SMOKE if args.smoke else FULL)

    capacity = 1.0
    if args.trace:
        from repro_torch.scenarios import load_trace

        tr = load_trace(args.trace)
        capacity = float(tr.capacity)
        p["families"] = (tr.name,)
        p["batch"], p["iters"], p["n"] = tr.batch, tr.iters, tr.n
        suite = {tr.name: (tr.rates, tr.active)}
        print(f"replaying trace {tr.name!r} ({tr.source}, "
              f"capacity {capacity:g})")
    cfg = LagSimConfig(capacity=capacity, dt=1.0, migration_steps=2,
                       use_kernel=args.use_kernel)
    if not args.trace:
        suite = masked_scenario_suite(0, p["batch"], p["iters"], p["n"],
                                      families=p["families"], device=dev)
    print(f"closed-loop sweep: {len(p['policies'])} policies x "
          f"{len(p['families'])} families x {p['batch']} streams of "
          f"{p['iters']} steps, {p['n']} partitions (masked) ...")
    table = slo_table(suite, p["policies"], cfg, device=dev)
    print_table(table)
    return table


if __name__ == "__main__":
    main()

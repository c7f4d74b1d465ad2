"""Quickstart: the paper's algorithms in five minutes, through the
``repro_torch.api`` facade.

The counterpart of the reference's ``examples/quickstart.py``.  Every
policy name resolves through ``repro_torch.registry`` -- the one
catalogue of packers (Sec. II-B heuristics + Sec. IV-B/IV-C sticky
family), optimizers and reactive scalers -- and every call returns the
facade's versioned result dataclasses.  ``api.pack`` runs the host
(``py``) packer, as in the reference; ``api.evaluate`` sweeps its
streams on ``--device`` (default: the CUDA card, one ``pack_rows``
launch an algorithm a step).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch._device import resolve_device

C = 2.3e6  # consumer capacity, bytes/s (the paper's measured 2.3 MB/s)

SPEEDS = {"orders-0": 1.1e6, "orders-1": 0.7e6, "sensors-0": 1.9e6,
          "sensors-1": 0.4e6, "invoices-0": 0.2e6}


def main(argv=None):
    """Print the tour; returns the evaluation table (``EvaluateOutcome``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- what's on the shelf ---------------------------------------------
    for family in api.FAMILIES:
        print(f"{family:<10} {', '.join(api.list_policies(family=family))}")

    # --- one packing decision ----------------------------------------------
    speeds = dict(SPEEDS)
    res = api.pack(speeds, C, algorithm="BFD")
    print(f"\nBFD packs {len(speeds)} partitions onto {res.n_bins} "
          f"consumers:")
    for cid in sorted(res.loads):
        parts = sorted(p for p, c in res.assignment.items() if c == cid)
        print(f"  consumer {cid}: {parts} ({res.loads[cid] / 1e6:.2f} MB/s)")

    # --- a rebalance-aware decision (Algorithm 1, MBFP) ----------------------
    speeds["sensors-0"] = 2.5e6                    # the load shifted
    new = api.pack(speeds, C, algorithm="MBFP", prev=res.assignment)
    print(f"\nafter a load spike, MBFP uses {new.n_bins} consumers, "
          f"Rscore={new.rscore:.3f} consumer-iterations/s of backlog while "
          f"rebalancing")

    # --- the paper's evaluation on synthetic streams (Eq. 11) ----------------
    table = api.evaluate(algorithms=("BFD", "FFD", "NFD", "MBF", "MBFP"),
                         deltas=(5, 15, 25), n_partitions=30,
                         n_measurements=120, capacity=1.0, seed=0,
                         device=dev)
    print("\n delta  algo   CBS      E[R]   (lower is better on both)")
    for d in table.deltas:
        for a in sorted(table.algorithms):
            mark = " *pareto" if a in table.pareto[d] else ""
            print(f"  {d:3d}   {a:5s} {table.cbs[d][a]:7.4f} "
                  f"{table.avg_rscore[d][a]:7.3f}{mark}")
    return table


if __name__ == "__main__":
    main()

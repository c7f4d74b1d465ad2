"""Serving driver: the autoscaled replica fleet with roofline-derived
capacity (a copy of ``repro.launch.serve``: the same flags and printed
lines; host code, as the reference's).

Wires the full loop the paper + this framework describe: the one-card dry
run's ``serve_step`` roofline (``repro_torch.launch.dryrun``, one H100 a
replica) gives the replica capacity C (``repro_torch.serving.capacity``),
the monitor measures per-stream arrival rates, and the controller packs
streams onto the fewest replicas with the selected algorithm (default
MBFP), migrating via the two-phase protocol.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape decode_32k \
      --rules tail256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-67b \
      --algorithm MBFP --seconds 300
(falls back to a configured capacity when no dry-run record of the arch
fits one card, e.g. deepseek-67b's 134 GB of weights; pass ``--capacity``)
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.serving import AutoscaleSimulation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-67b")
    ap.add_argument("--rules", default="tail256",
                    help="dry-run variant to derive capacity from")
    ap.add_argument("--algorithm", default="MBFP")
    ap.add_argument("--streams", type=int, default=12)
    ap.add_argument("--seconds", type=int, default=300)
    ap.add_argument("--capacity", type=float, default=None,
                    help="override capacity (tokens/s) instead of deriving")
    ap.add_argument("--delta", type=float, default=15.0,
                    help="Eq. 11 workload variability (%% of C per step)")
    args = ap.parse_args(argv)

    cap = args.capacity
    source = "flag"
    if cap is None:
        try:
            from repro_torch.launch.mesh import MESH_NAME
            from repro_torch.serving.capacity import derived_replica_capacity
            d = derived_replica_capacity(args.arch, "decode_32k",
                                         mesh=MESH_NAME, rules=args.rules)
            cap = d["tokens_per_s"]
            source = (f"dry-run roofline ({d['bottleneck']}-bound, "
                      f"{d['step_seconds'] * 1e3:.0f} ms/step)")
        except Exception as e:  # no dry-run artifacts: fall back
            cap = 500.0
            source = f"default (no dry-run results: {e})"
    print(f"[serve] {args.arch}: replica capacity C = {cap:.0f} tokens/s "
          f"[{source}]")

    sim = AutoscaleSimulation(
        n_partitions=args.streams,
        rate_fn=AutoscaleSimulation.random_walk_rates(
            args.streams, cap, delta=args.delta, seed=0),
        capacity=cap, algorithm=args.algorithm,
        # production headroom: repack when a replica exceeds 90% of C, so
        # workload upswings drain instead of accumulating backlog
        overload_factor=0.9,
        record_bytes=max(64, int(cap // 50)))
    m = sim.run(seconds=args.seconds)

    n = np.asarray(m.n_replicas)
    lag = np.asarray(m.lag_bytes, float)
    migs = sim.controller.migrations
    print(f"[serve] fleet size: min {n.min()} / mean {n.mean():.1f} / "
          f"max {n.max()}")
    print(f"[serve] final lag: {lag[-1] / 1e3:.1f}K (peak {lag.max() / 1e3:.1f}K)")
    print(f"[serve] reassignments: {len(migs)}; mean Rscore "
          f"{np.mean([r.rscore for r in migs]) if migs else 0:.4f}; "
          f"total migrations {sum(len(r.moved) for r in migs)}")
    third = len(lag) // 3
    slope = (lag[-1] - lag[-third]) / max(third, 1)
    # a reactive autoscaler may end mid-upswing; anything under one
    # replica-equivalent of backlog growth is caught by the next scale-up
    verdict = "bounded" if slope < cap else "GROWING beyond one replica"
    print(f"[serve] lag slope last third: {slope:.1f} B/s ({verdict})")


if __name__ == "__main__":
    main()

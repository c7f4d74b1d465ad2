"""Adversarial robustness report: the worst-case SLO envelope per policy
family, from the adversarial benchmark's artifact, on the port.

The counterpart of the reference's ``examples/adversarial_report.py``:
the same table, the same lines.  Reads the benchmark artifact the
adversarial search publishes (the port's own, ``BENCH_PATH``, in the
envelope of the reference's ``BENCH_adversarial.json``) and prints, per
registry family: the representative policy, the worst violation fraction
the evolved scenario achieved against it, the incident load at that
worst case, the random-search baseline at the same eval budget, and the
witness knobs -- the concrete burst/skew/churn/lifecycle settings that
realize the worst case (replay them via ``repro_torch.api.replay`` on
the matching ``witness_<family>.npz`` trace).

``--attack POLICY`` skips the artifact and runs a fresh small search
against one named policy instead, on ``--device`` (default: the CUDA
card; the fitness oracle drains on ``lag_update`` and packs on
``pack_rows``), printing the same row live.

  PYTHONPATH=src python -m repro_torch.examples.adversarial_report
  PYTHONPATH=src python -m repro_torch.examples.adversarial_report --smoke
  PYTHONPATH=src python -m repro_torch.examples.adversarial_report \\
      --attack MWF [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         os.pardir, os.pardir, os.pardir))
#: the port's adversarial benchmark artifact (its name for the
#: reference's ``BENCH_adversarial.json``)
BENCH_PATH = os.path.join(REPO_ROOT, "BENCH_adversarial_torch.json")

#: the knobs worth a column (the rest are in the JSON)
_KNOB_COLS = ("burst_amp", "burst_len_frac", "tail_sigma", "churn_p")


def _print_table(families: dict) -> None:
    hdr = (f"{'family':<11} {'policy':<13} {'worst viol%':>11} "
           f"{'incidents':>9} {'random%':>8} {'beats':>5}  witness knobs")
    print(hdr)
    print("-" * len(hdr))
    for fam in sorted(families):
        row = families[fam]
        knobs = row["witness_knobs"]
        knob_s = " ".join(f"{k}={knobs[k]:.2f}" for k in _KNOB_COLS
                          if k in knobs)
        print(f"{fam:<11} {row['policy']:<13} "
              f"{100 * row['worst_violation_frac']:>11.1f} "
              f"{row['worst_incidents']:>9.1f} "
              f"{100 * row['baseline']['best_violation_frac']:>8.1f} "
              f"{'yes' if row['beats_baseline'] else 'no':>5}  {knob_s}")


def attack_row(policy: str, device=None) -> dict:
    """A fresh small search against ``policy`` (the reference's: pop 8, 5
    generations, 96 steps x 6 partitions, seed 0), as a report row."""
    from repro_torch.api import SearchConfig, attack
    from repro_torch.lagsim import LagSimConfig

    cfg = SearchConfig(pop_size=8, generations=5, iters=96, n=6)
    out = attack(policy, config=cfg, sim=LagSimConfig(), seed=0,
                 device=device)
    return {
        "policy": out.policy,
        "worst_violation_frac": out.best_violation_frac,
        "worst_incidents": out.best_incidents,
        "witness_knobs": out.witness_knobs,
        "baseline": {"best_violation_frac":
                     out.baseline.best_violation_frac if out.baseline
                     else 0.0},
        "beats_baseline": bool(out.beats_baseline),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: require the artifact to exist, carry "
                         "every registry family, and print cleanly")
    ap.add_argument("--attack", metavar="POLICY",
                    help="run a fresh small search against POLICY instead "
                         "of reading the artifact")
    ap.add_argument("--bench", default=BENCH_PATH,
                    help="path to the adversarial benchmark's artifact")
    ap.add_argument("--device", default=None,
                    help="torch device of --attack (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.attack:
        from repro_torch._device import resolve_device

        _print_table({"(live)": attack_row(args.attack,
                                           resolve_device(args.device))})
        return

    with open(args.bench) as f:
        report = json.load(f)
    families = report["families"]
    if args.smoke:
        from repro_torch.scenarios import family_representatives

        missing = sorted(set(family_representatives()) - set(families))
        assert not missing, (
            f"{os.path.basename(args.bench)} is missing envelope rows for "
            f"registry families {missing}; re-run the adversarial "
            f"benchmark")
        for fam, row in families.items():
            assert 0.0 <= row["worst_violation_frac"] <= 1.0, (fam, row)
            assert len(row["witness_genome"]) > 0, fam
    print(f"adversarial worst-case envelope "
          f"(seed {report['config']['seed']}, "
          f"{report['config']['pop_size']}x"
          f"{report['config']['generations']} search, "
          f"{report['config']['iters']} steps x "
          f"{report['config']['n_partitions']} partitions)\n")
    _print_table(families)
    print("\n(random% = best violation a uniform random search found at "
          "the same eval budget; replay any row via repro.api.replay on "
          "its witness_<family>.npz trace)")
    if args.smoke:
        print("adversarial report smoke OK")


if __name__ == "__main__":
    main()

"""Live terminal dashboard over a fleet run, on the port: streaming
sketch snapshots and incident counts from the host-side ``progress``
callback.

The counterpart of the reference's ``examples/live_dashboard.py``.
``FleetRunner.simulate(..., progress=...)`` hands a
:class:`~repro_torch.fleet.FleetProgress` snapshot to the callback after
each bucket group finishes: scenarios done/total, the merge of every
finished scenario's streaming sketch (whole-run mean/extrema/EWMA and
histogram quantiles per channel, O(1) memory however long the run), and
the cumulative per-rule incident counts from the in-loop alerting rules.
This example renders those snapshots as a redrawing ANSI dashboard
without ever materialising per-step frames (``record_frames=False``).

The callback is opt-in: a fleet run without ``progress=`` never calls
host code mid-run, and the dashboard never changes trajectories -- it
only reads finished buckets.  The twin's packers launch ``pack_rows``
on the card.

  PYTHONPATH=src python -m repro_torch.examples.live_dashboard [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.live_dashboard --smoke
  PYTHONPATH=src python -m repro_torch.examples.live_dashboard --no-ansi

:func:`run_dashboard` takes the scenarios, so that another caller (a
test) can give it traces of its own: torch and JAX draws never agree.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch._device import resolve_device
from repro_torch.core.scenarios import generate_masked_scenario
from repro_torch.fleet import FleetConfig, FleetProgress, FleetRunner
from repro_torch.lagsim import LagSimConfig
from repro_torch.telemetry import (AlertConfig, SketchConfig,
                                   TelemetryConfig, default_rules)

#: (family, scenarios, T, N) -- deliberately ragged so the fleet runs
#: several bucket groups and the dashboard gets several snapshots
FULL = (("bursty", 3, 48, 10), ("churn", 3, 64, 8),
        ("topic_lifecycle", 3, 96, 12))
SMOKE = (("bursty", 2, 24, 6), ("topic_lifecycle", 2, 32, 6))

#: sketch channels worth a dashboard row (of the ~10 recorded)
CHANNELS = ("lag_total", "consumers", "unreadable")


def _bar(frac: float, width: int = 32) -> str:
    full = int(round(frac * width))
    return "#" * full + "-" * (width - full)


def render(snap: FleetProgress) -> str:
    """One dashboard frame as plain text (ANSI clearing is the caller's)."""
    lines = [
        "repro fleet dashboard",
        f"  scenarios [{_bar(snap.done / max(snap.total, 1))}] "
        f"{snap.done}/{snap.total}   last bucket {snap.bucket}",
    ]
    if snap.sketch is not None:
        s = snap.sketch
        lines.append(f"  sketch ({s.count:.0f} policy-steps aggregated)")
        lines.append(f"    {'channel':<12} {'mean':>9} {'max':>9} "
                     f"{'ewma':>9} {'p99':>9}")
        ewma = s.ewma[min(s.ewma)]          # fastest window
        for ch in CHANNELS:
            if ch not in s.names:
                continue
            i = s.channel_index(ch)
            p99 = (f"{s.quantile(0.99, ch):>9.3f}"
                   if ch in s.hist_names else f"{'-':>9}")
            lines.append(f"    {ch:<12} {float(s.mean[i]):>9.3f} "
                         f"{float(s.vmax[i]):>9.3f} "
                         f"{float(ewma[i]):>9.3f} {p99}")
    if snap.incidents:
        firing = {k: v for k, v in snap.incidents.items() if v}
        lines.append(f"  incidents {firing if firing else '(none)'}")
    return "\n".join(lines)


def run_dashboard(scenarios, *, ansi: bool = False, device=None):
    """Simulate MBFP and KEDA_LAG over ``scenarios`` (a list of ``(speeds
    f32[T, N], active bool[T, N])``) through ``FleetRunner.simulate``
    with sketches and the default alert rules on, printing a frame a
    snapshot.  Returns ``(result, snapshots)``."""
    cfg = LagSimConfig(
        capacity=1.0, dt=1.0, migration_steps=2,
        telemetry=TelemetryConfig(record_frames=False,
                                  sketch=SketchConfig(),
                                  alerts=AlertConfig(rules=default_rules())))
    snaps = []

    def on_progress(snap: FleetProgress) -> None:
        snaps.append(snap)
        if ansi:
            sys.stdout.write("\x1b[2J\x1b[H")
        print(render(snap))
        if not ansi:
            print()
        sys.stdout.flush()

    runner = FleetRunner(FleetConfig())
    res = runner.simulate(("MBFP", "KEDA_LAG"), scenarios, cfg,
                          progress=on_progress, device=device)

    assert snaps and snaps[-1].done == len(scenarios), (
        "dashboard saw no complete progress stream")
    total_inc = sum(snaps[-1].incidents.values())
    print(f"done: {len(scenarios)} scenarios in {len(snaps)} snapshot(s), "
          f"{total_inc} incident(s) opened "
          f"(rules: {', '.join(res.alert_config.rule_names)})")
    return res, snaps


def plan_scenarios(plan, device=None):
    """The scenarios of ``plan`` ((family, count, T, N) rows), family
    ``i`` drawn from a generator seeded ``i``."""
    scenarios = []
    for i, (fam, count, t, n) in enumerate(plan):
        speeds, active = generate_masked_scenario(fam, i, count, t, n,
                                                  device=device)
        scenarios.extend((speeds[b], active[b]) for b in range(count))
    return scenarios


def main(argv=None):
    """Run the dashboard; returns :func:`run_dashboard`'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes + plain output for CI")
    ap.add_argument("--no-ansi", action="store_true",
                    help="append frames instead of redrawing in place")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ansi = not (args.smoke or args.no_ansi) and sys.stdout.isatty()
    scenarios = plan_scenarios(SMOKE if args.smoke else FULL, dev)
    return run_dashboard(scenarios, ansi=ansi, device=dev)


if __name__ == "__main__":
    main()

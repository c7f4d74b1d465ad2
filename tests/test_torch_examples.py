"""The port's five lag-twin examples (``repro_torch.examples``) against the
reference's (``examples/``), on the CPU.

Each reference example runs as a script (``runpy``, its own arguments),
drawing its traces from JAX keys; the port's counterpart is given those
same traces (and, for ``pareto_frontier``, the same anneal draws, made
with the reference's key chain), and its printed lines must equal the
reference's, character for character: integers exact, floats as printed
(agreement within 1e-5 prints alike at the examples' 1-4 decimals).
Torch and JAX draws never agree, so the port's own runs (``main([...,
"--device", "cpu"])``) are held only to running at smoke size and
printing the reference's layout.
"""
import contextlib
import json
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.scenarios import generate_masked_scenario as j_masked  # noqa: E402
from repro.core.scenarios import generate_scenario as j_generate  # noqa: E402
from repro.core.scenarios import masked_scenario_suite as j_masked_suite  # noqa: E402
from repro.core.scenarios import scenario_suite as j_suite  # noqa: E402
from repro.opt.anneal import _temperature_schedule as j_schedule  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import anneal_noise_from_numpy  # noqa: E402
from repro_torch.examples import (adversarial_report,  # noqa: E402
                                  lag_slo_sweep, live_dashboard,
                                  pareto_frontier, quickstart,
                                  scenario_sweep)

ROOT = Path(__file__).resolve().parents[1]


def reference_output(name, argv, monkeypatch):
    """What ``examples/<name>.py`` prints, run as a script with ``argv``."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name="__main__")
    return out.getvalue()


def printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return out.getvalue(), result


def as_torch(x):
    return torch.tensor(np.asarray(x))


def same_lines(got, want):
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_prints_the_reference_lines(monkeypatch):
    """The shelf, the BFD and MBFP packings (the host packer, as in the
    reference) and the evaluation table (Eq. 11 streams drawn with numpy
    from the same seed in both packages) line for line."""
    want = reference_output("quickstart", [], monkeypatch)
    got, table = printed(quickstart.main, ["--device", "cpu"])
    same_lines(got, want)
    assert table.deltas == (5, 15, 25)


def test_quickstart_main_runs_at_smoke_size(monkeypatch):
    """``main`` with the evaluation cut to 12 measurements of 8
    partitions: the shelf and both packings as in the full run, a row a
    (delta, algorithm)."""
    real = api.evaluate
    monkeypatch.setattr(api, "evaluate", lambda **kw: real(
        **dict(kw, n_partitions=8, n_measurements=12)))
    got, table = printed(quickstart.main, ["--device", "cpu"])
    assert "BFD packs 5 partitions onto 2 consumers:" in got
    assert "after a load spike, MBFP uses 3 consumers" in got
    rows = [ln for ln in got.splitlines() if ln.startswith("  ")
            and ln.split()[0].isdigit()]
    assert len(rows) == 15
    for d in table.deltas:
        assert all(np.isfinite(v) for v in table.cbs[d].values())


# ---------------------------------------------------------------------------
# scenario_sweep
# ---------------------------------------------------------------------------


def test_scenario_sweep_prints_the_reference_rows(monkeypatch):
    """The 12 packers over the reference's suite (5 families x 3 streams
    of 48 x 16): mean bins, mean R and migrations a (family, algorithm),
    the header and the stars."""
    want = reference_output("scenario_sweep", [], monkeypatch)
    ex = scenario_sweep
    suite = j_suite(jax.random.key(0), ex.BATCH, ex.ITERS, ex.N_PARTITIONS,
                    capacity=ex.CAPACITY, families=ex.FAMILIES)
    monkeypatch.setattr(ex, "scenario_suite", lambda *a, **k: {
        f: as_torch(v) for f, v in suite.items()})
    got, rows = printed(ex.main, ["--device", "cpu"])
    same_lines(got, want)
    assert set(rows) == set(ex.FAMILIES)


def test_scenario_sweep_main_runs_at_smoke_size(monkeypatch):
    """``main`` on its own draws, cut to one stream of 12 steps a
    family: a block a family, a row an algorithm, integer migrations."""
    monkeypatch.setattr(scenario_sweep, "BATCH", 1)
    monkeypatch.setattr(scenario_sweep, "ITERS", 12)
    got, rows = printed(scenario_sweep.main, ["--device", "cpu"])
    assert got.count("mean bins") == len(scenario_sweep.FAMILIES)
    for fam, by_algo in rows.items():
        assert set(by_algo) == set(scenario_sweep.ALGORITHMS)
        for b, r, m in by_algo.values():
            assert b >= 1 and r >= 0 and isinstance(m, int)


# ---------------------------------------------------------------------------
# lag_slo_sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--smoke"], ["--smoke", "--use-kernel"]])
def test_lag_slo_sweep_prints_the_reference_rows(argv, monkeypatch):
    """The closed loop over the reference's masked suite: violation %,
    peak lag, time to drain, cost and migrations a (family, policy), with
    the drain through the per-step torch ops or through ``lag_update``'s
    wrapper (its plain version on the CPU)."""
    want = reference_output("lag_slo_sweep", argv, monkeypatch)
    p = lag_slo_sweep.SMOKE
    suite = j_masked_suite(jax.random.key(0), p["batch"], p["iters"],
                           p["n"], families=p["families"])
    monkeypatch.setattr(lag_slo_sweep, "masked_scenario_suite",
                        lambda *a, **k: {f: tuple(as_torch(x) for x in v)
                                         for f, v in suite.items()})
    got, table = printed(lag_slo_sweep.main, argv + ["--device", "cpu"])
    same_lines(got, want)
    assert list(table) == list(p["families"])


def test_lag_slo_sweep_replays_a_trace_as_the_reference(tmp_path,
                                                         monkeypatch):
    """``--trace PATH``: one recorded trace (written by the reference's
    ``save_trace``) replayed at its own capacity, through both."""
    from repro.scenarios import save_trace, trace_from_scenario

    path = tmp_path / "bursty.npz"
    save_trace(trace_from_scenario("bursty", jax.random.key(3), 2, 20, 5,
                                   capacity=1.5), str(path))
    argv = ["--smoke", "--trace", str(path)]
    want = reference_output("lag_slo_sweep", argv, monkeypatch)
    got, _ = printed(lag_slo_sweep.main, argv + ["--device", "cpu"])
    same_lines(got, want)
    assert "replaying trace" in got


def test_lag_slo_sweep_main_runs_at_smoke_size():
    got, table = printed(lag_slo_sweep.main,
                         ["--smoke", "--use-kernel", "--device", "cpu"])
    assert got.count("viol%") == len(lag_slo_sweep.SMOKE["families"])
    for rows, best in table.values():
        assert [r[0] for r in rows] == list(lag_slo_sweep.SMOKE["policies"])
        assert 0 <= best < len(rows)
        assert all(np.isfinite(v) for r in rows for v in r[1:])


# ---------------------------------------------------------------------------
# pareto_frontier
# ---------------------------------------------------------------------------


def reference_draws(seed, steps, chains, n):
    """The reference annealer's draws under ``key(seed)``: ``split(key,
    steps)``, one ``[chains, N*M+1]`` Gumbel draw a step, and its
    temperatures."""
    width = n * (2 * n + 2) + 1
    keys = jax.random.split(jax.random.key(seed), steps)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (chains, width),
                                             jnp.float32))(keys)
    return anneal_noise_from_numpy(np.asarray(g), np.asarray(
        j_schedule(steps, 1.0, 0.02)), device="cpu")


@pytest.mark.parametrize("family,n", [("diurnal", 8), ("heavy_tail", 10)])
def test_pareto_frontier_prints_the_reference_report(family, n,
                                                     monkeypatch):
    """The bin floor, the annealed lambda sweep, the front and its
    hypervolume, and every heuristic's point, domination and HV share,
    from the reference's trace and draws."""
    argv = ["--family", family, "--n", str(n)]
    want = reference_output("pareto_frontier", argv, monkeypatch)
    lambdas = [0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0]
    trace = np.asarray(j_generate(family, jax.random.key(0), 1, 16, n,
                                  capacity=1.0))[0].copy()
    got, (fr, points) = printed(
        pareto_frontier.frontier_report, trace, family, lambdas=lambdas,
        restarts=4, steps=300, noise=reference_draws(0, 300, 28, n),
        device="cpu")
    same_lines(got, want)
    assert len(points) == 12 and fr.hypervolume > 0


def test_pareto_frontier_main_runs_at_smoke_size():
    got, (fr, points) = printed(pareto_frontier.main, [
        "--n", "5", "--iters", "8", "--steps", "40", "--restarts", "2",
        "--lambdas", "0", "2", "--device", "cpu"])
    assert "exact bin floor" in got and "Pareto front" in got
    assert len(fr.per_lambda) == 2 and len(points) == 12
    assert all(not m["dominated"] or m["hv_ratio"] <= 1.0
               for _, _, m in points)


# ---------------------------------------------------------------------------
# live_dashboard
# ---------------------------------------------------------------------------


def reference_scenarios(plan):
    out = []
    for i, (fam, count, t, n) in enumerate(plan):
        speeds, active = j_masked(fam, jax.random.key(i), count, t, n)
        out.extend((as_torch(speeds[b]), as_torch(active[b]))
                   for b in range(count))
    return out


@pytest.mark.parametrize("argv,plan", [(["--smoke"], "SMOKE"),
                                       (["--no-ansi"], "FULL")])
def test_live_dashboard_prints_the_reference_frames(argv, plan,
                                                    monkeypatch):
    """Every snapshot's frame (progress bar, the merged sketch's mean,
    max, EWMA and p99 rows, the incident counts) and the closing line,
    over the reference's scenarios, ragged into several buckets."""
    want = reference_output("live_dashboard", argv, monkeypatch)
    got, (res, snaps) = printed(
        live_dashboard.run_dashboard,
        reference_scenarios(getattr(live_dashboard, plan)), device="cpu")
    same_lines(got, want)
    assert len(snaps) > 1 and snaps[-1].done == snaps[-1].total


def test_live_dashboard_main_runs_at_smoke_size():
    got, (res, snaps) = printed(live_dashboard.main,
                                ["--smoke", "--device", "cpu"])
    assert got.count("repro fleet dashboard") == len(snaps) >= 2
    assert "\x1b[" not in got
    assert got.splitlines()[-1].startswith("done: 4 scenarios in ")


# ---------------------------------------------------------------------------
# adversarial_report
# ---------------------------------------------------------------------------


@pytest.fixture
def envelope(tmp_path):
    """A small artifact in the envelope of ``BENCH_adversarial.json``: one
    row for every registry family, drawn from a seeded RNG."""
    from repro.scenarios import family_representatives

    rng = np.random.default_rng(3)
    knobs = ("base_rate", "tail_sigma", "burst_start_frac", "burst_len_frac",
             "burst_amp", "churn_p", "lifecycle_frac", "birth_frac",
             "death_frac", "noise")
    fams = {}
    for fam, policy in sorted(family_representatives().items()):
        genome = rng.uniform(0, 4, len(knobs)).tolist()
        fams[fam] = {
            "policy": policy, "evals": 48, "generations_run": 6,
            "worst_violation_frac": float(rng.uniform()),
            "worst_incidents": float(rng.integers(0, 20)),
            "worst_fitness": float(rng.uniform()),
            "baseline": {"best_violation_frac": float(rng.uniform()),
                         "best_fitness": float(rng.uniform()), "evals": 48},
            "beats_baseline": bool(rng.integers(0, 2)),
            "witness_genome": genome,
            "witness_knobs": dict(zip(knobs, genome))}
    report = {"schema_version": 1, "kind": "adversarial",
              "config": {"seed": 0, "pop_size": 8, "generations": 6,
                         "iters": 96, "n_partitions": 6},
              "families": fams}
    path = tmp_path / "adversarial.json"
    path.write_text(json.dumps(report))
    return str(path)


@pytest.mark.parametrize("mode", ([], ["--smoke"]))
def test_adversarial_report_prints_the_reference_lines(envelope, mode,
                                                       monkeypatch):
    argv = ["--bench", envelope] + mode
    want = reference_output("adversarial_report", argv, monkeypatch)
    got, _ = printed(adversarial_report.main, argv)
    same_lines(got, want)
    assert got.count("\n") > 6
    assert ("adversarial report smoke OK" in got) == bool(mode)


def test_adversarial_report_smoke_refuses_a_missing_family(envelope,
                                                           tmp_path):
    report = json.loads(Path(envelope).read_text())
    report["families"].pop("sticky")
    short = tmp_path / "short.json"
    short.write_text(json.dumps(report))
    with pytest.raises(AssertionError, match="registry families"):
        printed(adversarial_report.main, ["--bench", str(short), "--smoke"])
    assert Path(adversarial_report.BENCH_PATH) == \
        ROOT / "BENCH_adversarial_torch.json"


def _test_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_adversarial_report_attack_row_follows_the_reference(monkeypatch):
    """``--attack NF``: the reference's search and baseline (its evolution
    step with jit off, as ``tests/test_torch_search.py`` runs it), and the
    port's fed the reference's draws, print the same row."""
    from repro_torch.scenarios import search as tsearch

    ts_tests = _test_module("test_torch_search")
    with ts_tests._eager_evolution():
        want = reference_output("adversarial_report", ["--attack", "NF"],
                                monkeypatch)
    cfg = tsearch.SearchConfig(pop_size=8, generations=5, iters=96, n=6)
    noise = ts_tests._reference_noise(cfg, 0, cfg.generations)
    for name in ("attack", "random_search"):
        fn = getattr(tsearch, name)
        monkeypatch.setattr(tsearch, name, lambda *a, _fn=fn, **k: _fn(
            *a, noise=noise, **k))
    got, _ = printed(adversarial_report.main,
                     ["--attack", "NF", "--device", "cpu"])
    same_lines(got, want)


# ---------------------------------------------------------------------------
# chip_smoke's path S: the kernel calls the examples make
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.fixture(scope="module")
def path_s_calls(chip_smoke):
    """Each of path S's examples run as the path runs it, on the CPU,
    with its kernel calls recorded (``chip_smoke._kernel_calls``)."""
    mods = {"quickstart": quickstart, "scenario_sweep": scenario_sweep,
            "lag_slo_sweep": lag_slo_sweep,
            "pareto_frontier": pareto_frontier,
            "live_dashboard": live_dashboard,
            "adversarial_report": adversarial_report}
    out = {}
    for name, argv, _ in chip_smoke.S_EXAMPLES:
        seen = {}
        with chip_smoke._kernel_calls(seen):
            printed(mods[name].main, list(argv) + ["--device", "cpu"])
        out[name] = seen
    return out


@pytest.mark.parametrize("name", ["quickstart", "scenario_sweep",
                                  "lag_slo_sweep", "pareto_frontier",
                                  "live_dashboard", "adversarial_report"])
def test_chip_path_s_holds_each_example_at_its_calls(chip_smoke,
                                                     path_s_calls, name):
    """Every kernel call an example of path S makes is at a shape that
    ``chip_smoke.S_CALLS`` lists (so ``check_s_calls`` holds the kernels
    there on the card), and the kernels path S holds it to are among
    them."""
    seen = path_s_calls[name]
    assert all(shape in chip_smoke.S_CALLS[k] for k, shape in seen)
    (held,) = [k for n, _, k in chip_smoke.S_EXAMPLES if n == name]
    assert not held or {k for k, _ in seen} & set(held)


def test_chip_path_s_calls_are_exactly_the_examples(chip_smoke,
                                                    path_s_calls):
    """Each shape of ``chip_smoke.S_CALLS`` is made by some example: the
    table checks no call path S does not make."""
    made = {key for seen in path_s_calls.values() for key in seen}
    assert made == {(k, s) for k, shapes in chip_smoke.S_CALLS.items()
                    for s in shapes}

"""The port's facade against the reference's: the same outcome fields,
the verbs' results on the same numpy inputs (integers exact, floats
within ``1e-5``; ``pack``'s R-score, a Python float sum, within
``1e-12``), and what the port does not carry yet refused by name before
anything runs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.lagsim import NotPortedError  # noqa: E402


@pytest.mark.parametrize("outcome", (
    "SimulateOutcome", "OptimizeOutcome", "PackOutcome", "SweepOutcome",
    "EvaluateOutcome", "BenchReport"))
def test_outcome_fields_equal_the_reference(outcome):
    ours = [(f.name, f.default) for f in
            dataclasses.fields(getattr(api, outcome))]
    ref = [(f.name, f.default) for f in
           dataclasses.fields(getattr(japi, outcome))]
    assert ours == ref


def test_simulate_outcome_telemetry_fields_stay_none():
    out = api.simulate(np.full((1, 3, 2), 0.3, np.float32),
                       policies=("BFD",), device="cpu")
    assert (out.telemetry, out.sketches, out.incidents) == (None, None, None)
    assert out.lag_total.shape == (1, 1, 3)


def test_simulate_refuses_control_plane_before_anything_runs(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("simulate ran before refusing control_plane=")

    monkeypatch.setattr(api, "default_fleet", boom)
    with pytest.raises(NotPortedError, match="control_plane"):
        api.simulate(np.zeros((1, 3, 2), np.float32), policies=("BFD",),
                     control_plane={"poll_steps": 2}, device="cpu")


PACKERS = japi.list_policies(family=japi.PACKER_FAMILIES, backend="jax")


@pytest.mark.parametrize("with_prev", (False, True))
@pytest.mark.parametrize("algorithm", PACKERS)
def test_pack_equals_the_reference(algorithm, with_prev):
    rng = np.random.default_rng(PACKERS.index(algorithm))
    n = 13
    speeds = rng.uniform(0.02, 0.7, n).astype(np.float32)
    prev = None
    if with_prev:
        prev = rng.integers(-1, 6, n).astype(np.int32)
    ours = api.pack(speeds, 1.0, algorithm=algorithm.lower(), prev=prev,
                    device="cpu")
    ref = japi.pack(speeds, 1.0, algorithm=algorithm.lower(), prev=prev,
                    backend="jax")
    assert (ours.algorithm, ours.capacity, ours.n_bins, ours.assignment) == (
        ref.algorithm, ref.capacity, ref.n_bins, ref.assignment)
    assert ours.backend == "torch" and ours.schema_version == 1
    assert sorted(ours.loads) == sorted(ref.loads)
    for c, load in ref.loads.items():
        assert abs(ours.loads[c] - load) <= 1e-5
    if with_prev:
        assert abs(ours.rscore - ref.rscore) <= 1e-12
    else:
        assert ours.rscore is None and ref.rscore is None


def test_rscore_copy_equals_the_reference():
    import importlib

    jr = importlib.import_module("repro.core.rscore")
    tr = importlib.import_module("repro_torch.core.rscore")

    rng = np.random.default_rng(5)
    prev = {j: int(c) for j, c in enumerate(rng.integers(0, 4, 40))}
    new = {j: int(c) for j, c in enumerate(rng.integers(0, 4, 40))}
    speeds = {j: float(w) for j, w in enumerate(rng.uniform(0, 1, 38))}
    for kw in ({}, {"active": set(range(0, 40, 3))}):
        assert (tr.rscore(prev, new, speeds, 1.7, **kw)
                == jr.rscore(prev, new, speeds, 1.7, **kw))
    with pytest.raises(KeyError, match="no write-speed sample"):
        tr.rscore(prev, new, speeds, 1.0, missing="raise")
    with pytest.raises(ValueError, match="capacity must be positive"):
        tr.rscore_of_set(set(), speeds, 0.0)


def test_sweep_equals_the_reference():
    traces = np.random.default_rng(6).uniform(0, 0.8, (3, 14, 6)).astype(
        np.float32)
    ours = api.sweep(traces, 1.0, device="cpu")
    ref = japi.sweep(traces, 1.0)
    assert ours.algorithms == ref.algorithms == tuple(PACKERS)
    np.testing.assert_array_equal(ours.bins, np.asarray(ref.bins))
    np.testing.assert_array_equal(ours.migrations, np.asarray(ref.migrations))
    np.testing.assert_allclose(ours.rscores, np.asarray(ref.rscores),
                               atol=1e-5, rtol=0)
    assert ours.bins.dtype == np.int32 and ours.rscores.dtype == np.float32


def test_evaluate_equals_the_reference():
    kw = dict(deltas=(5, 25), n_partitions=9, n_measurements=30, seed=3)
    ours = api.evaluate(device="cpu", **kw)
    ref = japi.evaluate(**kw)
    assert (ours.algorithms, ours.deltas, ours.cbs, ours.pareto) == (
        ref.algorithms, ref.deltas, ref.cbs, ref.pareto)
    for d in ref.deltas:
        for a in ref.algorithms:
            assert abs(ours.avg_rscore[d][a] - ref.avg_rscore[d][a]) <= 1e-5


def test_sweep_follows_capacity_on_a_warm_entry():
    """A second call of one shape with another capacity hits the warm
    cache entry and still packs with its own capacity."""
    runner = api.FleetRunner()
    traces = np.random.default_rng(8).uniform(0, 1.5, (3, 10, 6)).astype(
        np.float32)
    for capacity in (1.0, 2.0):
        ours = api.sweep(traces, capacity, fleet=runner, device="cpu")
        ref = japi.sweep(traces, capacity)
        np.testing.assert_array_equal(ours.bins, np.asarray(ref.bins))
        np.testing.assert_array_equal(ours.migrations,
                                      np.asarray(ref.migrations))
        np.testing.assert_allclose(ours.rscores, np.asarray(ref.rscores),
                                   atol=1e-5, rtol=0)
    stats = runner.stats()
    assert (stats["cache_hits"], stats["cache_misses"]) == (1, 1)


def test_evaluate_follows_capacity_on_a_warm_entry():
    kw = dict(deltas=(5, 25), n_partitions=9, n_measurements=30, seed=5)
    for capacity in (1.0, 2.0):
        ours = api.evaluate(capacity=capacity, device="cpu", **kw)
        ref = japi.evaluate(capacity=capacity, **kw)
        assert (ours.cbs, ours.pareto) == (ref.cbs, ref.pareto)
        for d in ref.deltas:
            for a in ref.algorithms:
                assert abs(ours.avg_rscore[d][a]
                           - ref.avg_rscore[d][a]) <= 1e-5
    assert api.default_fleet().stats()["cache_hits"] >= 1


def test_streams_copy_is_bit_identical():
    import importlib

    js = importlib.import_module("repro.core.streams")
    ts = importlib.import_module("repro_torch.core.streams")

    for init in ("random", "zero", "half", "full"):
        assert (ts.generate_stream(7, 25, 15, 1.3, init, seed=4).tobytes()
                == js.generate_stream(7, 25, 15, 1.3, init, seed=4).tobytes())
    a, b = ts.paper_streams(5, n_measurements=9), js.paper_streams(
        5, n_measurements=9)
    assert all(a[d].tobytes() == b[d].tobytes() for d in js.PAPER_DELTAS)


def test_bench_report_writes_the_reference_json(tmp_path):
    kw = dict(kind="lagsim", config={"iters": 8, "capacity": 1.0},
              families={"diurnal": {"BFD": [0.5, 0.25]}},
              extra={"rows": [1, 2]})
    ours = api.BenchReport(**kw).write(str(tmp_path / "ours.json"))
    ref = japi.BenchReport(**kw).write(str(tmp_path / "ref.json"))
    assert ours == ref
    assert ((tmp_path / "ours.json").read_text()
            == (tmp_path / "ref.json").read_text())
    with pytest.raises(ValueError, match="must not shadow envelope keys"):
        api.BenchReport("x", {}, {}, extra={"kind": 1}).as_dict()


def test_simulate_uses_the_given_fleet():
    runner = api.FleetRunner()
    traces = np.random.default_rng(7).uniform(0, 1, (2, 6, 3)).astype(
        np.float32)
    out = api.simulate(traces, policies=("BFD", "KEDA_LAG"), fleet=runner,
                       device="cpu")
    assert runner.stats()["cache_misses"] == 1   # the call used THIS runner
    ref = japi.simulate(traces, policies=("BFD", "KEDA_LAG"))
    for name in ("consumers", "migrations"):
        np.testing.assert_array_equal(getattr(out, name),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(out.lag_total, np.asarray(ref.lag_total),
                               atol=1e-5, rtol=0)
    assert sorted(out.metrics) == sorted(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(out.metrics[k], np.asarray(v), atol=1e-5)


def test_default_fleet_is_shared():
    assert api.default_fleet() is api.default_fleet()
    assert isinstance(api.default_fleet(), api.FleetRunner)
    assert api.FleetConfig is __import__(
        "repro_torch.fleet", fromlist=["FleetConfig"]).FleetConfig
    with pytest.raises(AttributeError):
        api.NoSuchThing

"""The port's fleet layer against ``repro.fleet``, case for case as
``tests/test_fleet.py``.

The same numpy inputs go through the reference's ``FleetRunner`` and the
port's (on the CPU, where every kernel runs its plain version):
integers equal exactly, floats within ``1e-5``, cache counters and span
names equal.  As in the reference's tests, a uniform fleet equals the
port's own direct engines bit for bit, and ragged scenarios padded into
buckets equal their solo runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.fleet import FleetConfig as JConfig  # noqa: E402
from repro.fleet import FleetRunner as JRunner  # noqa: E402
from repro.lagsim import LagSimConfig as JLag  # noqa: E402
from repro.telemetry.spans import default_tracer as jtracer  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.pack import sweep_streams  # noqa: E402
from repro_torch.core.scenarios import generate_masked_scenario  # noqa: E402
from repro_torch.fleet import FleetConfig, FleetRunner  # noqa: E402
from repro_torch.lagsim import LagSimConfig, sweep_lag  # noqa: E402
from repro_torch.telemetry.spans import default_tracer  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
CFG = LagSimConfig(capacity=1.0, dt=1.0, migration_steps=2)
JCFG = JLag(capacity=1.0, dt=1.0, migration_steps=2)
CPU = dict(device="cpu")
LAG_INTS = ("consumers", "migrations", "unreadable")


def _traces(b=3, t=12, n=6, seed=0):
    return np.random.default_rng(seed).uniform(0, 0.9, (b, t, n)).astype(
        np.float32)


def _lifecycle(b, t, n, seed):
    sp, act = generate_masked_scenario("topic_lifecycle", seed, b, t, n,
                                       **CPU)
    return sp.numpy(), act.numpy()


def _j(x):
    return None if x is None else jnp.asarray(x)


def _same_sweep(ours, ref):
    """A port ``FleetSweepResult`` against the reference's."""
    assert ours.algorithms == ref.algorithms
    for a, b in zip(ours.bins, ref.bins):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(ours.migrations, ref.migrations):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(ours.rscores, ref.rscores):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def _same_lag(ours, ref):
    """A port ``FleetLagResult`` against the reference's."""
    assert ours.policies == ref.policies
    for f in LAG_INTS:
        for a, b in zip(getattr(ours, f), getattr(ref, f)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for f in ("lag_total", "lag_max"):
        for a, b in zip(getattr(ours, f), getattr(ref, f)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    for f in ("telemetry", "sketch", "incidents"):
        assert (getattr(ours, f) is None) == (getattr(ref, f) is None), f
    if ref.telemetry is not None:
        for a, b in zip(ours.telemetry, ref.telemetry):
            assert a.names == b.names
            np.testing.assert_allclose(a.channels, np.asarray(b.channels),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(a.steps, np.asarray(b.steps))
    if ref.incidents is not None:
        for i in range(len(ref.incidents)):
            got, want = ours.scenario_incidents(i), ref.scenario_incidents(i)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                g, w = g.as_dict(), w.as_dict()
                assert g.pop("peak") == pytest.approx(w.pop("peak"),
                                                      rel=1e-5, abs=1e-5)
                assert g == w


def _stats(runner):
    return {k: v for k, v in runner.stats().items() if k != "devices"}


# ---------------------------------------------------------------------------
# uniform fleets == direct engines, and == the reference's fleet
# ---------------------------------------------------------------------------
def test_uniform_sweep_equals_direct():
    tr = _traces()
    runner = FleetRunner()
    res = runner.sweep(("BFD", "MBFP"), tr, 1.0, **CPU)
    direct = sweep_streams(("BFD", "MBFP"), tr, 1.0, **CPU)
    bins, rscores, migs = res.stacked()
    np.testing.assert_array_equal(bins, direct.bins.numpy())
    assert rscores.tobytes() == direct.rscores.numpy().tobytes()
    np.testing.assert_array_equal(migs, direct.migrations.numpy())
    _same_sweep(res, JRunner().sweep(("BFD", "MBFP"), _j(tr), 1.0))
    assert runner.stats()["buckets"] == {"12x6": 3}


def test_uniform_simulate_equals_direct():
    tr = _traces(seed=1)
    res = FleetRunner().simulate(("BFD", "KEDA_LAG"), tr, CFG, **CPU)
    direct = sweep_lag(("BFD", "KEDA_LAG"), tr, CFG, **CPU)
    st = res.stacked()
    for f in ("lag_total", "lag_max", *LAG_INTS):
        assert st[f].tobytes() == getattr(direct, f).numpy().tobytes(), f
    _same_lag(res, JRunner().simulate(("BFD", "KEDA_LAG"), _j(tr), JCFG))


def test_uniform_result_copies_a_field_only_when_read():
    """A uniform batch's fields stay tensors where they ran until read:
    ``stacked(fields)`` copies those fields only, and a field read later
    row by row equals the engine's."""
    tr = _traces(b=4, seed=4)
    res = FleetRunner().simulate(("BFD", "KEDA_LAG"), tr, CFG, **CPU)
    direct = sweep_lag(("BFD", "KEDA_LAG"), tr, CFG, **CPU)
    st = res.stacked(("lag_total", "consumers", "migrations"))
    assert sorted(st) == ["consumers", "lag_total", "migrations"]
    for f in ("lag_max", "unreadable"):
        assert isinstance(getattr(res, f)._batch, torch.Tensor), f
    want = direct.lag_max.numpy()
    assert len(res.lag_max) == 4
    assert np.stack(list(res.lag_max), 1).tobytes() == want.tobytes()
    assert res.lag_max[-1].tobytes() == want[:, -1].tobytes()
    assert [r.tobytes() for r in res.lag_max[1:3]] == [
        want[:, i].tobytes() for i in (1, 2)]
    assert isinstance(res.lag_max._batch, np.ndarray)


def test_masked_sweep_equals_direct():
    sp, ac = _lifecycle(2, 16, 5, seed=2)
    res = FleetRunner().sweep(("BFD",), sp, 1.0, active=ac, **CPU)
    direct = sweep_streams(("BFD",), sp, 1.0, ac, **CPU)
    bins, rscores, _ = res.stacked()
    np.testing.assert_array_equal(bins, direct.bins.numpy())
    assert rscores.tobytes() == direct.rscores.numpy().tobytes()
    _same_sweep(res, JRunner().sweep(("BFD",), _j(sp), 1.0, active=_j(ac)))


def test_masked_simulate_equals_direct():
    sp, ac = _lifecycle(2, 16, 5, seed=3)
    res = FleetRunner().simulate(("MWF", "RATE_THRESHOLD"), sp, CFG,
                                 active=ac, **CPU)
    direct = sweep_lag(("MWF", "RATE_THRESHOLD"), sp, CFG, active=ac, **CPU)
    st = res.stacked()
    for f in ("lag_total", *LAG_INTS):
        assert st[f].tobytes() == getattr(direct, f).numpy().tobytes(), f
    _same_lag(res, JRunner().simulate(("MWF", "RATE_THRESHOLD"), _j(sp),
                                      JCFG, active=_j(ac)))


# ---------------------------------------------------------------------------
# ragged fleets: bucket padding is exact
# ---------------------------------------------------------------------------
def test_ragged_sweep_equals_solo_runs():
    rng = np.random.default_rng(3)
    cfg = dict(t_buckets=(16,), n_buckets=(8,))
    runner = FleetRunner(FleetConfig(**cfg))
    shapes = ((10, 5), (16, 8), (7, 3), (12, 8))
    scen = [rng.uniform(0, 1, s).astype(np.float32) for s in shapes]
    res = runner.sweep(("BFD", "MWF"), scen, 1.0, **CPU)
    for i, s in enumerate(scen):
        solo = sweep_streams(("BFD", "MWF"), s[None], 1.0, **CPU)
        assert res.bins[i].shape == (2, s.shape[0])
        np.testing.assert_array_equal(res.bins[i], solo.bins[:, 0].numpy())
        # the R-score sums run over the padded row: within the rounding
        np.testing.assert_allclose(res.rscores[i],
                                   solo.rscores[:, 0].numpy(), **TOL)
    stats = runner.stats()
    assert stats["buckets"] == {"16x8": 4}
    assert stats["cache_misses"] == 1
    ref = JRunner(JConfig(**cfg))
    _same_sweep(res, ref.sweep(("BFD", "MWF"), [_j(s) for s in scen], 1.0))
    assert _stats(runner) == _stats(ref)


def test_ragged_simulate_equals_solo_runs():
    """Padded partitions are dead (inactive) partitions, so the twin's
    trajectories are unchanged; the config resolves at each scenario's
    true N (reactive clamps must not widen to the bucket)."""
    rng = np.random.default_rng(4)
    cfg = dict(t_buckets=(20,), n_buckets=(8,))
    runner = FleetRunner(FleetConfig(**cfg))
    shapes = ((14, 4), (20, 8), (9, 6))
    scen = [rng.uniform(0, 1.2, s).astype(np.float32) for s in shapes]
    res = runner.simulate(("BFD", "KEDA_LAG"), scen, CFG, **CPU)
    for i, s in enumerate(scen):
        solo = sweep_lag(("BFD", "KEDA_LAG"), s[None], CFG, **CPU)
        np.testing.assert_allclose(res.lag_total[i],
                                   solo.lag_total[:, 0].numpy(), **TOL)
        for f in LAG_INTS:
            np.testing.assert_array_equal(getattr(res, f)[i],
                                          getattr(solo, f)[:, 0].numpy())
    ref = JRunner(JConfig(**cfg))
    _same_lag(res, ref.simulate(("BFD", "KEDA_LAG"), [_j(s) for s in scen],
                                JCFG))
    assert _stats(runner) == _stats(ref)


def test_ragged_masked_scenarios_as_pairs():
    sp1, ac1 = generate_masked_scenario("churn", 5, 1, 12, 4, **CPU)
    sp2, ac2 = _lifecycle(1, 18, 7, seed=6)
    pairs = [(sp1[0].numpy(), ac1[0].numpy()), (sp2[0], ac2[0])]
    cfg = dict(t_buckets=(18,), n_buckets=(8,))
    runner = FleetRunner(FleetConfig(**cfg))
    res = runner.sweep(("MBFP",), pairs, 1.0, **CPU)
    for i, (sp, ac) in enumerate(pairs):
        solo = sweep_streams(("MBFP",), sp[None], 1.0, ac[None], **CPU)
        np.testing.assert_array_equal(res.bins[i], solo.bins[:, 0].numpy())
    ref = JRunner(JConfig(**cfg))
    _same_sweep(res, ref.sweep(("MBFP",), [(_j(s), _j(a)) for s, a in pairs],
                               1.0))
    sim = runner.simulate(("MBFP", "KEDA_LAG"), pairs, CFG, **CPU)
    _same_lag(sim, ref.simulate(("MBFP", "KEDA_LAG"),
                                [(_j(s), _j(a)) for s, a in pairs], JCFG))
    assert _stats(runner) == _stats(ref)


def test_views_of_one_tensor_pad_like_host_arrays():
    """Scenarios that are views of one tensor (the way a fleet cut from
    one big batch arrives on the card) are gathered in one read; masks
    given as ``None`` inside a masked group count as all True.  Both
    equal the same scenarios given as separate host arrays."""
    rng = np.random.default_rng(7)
    big = torch.tensor(rng.uniform(0, 1.2, (4, 20, 8)).astype(np.float32))
    mask = torch.tensor(rng.uniform(size=(4, 20, 8)) < 0.85)
    cut = ((14, 4), (20, 8), (9, 6), (20, 3))
    views = [(big[i, :t, :n], None if i == 1 else mask[i, :t, :n])
             for i, (t, n) in enumerate(cut)]
    copies = [(sp.numpy().copy(), None if ac is None else ac.numpy().copy())
              for sp, ac in views]
    fleet = FleetConfig(t_buckets=(20,), n_buckets=(8,))
    got = FleetRunner(fleet).simulate(("BFD", "MWFP"), views, CFG, **CPU)
    want = FleetRunner(fleet).simulate(("BFD", "MWFP"), copies, CFG, **CPU)
    for f in ("lag_total", *LAG_INTS):
        for a, b in zip(getattr(got, f), getattr(want, f)):
            assert a.tobytes() == b.tobytes(), f
    # a 3-D batch that needs padding takes the same path (rows are views)
    bat = FleetRunner(fleet).sweep(("FF",), big[:, :15, :5], 1.0, **CPU)
    solo = sweep_streams(("FF",), big[:, :15, :5], 1.0, **CPU)
    np.testing.assert_array_equal(bat.stacked()[0], solo.bins.numpy())


def test_padded_annealer_runs_are_valid():
    """The annealers draw over N, so padding changes their trajectories;
    a padded run must still be a valid one."""
    rng = np.random.default_rng(8)
    shapes = ((6, 3), (8, 5))
    scen = [rng.uniform(0, 0.9, s).astype(np.float32) for s in shapes]
    runner = FleetRunner(FleetConfig(t_buckets=(8,), n_buckets=(8,)))
    res = runner.simulate(("ANNEAL", "ANNEAL_STICKY"), scen, CFG, **CPU)
    for i, (t, n) in enumerate(shapes):
        assert res.consumers[i].shape == (2, t)
        assert (res.consumers[i] >= 1).all() and (res.consumers[i] <= n).all()
        assert (res.migrations[i] <= n).all()
        assert (res.unreadable[i] <= n).all()
        assert np.isfinite(res.lag_total[i]).all()


# ---------------------------------------------------------------------------
# bounded run cache, validation, progress, fitness, spans
# ---------------------------------------------------------------------------
def test_compile_cache_is_bounded_lru():
    runner = FleetRunner(FleetConfig(max_compile_cache=2))
    ref = JRunner(JConfig(max_compile_cache=2))
    for t in (8, 9, 10):
        runner.sweep(("BFD",), _traces(1, t, 4), 1.0, **CPU)
        ref.sweep(("BFD",), _j(_traces(1, t, 4)), 1.0)
    s = runner.stats()
    assert s["cache_entries"] <= 2
    assert s["cache_misses"] == 3 and s["cache_evictions"] >= 1
    assert _stats(runner) == _stats(ref)
    # the warm entry still answers correctly after evictions
    tr = _traces(1, 10, 4)
    res = runner.sweep(("BFD",), tr, 1.0, **CPU)
    ref.sweep(("BFD",), _j(tr), 1.0)
    direct = sweep_streams(("BFD",), tr, 1.0, **CPU)
    np.testing.assert_array_equal(res.stacked()[0], direct.bins.numpy())
    assert runner.stats()["cache_hits"] >= 1
    assert _stats(runner) == _stats(ref)
    runner.reset()
    ref.reset()
    runner.sweep(("BFD",), tr, 1.0, **CPU)
    ref.sweep(("BFD",), _j(tr), 1.0)
    assert _stats(runner) == _stats(ref)
    assert runner.stats()["cache_hits"] == 1
    runner.clear()
    assert runner.stats()["cache_entries"] == 0


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("kw", (dict(max_compile_cache=0),
                                dict(t_buckets=(32, 16)),
                                dict(n_buckets=(8, 4))))
def test_fleet_config_validation(kw):
    assert (_message(lambda: FleetConfig(**kw))
            == _message(lambda: JConfig(**kw)))


def test_scenario_shape_validation():
    cases = (
        lambda R, c, x: R().sweep(("BFD",), [x(np.zeros((4,)))], 1.0, **c),
        lambda R, c, x: R().sweep(("BFD",), x(_traces(2, 8, 4)), 1.0,
                                  active=x(np.ones((2, 8, 3), bool)), **c),
        lambda R, c, x: R().simulate(("BFD",), [x(_traces(1, 4, 3)[0])],
                                     active=x(np.ones((1, 4, 3), bool)), **c),
        lambda R, c, x: R().sweep(("BFD",), [(x(np.zeros((4, 3))),
                                              x(np.ones((4, 2), bool)))],
                                  1.0, **c),
    )
    for case in cases:
        ours = _message(lambda: case(FleetRunner, CPU, lambda a: a))
        ref = _message(lambda: case(JRunner, {}, _j))
        assert ours == ref


def test_progress_snapshots_equal_the_reference():
    rng = np.random.default_rng(9)
    scen = [rng.uniform(0, 1, s).astype(np.float32)
            for s in ((5, 3), (8, 4), (6, 3), (8, 8))]
    cfg = dict(t_buckets=(8,), n_buckets=(4, 8))
    ours, ref = [], []
    FleetRunner(FleetConfig(**cfg)).simulate(("BFD",), scen, CFG,
                                             progress=ours.append, **CPU)
    JRunner(JConfig(**cfg)).simulate(("BFD",), [_j(s) for s in scen], JCFG,
                                     progress=ref.append)
    assert ([(p.done, p.total, p.bucket, p.sketch, p.incidents)
             for p in ours]
            == [(p.done, p.total, p.bucket, p.sketch, p.incidents)
                for p in ref])
    one = []
    FleetRunner().simulate(("BFD",), _traces(2, 5, 3), CFG,
                           progress=one.append, **CPU)
    assert [(p.done, p.total, p.bucket) for p in one] == [(2, 2, "5x3")]


def test_fitness_equals_the_reference():
    tr = _traces(4, 16, 5, seed=10) * 1.6
    ours = FleetRunner().fitness(("BFD", "KEDA_LAG"), tr, CFG, **CPU)
    ref = JRunner().fitness(("BFD", "KEDA_LAG"), _j(tr), JCFG)
    assert ours.policies == ref.policies
    for f in ("violation_frac", "incidents", "fitness"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
        assert getattr(ours, f).dtype == getattr(ref, f).dtype
    assert 0 < ours.violation_frac.mean() < 1
    assert (_message(lambda: FleetRunner().fitness(
        ("BFD",), tr, CFG, incident_weight=1.0, **CPU))
        == _message(lambda: JRunner().fitness(("BFD",), _j(tr), JCFG,
                                               incident_weight=1.0)))


def _fleet_spans(tracer):
    return [r.name for r in tracer.records()
            if r.name.startswith(("api.", "fleet."))]


def test_span_names_equal_the_reference():
    """The same calls record the same span names, the reference's
    ``fleet.trace_lower`` + ``fleet.compile`` pair as the port's one
    ``fleet.build``."""
    def calls(runner_cls, cfg_cls, verbs, lag, c, x):
        runner = runner_cls(cfg_cls(t_buckets=(8,), n_buckets=(4,),
                                    max_compile_cache=1))
        verbs.sweep(x(_traces(2, 8, 4)), 1.0, algorithms=("BFD",),
                    fleet=runner, **c)
        verbs.sweep(x(_traces(2, 8, 4)), 1.0, algorithms=("BFD",),
                    fleet=runner, **c)
        runner.simulate(("BFD",), [x(_traces(1, 6, 3)[0]),
                                   x(_traces(1, 8, 2)[0])], lag, **c)
        runner.fitness(("BFD",), x(_traces(2, 5, 3)), lag, **c)

    default_tracer().reset()
    jtracer().reset()
    calls(FleetRunner, FleetConfig, api, CFG, CPU, lambda a: a)
    calls(JRunner, JConfig, japi, JCFG, {}, _j)
    ref = []
    for name in _fleet_spans(jtracer()):
        if name == "fleet.compile":
            assert ref[-1] == "fleet.trace_lower"
            ref[-1] = "fleet.build"
        else:
            ref.append(name)
    ours = _fleet_spans(default_tracer())
    assert ours == ref
    assert {"fleet.build", "fleet.cache_hit", "fleet.cache_miss",
            "fleet.cache_evict", "fleet.dispatch", "fleet.sweep",
            "fleet.simulate", "fleet.fitness", "api.sweep"} <= set(ours)


def test_split_over_two_devices_equals_one_device():
    """``devices=("cpu", "cpu")`` splits each padded batch into two
    contiguous chunks (an all-inactive dummy scenario evens an odd
    batch); the result equals one device's bit for bit."""
    two = FleetRunner(FleetConfig(devices=("cpu", "cpu"), t_buckets=(12,),
                                  n_buckets=(6,)))
    one = FleetRunner(FleetConfig(t_buckets=(12,), n_buckets=(6,)))
    rng = np.random.default_rng(11)
    ragged = [rng.uniform(0, 1, s).astype(np.float32)
              for s in ((12, 6), (9, 5), (10, 6))]
    uniform = _traces(3, 12, 6, seed=12)
    for scen in (ragged, uniform):
        a = two.simulate(("BFD", "KEDA_LAG"), scen, CFG)
        b = one.simulate(("BFD", "KEDA_LAG"), scen, CFG, **CPU)
        for f in ("lag_total", "lag_max", *LAG_INTS):
            for x, y in zip(getattr(a, f), getattr(b, f)):
                assert x.tobytes() == y.tobytes(), f
        s2 = two.sweep(("MBF", "NFD"), scen, 1.0)
        s1 = one.sweep(("MBF", "NFD"), scen, 1.0, **CPU)
        for f in ("bins", "rscores", "migrations"):
            for x, y in zip(getattr(s2, f), getattr(s1, f)):
                assert x.tobytes() == y.tobytes(), f
    assert two.stats()["devices"] == 2 and one.stats()["devices"] == 1
    assert two.stats()["buckets"] == {"12x6": 12}

"""The port's in-loop telemetry against ``repro.telemetry``, case for case
as ``tests/test_telemetry.py`` and ``tests/test_observability.py`` (their
golden fixtures left out: the port is held against live reference runs
on the same numpy inputs).

Tolerances: integers (trajectories, histogram and step counts, incident
open/close steps, rule counts, event kinds and steps) exact; channel
values, sketch moments and alert windows within ``atol = rtol = 1e-5``
(``m2``, a sum of squares, within ``rtol = 1e-5`` of its magnitude).
Within the port, telemetry on and off give the same trajectories bit for
bit, and a padded fleet run's state equals its direct run's (counts,
histograms and incident tables exact).
"""
import builtins
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.telemetry as jt  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core.scenarios import generate_masked_scenario  # noqa: E402
from repro.fleet import FleetConfig as JFleetConfig  # noqa: E402
from repro.fleet import FleetRunner as JFleetRunner  # noqa: E402
from repro.lagsim import LagSimConfig as JConfig  # noqa: E402
from repro.lagsim import simulate_lag as j_simulate_lag  # noqa: E402
from repro.lagsim import sweep_lag as j_sweep_lag  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import registry  # noqa: E402
from repro_torch.convert import (alert_state_from_numpy,  # noqa: E402
                                 sketch_state_from_numpy)
from repro_torch.fleet import (FleetConfig, FleetProgress,  # noqa: E402
                               FleetRunner)
from repro_torch.lagsim import LagSimConfig, simulate_lag, sweep_lag  # noqa: E402
from repro_torch.telemetry import (BASE_CHANNELS, AlertConfig,  # noqa: E402
                                   AlertRule, CounterState, EventStream,
                                   SketchConfig, SketchSummary,
                                   TelemetryConfig, alert_init, alert_step,
                                   decode_events, decode_incidents,
                                   default_rules, incident_counts,
                                   incident_summary, merge_summaries,
                                   otlp_metrics_json, prometheus_exposition,
                                   sketch_init, sketch_update,
                                   summaries_from_state, validate_exposition)

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = dict(device="cpu")
CFG = LagSimConfig(capacity=1.0, dt=1.0, migration_steps=2)
JCFG = JConfig(capacity=1.0, dt=1.0, migration_steps=2)
FIELDS = ("lag_total", "lag_max", "consumers", "migrations", "unreadable")
POLICIES = ("MBFP", "KEDA_LAG")
SKETCH_F = ("mean", "m2", "vmin", "vmax", "ewma", "ewma_w")
SKETCH_I = ("count", "hist")
ALERT_F = ("fast", "fast_w", "slow", "slow_w", "prev_lag", "prev_cons",
           "measure", "cur_peak", "peak")
ALERT_I = ("tick", "consec", "active", "cur_start", "open_step",
           "close_step", "count")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _tele(cfg, **kw):
    return dataclasses.replace(cfg, telemetry=TelemetryConfig(**kw))


def _obs(cfg, *, frames=True, sketch=True, alerts=True, **sk):
    return dataclasses.replace(cfg, telemetry=TelemetryConfig(
        record_frames=frames,
        sketch=SketchConfig(**sk) if sketch else None,
        alerts=AlertConfig(rules=default_rules()) if alerts else None))


def _jobs(cfg, *, frames=True, sketch=True, alerts=True, **sk):
    return dataclasses.replace(cfg, telemetry=jt.TelemetryConfig(
        record_frames=frames,
        sketch=jt.SketchConfig(**sk) if sketch else None,
        alerts=jt.AlertConfig(rules=jt.default_rules()) if alerts else None))


@functools.lru_cache(maxsize=None)
def _scenario(seed=0, batch=2, t=24, n=6):
    sp, act = generate_masked_scenario("topic_lifecycle",
                                       jax.random.key(seed), batch, t, n)
    return np.asarray(sp), np.asarray(act)


def _bits(a, b, ctx=""):
    for f in FIELDS:
        assert _np(getattr(a, f)).tobytes() == _np(getattr(b, f)).tobytes(), \
            (ctx, f)


def _same_sketch(got, want, ctx=""):
    """A port sketch state against a reference one (any batch shape)."""
    assert got.names == want.names and got.hist_names == want.hist_names
    for f in SKETCH_I:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      f"{ctx}: {f}")
    for f in SKETCH_F:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f"{ctx}: {f}")


def _same_alerts(got, want, ctx=""):
    assert got.rule_names == want.rule_names
    for f in ALERT_I:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      f"{ctx}: {f}")
    for f in ALERT_F:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f"{ctx}: {f}")


def _same_frame(got, want, ctx=""):
    assert got.names == want.names
    np.testing.assert_allclose(_np(got.channels), np.asarray(want.channels),
                               **TOL, err_msg=ctx)
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    np.testing.assert_array_equal(_np(got.count), np.asarray(want.count))


def _same_incidents(got, want):
    """Decoded incidents: every field exact but the peak measure, a float
    (within 1e-5 of its magnitude)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.as_dict(), w.as_dict()
        assert g.pop("peak") == pytest.approx(w.pop("peak"), rel=1e-5,
                                              abs=1e-5)
        assert g == w


def _same_events(got, want):
    assert len(got) == len(want)
    for (k, s, i, d), (wk, ws, wi, wd) in zip(got, want):
        assert (k, s, i) == (wk, ws, wi)
        assert set(d) == set(wd)
        for key in d:
            assert d[key] == pytest.approx(wd[key], abs=1e-5)


# ---------------------------------------------------------------------------
# off == the recorder-free loop; on never changes trajectories
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
def test_off_is_bit_identical_direct(policy):
    speeds, active = _scenario()
    off = simulate_lag(speeds[0], policy=policy, cfg=CFG, active=active[0],
                       **CPU)
    dis = simulate_lag(speeds[0], policy=policy,
                       cfg=_tele(CFG, enabled=False), active=active[0],
                       **CPU)
    _bits(off, dis)
    assert off.telemetry is None and dis.telemetry is None
    assert dis.sketch is None and dis.incidents is None


@pytest.fixture(scope="module")
def direct_frames():
    """The reference's frame, sketch and alerts on each policy over one
    masked lifecycle stream."""
    speeds, active = _scenario()
    return speeds, active, {
        pol: j_simulate_lag(speeds[0], policy=pol, cfg=_jobs(JCFG),
                            active=active[0]) for pol in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_on_trajectories_unchanged_direct(direct_frames, policy):
    speeds, active, ref = direct_frames
    off = simulate_lag(speeds[0], policy=policy, cfg=CFG, active=active[0],
                       **CPU)
    on = simulate_lag(speeds[0], policy=policy, cfg=_obs(CFG),
                      active=active[0], **CPU)
    _bits(off, on, policy)
    frame = on.telemetry
    t = speeds.shape[1]
    assert frame.names[:len(BASE_CHANNELS)] == BASE_CHANNELS
    assert tuple(frame.channels.shape) == (t, len(frame.names))
    assert int(frame.count) == t
    assert np.array_equal(_np(frame.steps), np.arange(t))
    _same_frame(frame, ref[policy].telemetry, policy)
    _same_sketch(on.sketch, ref[policy].sketch, policy)
    _same_alerts(on.incidents, ref[policy].incidents, policy)


def test_fused_wide_emits_sketch_and_alerts():
    """Under ``fused_steps`` the heuristics take ``_fused_wide`` with a
    sketch and alerts on (frames off), even with ``fused_kernel``: the
    trajectories equal the telemetry-off run bit for bit, and the states
    equal the reference's fused path's."""
    speeds, active = _scenario(seed=2, batch=3, t=20, n=6)
    pols = ("NF", "BFD", "WFD")
    over = dict(fused_steps=4, fused_kernel=True)
    off = sweep_lag(pols, speeds, dataclasses.replace(CFG, **over),
                    active=active, **CPU)
    on = sweep_lag(pols, speeds, dataclasses.replace(
        _obs(CFG, frames=False), **over), active=active, **CPU)
    _bits(off, on, "fused")
    assert on.telemetry is None
    want = j_sweep_lag(pols, speeds, dataclasses.replace(
        _jobs(JCFG, frames=False), fused_steps=4), active=active)
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(on, f)),
                                   np.asarray(getattr(want, f)), **TOL)
    _same_sketch(on.sketch, want.sketch, "fused")
    _same_alerts(on.incidents, want.incidents, "fused")


def test_off_is_bit_identical_fleet_padded():
    speeds, active = _scenario(t=20, n=5)
    fleet = FleetRunner(FleetConfig(t_buckets=(32,), n_buckets=(8,)))
    off = fleet.simulate(POLICIES, speeds, CFG, active=active, **CPU)
    dis = fleet.simulate(POLICIES, speeds, _tele(CFG, enabled=False),
                         active=active, **CPU)
    for i in range(speeds.shape[0]):
        for f in FIELDS:
            assert getattr(off, f)[i].tobytes() == \
                getattr(dis, f)[i].tobytes(), (i, f)
    assert off.telemetry is None and dis.telemetry is None


@pytest.mark.parametrize("seed,t,n", ((0, 4, 2), (1, 13, 5), (7, 24, 8)))
def test_off_bit_identical_fixed_seeds(seed, t, n):
    speeds, active = _scenario(seed=seed, batch=1, t=t, n=n)
    off = simulate_lag(speeds[0], policy="MBFP", cfg=CFG, active=active[0],
                       **CPU)
    dis = simulate_lag(speeds[0], policy="MBFP",
                       cfg=_tele(CFG, enabled=False), active=active[0],
                       **CPU)
    on = simulate_lag(speeds[0], policy="MBFP", cfg=_tele(CFG),
                      active=active[0], **CPU)
    _bits(off, dis)
    _bits(off, on)


# ---------------------------------------------------------------------------
# recorder semantics: sweep stacking, fleet padding, ring mode
# ---------------------------------------------------------------------------
def test_sweep_stacks_frames_and_for_policy_slices():
    speeds, active = _scenario()
    res = sweep_lag(POLICIES, speeds, cfg=_tele(CFG), active=active, **CPU)
    want = j_sweep_lag(POLICIES, speeds, dataclasses.replace(
        JCFG, telemetry=jt.TelemetryConfig()), active=active)
    p, b, t = len(POLICIES), speeds.shape[0], speeds.shape[1]
    k = len(res.telemetry.names)
    assert tuple(res.telemetry.channels.shape) == (p, b, t, k)
    _same_frame(res.telemetry, want.telemetry)
    for pi, pol in enumerate(POLICIES):
        one = res.for_policy(pol)
        direct = simulate_lag(speeds[1], policy=pol, cfg=_tele(CFG),
                              active=active[1], **CPU)
        assert torch.equal(one.telemetry.channels[1],
                           direct.telemetry.channels)


def test_fleet_padded_frames_match_direct():
    speeds, active = _scenario(t=20, n=5)
    fleet = FleetRunner(FleetConfig(t_buckets=(32,), n_buckets=(8,)))
    res = fleet.simulate(POLICIES, speeds, _tele(CFG), active=active, **CPU)
    ref = JFleetRunner(JFleetConfig(t_buckets=(32,), n_buckets=(8,))
                       ).simulate(POLICIES, jnp.asarray(speeds),
                                  dataclasses.replace(
                                      JCFG, telemetry=jt.TelemetryConfig()),
                                  active=jnp.asarray(active))
    t = speeds.shape[1]
    for i in range(speeds.shape[0]):
        frame = res.telemetry[i]
        assert frame.channels.shape[1] == t
        _same_frame(frame, ref.telemetry[i], str(i))
        for pi, pol in enumerate(POLICIES):
            direct = simulate_lag(speeds[i], policy=pol, cfg=_tele(CFG),
                                  active=active[i], **CPU)
            np.testing.assert_allclose(frame.channels[pi],
                                       _np(direct.telemetry.channels), **TOL)


def test_ring_mode_keeps_exact_tail():
    speeds, active = _scenario(batch=1, t=40, n=6)
    full = simulate_lag(speeds[0], policy="MBFP", cfg=_tele(CFG),
                        active=active[0], **CPU)
    ring = simulate_lag(speeds[0], policy="MBFP", cfg=_tele(CFG, ring=8),
                        active=active[0], **CPU)
    rf = ring.telemetry
    assert rf.channels.shape[0] == 8 and int(rf.count) == 40
    order = np.argsort(_np(rf.steps), kind="stable")
    assert np.array_equal(_np(rf.steps)[order], np.arange(32, 40))
    assert np.array_equal(_np(rf.channels)[order],
                          _np(full.telemetry.channels)[32:])
    want = j_simulate_lag(speeds[0], policy="MBFP", cfg=dataclasses.replace(
        JCFG, telemetry=jt.TelemetryConfig(ring=8)), active=active[0])
    _same_frame(rf, want.telemetry, "ring")


def test_ring_through_fleet_raises():
    speeds, active = _scenario(t=20, n=5)
    fleet = FleetRunner(FleetConfig(t_buckets=(32,), n_buckets=(8,)))
    with pytest.raises(ValueError, match="ring"):
        fleet.simulate(POLICIES, speeds, _tele(CFG, ring=8), active=active,
                       **CPU)


def test_telemetry_config_validation():
    for bad, exc in (({"lag_quantiles": (1.5,)}, ValueError),
                     ({"ring": 0}, ValueError),
                     ({"record_frames": False, "ring": 8}, ValueError),
                     ({"sketch": "yes"}, TypeError),
                     ({"alerts": "yes"}, TypeError)):
        with pytest.raises(exc) as want:
            jt.TelemetryConfig(**bad)
        with pytest.raises(exc) as got:
            TelemetryConfig(**bad)
        assert str(got.value) == str(want.value)
    for make, jmake in ((lambda: SketchConfig(hist_bins=1),
                         lambda: jt.SketchConfig(hist_bins=1)),
                        (lambda: SketchConfig(ewma_halflives=(0.0,)),
                         lambda: jt.SketchConfig(ewma_halflives=(0.0,))),
                        (lambda: AlertConfig(), lambda: jt.AlertConfig()),
                        (lambda: AlertRule(name="x", kind="nope"),
                         lambda: jt.AlertRule(name="x", kind="nope")),
                        (lambda: AlertConfig(rules=(AlertRule.slo_burn(),) * 2),
                         lambda: jt.AlertConfig(
                             rules=(jt.AlertRule.slo_burn(),) * 2))):
        with pytest.raises(ValueError) as want:
            jmake()
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="telemetry"):
        LagSimConfig(capacity=1.0, telemetry="yes").resolve(4)
    with pytest.raises(ValueError, match="unknown channel"):
        simulate_lag(_scenario()[0][0], policy="MBFP",
                     cfg=_obs(CFG, hist_channels=("nope",)), **CPU)
    rc = _obs(CFG).resolve(6)
    assert rc.telemetry.sketch.hist_max == _jobs(JCFG).resolve(
        6).telemetry.sketch.hist_max == 48.0


# ---------------------------------------------------------------------------
# event decoding
# ---------------------------------------------------------------------------
def _stream(direct_frames):
    speeds, active, ref = direct_frames
    res = simulate_lag(speeds[0], policy="MBFP", cfg=_tele(CFG),
                       active=active[0], **CPU)
    return EventStream.from_frame(res.telemetry)


def test_event_stream_equals_reference(direct_frames):
    """The decoded stream of a live run equals the reference's decoding of
    its own run: kinds, steps and indices exact, data within 1e-5."""
    stream = _stream(direct_frames)
    want = jt.EventStream.from_frame(direct_frames[2]["MBFP"].telemetry)
    _same_events([(e.kind, e.step, e.index, e.data) for e in stream.events],
                 [(e.kind, e.step, e.index, e.data) for e in want.events])
    assert stream.counts() == want.counts()
    assert {"scale", "migration", "lifecycle"} <= set(stream.counts())
    got, ref = json.loads(stream.to_json()), json.loads(want.to_json())
    assert (got["channels"], got["recorded_steps"], got["counts"]) == \
        (ref["channels"], ref["recorded_steps"], ref["counts"])
    assert [e.as_dict() for e in decode_events(stream.frame)] == \
        [e.as_dict() for e in stream.events]


def test_to_dataframe_degrades_without_pandas(direct_frames, monkeypatch):
    stream = _stream(direct_frames)
    real_import = builtins.__import__

    def no_pandas(name, *a, **kw):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    with pytest.raises(ImportError, match="to_dataframe needs pandas"):
        stream.to_dataframe()
    with pytest.raises(ImportError, match="optional dependency"):
        stream.events_dataframe()
    assert json.loads(stream.to_json())


def test_api_simulate_carries_frames():
    speeds, active = _scenario()
    out = api.simulate(speeds, policies=POLICIES, config=CFG, active=active,
                       telemetry=TelemetryConfig(), **CPU)
    ref = japi.simulate(speeds, policies=POLICIES, config=JCFG,
                        active=active, telemetry=jt.TelemetryConfig())
    assert len(out.telemetry) == speeds.shape[0]
    for got, want in zip(out.telemetry, ref.telemetry):
        _same_frame(got, want)
    assert EventStream.from_frame(out.telemetry[0]).counts() == \
        jt.EventStream.from_frame(ref.telemetry[0]).counts()


# ---------------------------------------------------------------------------
# custom counters end to end
# ---------------------------------------------------------------------------
def test_counter_state_flows_into_fleet_sketch():
    """A registered policy carrying ``CounterState`` gets its counters
    recorded as channels through the padded fleet: frame names, sketch
    aggregation, histograms; the padded steps stay invisible."""
    name = "TEST_COUNTED"

    @registry.register(name, family="reactive",
                       summary="test-only KEDA_LAG wrapper with counters")
    def _build(n, capacity, device):
        inner = registry.make_policy("KEDA_LAG", n, capacity, device=device)

        def init(n_partitions):
            return CounterState(counters=torch.zeros(2),
                                inner=inner.init(n_partitions),
                                names=("steps_seen", "scale_ups"))

        def step(speeds, lag, prev, state, active=None):
            assign, k, nxt = inner.step(speeds, lag, prev, state.inner,
                                        active)
            up = (nxt[0] > state.inner[0]).float()
            counters = state.counters + torch.stack(
                [torch.ones_like(up), up], -1)
            return assign, k, CounterState(counters=counters, inner=nxt,
                                           names=state.names)

        return init, step

    try:
        speeds, active = _scenario(t=20, n=5)
        cfg = dataclasses.replace(CFG, telemetry=TelemetryConfig(
            sketch=SketchConfig(hist_channels=("lag_total", "steps_seen"))))
        fleet = FleetRunner(FleetConfig(t_buckets=(32,), n_buckets=(8,)))
        res = fleet.simulate((name,), speeds, cfg, active=active, **CPU)
        assert res.telemetry[0].names[-2:] == ("steps_seen", "scale_ups")
        ((_, counted),) = res.sketch_summaries(0)
        assert counted.names[-2:] == ("steps_seen", "scale_ups")
        t = speeds.shape[1]
        i = counted.channel_index("steps_seen")
        assert counted.count == t
        assert float(counted.vmax[i]) == t and float(counted.vmin[i]) == 1.0
        assert float(counted.mean[i]) == pytest.approx((t + 1) / 2)
        assert counted.quantile(1.0, "steps_seen") == pytest.approx(
            t, abs=counted.edges[1] - counted.edges[0])
        direct = simulate_lag(speeds[0], policy=name, cfg=cfg,
                              active=active[0], **CPU)
        got = res.sketch[0]
        for fld in ("count", "hist", "vmin", "vmax"):
            np.testing.assert_array_equal(getattr(got, fld)[0],
                                          _np(getattr(direct.sketch, fld)))
        with pytest.raises(ValueError, match="identical telemetry channels"):
            sweep_lag((name, "KEDA_LAG"), speeds, cfg=dataclasses.replace(
                CFG, telemetry=TelemetryConfig()), active=active, **CPU)
    finally:
        # the registry keys a spec by (name, backend) and lists the name
        # in _ORDER: both go, or later tests still see the policy
        registry._REGISTRY.pop((name, "torch"), None)
        if name in registry._ORDER:
            registry._ORDER.remove(name)


# ---------------------------------------------------------------------------
# sketch numerics against full-frame numpy and the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sketched():
    speeds, active = _scenario(seed=0, batch=1, t=48, n=6)
    cfg = _obs(CFG, alerts=False)
    res = simulate_lag(speeds[0], policy="MBFP", cfg=cfg, active=active[0],
                       **CPU)
    want = j_simulate_lag(speeds[0], policy="MBFP",
                          cfg=_jobs(JCFG, alerts=False), active=active[0])
    scfg = cfg.resolve(6).telemetry.sketch
    return (SketchSummary.from_state(res.sketch, scfg),
            _np(res.telemetry.channels), scfg, res, want)


def test_sketch_state_equals_reference(sketched):
    _, _, _, res, want = sketched
    _same_sketch(res.sketch, want.sketch)


def test_sketch_moments_match_numpy(sketched):
    summary, frame, _, _, _ = sketched
    assert summary.count == frame.shape[0]
    assert np.allclose(summary.mean, frame.mean(axis=0), atol=1e-4)
    assert np.allclose(summary.variance(), frame.var(axis=0), atol=1e-3)
    assert np.allclose(summary.vmin, frame.min(axis=0), atol=1e-6)
    assert np.allclose(summary.vmax, frame.max(axis=0), atol=1e-6)


@pytest.mark.parametrize("q", (0.5, 0.9, 0.99))
def test_sketch_quantile_within_bin_width(sketched, q):
    summary, frame, scfg, _, want = sketched
    lag = frame[:, summary.channel_index("lag_total")]
    exact = float(np.quantile(lag, q, method="inverted_cdf"))
    got = summary.quantile(q, "lag_total")
    assert abs(got - exact) <= scfg.bin_width + 1e-6, (got, exact)
    ref = jt.SketchSummary.from_state(want.sketch, scfg)
    assert got == ref.quantile(q, "lag_total")


def test_ewma_matches_reference_loop(sketched):
    summary, frame, _, _, _ = sketched
    for h, got in summary.ewma.items():
        alpha = 1.0 - 2.0 ** (-1.0 / h)
        acc = np.zeros(frame.shape[1])
        w = 0.0
        for row in frame:
            acc = (1 - alpha) * acc + alpha * row
            w = (1 - alpha) * w + alpha
        assert np.allclose(got, acc / w, atol=1e-4), h


def test_sweep_stacks_sketch_and_for_policy_slices():
    speeds, active = _scenario()
    res = sweep_lag(POLICIES, speeds, cfg=_obs(CFG), active=active, **CPU)
    want = j_sweep_lag(POLICIES, speeds, cfg=_jobs(JCFG), active=active)
    p, b = len(POLICIES), speeds.shape[0]
    assert tuple(res.sketch.count.shape) == (p, b)
    assert tuple(res.incidents.count.shape[:2]) == (p, b)
    one = res.for_policy("KEDA_LAG")
    assert torch.equal(one.sketch.mean, res.sketch.mean[1])
    _same_sketch(res.sketch, want.sketch)
    _same_alerts(res.incidents, want.incidents)
    scfg = _obs(CFG).resolve(speeds.shape[2]).telemetry.sketch
    pairs = summaries_from_state(res.sketch, scfg)
    assert [idx for idx, _ in pairs] == \
        [(i, j) for i in range(p) for j in range(b)]


# ---------------------------------------------------------------------------
# fleet padding, merging, progress, fitness
# ---------------------------------------------------------------------------
def test_fleet_padded_sketch_and_alerts_match_direct():
    speeds, active = _scenario(t=20, n=5)
    cfg = _obs(CFG)
    fleet = FleetRunner(FleetConfig(t_buckets=(32,), n_buckets=(8,)))
    res = fleet.simulate(POLICIES, speeds, cfg, active=active, **CPU)
    ref = JFleetRunner(JFleetConfig(t_buckets=(32,), n_buckets=(8,))
                       ).simulate(POLICIES, jnp.asarray(speeds),
                                  _jobs(JCFG), active=jnp.asarray(active))
    rcfg = cfg.resolve(speeds.shape[2])
    for i in range(speeds.shape[0]):
        _same_sketch(res.sketch[i], ref.sketch[i], str(i))
        _same_alerts(res.incidents[i], ref.incidents[i], str(i))
        for pi, pol in enumerate(POLICIES):
            direct = simulate_lag(speeds[i], policy=pol, cfg=cfg,
                                  active=active[i], **CPU)
            got = res.sketch[i]
            for fld in SKETCH_I:
                np.testing.assert_array_equal(getattr(got, fld)[pi],
                                              _np(getattr(direct.sketch,
                                                          fld)))
            for fld in SKETCH_F:
                np.testing.assert_allclose(
                    getattr(got, fld)[pi], _np(getattr(direct.sketch, fld)),
                    **TOL)
            for fld in ALERT_I:
                np.testing.assert_array_equal(
                    getattr(res.incidents[i], fld)[pi],
                    _np(getattr(direct.incidents, fld)), fld)
            want = SketchSummary.from_state(direct.sketch,
                                            rcfg.telemetry.sketch)
            have = dict(res.sketch_summaries(i))[(pi,)]
            np.testing.assert_allclose(have.mean, want.mean, **TOL)
        _same_incidents(res.scenario_incidents(i),
                        ref.scenario_incidents(i))
    incs = res.scenario_incidents(0)
    assert incs and all(inc.index[0] in (0, 1) for inc in incs)


def test_fleet_raises_named_errors_when_off():
    speeds, active = _scenario(t=10, n=4)
    res = FleetRunner().simulate(("MBFP",), speeds, CFG, active=active,
                                 **CPU)
    with pytest.raises(ValueError, match="no sketches"):
        res.sketch_summaries(0)
    with pytest.raises(ValueError, match="no alerting"):
        res.scenario_incidents(0)


def test_merge_summaries_equals_whole():
    speeds, active = _scenario(batch=3, t=32, n=6)
    cfg = _obs(CFG, alerts=False)
    res = sweep_lag(("MBFP",), speeds, cfg=cfg, active=active, **CPU)
    scfg = cfg.resolve(speeds.shape[2]).telemetry.sketch
    parts = [s for _, s in summaries_from_state(res.sketch, scfg)]
    merged = merge_summaries(parts)
    frames = _np(res.telemetry.channels)[0]
    allsteps = frames.reshape(-1, frames.shape[-1])
    assert merged.count == allsteps.shape[0]
    assert np.allclose(merged.mean, allsteps.mean(axis=0), atol=1e-4)
    assert np.allclose(merged.variance(), allsteps.var(axis=0), atol=1e-3)
    assert np.allclose(merged.vmin, allsteps.min(axis=0))
    assert np.allclose(merged.vmax, allsteps.max(axis=0))
    assert np.allclose(merged.hist.sum(axis=1),
                       [allsteps.shape[0]] * len(merged.hist_names))
    # the reference's merge of the same summaries, field for field
    ref = jt.merge_summaries([jt.SketchSummary(**dataclasses.asdict(s))
                              for s in parts])
    for f in ("count", "mean", "m2", "vmin", "vmax", "hist"):
        np.testing.assert_array_equal(getattr(merged, f), getattr(ref, f))
    with pytest.raises(ValueError, match="at least one summary"):
        merge_summaries([])


def test_fleet_progress_callback_streams_snapshots():
    speeds_a, active_a = _scenario(seed=0, batch=2, t=20, n=5)
    speeds_b, active_b = _scenario(seed=1, batch=1, t=40, n=5)
    scen = [(speeds_a[i], active_a[i]) for i in range(2)]
    scen.append((speeds_b[0], active_b[0]))
    fleet = FleetRunner(FleetConfig(t_buckets=(32, 64), n_buckets=(8,)))
    snaps = []
    fleet.simulate(POLICIES, scen, _obs(CFG), progress=snaps.append, **CPU)
    ref = []
    JFleetRunner(JFleetConfig(t_buckets=(32, 64), n_buckets=(8,))).simulate(
        POLICIES, [(jnp.asarray(s), jnp.asarray(a)) for s, a in scen],
        _jobs(JCFG), progress=ref.append)
    assert len(snaps) == len(ref) >= 2
    assert [s.done for s in snaps] == [s.done for s in ref]
    last = snaps[-1]
    assert isinstance(last, FleetProgress)
    assert last.done == last.total == len(scen)
    assert last.sketch is not None and last.sketch.count > 0
    for got, want in zip(snaps, ref):
        assert got.incidents == want.incidents
        assert got.sketch.count == want.sketch.count
        np.testing.assert_allclose(got.sketch.mean, want.sketch.mean, **TOL)
    assert set(last.incidents) == set(r.name for r in default_rules())


@pytest.mark.parametrize("weight", (0.0, 2.5))
def test_fitness_with_incident_weight(weight):
    speeds, active = _scenario(seed=4, batch=3, t=24, n=6)
    got = FleetRunner().fitness(POLICIES, speeds, _obs(CFG, frames=False),
                                active=active, incident_weight=weight,
                                **CPU)
    want = JFleetRunner().fitness(POLICIES, jnp.asarray(speeds),
                                  _jobs(JCFG, frames=False),
                                  active=jnp.asarray(active),
                                  incident_weight=weight)
    np.testing.assert_array_equal(got.incidents, want.incidents)
    np.testing.assert_allclose(got.fitness, want.fitness, **TOL)
    np.testing.assert_allclose(got.violation_frac, want.violation_frac,
                               **TOL)
    assert got.fitness.dtype == np.float32
    with pytest.raises(ValueError, match="incident_weight > 0 needs"):
        FleetRunner().fitness(POLICIES, speeds, CFG, active=active,
                              incident_weight=1.0, **CPU)


# ---------------------------------------------------------------------------
# alert semantics: open/close steps, durations, overflow, gating
# ---------------------------------------------------------------------------
def _quiet(**kw):
    sig = dict(lag_total=0.0, consumers=1.0, unreadable=0.0,
               storm_parts=0.0)
    sig.update(kw)
    return sig


def _drive(cfg, jcfg, signals):
    """``alert_step`` over ``signals`` in both packages; the port's final
    state, held equal to the reference's."""
    state, jstate = alert_init(cfg), jt.alert_init(jcfg)
    for sig in signals:
        state = alert_step(cfg, state, slo_lag=1.0, **sig)
        jstate = jt.alert_step(jcfg, jstate, slo_lag=1.0, **sig)
    _same_alerts(state, jstate)
    return state


def test_storm_incident_open_close_steps():
    cfg = AlertConfig(rules=(AlertRule.rebalance_storm(storm_steps=3),))
    jcfg = jt.AlertConfig(rules=(jt.AlertRule.rebalance_storm(
        storm_steps=3),))
    sigs = [_quiet()] * 2 + [_quiet(unreadable=2.0)] * 5 + [_quiet()] * 2
    (inc,) = decode_incidents(_drive(cfg, jcfg, sigs), cfg, dt=2.0)
    assert inc.kind == "rebalance_storm" and not inc.still_open
    assert (inc.open_step, inc.close_step) == (4, 6)
    assert inc.duration_s == 6.0 and inc.peak == 5.0


def test_still_open_incident_closes_at_last_step():
    cfg = AlertConfig(rules=(AlertRule.rebalance_storm(storm_steps=2),))
    jcfg = jt.AlertConfig(rules=(jt.AlertRule.rebalance_storm(
        storm_steps=2),))
    (inc,) = decode_incidents(
        _drive(cfg, jcfg, [_quiet(unreadable=1.0)] * 4), cfg)
    assert inc.still_open and (inc.open_step, inc.close_step) == (1, 3)
    assert inc.duration_s == 3.0


def test_incident_table_overflow_counts_without_rows():
    cfg = AlertConfig(rules=(AlertRule.rebalance_storm(storm_steps=1),),
                      max_incidents=1)
    jcfg = jt.AlertConfig(rules=(jt.AlertRule.rebalance_storm(
        storm_steps=1),), max_incidents=1)
    state = _drive(cfg, jcfg, [_quiet(unreadable=1.0), _quiet()] * 3)
    assert incident_counts(state) == {"rebalance_storm": 3}
    decoded = decode_incidents(state, cfg)
    assert len(decoded) == 1 and decoded[0].open_step == 0
    summ = incident_summary(state, cfg)["rebalance_storm"]
    assert summ["count"] == 3.0 and summ["open"] == 0.0


def test_slo_burn_needs_both_windows():
    kw = dict(slo_target=0.9, burn_threshold=3.0, fast_halflife=2.0,
              slow_halflife=64.0)
    cfg = AlertConfig(rules=(AlertRule.slo_burn(**kw),))
    jcfg = jt.AlertConfig(rules=(jt.AlertRule.slo_burn(**kw),))
    healthy = [_quiet()] * 40
    spike = healthy + [_quiet(lag_total=5.0)] * 3 + [_quiet()] * 10
    assert incident_counts(_drive(cfg, jcfg, spike)) == {"slo_burn": 0}
    sustained = healthy + [_quiet(lag_total=5.0)] * 30
    assert incident_counts(_drive(cfg, jcfg, sustained)) == {"slo_burn": 1}


def test_lag_growth_and_thrash_rules():
    cfg = AlertConfig(rules=(AlertRule.lag_growth(sustain_steps=3),
                             AlertRule.consumer_thrash(thrash_rate=0.2)))
    jcfg = jt.AlertConfig(rules=(jt.AlertRule.lag_growth(sustain_steps=3),
                                 jt.AlertRule.consumer_thrash(
                                     thrash_rate=0.2)))
    sigs = ([_quiet(lag_total=float(i)) for i in range(10)]
            + [_quiet(lag_total=1.0)] * 20
            + [_quiet(consumers=float(1 + i % 2)) for i in range(12)]
            + [_quiet()] * 30)
    state = _drive(cfg, jcfg, sigs)
    assert incident_counts(state) == {"lag_growth": 1,
                                      "consumer_thrash": 1}


def test_valid_false_freezes_sketch_and_alert_state():
    cfg = AlertConfig(rules=default_rules())
    st1 = alert_step(cfg, alert_init(cfg), slo_lag=1.0,
                     **_quiet(lag_total=9.0))
    frozen = alert_step(cfg, st1, slo_lag=1.0, valid=torch.tensor(False),
                        **_quiet(lag_total=99.0))
    for fld in ("tick", "fast", "prev_lag", "count"):
        assert torch.equal(getattr(frozen, fld), getattr(st1, fld)), fld
    # a batch of rows: only the valid ones move
    scfg = SketchConfig(hist_max=10.0)
    sk = sketch_init(scfg, ("a", "lag_total"), batch=(3,))
    vec = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    sk1 = sketch_update(scfg, sk, vec, valid=torch.tensor([True, False,
                                                           True]))
    assert sk1.count.tolist() == [1.0, 0.0, 1.0]
    assert torch.equal(sk1.hist[1], sk.hist[1])
    assert torch.equal(sk1.mean[1], sk.mean[1])


def test_states_resume_from_reference_mid_trace(direct_frames):
    """A reference sketch and alert state, carried over mid-trace by
    ``convert``, resume in the port: the next steps' updates equal the
    reference's."""
    speeds, active, ref = direct_frames
    jcfg = _jobs(JCFG).resolve(6).telemetry
    cfg = _obs(CFG).resolve(6).telemetry
    frame = np.asarray(ref["KEDA_LAG"].telemetry.channels)       # [T, K]
    names = ref["KEDA_LAG"].telemetry.names
    jsk, jal = jt.sketch_init(jcfg.sketch, names), jt.alert_init(jcfg.alerts)
    col = names.index
    for t in range(frame.shape[0]):
        if t == 10:
            sk = sketch_state_from_numpy(
                jax.tree_util.tree_map(np.asarray, jsk), **CPU)
            al = alert_state_from_numpy(
                jax.tree_util.tree_map(np.asarray, jal), **CPU)
        sig = dict(lag_total=frame[t, col("lag_total")],
                   consumers=frame[t, col("consumers")],
                   unreadable=frame[t, col("unreadable")],
                   storm_parts=frame[t, col("storm_parts")])
        jsk = jt.sketch_update(jcfg.sketch, jsk, jnp.asarray(frame[t]))
        jal = jt.alert_step(jcfg.alerts, jal, slo_lag=1.0, **sig)
        if t >= 10:
            sk = sketch_update(cfg.sketch, sk, torch.tensor(frame[t]))
            al = alert_step(cfg.alerts, al, slo_lag=1.0, **{
                k: torch.tensor(v) for k, v in sig.items()})
            _same_sketch(sk, jsk, str(t))
            _same_alerts(al, jal, str(t))


# ---------------------------------------------------------------------------
# export: Prometheus + OTLP
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def exported():
    speeds, active = _scenario(batch=1, t=32, n=6)
    cfg = _obs(CFG, frames=False)
    res = simulate_lag(speeds[0], policy="KEDA_LAG", cfg=cfg,
                       active=active[0], **CPU)
    want = j_simulate_lag(speeds[0], policy="KEDA_LAG",
                          cfg=_jobs(JCFG, frames=False), active=active[0])
    scfg = cfg.resolve(6).telemetry.sketch
    summary = SketchSummary.from_state(res.sketch, scfg)
    incidents = decode_incidents(res.incidents, cfg.telemetry.alerts)
    ref_summary = jt.SketchSummary.from_state(want.sketch, scfg)
    ref_incidents = jt.decode_incidents(want.incidents,
                                        _jobs(JCFG).telemetry.alerts)
    return summary, incidents, ref_summary, ref_incidents


SPANS = {"api.simulate": {"count": 2, "total_us": 10.0, "steady_us": 4.0}}


def test_prometheus_exposition_lints_clean_and_equals_reference(exported):
    summary, incidents, ref_summary, ref_incidents = exported
    text = prometheus_exposition(sketch=summary, incidents=incidents,
                                 spans=SPANS, labels={"run": "test"})
    validate_exposition(text)
    assert 'repro_sketch_mean{channel="lag_total",run="test"}' in text
    assert "# TYPE repro_sketch_lag_total histogram" in text
    assert "repro_incidents_total{" in text
    # the same inputs render the same text in both packages
    assert text == jt.prometheus_exposition(
        sketch=summary, incidents=incidents, spans=SPANS,
        labels={"run": "test"})
    # and the port's run renders the reference run's histogram, incident
    # and span lines (the float gauges agree within 1e-5)
    ref_text = jt.prometheus_exposition(sketch=ref_summary,
                                        incidents=ref_incidents, spans=SPANS,
                                        labels={"run": "test"})
    pick = lambda s: [ln for ln in s.splitlines()  # noqa: E731
                      if "_bucket" in ln or "incidents" in ln
                      or "span" in ln or ln.startswith("#")]
    assert pick(text) == pick(ref_text)
    with pytest.raises(ValueError, match="label"):
        prometheus_exposition(sketch=summary, labels={"bad-name": "x"})
    for bad in ("untyped_metric 1\n", "# TYPE 9bad counter\n",
                "# TYPE m gauge\nm abc\n",
                '# TYPE h histogram\nh_bucket{le="+Inf"} 5\nh_count 7\n'):
        with pytest.raises(ValueError) as want:
            jt.validate_exposition(bad)
        with pytest.raises(ValueError) as got:
            validate_exposition(bad)
        assert str(got.value) == str(want.value)


def test_otlp_metrics_json_equals_reference(exported):
    summary, incidents, ref_summary, ref_incidents = exported
    a = otlp_metrics_json(sketch=summary, incidents=incidents)
    assert a == otlp_metrics_json(sketch=summary, incidents=incidents)
    assert a == jt.otlp_metrics_json(sketch=summary, incidents=incidents)
    metrics = a["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]
    by_name = {m["name"]: m for m in metrics}
    hist = by_name["repro.sketch.hist.lag_total"]["histogram"][
        "dataPoints"][0]
    ref = jt.otlp_metrics_json(sketch=ref_summary, incidents=ref_incidents)
    ref_by = {m["name"]: m for m in
              ref["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
    assert hist["bucketCounts"] == ref_by["repro.sketch.hist.lag_total"][
        "histogram"]["dataPoints"][0]["bucketCounts"]
    assert by_name["repro.incidents.count"] == ref_by["repro.incidents.count"]
    assert json.dumps(a)


def test_api_simulate_surfaces_sketches_and_incidents():
    speeds, active = _scenario()
    tele = TelemetryConfig(record_frames=False, sketch=SketchConfig(),
                           alerts=AlertConfig(rules=default_rules()))
    out = api.simulate(speeds, policies=POLICIES, config=CFG, active=active,
                       telemetry=tele, **CPU)
    ref = japi.simulate(speeds, policies=POLICIES,
                        config=JCFG,
                        active=active, telemetry=jt.TelemetryConfig(
                            record_frames=False, sketch=jt.SketchConfig(),
                            alerts=jt.AlertConfig(
                                rules=jt.default_rules())))
    assert out.telemetry is None
    assert len(out.sketches) == speeds.shape[0]
    assert len(out.sketches[0]) == len(POLICIES)
    merged = merge_summaries([s for per in out.sketches for s in per])
    assert merged.count == len(POLICIES) * speeds.shape[0] * speeds.shape[1]
    for got, want in zip(out.sketches, ref.sketches):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.hist, w.hist)
            np.testing.assert_allclose(g.mean, w.mean, **TOL)
    for got, want in zip(out.incidents, ref.incidents):
        _same_incidents(got, want)
    incs = [i for per in out.incidents for i in per]
    assert incs and all(i.index[0] < len(POLICIES) for i in incs)
    validate_exposition(prometheus_exposition(sketch=merged, incidents=incs))
    plain = api.simulate(speeds[:1], policies=("MBFP",), config=CFG,
                         active=active[:1], **CPU)
    assert plain.sketches is None and plain.incidents is None


def test_device_split_joins_frames_sketches_and_alerts():
    """``devices=("cpu", "cpu")`` splits each padded batch (3 scenarios,
    padded with a dummy row to 4) in two: the joined frames, sketch and
    alert states equal one device's run exactly."""
    speeds, active = _scenario(batch=3, t=20, n=5)
    scen = [(speeds[i], active[i]) for i in range(3)]
    cfg = _obs(CFG)
    kw = dict(t_buckets=(24,), n_buckets=(8,))
    one = FleetRunner(FleetConfig(**kw)).simulate(POLICIES, scen, cfg, **CPU)
    two = FleetRunner(FleetConfig(devices=("cpu", "cpu"), **kw)).simulate(
        POLICIES, scen, cfg)
    for i in range(3):
        assert np.array_equal(one.telemetry[i].channels,
                              two.telemetry[i].channels)
        for f in SKETCH_I + SKETCH_F:
            assert np.array_equal(getattr(one.sketch[i], f),
                                  getattr(two.sketch[i], f)), f
        for f in ALERT_I + ALERT_F:
            assert np.array_equal(getattr(one.incidents[i], f),
                                  getattr(two.incidents[i], f)), f

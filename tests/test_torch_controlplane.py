"""The port's control plane against ``repro.lagsim.controlplane``, case for
case as ``tests/test_controlplane.py`` (its golden fixtures left out: the
port is held against live reference runs on the same numpy inputs).

Tolerances: integers (assignments, consumers, migrations, unreadable and
storm counts, the control plane's state) exact; lag within ``atol = rtol
= 1e-5``.  Within the port, zero friction equals the bare engine bit for
bit, and a padded fleet run equals the direct one (integers exact).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core.scenarios import generate_masked_scenario  # noqa: E402
from repro.fleet import FleetConfig as JFleetConfig  # noqa: E402
from repro.fleet import FleetRunner as JFleetRunner  # noqa: E402
from repro.lagsim import ControlPlaneConfig as JCP  # noqa: E402
from repro.lagsim import LagSimConfig as JConfig  # noqa: E402
from repro.lagsim import simulate_lag as j_simulate_lag  # noqa: E402
from repro.lagsim import sweep_lag as j_sweep_lag  # noqa: E402
from repro.lagsim import wrap_policy as j_wrap_policy  # noqa: E402
from repro.lagsim.controlplane import _fold_to_max as j_fold  # noqa: E402
from repro.lagsim.fused import FusedPathError as JFusedPathError  # noqa: E402
from repro.lagsim.fused import fused_mode as j_fused_mode  # noqa: E402
import repro.registry as jreg  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import controlplane_state_from_numpy  # noqa: E402
from repro_torch.fleet import FleetConfig, FleetRunner  # noqa: E402
from repro_torch.lagsim import (ControlPlaneConfig, ControlPlaneState,  # noqa: E402
                                FusedPathError, LagSimConfig, fused_mode,
                                simulate_lag, sweep_lag, wrap_policy)
from repro_torch.lagsim.controlplane import _fold_to_max  # noqa: E402
import repro_torch.registry as treg  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = dict(device="cpu")
CFG = LagSimConfig(capacity=1.0, dt=1.0, migration_steps=2)
JCFG = JConfig(capacity=1.0, dt=1.0, migration_steps=2)
ZF, JZF = ControlPlaneConfig(), JCP()
FIELDS = ("lag_total", "lag_max", "consumers", "migrations", "unreadable")
PACKERS = japi.list_policies(family=japi.PACKER_FAMILIES, backend="jax")
ZF_POLICIES = PACKERS + ("KEDA_LAG", "RATE_THRESHOLD")
KNOBS = dict(polling_interval=2, observation_delay=2, actuation_delay=1,
             cooldown_period=4, min_replicas=2, max_replicas=3,
             warmup_steps=2)


def _with_cp(cfg, cp):
    return dataclasses.replace(cfg, control_plane=cp)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(got, want, ctx, exact_lag=False):
    """Port trace (or sweep) against a reference one."""
    for f in FIELDS:
        g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
        if f.startswith("lag") and not exact_lag:
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"{ctx}: {f}")
        else:
            np.testing.assert_array_equal(g, w, f"{ctx}: {f}")


def _bits(a, b, ctx):
    for f in FIELDS:
        assert _np(getattr(a, f)).tobytes() == _np(getattr(b, f)).tobytes(), \
            (ctx, f)


@functools.lru_cache(maxsize=None)
def _lifecycle(seed=0, b=2, t=24, n=6):
    sp, act = generate_masked_scenario("topic_lifecycle",
                                       jax.random.key(seed), b, t, n)
    return np.asarray(sp), np.asarray(act)


def _trace(seed, t=40, n=6, scale=1.2):
    return np.random.default_rng(seed).uniform(0, scale, (t, n)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# named errors for inconsistent knobs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    {"polling_interval": 0}, {"observation_delay": -1},
    {"actuation_delay": -2}, {"cooldown_period": -1},
    {"polling_interval": 4, "cooldown_period": 2}, {"warmup_steps": -1},
    {"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
    {"polling_interval": 1.5}, {"min_replicas": True},
])
def test_named_config_errors(kwargs):
    with pytest.raises(ValueError) as want:
        JCP(**kwargs)
    with pytest.raises(ValueError) as got:
        ControlPlaneConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_cooldown_zero_and_equal_to_polling_are_legal():
    for cp in (ControlPlaneConfig(polling_interval=4, cooldown_period=0),
               ControlPlaneConfig(polling_interval=4, cooldown_period=4)):
        assert hash(cp) == hash(dataclasses.replace(cp))   # a cache key
    assert ZF.is_zero_friction and not ControlPlaneConfig(
        warmup_steps=1).is_zero_friction
    assert ControlPlaneConfig(**KNOBS).knobs() == JCP(**KNOBS).knobs()


def test_engine_rejects_non_config_control_plane():
    with pytest.raises(ValueError, match="must be a ControlPlaneConfig"):
        LagSimConfig(control_plane={"polling_interval": 2}).resolve(4)
    with pytest.raises(ValueError, match="must be a ControlPlaneConfig"):
        wrap_policy(lambda n: 0, lambda *a: a, {"polling_interval": 2})


def test_api_simulate_raises_named_errors():
    tr = np.full((1, 6, 4), 0.5, np.float32)
    with pytest.raises(ValueError, match="cooldown_period=2 < polling"):
        api.simulate(tr, policies=("BFD",), control_plane={
            "polling_interval": 4, "cooldown_period": 2}, **CPU)
    with pytest.raises(ValueError, match="warmup_steps=-1"):
        api.simulate(tr, policies=("BFD",),
                     control_plane={"warmup_steps": -1}, **CPU)
    with pytest.raises(ValueError, match="must be a ControlPlaneConfig"):
        api.simulate(tr, policies=("BFD",), control_plane=3, **CPU)


# ---------------------------------------------------------------------------
# zero friction is the identity
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def zero_friction():
    """The reference's zero-friction sweep of the 12 packers and both
    idealized scalers over one masked lifecycle batch."""
    sp, act = _lifecycle(seed=3, b=2, t=20, n=5)
    return sp, act, j_sweep_lag(ZF_POLICIES, sp, _with_cp(JCFG, JZF),
                                active=act)


@pytest.mark.parametrize("policy", ZF_POLICIES)
def test_zero_friction_equals_bare_engine(zero_friction, policy):
    sp, act, want = zero_friction
    bare = sweep_lag((policy,), sp, CFG, active=act, **CPU)
    wrapped = sweep_lag((policy,), sp, _with_cp(CFG, ZF), active=act, **CPU)
    _bits(bare, wrapped, policy)
    _same(wrapped.for_policy(policy), want.for_policy(policy), policy)


@pytest.fixture(scope="module")
def real_zero_friction(zero_friction):
    sp, act, _ = zero_friction
    pols = ("KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG")
    return j_sweep_lag(pols, sp, _with_cp(JCFG, JZF), active=act)


@pytest.mark.parametrize("policy", ("KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG"))
def test_zero_friction_real_equals_plain_keda(zero_friction,
                                              real_zero_friction, policy):
    """A REAL scaler with zero-friction knobs is its idealized trigger:
    KEDA_LAG_REAL equals KEDA_LAG bit for bit; both, and Cloud Run's
    CPU+lag trigger, equal the reference's live runs."""
    sp, act, want = zero_friction
    real = sweep_lag((policy,), sp, _with_cp(CFG, ZF), active=act, **CPU)
    _same(real.for_policy(policy), real_zero_friction.for_policy(policy),
          policy)
    if policy == "KEDA_LAG_REAL":
        keda = sweep_lag(("KEDA_LAG",), sp, CFG, active=act, **CPU)
        for f in FIELDS:
            assert _np(getattr(real, f)).tobytes() == \
                _np(getattr(keda, f)).tobytes(), f


def test_zero_friction_under_fleet_bucketing():
    rng = np.random.default_rng(11)
    scen = [rng.uniform(0, 1.1, s).astype(np.float32)
            for s in ((14, 4), (20, 8), (9, 6))]
    pols = ("BFD", "KEDA_LAG", "KEDA_LAG_REAL")
    runner = FleetRunner(FleetConfig(t_buckets=(20,), n_buckets=(8,)))
    plain = runner.simulate(pols, scen, CFG, **CPU)
    wrapped = runner.simulate(pols, scen, _with_cp(CFG, ZF), **CPU)
    ref = JFleetRunner(JFleetConfig(t_buckets=(20,), n_buckets=(8,))
                       ).simulate(pols, [jnp.asarray(s) for s in scen],
                                  _with_cp(JCFG, JZF))
    for i in range(len(scen)):
        for p in (0, 1):
            for f in ("lag_total", "consumers", "migrations"):
                np.testing.assert_array_equal(getattr(plain, f)[i][p],
                                              getattr(wrapped, f)[i][p])
        np.testing.assert_array_equal(wrapped.consumers[i][2],
                                      wrapped.consumers[i][1])
        np.testing.assert_array_equal(wrapped.lag_total[i][2],
                                      wrapped.lag_total[i][1])
        for f in FIELDS:
            g, w = getattr(wrapped, f)[i], np.asarray(getattr(ref, f)[i])
            if f.startswith("lag"):
                np.testing.assert_allclose(g, w, **TOL)
            else:
                np.testing.assert_array_equal(g, w, f)


# ---------------------------------------------------------------------------
# properties: cooldown / clamping / staleness / warm-up locality
# ---------------------------------------------------------------------------
def _apply_steps(assigns, consumers):
    """Steps at which a scale decision *applied* (output changed)."""
    events = []
    prev_a = np.full(assigns.shape[1], -1, assigns.dtype)
    prev_n = 0
    for t in range(assigns.shape[0]):
        if consumers[t] != prev_n or not np.array_equal(assigns[t], prev_a):
            events.append(t)
        prev_a, prev_n = assigns[t], consumers[t]
    return events


def _run(trace, policy, cfg):
    """The port's run and the reference's on one trace: (trace, assigns)
    each, held equal."""
    got, ga = simulate_lag(trace, policy=policy, cfg=cfg,
                           record_assign=True, **CPU)
    jcfg = JConfig(**{**dataclasses.asdict(cfg), "control_plane": JCP(
        **dataclasses.asdict(cfg.control_plane))})
    want, wa = j_simulate_lag(jnp.asarray(trace), policy=policy, cfg=jcfg,
                              record_assign=True)
    _same(got, want, policy)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    return got, ga.numpy()


def _check_cooldown(seed, polling, cooldown, delay):
    cp = ControlPlaneConfig(polling_interval=polling,
                            cooldown_period=cooldown,
                            observation_delay=delay, actuation_delay=delay)
    res, assigns = _run(_trace(seed), "KEDA_LAG", _with_cp(CFG, cp))
    events = _apply_steps(assigns, res.consumers.numpy())
    assert (np.diff(events) >= max(cooldown, 1)).all(), (events, cp)
    for t in events:
        assert (t - delay) % polling == 0, (t, cp)


def _check_clamp(seed, lo, hi):
    cp = ControlPlaneConfig(min_replicas=lo, max_replicas=hi,
                            polling_interval=2, cooldown_period=2,
                            warmup_steps=1)
    trace = _trace(seed, scale=2.0)
    for pol in ("KEDA_LAG", "BFD"):
        res, a = _run(trace, pol, _with_cp(CFG, cp))
        cons = res.consumers.numpy()
        assert cons.min() >= lo and cons.max() <= hi, (pol, cons)
        for t in range(a.shape[0]):
            assert len(set(a[t][a[t] >= 0])) <= hi, (pol, t, a[t])


def _check_staleness(seed, delay):
    cfgz = _with_cp(dataclasses.replace(CFG, lag_threshold=3.0),
                    ControlPlaneConfig(observation_delay=delay))
    t0 = 12
    tr1 = _trace(seed)
    tr2 = tr1.copy()
    tr2[t0:] = tr2[t0:] * 5.0 + 1.0     # violently different future
    _, a1 = _run(tr1, "KEDA_LAG", cfgz)
    _, a2 = _run(tr2, "KEDA_LAG", cfgz)
    np.testing.assert_array_equal(a1[:t0 + delay], a2[:t0 + delay])
    assert not np.array_equal(a1, a2)


@pytest.mark.parametrize("seed", (0, 1))
def test_control_plane_properties_fixed_instances(seed):
    _check_cooldown(seed, polling=3, cooldown=6, delay=1)
    _check_cooldown(seed + 10, polling=1, cooldown=0, delay=0)
    _check_clamp(seed, lo=2, hi=4)
    _check_staleness(seed, delay=2)
    _check_staleness(seed + 10, delay=0)


@pytest.mark.parametrize("k", (1, 2, 3, 5, 40))
def test_fold_to_max_against_reference(k):
    """Below the used count the fold merges ranks ``r >= k`` onto ``r %
    k``; at or above it, it is the identity.  Rows with duplicate ids and
    unassigned partitions, batched, equal the reference's row by row."""
    rng = np.random.default_rng(k)
    n = 7
    m = 2 * n + 2
    assign = rng.integers(-1, m, (16, n)).astype(np.int32)
    assign[0] = [3, 3, 3, -1, 3, 3, -1]          # one consumer used
    n_bins = rng.integers(1, m, 16).astype(np.int32)
    got, got_n = _fold_to_max(torch.tensor(assign, dtype=torch.long),
                              torch.tensor(n_bins, dtype=torch.long),
                              k=k, m=m)
    for r in range(16):
        want, want_n = j_fold(jnp.asarray(assign[r]), jnp.int32(n_bins[r]),
                              k=k, m=m)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
        assert int(got_n[r]) == int(want_n)
        used = len(set(assign[r][assign[r] >= 0]))
        if used <= k:
            np.testing.assert_array_equal(got[r].numpy(), assign[r])
        else:
            assert len(set(got[r].numpy()[assign[r] >= 0])) == k


def test_warmup_touches_only_scaled_consumers():
    """The wrapper driven directly by a scripted inner policy, the port's
    batched over two rows: the storm hits exactly the consumers whose
    partition set the applied decision changed, as in the reference."""
    plan = {0: ([0, 0, 1, 1], 2), 3: ([0, 0, 1, 2], 3)}

    def later(tick):
        return plan[[k for k in sorted(plan) if int(tick) >= k][-1]]

    def j_inner(speeds, lag, prev, tick, active=None):
        a, k = later(tick)
        return jnp.asarray(a, jnp.int32), jnp.int32(k), tick + 1

    def inner(speeds, lag, prev, tick, active=None):
        a, k = later(tick)
        rows = speeds.shape[0]
        return (torch.tensor(a).expand(rows, 4), torch.full((rows,), k),
                tick + 1)

    j_init, j_step = j_wrap_policy(lambda n: jnp.int32(0), j_inner,
                                   JCP(warmup_steps=4))
    init, step = wrap_policy(lambda n: 0, inner,
                             ControlPlaneConfig(warmup_steps=4))
    n = 4
    state, j_state = init(n), j_init(n)
    assert isinstance(state, ControlPlaneState)
    prev = torch.full((2, n), -1)
    j_prev = jnp.full((n,), -1, jnp.int32)
    seen = []
    for _ in range(6):
        prev, k, state = step(torch.full((2, n), 0.5), torch.zeros(2, n),
                              prev, state)
        j_prev, _, j_state = j_step(jnp.full((n,), 0.5), jnp.zeros(n),
                                    j_prev, j_state)
        np.testing.assert_array_equal(state.warming[0].numpy(),
                                      np.asarray(j_state.warming))
        np.testing.assert_array_equal(state.warming[1].numpy(),
                                      np.asarray(j_state.warming))
        seen.append(state.warming[0].tolist())
    assert seen[0] == [4, 4, 4, 4]
    assert seen[3] == [1, 1, 4, 4]
    assert seen[4] == [0, 0, 3, 3]


# ---------------------------------------------------------------------------
# the REAL scalers over a masked lifecycle stream (direct + fleet path)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lifecycle_real():
    sp, act = _lifecycle(seed=0, b=1, t=24, n=6)
    out = {}
    for pol in ("KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG"):
        out[pol] = j_simulate_lag(jnp.asarray(sp[0]), policy=pol, cfg=JCFG,
                                  active=jnp.asarray(act[0]),
                                  record_assign=True)
    return sp, act, out


@pytest.mark.parametrize("policy", ("KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG"))
def test_real_scalers_topic_lifecycle(lifecycle_real, policy):
    """The registry's own friction (no cfg.control_plane) over a masked
    topic_lifecycle stream: assignments and every trajectory equal the
    reference's, SLO metrics within 1e-5; the storm costs downtime with
    no migration (downtime the migration model cannot explain)."""
    from repro.lagsim import slo_summary as j_slo
    from repro_torch.lagsim import slo_summary

    sp, act, ref = lifecycle_real
    want, wa = ref[policy]
    got, ga = simulate_lag(sp[0], policy=policy, cfg=CFG, active=act[0],
                           record_assign=True, **CPU)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    _same(got, want, policy)
    storm = (got.unreadable.numpy() > 0) & (got.migrations.numpy() == 0)
    assert storm.any()
    ours = slo_summary(got.lag_total.numpy(), got.consumers.numpy(),
                       got.migrations.numpy(), slo_lag=1.0, dt=1.0)
    theirs = j_slo(np.asarray(want.lag_total), np.asarray(want.consumers),
                   np.asarray(want.migrations), slo_lag=1.0, dt=1.0)
    for k in theirs:
        np.testing.assert_allclose(ours[k], np.asarray(theirs[k]), **TOL)


def test_real_scaler_survives_fleet_padding(lifecycle_real):
    sp, act, ref = lifecycle_real
    want, _ = ref["KEDA_LAG_REAL"]
    runner = FleetRunner(FleetConfig(t_buckets=(32,), n_buckets=(8,)))
    res = runner.simulate(("KEDA_LAG_REAL",), [(sp[0], act[0])], CFG, **CPU)
    np.testing.assert_allclose(res.lag_total[0][0],
                               np.asarray(want.lag_total), **TOL)
    for f in ("consumers", "migrations", "unreadable"):
        np.testing.assert_array_equal(getattr(res, f)[0][0],
                                      np.asarray(getattr(want, f)), f)


# ---------------------------------------------------------------------------
# api / sweep threading
# ---------------------------------------------------------------------------
def test_api_simulate_threads_control_plane():
    tr = np.asarray(jax.random.uniform(jax.random.key(2), (2, 12, 5),
                                       maxval=0.8))
    knobs = {"polling_interval": 2, "cooldown_period": 4, "warmup_steps": 1}
    pols = ("BFD", "KEDA_LAG_REAL")
    via_map = api.simulate(tr, policies=pols, control_plane=knobs, **CPU)
    via_cfg = api.simulate(tr, policies=pols,
                           control_plane=ControlPlaneConfig(**knobs), **CPU)
    assert via_map.schema_version == api.API_VERSION
    np.testing.assert_array_equal(via_map.lag_total, via_cfg.lag_total)
    np.testing.assert_array_equal(via_map.consumers, via_cfg.consumers)
    plain = api.simulate(tr, policies=pols, **CPU)
    assert not np.array_equal(via_map.consumers, plain.consumers)
    ref = japi.simulate(tr, policies=pols, control_plane=knobs)
    np.testing.assert_array_equal(via_map.consumers, ref.consumers)
    np.testing.assert_array_equal(via_map.migrations, ref.migrations)
    np.testing.assert_allclose(via_map.lag_total, ref.lag_total, **TOL)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(via_map.metrics[k], v, **TOL)


def test_api_exports_control_plane_config():
    assert api.ControlPlaneConfig is ControlPlaneConfig
    assert "ControlPlaneConfig" in api.__all__


def test_sweep_lag_accepts_control_plane():
    sp, act = _lifecycle(seed=5, b=3, t=16, n=4)
    cp = ControlPlaneConfig(**KNOBS)
    pols = ("KEDA_LAG", "CLOUD_RUN_CPU_LAG", "MBF")
    got = sweep_lag(pols, sp, _with_cp(CFG, cp), active=act, **CPU)
    want = j_sweep_lag(pols, sp, _with_cp(JCFG, JCP(**KNOBS)), active=act)
    assert got.lag_total.shape == (3, 3, 16)
    _same(got, want, "sweep")


def test_fused_path_refuses_control_plane_and_real_scalers():
    fused = LagSimConfig(fused_steps=4)
    for pol, cfg, jcfg in (
            ("BFD", _with_cp(fused, ZF), JConfig(fused_steps=4,
                                                 control_plane=JZF)),
            ("KEDA_LAG_REAL", fused, JConfig(fused_steps=4)),
            ("CLOUD_RUN_CPU_LAG", fused, JConfig(fused_steps=4))):
        with pytest.raises(JFusedPathError) as want:
            j_fused_mode(pol, jcfg, 6)
        with pytest.raises(FusedPathError) as got:
            fused_mode(pol, cfg, 6)
        assert str(got.value) == str(want.value)
        with pytest.raises(FusedPathError):
            sweep_lag((pol,), np.zeros((1, 4, 6), np.float32), cfg, **CPU)


# ---------------------------------------------------------------------------
# the control plane's state carried across mid-trace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", (False, True))
def test_state_resumes_from_reference_mid_trace(masked):
    """The reference's wrapped KEDA_LAG runs 9 steps a row; its state,
    carried over by ``convert.controlplane_state_from_numpy``, resumes in
    the port for 12 more steps beside the reference's own: every output
    equal, and the two states equal leaf by leaf after every step."""
    rng = np.random.default_rng(4)
    rows, n, t0, t1 = 3, 6, 9, 21
    cp = ControlPlaneConfig(**KNOBS)
    knobs = dict(lag_threshold=1.4, target_utilization=0.75,
                 max_consumers=6, scale_down_patience=2)
    ref = jreg.make_policy("KEDA_LAG", n, jnp.float32(1.0), backend="jax",
                           **{k: (jnp.float32(v) if isinstance(v, float)
                                  else v) for k, v in knobs.items()})
    j_init, j_step = j_wrap_policy(ref.init, ref.step, JCP(**KNOBS))
    ours = treg.make_policy("KEDA_LAG", n, 1.0, device="cpu", **knobs)
    init, step = wrap_policy(ours.init, ours.step, cp, device="cpu")
    speeds = rng.uniform(0, 1.5, (t1, rows, n)).astype(np.float32)
    lag = rng.uniform(0, 3.0, (t1, rows, n)).astype(np.float32)
    act = rng.random((t1, rows, n)) > 0.2 if masked else None
    j_states = [j_init(n) for _ in range(rows)]
    j_prev = [jnp.full((n,), -1, jnp.int32) for _ in range(rows)]
    state = prev = None
    for t in range(t1):
        outs = []
        for r in range(rows):
            args = (jnp.asarray(speeds[t, r]), jnp.asarray(lag[t, r]),
                    j_prev[r], j_states[r])
            if act is not None:
                args += (jnp.asarray(act[t, r]),)
            j_prev[r], k, j_states[r] = j_step(*args)
            outs.append((np.asarray(j_prev[r]), int(k)))
        stacked = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *j_states)
        if t + 1 == t0:                 # carry the reference's state over
            state = controlplane_state_from_numpy(stacked, **CPU)
            prev = torch.tensor(np.stack([o[0] for o in outs]),
                                dtype=torch.long)
        elif t + 1 > t0:
            a, k, state = step(torch.tensor(speeds[t]), torch.tensor(lag[t]),
                               prev, state,
                               None if act is None else torch.tensor(act[t]))
            prev = a
            np.testing.assert_array_equal(
                a.numpy(), np.stack([o[0] for o in outs]), str(t))
            np.testing.assert_array_equal(k.numpy(), [o[1] for o in outs])
            want = controlplane_state_from_numpy(stacked, **CPU)
            for f in dataclasses.fields(ControlPlaneState):
                g, w = getattr(state, f.name), getattr(want, f.name)
                if f.name == "inner":
                    for gi, wi in zip(g, w):
                        np.testing.assert_array_equal(gi.numpy(),
                                                      wi.numpy())
                    continue
                g = torch.broadcast_to(g, w.shape)
                assert torch.equal(g.to(w.dtype), w), (t, f.name)

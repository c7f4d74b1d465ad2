"""The port's closed loop against ``repro.lagsim``, on every route.

The same numpy traces go through the reference ``sweep_lag`` (the plain
per-step scan) and the port's ``sweep_lag`` with the per-step loop
(``use_kernel`` False and True), the fused engine (``fused_steps``) and
the fused kernel path (``fused_kernel``), masked and unmasked, for all
14 ported policies.  Integer trajectories (consumers, migrations,
unreadable) must match exactly; lag within ``atol = rtol = 1e-5``.  The
reactive KEDA_LAG decision is a ``ceil`` of a float sum: the seeds here
do not land on a threshold boundary, which the exact integer check
would show.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.lagsim import LagSimConfig as JConfig  # noqa: E402
from repro.lagsim import simulate_lag as j_simulate_lag  # noqa: E402
from repro.lagsim import summarize_sweep as j_summarize  # noqa: E402
from repro.lagsim import sweep_lag as j_sweep_lag  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import config_from_reference, state_from_numpy  # noqa: E402
from repro_torch.lagsim import (FusedPathError, LagSimConfig,  # noqa: E402
                                fused_mode, simulate_lag, sweep_lag)

TOL = dict(atol=1e-5, rtol=1e-5)
POLICIES = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD",
            "MWF", "MBF", "MWFP", "MBFP", "KEDA_LAG", "RATE_THRESHOLD")
FIELDS = ("lag_total", "lag_max", "consumers", "migrations", "unreadable")
BASE = dict(capacity=1.0, dt=0.7, migration_steps=3)
ROUTES = {"loop": {}, "loop+kernel": dict(use_kernel=True),
          "fused": dict(fused_steps=4),
          "fused+kernel": dict(fused_steps=7, fused_kernel=True)}


def _traces(masked, seed=3, b=3, t=24, n=6):
    rng = np.random.default_rng(seed)
    tr = rng.uniform(0, 1.1, (b, t, n)).astype(np.float32)
    if not masked:
        return tr, None
    act = rng.random((b, t, n)) > 0.2
    return np.where(act, tr, 0).astype(np.float32), act


@pytest.fixture(scope="module")
def reference():
    out = {}
    for masked in (False, True):
        tr, act = _traces(masked)
        out[masked] = (tr, act, j_sweep_lag(POLICIES, tr, JConfig(**BASE),
                                            active=act))
    return out


def _assert_traces(got, want, ctx):
    for f in FIELDS:
        g = getattr(got, f)
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(getattr(want, f))
        if f.startswith("lag"):
            np.testing.assert_allclose(g, w, **TOL, err_msg=str(ctx))
        else:
            np.testing.assert_array_equal(g, w, str((ctx, f)))


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("route", tuple(ROUTES))
def test_sweep_matches_reference(reference, route, masked):
    tr, act, want = reference[masked]
    got = sweep_lag(POLICIES, torch.tensor(tr),
                    LagSimConfig(**BASE, **ROUTES[route]),
                    active=None if act is None else torch.tensor(act),
                    device="cpu")
    assert got.policies == POLICIES
    _assert_traces(got, want, (route, masked))


def test_use_kernel_matches_reference_kernel_path():
    tr, act = _traces(True, seed=5, b=2, t=10, n=5)
    cfg = dict(BASE, use_kernel=True)
    want = j_sweep_lag(("BFD", "MWF"), tr, JConfig(**cfg), active=act)
    got = sweep_lag(("BFD", "MWF"), tr, LagSimConfig(**cfg), active=act,
                    device="cpu")
    _assert_traces(got, want, "use_kernel")


@pytest.mark.parametrize("fused", (False, True))
@pytest.mark.parametrize("policy", ("BFD", "MWF", "KEDA_LAG"))
def test_simulate_lag_initial_lag_and_assigns(policy, fused):
    rng = np.random.default_rng(11)
    tr = rng.uniform(0, 1.2, (17, 6)).astype(np.float32)
    il = np.linspace(0.0, 3.0, 6).astype(np.float32)
    # the reference's megakernel entry takes no rank-1 initial_lag, so
    # its fused engine (pinned to its scan) is the oracle of the port's
    # fused kernel path here
    over = dict(fused_steps=4) if fused else {}
    want, wa = j_simulate_lag(tr, policy=policy,
                              cfg=JConfig(**BASE, **over),
                              initial_lag=jnp.asarray(il), record_assign=True)
    st = state_from_numpy(il, device="cpu")
    cfg = LagSimConfig(**BASE, **over, fused_kernel=fused)
    got, ga = simulate_lag(tr, policy=policy, cfg=cfg,
                           initial_lag=st.lag, record_assign=True,
                           device="cpu")
    _assert_traces(got, want, (policy, fused))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


@pytest.mark.parametrize("masked", (False, True))
def test_api_simulate_metrics_match_reference(reference, masked):
    tr, act, want = reference[masked]
    cfg = JConfig(**BASE)
    ref_metrics = j_summarize(want, cfg)
    out = api.simulate(tr, policies=POLICIES,
                       config=config_from_reference(dataclasses.asdict(cfg)),
                       active=act, device="cpu", fused_steps=8,
                       fused_kernel=True)
    assert out.policies == POLICIES
    assert set(out.metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(out.metrics[k], np.asarray(v), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(out.consumers, np.asarray(want.consumers))


def test_config_conversion_and_refusals():
    from repro.lagsim import ControlPlaneConfig as JCP
    from repro.telemetry import AlertConfig as JA
    from repro.telemetry import SketchConfig as JS
    from repro.telemetry import TelemetryConfig as JT
    from repro.telemetry import default_rules

    fields = dataclasses.asdict(JConfig(capacity=2.0, dt=0.5, fused_steps=3))
    cfg = config_from_reference(fields)
    assert dataclasses.asdict(cfg) == fields
    assert cfg.resolve(6).lag_threshold == JConfig(
        capacity=2.0, dt=0.5).resolve(6).lag_threshold
    # the control plane and telemetry come across, nested configs too
    full = JConfig(capacity=2.0, dt=0.5, control_plane=JCP(
        polling_interval=3, cooldown_period=6, max_replicas=4),
        telemetry=JT(ring=8, sketch=JS(ewma_halflives=(4.0,)),
                     alerts=JA(rules=default_rules(), max_incidents=5)))
    fields = dataclasses.asdict(full)
    cfg = config_from_reference(fields)
    assert dataclasses.asdict(cfg) == fields
    assert (dataclasses.asdict(cfg.resolve(6))
            == dataclasses.asdict(full.resolve(6)))
    # a control plane or telemetry of another type: the reference's
    # named errors, from resolve
    for ours, ref in ((LagSimConfig(control_plane=object()),
                       JConfig(control_plane=object())),
                      (config_from_reference(dict(fields,
                                                  control_plane=object())),
                       JConfig(control_plane=object())),
                      (LagSimConfig(telemetry=object()),
                       JConfig(telemetry=object()))):
        with pytest.raises(ValueError) as want:
            ref.resolve(4)
        with pytest.raises(ValueError) as got:
            ours.resolve(4)
        assert (str(got.value).split(";")[0]
                == str(want.value).split(";")[0])
    with pytest.raises(ValueError, match="not LagSimConfig fields"):
        config_from_reference(dict(fields, bogus=1))
    with pytest.raises(ValueError, match="fused_kernel=True requires"):
        LagSimConfig(fused_kernel=True).resolve(4)


def test_fused_routing_table():
    fused = LagSimConfig(fused_steps=8)
    assert fused_mode("BFD", fused, 6) == "fused"
    assert fused_mode("BFD", fused, 15) == "unfused"
    assert fused_mode("MWF", fused, 6) == "unfused"
    assert fused_mode("KEDA_LAG", fused, 6) == "unfused"
    assert fused_mode("BFD", dataclasses.replace(fused, use_kernel=True),
                      6) == "unfused"
    with pytest.raises(FusedPathError):
        fused_mode("BFD", dataclasses.replace(fused, control_plane=object()),
                   6)


def test_shape_errors_are_named():
    with pytest.raises(ValueError, match="active mask has shape"):
        sweep_lag(("BFD",), np.zeros((2, 4, 3), np.float32),
                  active=np.ones((2, 4, 2), bool), device="cpu")
    with pytest.raises(ValueError, match="initial_lag has shape"):
        simulate_lag(np.zeros((4, 3), np.float32), policy="BFD",
                     initial_lag=np.zeros(2, np.float32), device="cpu")

"""The port's registry against the reference catalogue, and the reactive
scalers' step parity.

Names (in registration order), families, hyperparameters, paper sections
and summaries must equal ``repro.registry``'s ``jax`` backend, policy for
policy; the reactive scalers must give the same assignment, consumer
count and state as the reference's ``Policy.step`` on the same inputs,
step after step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.registry as jreg  # noqa: E402
import repro_torch.registry as treg  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402

PORTED = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD",
          "MWF", "MBF", "MWFP", "MBFP", "KEDA_LAG", "RATE_THRESHOLD",
          "KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG", "ANNEAL", "ANNEAL_STICKY")


def test_names_follow_reference_registration_order():
    assert treg.list_policies() == PORTED
    assert treg.list_policies() == jreg.list_policies(backend="jax")


@pytest.mark.parametrize("name", PORTED)
def test_family_and_hyperparams_equal_reference(name):
    ours, ref = treg.get_spec(name), jreg.get_spec(name, backend="jax")
    assert ours.family == ref.family
    assert dict(ours.hyperparams) == dict(ref.hyperparams)
    assert ours.paper_section == ref.paper_section
    assert ours.summary == ref.summary


def test_family_filter_and_errors():
    assert treg.list_policies(family="reactive") == (
        "KEDA_LAG", "RATE_THRESHOLD", "KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG")
    assert treg.list_policies(family="reactive") == jreg.list_policies(
        family="reactive", backend="jax")
    with pytest.raises(ValueError, match="unknown family"):
        treg.list_policies(family="bogus")
    with pytest.raises(ValueError, match="unknown policy"):
        treg.get_spec("KEDA_LAG_FAKE")
    with pytest.raises(ValueError, match="does not take hyperparams"):
        treg.make_policy("BFD", 4, device="cpu", gain=2.0)
    with pytest.raises(ValueError, match="already registered"):
        treg.register("BFD", family="heuristic")(lambda *a, **k: None)
    with pytest.raises(ValueError, match="does not take options"):
        treg.make_policy("BFD", 4, device="cpu", options={"noise": []})
    with pytest.raises(ValueError, match="has no one-shot packer"):
        treg.packer_for("ANNEAL")


@pytest.mark.parametrize("name", ("ANNEAL", "ANNEAL_STICKY"))
def test_fused_mode_refuses_optimizers_like_the_reference(name):
    from repro.lagsim import LagSimConfig as JConfig
    from repro.lagsim.fused import FusedPathError as JFusedPathError
    from repro.lagsim.fused import fused_mode as j_fused_mode
    from repro_torch.lagsim import FusedPathError, LagSimConfig, fused_mode

    with pytest.raises(JFusedPathError) as want:
        j_fused_mode(name, JConfig(fused_steps=4), 6)
    with pytest.raises(FusedPathError) as got:
        fused_mode(name, LagSimConfig(fused_steps=4), 6)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("name", ("KEDA_LAG", "RATE_THRESHOLD"))
def test_reactive_step_parity(name, masked):
    rng = np.random.default_rng(7)
    rows, n, steps = 4, 6, 12
    knobs = dict(lag_threshold=1.4, target_utilization=0.75,
                 max_consumers=5, scale_down_patience=2)
    ref = jreg.make_policy(name, n, jnp.float32(1.0), backend="jax",
                           **{k: (jnp.float32(v) if isinstance(v, float)
                                  else v) for k, v in knobs.items()})
    ours = treg.make_policy(name, n, 1.0, device="cpu", **knobs)
    ref_state = [ref.init(n) for _ in range(rows)]
    our_state = ours.init(n)
    for t in range(steps):
        # scaled so that totals cross several thresholds up and down
        speeds = (rng.uniform(0, 1.2, (rows, n)) * (1 + (t % 5))
                  ).astype(np.float32)
        lag = (rng.uniform(0, 2.5, (rows, n)) * (t % 3)).astype(np.float32)
        act = (rng.random((rows, n)) > 0.3) if masked else None
        st = state_from_numpy(lag, device="cpu")
        assign, n_cons, our_state = ours.step(
            torch.tensor(speeds), st.lag, st.prev_assign, our_state,
            None if act is None else torch.tensor(act))
        for r in range(rows):
            a, k, ref_state[r] = ref.step(
                jnp.asarray(speeds[r]), jnp.asarray(lag[r]),
                jnp.full(n, -1, jnp.int32), ref_state[r],
                None if act is None else jnp.asarray(act[r]))
            np.testing.assert_array_equal(assign[r].numpy(), np.asarray(a))
            assert int(n_cons[r]) == int(k), (t, r)
            assert int(our_state[1][r]) == int(ref_state[r][1]), (t, r)

"""The port's scenario transforms against ``repro.core.scenarios``.

PRNG streams of JAX and PyTorch never agree, so each family is split
into draws and a transform: these tests replay the reference's
``jax.random.split`` sequence to make the reference's own draws, feed
them to the port's transform, and hold the result against the reference
generator's output (floats within ``atol = rtol = 1e-5``, masks
exactly).  The port's device generators are checked for shape,
determinism and the mask contract.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import scenarios as jsc  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
B, T, N = 3, 40, 5


def _t(x):
    return torch.tensor(np.asarray(x))


def _walk_steps(key):
    return jax.random.uniform(key, (B, T - 1, N), minval=-1.0, maxval=1.0)


@pytest.mark.parametrize("seed", (0, 1))
def test_diurnal_transform(seed):
    key = jax.random.key(seed)
    k_mean, k_phase, k_amp, k_noise = jax.random.split(key, 4)
    draws = dict(
        mean=jax.random.uniform(k_mean, (B, 1, N), minval=0.1, maxval=0.6),
        phase=jax.random.uniform(k_phase, (B, 1, N), maxval=2 * np.pi),
        amp=jax.random.uniform(k_amp, (B, 1, N), maxval=0.4),
        steps=_walk_steps(k_noise))
    got = tsc.diurnal({k: _t(v) for k, v in draws.items()}, capacity=1.5)
    want = jsc.diurnal(key, B, T, N, capacity=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", (0, 1))
def test_bursty_transform(seed):
    key = jax.random.key(seed)
    k_base, k_arrive, k_size = jax.random.split(key, 3)
    draws = dict(
        floor=jax.random.uniform(k_base, (B, 1, N), minval=0.2, maxval=1.0),
        arrive=jax.random.bernoulli(k_arrive, 0.2, (T, B, N)),
        size=jax.random.uniform(k_size, (T, B, N), minval=0.3, maxval=1.0))
    got = tsc.bursty({k: _t(v) for k, v in draws.items()})
    want = jsc.bursty(key, B, T, N, p_spike=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", (0, 1))
def test_topic_lifecycle_transform(seed):
    key = jax.random.key(seed)
    k_alive0, k_birth, k_life, k_level, k_noise = jax.random.split(key, 5)
    draws = dict(
        alive0=jax.random.bernoulli(k_alive0, 0.5, (B, N)),
        birth=jax.random.uniform(k_birth, (B, N), maxval=float(T)),
        life=jax.random.uniform(k_life, (B, N), minval=0.15 * T,
                                maxval=float(T)),
        level=jax.random.uniform(k_level, (B, 1, N), minval=0.3, maxval=1.5),
        steps=_walk_steps(k_noise))
    sp, act = tsc.topic_lifecycle_masked({k: _t(v) for k, v in draws.items()})
    w_sp, w_act = jsc.topic_lifecycle_masked(key, B, T, N)
    np.testing.assert_array_equal(act.numpy(), np.asarray(w_act))
    np.testing.assert_allclose(sp.numpy(), np.asarray(w_sp), **TOL)


@pytest.mark.parametrize("seed", (0, 1))
def test_random_walk_transform(seed):
    key = jax.random.key(seed)
    k_init, k_walk = jax.random.split(key)
    draws = dict(init=jax.random.uniform(k_init, (B, N)),
                 steps=jax.random.uniform(k_walk, (T - 1, B, N), minval=-1.0,
                                          maxval=1.0))
    got = tsc.random_walk({k: _t(v) for k, v in draws.items()},
                          capacity=1.5, delta=25.0)
    want = jsc.random_walk(key, B, T, N, capacity=1.5, delta=25.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[:, 1:] == 0).any()      # the per-step clip was exercised


@pytest.mark.parametrize("seed", (0, 1))
def test_ramp_transform(seed):
    key = jax.random.key(seed)
    k_init, k_slope, k_noise = jax.random.split(key, 3)
    draws = dict(
        init=jax.random.uniform(k_init, (B, 1, N), maxval=0.8),
        slope=jax.random.uniform(k_slope, (B, 1, N), minval=-2.0, maxval=2.0),
        steps=_walk_steps(k_noise))
    got = tsc.ramp({k: _t(v) for k, v in draws.items()}, capacity=1.5,
                   noise=0.05)
    want = jsc.ramp(key, B, T, N, capacity=1.5, max_slope=2.0, noise=0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _churn_draws(key, p_flip):
    k_state, k_flip, k_hot, k_noise = jax.random.split(key, 4)
    return {k: _t(v) for k, v in dict(
        state0=jax.random.bernoulli(k_state, 0.5, (B, N)),
        flips=jax.random.bernoulli(k_flip, p_flip, (T, B, N)),
        level=jax.random.uniform(k_hot, (B, 1, N), minval=0.5, maxval=1.5),
        jitter=jax.random.uniform(k_noise, (B, T, N), minval=-1.0,
                                  maxval=1.0)).items()}


@pytest.mark.parametrize("seed", (0, 1))
def test_churn_transforms(seed):
    key = jax.random.key(seed)
    draws = _churn_draws(key, 0.1)
    got = tsc.churn(draws, capacity=1.5, hot=0.7, idle=0.02, noise=0.1)
    want = jsc.churn(key, B, T, N, capacity=1.5, p_flip=0.1, hot=0.7,
                     idle=0.02, noise=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    sp, act = tsc.churn_masked(draws, capacity=1.5, hot=0.7, noise=0.1)
    w_sp, w_act = jsc.churn_masked(key, B, T, N, capacity=1.5, p_flip=0.1,
                                   hot=0.7, noise=0.1)
    np.testing.assert_array_equal(act.numpy(), np.asarray(w_act))
    np.testing.assert_allclose(sp.numpy(), np.asarray(w_sp), **TOL)
    assert act.any() and not act.all()


@pytest.mark.parametrize("seed", (0, 1))
def test_heavy_tail_transform(seed):
    key = jax.random.key(seed)
    k_base, k_noise = jax.random.split(key)
    draws = dict(normal=jax.random.normal(k_base, (B, 1, N)),
                 steps=_walk_steps(k_noise))
    got = tsc.heavy_tail({k: _t(v) for k, v in draws.items()}, capacity=1.5,
                         sigma=1.5, scale=0.2, noise=0.2)
    want = jsc.heavy_tail(key, B, T, N, capacity=1.5, sigma=1.5, scale=0.2,
                          noise=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


ADVERSARIAL_KNOBS = (
    {},
    dict(base_rate=0.5, tail_sigma=2.0, burst_start_frac=0.1,
         burst_len_frac=0.5, burst_amp=3.0, churn_p=0.1, lifecycle_frac=0.6,
         birth_frac=0.2, death_frac=0.7, noise=0.15),
    # an equal window: death == birth (the clamp's edge)
    dict(churn_p=0.05, lifecycle_frac=1.0, birth_frac=0.3, death_frac=0.3),
)


@pytest.mark.parametrize("knobs", ADVERSARIAL_KNOBS)
@pytest.mark.parametrize("seed", (0, 1))
def test_adversarial_transforms(seed, knobs):
    key = jax.random.key(seed)
    k_tail, k_churn, k_state, k_sel, k_noise = jax.random.split(key, 5)
    churn_p = knobs.get("churn_p", 0.0)
    draws = {k: _t(v) for k, v in dict(
        tail=jax.random.normal(k_tail, (B, 1, N)),
        state0=jax.random.bernoulli(k_state, 0.9, (B, N)),
        flips=jax.random.bernoulli(k_churn, churn_p, (T, B, N)),
        select=jax.random.uniform(k_sel, (B, 1, N)),
        jitter=jax.random.uniform(k_noise, (B, T, N), minval=-1.0,
                                  maxval=1.0)).items()}
    tknobs = {k: v for k, v in knobs.items() if k != "churn_p"}
    sp, act = tsc.adversarial_masked(draws, capacity=1.5, **tknobs)
    w_sp, w_act = jsc.adversarial_masked(key, B, T, N, capacity=1.5, **knobs)
    np.testing.assert_array_equal(act.numpy(), np.asarray(w_act))
    np.testing.assert_allclose(sp.numpy(), np.asarray(w_sp), **TOL)
    legacy = tsc.adversarial(draws, capacity=1.5, **tknobs)
    np.testing.assert_allclose(
        legacy.numpy(),
        np.asarray(jsc.adversarial(key, B, T, N, capacity=1.5, **knobs)),
        **TOL)
    assert float(sp.max()) <= 1.5


def test_family_registry_equals_the_reference():
    assert tuple(tsc.FAMILY_SPECS) == tuple(jsc.FAMILY_SPECS)
    assert tuple(tsc.SCENARIO_FAMILIES) == tuple(jsc.SCENARIO_FAMILIES)
    assert (tuple(tsc.MASKED_SCENARIO_FAMILIES)
            == tuple(jsc.MASKED_SCENARIO_FAMILIES))
    for name, ref in jsc.FAMILY_SPECS.items():
        ours = tsc.family_spec(name)
        assert ours.name == ref.name
        assert ([dataclasses.astuple(k) for k in ours.knobs]
                == [dataclasses.astuple(k) for k in ref.knobs])
        assert ours.ordered == ref.ordered
        assert ours.knob_names == ref.knob_names
    with pytest.raises(ValueError, match="unknown scenario family"):
        tsc.family_spec("nope")
    with pytest.raises(ValueError, match="already registered"):
        tsc.register_family("ramp", tsc.SCENARIO_FAMILIES["ramp"])
    with pytest.raises(ValueError, match="outside bounds"):
        tsc.KnobSpec("x", 0.0, 1.0, 2.0)
    with pytest.raises(ValueError, match="unregistered knobs"):
        tsc.FamilySpec("f", None, None, knobs=(tsc.KnobSpec("a", 0, 1, 0),),
                       ordered=(("a", "b"),))


@pytest.mark.parametrize("family", tuple(jsc.FAMILY_SPECS))
def test_registered_generators_at_their_defaults(family):
    """Each family at its registered default knobs: deterministic under
    its seed, shaped and typed, non-negative; masked speeds vanish where
    the mask is off, and every knob is accepted by name."""
    sp = tsc.generate_scenario(family, 3, 2, 24, 5, device="cpu")
    assert sp.shape == (2, 24, 5) and sp.dtype == torch.float32
    assert torch.equal(sp, tsc.generate_scenario(family, 3, 2, 24, 5,
                                                 device="cpu"))
    assert (sp >= 0).all()
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(sp, tsc.generate_scenario(family, gen, 2, 24, 5))
    knobs = {k.name: k.default for k in tsc.family_spec(family).knobs}
    assert torch.equal(sp, tsc.generate_scenario(family, 3, 2, 24, 5,
                                                 device="cpu", **knobs))
    msp, act = tsc.generate_masked_scenario(family, 3, 2, 24, 5,
                                            device="cpu")
    assert act.dtype == torch.bool and act.shape == msp.shape
    assert (msp[~act] == 0).all()


def test_suites_keying_and_mask_contract():
    fams = tuple(tsc.SCENARIO_FAMILIES)
    suite = tsc.scenario_suite(11, 2, 20, 4, device="cpu")
    masked = tsc.masked_scenario_suite(11, 2, 20, 4, device="cpu")
    assert tuple(suite) == fams and tuple(masked) == fams
    gens = tsc._split(11, len(fams), "cpu")
    for f, g in zip(fams, gens):
        assert torch.equal(suite[f], tsc.generate_scenario(f, g, 2, 20, 4))
    for f in fams:
        sp, act = masked[f]
        if f in ("churn", "topic_lifecycle", "adversarial"):
            # the same draws: the legacy trace is the masked one where on
            assert torch.equal(torch.where(act, suite[f], 0.0), sp)
        else:
            assert act.all() and torch.equal(sp, suite[f])
    assert not torch.equal(suite["diurnal"],
                           tsc.scenario_suite(12, 2, 20, 4, device="cpu")
                           ["diurnal"])
    labels, stacked = tsc.stack_suite(suite)
    assert stacked.shape == (2 * len(fams), 20, 4)
    assert labels == tuple(f for f in fams for _ in range(2))
    labels_m, sp_m, act_m = tsc.stack_masked_suite(masked)
    assert labels_m == labels and sp_m.shape == act_m.shape == stacked.shape
    assert torch.equal(sp_m[labels.index("ramp")], stacked[labels.index("ramp")])


@pytest.mark.parametrize("family", ("diurnal", "bursty", "topic_lifecycle"))
def test_device_generators(family):
    sp, act = tsc.generate_masked_scenario(family, 7, 4, 30, 6, device="cpu")
    again, _ = tsc.generate_masked_scenario(family, 7, 4, 30, 6,
                                            device="cpu")
    other, _ = tsc.generate_masked_scenario(family, 8, 4, 30, 6,
                                            device="cpu")
    assert sp.shape == (4, 30, 6) and sp.dtype == torch.float32
    assert torch.equal(sp, again) and not torch.equal(sp, other)
    assert (sp >= 0).all()
    assert act.shape == sp.shape and act.dtype == torch.bool
    if family == "topic_lifecycle":
        assert (sp[~act] == 0).all() and not act.all()
    else:
        assert act.all()


def test_generator_errors_are_named():
    with pytest.raises(ValueError, match="unknown scenario family"):
        tsc.generate_scenario("nope", 0, 1, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown scenario family"):
        tsc.generate_masked_scenario("nope", 0, 1, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="death precedes birth"):
        tsc.topic_lifecycle_draws(torch.Generator(), 1, 4, 2,
                                  min_life_frac=-0.1)
    with pytest.raises(ValueError, match="death precedes birth"):
        tsc.generate_masked_scenario("adversarial", 0, 1, 4, 2, device="cpu",
                                     birth_frac=0.6, death_frac=0.2)
    with pytest.raises(ValueError, match="pass device=None"):
        tsc.generate_scenario("ramp", torch.Generator(), 1, 4, 2,
                              device="meta")

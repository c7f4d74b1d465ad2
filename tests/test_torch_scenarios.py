"""The port's scenario transforms against ``repro.core.scenarios``.

PRNG streams of JAX and PyTorch never agree, so each family is split
into draws and a transform: these tests replay the reference's
``jax.random.split`` sequence to make the reference's own draws, feed
them to the port's transform, and hold the result against the reference
generator's output (floats within ``atol = rtol = 1e-5``, masks
exactly).  The port's device generators are checked for shape,
determinism and the mask contract.
"""
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


@pytest.mark.parametrize("family", ("diurnal", "bursty", "topic_lifecycle"))
def test_device_generators(family):
    sp, act = tsc.generate(family, 4, 30, 6, seed=7, device="cpu")
    again, _ = tsc.generate(family, 4, 30, 6, seed=7, device="cpu")
    other, _ = tsc.generate(family, 4, 30, 6, seed=8, device="cpu")
    assert sp.shape == (4, 30, 6) and sp.dtype == torch.float32
    assert torch.equal(sp, again) and not torch.equal(sp, other)
    assert (sp >= 0).all()
    if family == "topic_lifecycle":
        assert act.shape == sp.shape and act.dtype == torch.bool
        assert (sp[~act] == 0).all()
    else:
        assert act is None


def test_generator_errors_are_named():
    with pytest.raises(ValueError, match="not yet ported"):
        tsc.generate("ramp", 1, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="death precedes birth"):
        tsc.topic_lifecycle_draws(torch.Generator(), 1, 4, 2,
                                  min_life_frac=-0.1)

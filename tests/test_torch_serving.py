"""The port's serve step and greedy generation against the JAX reference.

``serve_step`` over 6 steps (logits and ``cache_len``), and
``SharedModel.generate`` with prompts of unequal length, the reference's
weights injected and the batch padded to ``max_batch``: the same tokens
in float32.  In bfloat16 the logits are compared under teacher forcing
only (a greedy token may flip on a near-tie).  Also the port's own
decode-versus-prefill consistency, as ``tests/test_arch_smoke.py`` checks
the reference's.  Tolerances as in ``test_torch_models.py``: ``1e-5`` in
float32, ``5e-2`` in bfloat16.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import serve_step as j_serve_step  # noqa: E402
from repro.serving.llm_replica import SharedModel as JSharedModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import init_decode_state, init_params  # noqa: E402
from repro_torch.serving import SharedModel  # noqa: E402

ARCHS = ("qwen3-8b", "olmo-1b", "granite-3-8b")
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32"),
          "bf16-params": ("bfloat16", "bfloat16")}


def close(got, want, dtype):
    t = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=t, rtol=t)


def configs(arch, dt):
    dtype, pdtype = DTYPES[dt]
    return tuple(dataclasses.replace(m.get(arch, smoke=True), dtype=dtype,
                                     param_dtype=pdtype)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def reference_step(arch, dt):
    jcfg, _ = configs(arch, dt)
    return jax.jit(lambda p, s, b: j_serve_step(p, jcfg, s, b))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_serve_step_matches_reference(arch, dt):
    jcfg, tcfg = configs(arch, dt)
    jp = j_init_params(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (3, 6)).astype(np.int32)
    jstate = j_init_state(jcfg, 3, 8)
    tstate = init_decode_state(tcfg, 3, 8, device="cpu")
    step = make_serve_step(tcfg, device="cpu")
    for t in range(6):
        jl, jstate = reference_step(arch, dt)(
            jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
        tl, tstate = step(tp, tstate, {"inputs": toks[:, t]})
        assert tl.shape == (3, jcfg.vocab_size) and tl.dtype == tcfg.adtype
        close(tl, jl, jcfg.dtype)
        assert int(tstate["cache_len"]) == int(jstate["cache_len"]) == t + 1
    assert tstate["cache_len"].dtype == torch.int32
    for name in ("k", "v"):
        close(tstate["kv"][name], jstate["kv"][name], jcfg.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """Unequal prompts (right-padded with 0 and teacher-forced), three
    prompts padded to a batch of four, six greedy tokens: equal."""
    jcfg, tcfg = configs(arch, "f32")
    ref = JSharedModel(jcfg, max_len=24, max_batch=4, seed=2)
    port = SharedModel(tcfg, max_len=24, max_batch=4, device="cpu",
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, ref.params), tcfg,
                           device="cpu"))
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, jcfg.vocab_size, n)) for n in (5, 2, 7)]
    want = ref.generate(prompts, 6)
    got = port.generate(prompts, 6)
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generate_rejects_more_prompts_than_the_batch():
    cfg = tconfigs.get("qwen3-8b", smoke=True)
    model = SharedModel(cfg, max_len=8, max_batch=2, device="cpu")
    with pytest.raises(ValueError):
        model.generate([[1], [2], [3]], 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Feeding tokens one by one through the cache reproduces the
    full-sequence logits at every position (float32, the port alone)."""
    _, cfg = configs(arch, "f32")
    params = init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    prefill = make_prefill_step(cfg, device="cpu")
    step = make_serve_step(cfg, device="cpu")
    state = init_decode_state(cfg, 2, 8, device="cpu")
    for t in range(6):
        logits, state = step(params, state, {"inputs": toks[:, t]})
        full = prefill(params, {"inputs": toks[:, :t + 1]})
        torch.testing.assert_close(logits, full, atol=1e-5, rtol=1e-5)

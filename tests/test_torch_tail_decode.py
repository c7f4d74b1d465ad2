"""The port's tailed decode (``decode_tail_window > 0``) against the JAX
reference: ``init_kv_tail``, ``decode_attention_tailed`` and
``flush_kv_tail``, the tailed branch of ``init_decode_state`` and
``serve_step``, and ``SharedModel.generate`` with a tailed config.

The reference's weights and, where a test resumes mid-run, its decode
state are carried across by ``convert``; the same numpy tokens enter both
packages.  Both runs flush when ``cache_len % W == 0``, as
``tests/test_tail_decode.py`` does.  Tolerances: ``1e-5`` in float32,
``5e-2`` in bfloat16 (the reference in bfloat16 runs eagerly under
``jax.disable_jit()``: jitted, XLA's excess precision moves a MoE
router's input and flips near-tie experts).  The port's attention runs
the decode kernel's plain version on the CPU; the reference's tailed
attention is jnp (it has no Pallas kernel).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import serve_step as j_serve_step  # noqa: E402
from repro.serving.llm_replica import SharedModel as JSharedModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (decode_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_plain, decode_attention_tailed_fwd,
    decode_attention_tailed_plain)
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import (flush_kv_tail, init_decode_state,  # noqa: E402
                                init_kv_tail, init_params, serve_step)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.serving import SharedModel  # noqa: E402

W = 4
N_TOK = 11      # crosses two flushes (at 4 and 8)
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32")}


def tol(dtype):
    return 1e-5 if dtype == "float32" else 5e-2


def close(got, want, dtype, msg=""):
    t = tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=t, rtol=t,
                               err_msg=msg)


def configs(arch, dt="f32", **over):
    dtype, pdtype = DTYPES[dt]
    return tuple(dataclasses.replace(m.get(arch, smoke=True), dtype=dtype,
                                     param_dtype=pdtype, **over)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def models(arch, dt="f32", window=W):
    """(reference cfg, port cfg, reference params, port params), tailed at
    ``window``."""
    jcfg, tcfg = configs(arch, dt, decode_tail_window=window)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def reference(fn, dtype):
    """The reference's ``fn``: jitted in float32, eager in bfloat16."""
    if dtype == "float32":
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def same_state(tstate, jstate, dtype, msg):
    assert int(tstate["cache_len"]) == int(jstate["cache_len"]), msg
    for part in ("kv", "tail"):
        for name in ("k", "v"):
            close(tstate[part][name], jstate[part][name], dtype,
                  f"{msg}: {part}.{name}")


# ---------------------------------------------------------------------------
# the reference's own test (tests/test_tail_decode.py) on the port
# ---------------------------------------------------------------------------


def test_tailed_decode_matches_forward_and_plain_decode():
    """Stepping with a tail of 4 and a flush every 4 steps gives the plain
    decode's logits and the full-sequence forward's at every step; after
    the run the main cache holds the flushed prefix and nothing past it."""
    _, cfg = configs("qwen3-8b")
    cfg_tail = dataclasses.replace(cfg, decode_tail_window=W)
    params = init_params(cfg, seed=0, device="cpu")
    toks = tokens(cfg, 2, N_TOK, seed=1)
    prefill = make_prefill_step(cfg, device="cpu")
    step_p = make_serve_step(cfg, device="cpu")
    step_t = make_serve_step(cfg_tail, device="cpu")
    state_p = init_decode_state(cfg, 2, 16, device="cpu")
    state_t = init_decode_state(cfg_tail, 2, 16, device="cpu")
    assert "tail" in state_t and "tail" not in state_p
    for t in range(N_TOK):
        lg_p, state_p = step_p(params, state_p, {"inputs": toks[:, t]})
        lg_t, state_t = step_t(params, state_t, {"inputs": toks[:, t]})
        if int(state_t["cache_len"]) % W == 0:
            state_t = flush_kv_tail(cfg_tail, state_t)
        np.testing.assert_allclose(lg_t.numpy(), lg_p.numpy(), atol=2e-3,
                                   rtol=2e-3, err_msg=f"tail vs plain at {t}")
        full = prefill(params, {"inputs": toks[:, :t + 1]})
        np.testing.assert_allclose(lg_t.numpy(), full.numpy(), atol=2e-2,
                                   rtol=2e-2, err_msg=f"tail vs forward {t}")
    main_len = (N_TOK // W) * W
    k_main = state_t["kv"]["k"][0, 0, 0, :, 0]
    assert bool((k_main[:main_len] != 0).any())
    assert bool((k_main[main_len + 1:] == 0).all())
    # the flushed prefix is the plain decode's cache, row for row
    close(state_t["kv"]["k"][:, :, :, :main_len],
          state_p["kv"]["k"][:, :, :, :main_len].numpy(), "float32")


# ---------------------------------------------------------------------------
# the port against the reference, step for step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_tailed_serve_step_matches_reference(arch, dt):
    """11 steps of a batch of 2 with a flush at 4 and 8: logits, the main
    cache, the tail and ``cache_len`` equal after every step and every
    flush."""
    jcfg, tcfg, jp, tp = models(arch, dt)
    jstep = reference(lambda p, s, b: j_serve_step(p, jcfg, s, b), jcfg.dtype)
    jflush = reference(lambda s: jattn.flush_kv_tail(jcfg, s), jcfg.dtype)
    step = make_serve_step(tcfg, device="cpu")
    toks = tokens(jcfg, 2, N_TOK, seed=3)
    jstate = j_init_state(jcfg, 2, 16)
    tstate = init_decode_state(tcfg, 2, 16, device="cpu")
    same_state(tstate, jstate, jcfg.dtype, "initial")
    for t in range(N_TOK):
        jl, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
        tl, tstate = step(tp, tstate, {"inputs": toks[:, t]})
        close(tl, jl, jcfg.dtype, f"logits at step {t}")
        if int(jstate["cache_len"]) % W == 0:
            jstate = jflush(jstate)
            tstate = flush_kv_tail(tcfg, tstate)
        same_state(tstate, jstate, jcfg.dtype, f"after step {t}")
    assert tstate["cache_len"].dtype == torch.int32


@pytest.mark.parametrize("start", [6, 8])
def test_tailed_run_resumes_from_the_reference_state(start):
    """The reference runs ``start`` steps (6: two rows in the tail; 8:
    just flushed); its state enters the port through
    ``decode_state_from_numpy`` and both run on to 11 steps, equal."""
    jcfg, tcfg, jp, tp = models("qwen3-8b")
    jstep = jax.jit(lambda p, s, b: j_serve_step(p, jcfg, s, b))
    toks = tokens(jcfg, 2, N_TOK, seed=4)
    jstate = j_init_state(jcfg, 2, 16)
    for t in range(start):
        _, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
        if int(jstate["cache_len"]) % W == 0:
            jstate = jattn.flush_kv_tail(jcfg, jstate)
    tstate = decode_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                     device="cpu")
    same_state(tstate, jstate, "float32", "converted")
    step = make_serve_step(tcfg, device="cpu")
    for t in range(start, N_TOK):
        jl, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
        tl, tstate = step(tp, tstate, {"inputs": toks[:, t]})
        close(tl, jl, "float32", f"step {t}")
        if int(jstate["cache_len"]) % W == 0:
            jstate = jattn.flush_kv_tail(jcfg, jstate)
            tstate = flush_kv_tail(tcfg, tstate)
        same_state(tstate, jstate, "float32", f"after step {t}")


def test_decode_state_from_numpy_checks_its_input():
    jcfg, tcfg, _, _ = models("qwen3-8b")
    jstate = jax.tree.map(np.asarray, j_init_state(jcfg, 2, 16))
    with pytest.raises(ValueError, match="keys"):
        decode_state_from_numpy({"cache_len": 0, "kv": jstate["kv"]}, tcfg,
                                device="cpu")
    bad = dict(jstate, tail={k: v[:, :, :, :3] for k, v in
                             jstate["tail"].items()})
    with pytest.raises(ValueError, match="tail.k"):
        decode_state_from_numpy(bad, tcfg, device="cpu")
    _, hybrid = configs("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="dense or MoE"):
        decode_state_from_numpy(jstate, hybrid, device="cpu")


def test_hybrid_model_ignores_the_tail_window():
    """jamba with ``decode_tail_window = 4``: no tail in either package's
    state, and the port's steps equal its steps without the window."""
    jcfg, tcfg, jp, tp = models("jamba-v0.1-52b")
    assert "tail" not in j_init_state(jcfg, 2, 16)
    plain = dataclasses.replace(tcfg, decode_tail_window=0)
    toks = tokens(jcfg, 2, 6, seed=5)
    states = [init_decode_state(c, 2, 16, device="cpu") for c in (tcfg, plain)]
    assert "tail" not in states[0]
    steps = [make_serve_step(c, device="cpu") for c in (tcfg, plain)]
    for t in range(6):
        (got, states[0]), (want, states[1]) = (
            step(tp, st, {"inputs": toks[:, t]})
            for step, st in zip(steps, states))
        assert torch.equal(got, want), t
    jstep = jax.jit(lambda p, s, b: j_serve_step(p, jcfg, s, b))
    jstate = j_init_state(jcfg, 2, 16)
    for t in range(6):
        jl, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
    close(got, jl, "float32")


# ---------------------------------------------------------------------------
# the attention alone
# ---------------------------------------------------------------------------


def _attention_inputs(jcfg, cache_len, seed=0, s_len=16):
    """The layer-0 attention weights, x (B, 1, d) and random main and tail
    caches, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    b, kv, hd = 2, jcfg.n_kv_heads, jcfg.head_dim

    def draw(shape):
        a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(
            jcfg.dtype)
        return a, torch.tensor(np.asarray(a, np.float32)).to(
            torch_dtype(jcfg.dtype))
    x = draw((b, 1, jcfg.d_model))
    caches = [draw((b, kv, n, hd)) for n in (s_len, s_len, W, W)]
    pos = np.full((b, 1), cache_len, np.int32)
    return x, caches, pos


@pytest.mark.parametrize("cache_len", [0, 1, 3, 4, 6, 11])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_tailed_attention_matches_reference(cache_len, dt):
    """``attention.decode_attention_tailed`` (its kernel's plain version)
    against the reference's at ``main_len = 0`` (cache_len 0-3), at
    ``tail_len = 0`` (4) and between: the output and the written tail."""
    jcfg, tcfg, jp, tp = models("qwen3-8b", dt)
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tlayer = tp["layers"][0]["attn"]
    (jx, tx), caches, pos = _attention_inputs(jcfg, cache_len, seed=cache_len)
    fn = reference(lambda *a: jattn.decode_attention_tailed(jlayer, jcfg, *a),
                   jcfg.dtype)
    jy, jk, jv = fn(jx, *(c[0] for c in caches), jnp.int32(cache_len),
                    jnp.asarray(pos))
    ty, tk, tv = tattn.decode_attention_tailed(
        tlayer, tcfg, tx, *(c[1] for c in caches),
        torch.tensor(cache_len, dtype=torch.int32), torch.tensor(pos))
    close(ty, jy, jcfg.dtype, "output")
    close(tk, jk, jcfg.dtype, "k tail")
    close(tv, jv, jcfg.dtype, "v tail")


@pytest.mark.parametrize("cache_len", [0, 2, 3, 4, 5, 9, 12, 15])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_plain_tailed_equals_plain_decode_over_the_joined_rows(cache_len, g):
    """The two-part merge over main[0:main_len] ++ tail[0:tail_len + 1]
    equals one softmax over those rows laid out as one cache (what the
    kernel computes)."""
    rng = np.random.default_rng(cache_len)
    b, kv, hd, s_len = 2, 2, 16, 16

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32))
    q, km, vm = draw(b, kv, g, hd), draw(b, kv, s_len, hd), draw(
        b, kv, s_len, hd)
    kt, vt = draw(b, kv, W, hd), draw(b, kv, W, hd)
    got = decode_attention_tailed_fwd(q, km, vm, kt, vt,
                                      torch.tensor(cache_len, dtype=torch.int32),
                                      W)
    main_len = cache_len // W * W
    tail_len = cache_len - main_len
    k = torch.cat([km[:, :, :main_len], kt[:, :, :tail_len + 1]], 2)
    v = torch.cat([vm[:, :, :main_len], vt[:, :, :tail_len + 1]], 2)
    want = decode_attention_plain(q, k, v, cache_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)
    assert torch.equal(got, decode_attention_tailed_plain(
        q, km, vm, kt, vt, cache_len, W))


def test_tailed_wrapper_checks_shapes():
    q = torch.zeros(2, 2, 4, 16)
    cache = torch.zeros(2, 2, 16, 16)
    tail = torch.zeros(2, 2, W, 16)
    with pytest.raises(ValueError, match="tails"):
        decode_attention_tailed_fwd(q, cache, cache, tail, tail, 0, W + 1)
    with pytest.raises(ValueError, match="tails"):
        decode_attention_tailed_fwd(q, cache, cache, tail[:1], tail, 0, W)


@pytest.mark.parametrize("cache_len", [4, 8, 16, 2, -14, 30])
def test_flush_matches_reference_with_its_clamping(cache_len):
    """The flush writes the tail at ``cache_len - W`` placed as
    ``dynamic_update_slice`` places it (2 - 4 counts from the end, at 14,
    then clamps to 12; -18 to -2, then 0; 26 to 12), zeroes the tail, and
    leaves ``cache_len``; in place."""
    jcfg, tcfg, _, _ = models("qwen3-8b")
    rng = np.random.default_rng(abs(cache_len))
    jstate = j_init_state(jcfg, 2, 16)
    jstate = dict(jstate, cache_len=jnp.int32(cache_len), kv=jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32)),
        jstate["kv"]), tail=jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32)),
        jstate["tail"]))
    tstate = decode_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                     device="cpu")
    k_main = tstate["kv"]["k"]
    want = jattn.flush_kv_tail(jcfg, jstate)
    got = flush_kv_tail(tcfg, tstate)
    same_state(got, want, "float32", "flushed")
    assert got["kv"]["k"] is k_main
    assert not bool(got["tail"]["k"].any())


def test_flush_refuses_a_window_longer_than_the_cache():
    _, tcfg = configs("qwen3-8b", decode_tail_window=32)
    state = init_decode_state(tcfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="window"):
        flush_kv_tail(tcfg, state)


def test_init_kv_tail_matches_reference():
    jcfg, tcfg, _, _ = models("qwen3-8b", "bf16")
    want = jattn.init_kv_tail(jcfg, 3, W, n_layers=2)
    got = init_kv_tail(tcfg, 3, W, 2, device="cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.bfloat16 and not bool(
            got[name].any())


def test_tailed_serve_step_takes_no_host_sync():
    """The tailed step reads no tensor value on the host, so it replays as
    one CUDA graph across fills; the flush neither."""
    from torch.utils._python_dispatch import TorchDispatchMode

    syncing = {"aten._local_scalar_dense.default", "aten.nonzero.default",
               "aten.masked_select.default", "aten.item.default"}

    class Ops(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(str(func))
            return func(*args, **(kwargs or {}))

    _, tcfg, _, tp = models("qwen3-8b")
    state = init_decode_state(tcfg, 2, 16, device="cpu")
    tok = torch.tensor([3, 4])
    with Ops() as ops:
        for _ in range(W):
            _, state = serve_step(tp, tcfg, state, {"inputs": tok})
        flush_kv_tail(tcfg, state)
    assert not ops.seen & syncing, ops.seen & syncing


# ---------------------------------------------------------------------------
# SharedModel.generate with a tailed config: the reference never flushes
# ---------------------------------------------------------------------------


def test_generate_with_a_tailed_config_equals_reference_unflushed():
    """``SharedModel.generate`` never calls ``flush_kv_tail``, in the
    reference and in the port alike: past W steps the tail wraps and
    attention reads W main rows that were never written.  The port
    reproduces that result token for token (6 prompt + 5 greedy steps
    over W = 4)."""
    jcfg, tcfg = configs("qwen3-8b", decode_tail_window=W)
    ref = JSharedModel(jcfg, max_len=16, max_batch=2, seed=2)
    port = SharedModel(tcfg, max_len=16, max_batch=2, device="cpu",
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, ref.params), tcfg,
                           device="cpu"))
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, jcfg.vocab_size, n)) for n in (6, 3)]
    want = ref.generate(prompts, 5)
    np.testing.assert_array_equal(port.generate(prompts, 5), want)
    untailed = SharedModel(dataclasses.replace(tcfg, decode_tail_window=0),
                           max_len=16, max_batch=2, device="cpu",
                           params=port.params)
    # the unflushed tail is a different function from the plain decode
    assert not np.array_equal(untailed.generate(prompts, 5), want)

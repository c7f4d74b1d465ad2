"""The port's Mamba block and the hybrid family (jamba) against the JAX
reference (``repro.models.mamba``, the period layout of
``repro.models.transformer``).

The reference's weights are carried across with
``convert.params_from_numpy`` (its ``layers.sub{j}`` stacked over periods
become the port's layer ``p * period + j``); the same numpy activations
and token ids enter both packages.  Tolerances: ``atol = rtol = 1e-5``
in float32, ``5e-2`` in bfloat16, as ``test_torch_models.py``.  The
port's within-chunk scan is ``jax.lax.associative_scan``'s own recursion
(the same pairs combined in the same order), so float32 results agree to
a few ulps (XLA may contract a product and a sum into one FMA) and the
1e-5 tolerance holds with room.  In bfloat16 the reference's models run
eagerly (``test_torch_moe.py`` says why), and decode is compared in
float32 only, as there.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import serve_step as j_serve_step  # noqa: E402
from repro.serving.llm_replica import SharedModel as JSharedModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import (forward, init_decode_state,  # noqa: E402
                                init_params)
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.models.layers import embed_inputs, logits_fn  # noqa: E402
from repro_torch.models.transformer import (attention_layers,  # noqa: E402
                                            backbone)
from repro_torch.serving import SharedModel  # noqa: E402

ARCH = "jamba-v0.1-52b"
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32"),
          "bf16-params": ("bfloat16", "bfloat16")}


def close(got, want, dtype, msg=""):
    t = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=t, rtol=t,
                               err_msg=msg)


def reference(fn, dtype):
    """The reference's ``fn``: jitted in float32, eager in bfloat16."""
    if dtype == "float32":
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def configs(dt="f32", **over):
    dtype, pdtype = DTYPES[dt]
    return tuple(dataclasses.replace(m.get(ARCH, smoke=True), dtype=dtype,
                                     param_dtype=pdtype, **over)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def models(dt="f32"):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = configs(dt)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def mamba_weights(dt="f32", layer=0):
    """(reference, port) weights of layer ``layer``, a Mamba layer."""
    jcfg, tcfg, jp, tp = models(dt)
    assert not tcfg.is_attn_layer(layer)
    return (jax.tree.map(lambda a: a[0], jp["layers"][f"sub{layer}"]["mix"]),
            tp["layers"][layer]["mix"])


def activations(dtype, shape, seed=0):
    """(jax, torch) copies of one numpy draw in ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.tensor(np.asarray(jx, np.float32)).to(torch_dtype(dtype))


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------


def test_init_mamba_draws_the_reference_laws():
    _, tcfg = configs()
    p = tmamba.init_mamba(tcfg, generator=torch.Generator().manual_seed(0))
    jp = jmamba.init_mamba(jax.random.key(0), configs()[0])
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()} == tmamba.mamba_shapes(tcfg)
    for name in ("conv_b", "dt_bias", "A_log", "D"):
        close(p[name], jp[name], "float32")
    for name, fan_in in (("w_in", tcfg.d_model), ("w_out", 2 * tcfg.d_model)):
        x = p[name] * fan_in ** 0.5
        assert float(x.abs().max()) <= 3.0 + 1e-3


@pytest.mark.parametrize("s", [1, 5, 13])
@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(s, with_ctx, dtype):
    jp, tp = mamba_weights()
    d_in = tp["conv"].shape[1]
    jx, tx = activations(dtype, (2, s, d_in), seed=s)
    jc, tc = activations(dtype, (2, tp["conv"].shape[0] - 1, d_in), seed=40)
    want = jmamba._causal_conv(jp, jx, jc if with_ctx else None)
    got = tmamba._causal_conv(tp, tx, tc if with_ctx else None)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    close(got, want, dtype)


@pytest.mark.parametrize("num", [1, 2, 3, 7, 8, 13, 16])
def test_associative_scan_is_the_references(num):
    """The port's recursion against ``jax.lax.associative_scan`` of the
    same combine on the same pairs, and against a sequential loop."""
    rng = np.random.default_rng(num)
    a = rng.uniform(0.2, 1.0, (2, num, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, num, 3, 4)).astype(np.float32)

    def combine(x, y):
        (a1, b1), (a2, b2) = x, y
        return a1 * a2, b1 * a2 + b2

    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = tmamba._associative_scan(torch.tensor(a), torch.tensor(b))
    for g, w in zip(got, want):
        close(g, w, "float32")
    h, hs = np.zeros((2, 3, 4), np.float32), []
    for t in range(num):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    close(got[1], np.stack(hs, axis=1), "float32")


@pytest.mark.parametrize("s", [1, 8, 13, 20])
@pytest.mark.parametrize("h0", ["zeros", "random"])
def test_selective_ssm_matches_reference(s, h0):
    """Chunks of 8 (jamba-smoke's ``mamba_chunk``): S = 13 and 20 pad the
    last chunk, whose zero steps still decay h_last, as in the
    reference; h0 nonzero carries a state in."""
    jcfg, tcfg = configs()
    jp, tp = mamba_weights()
    d_in, n = tp["A_log"].shape
    jx, tx = activations("float32", (2, s, d_in), seed=20 + s)
    if h0 == "zeros":
        jh, th = jnp.zeros((2, d_in, n)), torch.zeros((2, d_in, n))
    else:
        jh, th = activations("float32", (2, d_in, n), seed=30)
    jy, jlast = jax.jit(lambda p, x, h: jmamba._selective_ssm(
        p, jcfg, x, h))(jp, jx, jh)
    ty, tlast = tmamba._selective_ssm(tp, tcfg, tx, th)
    close(ty, jy, "float32")
    close(tlast, jlast, "float32")


@pytest.mark.parametrize("dt", ["f32", "bf16", "bf16-params"])
@pytest.mark.parametrize("s", [6, 19])
def test_mamba_block_matches_reference(dt, s):
    jcfg, tcfg = configs(dt)
    jp, tp = mamba_weights(dt, layer=1)
    jx, tx = activations(jcfg.dtype, (2, s, jcfg.d_model), seed=50 + s)
    want = reference(lambda p, x: jmamba.mamba_block(p, jcfg, x),
                     jcfg.dtype)(jp, jx)
    got = tmamba.mamba_block(tp, tcfg, tx)
    assert got.dtype == tx.dtype
    close(got, want, jcfg.dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba_decode_step_matches_reference(dt):
    """Six steps from a zero state: outputs, and the state written in
    place (h in float32, the conv window of pre-conv inputs in the
    activation dtype)."""
    jcfg, tcfg = configs(dt)
    jp, tp = mamba_weights(dt)
    jst = jmamba.init_mamba_state(jcfg, 3)
    tst = tmamba.init_mamba_state(tcfg, 3)
    h, conv = tst["h"], tst["conv"]
    assert h.dtype == torch.float32 and conv.dtype == tcfg.adtype
    step = reference(lambda p, x, s: jmamba.mamba_decode_step(p, jcfg, x, s),
                     jcfg.dtype)
    for t in range(6):
        jx, tx = activations(jcfg.dtype, (3, 1, jcfg.d_model), seed=60 + t)
        jy, jst = step(jp, jx, jst)
        ty, tst2 = tmamba.mamba_decode_step(tp, tcfg, tx, tst)
        assert tst2["h"] is h and tst2["conv"] is conv
        close(ty, jy, jcfg.dtype, f"step {t}")
        close(h, jst["h"], jcfg.dtype, f"step {t}")
        close(conv, jst["conv"], jcfg.dtype, f"step {t}")


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------


def test_period_layout_and_decode_state():
    """Layer ``p * period + j`` is the reference's ``sub{j}`` of period
    ``p``: attention at the offset, MoE every second layer; the KV cache
    holds the attention layers only, a Mamba state each of the others."""
    jcfg, tcfg, jp, tp = models()
    period = tcfg.attn_layer_period
    assert attention_layers(tcfg) == [p * period + tcfg.attn_layer_offset
                                      for p in range(tcfg.n_layers // period)]
    for i, lp in enumerate(tp["layers"]):
        j = i % period
        sub = jp["layers"][f"sub{j}"]
        assert set(lp) == {"ln1", "mix", "ln2", "ffn"}
        assert set(lp["mix"]) == set(sub["mix"])
        assert set(lp["ffn"]) == set(sub["ffn"])
        np.testing.assert_array_equal(
            lp["ln1"]["scale"].numpy(),
            np.asarray(sub["ln1"]["scale"][i // period]))
    state = init_decode_state(tcfg, 2, 8, device="cpu")
    jstate = j_init_state(jcfg, 2, 8)
    assert tuple(state["kv"]["k"].shape) == jstate["kv"]["k"].shape
    n_mamba = tcfg.n_layers - len(attention_layers(tcfg))
    assert len(state["mamba"]) == n_mamba == int(np.prod(
        jstate["mamba"]["h"].shape[:2]))
    for name in ("h", "conv"):
        assert tuple(state["mamba"][0][name].shape) == \
            jstate["mamba"][name].shape[2:]


def _mamba_states(jstate, period_mamba):
    """The reference's (periods, Mamba layers of a period, ...) state as
    the port's flat list, in layer order."""
    h, conv = np.asarray(jstate["mamba"]["h"]), np.asarray(
        jstate["mamba"]["conv"], np.float32)
    return [{"h": h[p, m], "conv": conv[p, m]}
            for p in range(h.shape[0]) for m in range(period_mamba)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_logits_match_reference(dt):
    jcfg, tcfg, jp, tp = models(dt)
    toks = tokens(jcfg, 2, 19, seed=6)
    got = make_prefill_step(tcfg, device="cpu")(tp, {"inputs": toks})
    assert got.shape == (2, jcfg.vocab_size) and got.dtype == tcfg.adtype
    cfg = dataclasses.replace(jcfg, use_pallas=True)
    want = reference(j_prefill(cfg), jcfg.dtype)(
        jp, {"inputs": jnp.asarray(toks)})
    close(got, want, jcfg.dtype)


@pytest.mark.parametrize("batch", [2, 3])
def test_serve_step_matches_reference(batch):
    """Six decode steps (batch 2: one MoE dispatch group of 2; batch 3:
    each row alone): logits, ``cache_len``, the KV cache of the attention
    layers and every Mamba layer's state."""
    jcfg, tcfg, jp, tp = models()
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    jstep = jax.jit(lambda p, s, b: j_serve_step(p, jcfg, s, b))
    step = make_serve_step(tcfg, device="cpu")
    toks = tokens(jcfg, batch, 6, seed=7 + batch)
    jstate = j_init_state(jcfg, batch, 8)
    tstate = init_decode_state(tcfg, batch, 8, device="cpu")
    for t in range(6):
        jl, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
        tl, tstate = step(tp, tstate, {"inputs": toks[:, t]})
        close(tl, jl, jcfg.dtype, f"step {t}")
        assert int(tstate["cache_len"]) == t + 1
    for name in ("k", "v"):
        close(tstate["kv"][name], jstate["kv"][name], jcfg.dtype)
    want = _mamba_states(jstate, tcfg.attn_layer_period - 1)
    assert len(want) == len(tstate["mamba"])
    for got, ref in zip(tstate["mamba"], want):
        close(got["h"], ref["h"], "float32")
        close(got["conv"], ref["conv"], "float32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_loss_ce_and_aux_match_reference(dt):
    """``ce + AUX_LOSS_COEF * aux``, aux summed over the MoE layers of
    every period."""
    jcfg, tcfg, jp, tp = models(dt)
    toks = tokens(jcfg, 2, 13, seed=8)
    batch = {"inputs": toks, "labels": np.roll(toks, -1, axis=1)}
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    jl, jm = reference(lambda p, b: j_forward(p, jcfg, b), jcfg.dtype)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, tm = forward(tp, tcfg, {k: torch.tensor(v)
                                    for k, v in batch.items()})
    close(tl, jl, jcfg.dtype)
    close(tm["ce"], jm["ce"], jcfg.dtype)
    close(tm["aux"], jm["aux"], jcfg.dtype)


def test_generate_matches_reference():
    jcfg, tcfg = configs()
    ref = JSharedModel(jcfg, max_len=24, max_batch=4, seed=2)
    port = SharedModel(tcfg, max_len=24, max_batch=4, device="cpu",
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, ref.params), tcfg,
                           device="cpu"))
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, jcfg.vocab_size, n)) for n in (5, 2, 7)]
    np.testing.assert_array_equal(port.generate(prompts, 6),
                                  ref.generate(prompts, 6))


def test_jamba_decode_matches_forward():
    """The reference's ``tests/test_jamba_consistency.py`` on the port:
    float32, ``mamba_chunk`` 4, capacity factor 8 (no drops on either
    path): token-by-token decode reproduces the full-sequence logits,
    exercising the conv-window carry, the SSM state, the per-period KV
    cache and the MoE decode regrouping at once."""
    _, cfg = configs(mamba_chunk=4, capacity_factor=8.0)
    params = init_params(cfg, seed=0, device="cpu")
    n_tok = 6
    toks = torch.tensor(tokens(cfg, 2, n_tok, seed=1))
    pos = torch.arange(n_tok).expand(2, n_tok)
    with torch.no_grad():
        h = backbone(params, cfg, embed_inputs(params["embedding"], cfg,
                                               toks), pos)
        full = logits_fn(params, cfg, h)
    step = make_serve_step(cfg, device="cpu")
    state = init_decode_state(cfg, 2, 8, device="cpu")
    for t in range(n_tok):
        lg, state = step(params, state, {"inputs": toks[:, t]})
        # the reference's test holds 5e-2; the port's float32 meets 1e-5
        torch.testing.assert_close(lg, full[:, t], atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"step {t}: {m}")
    assert int(state["cache_len"]) == n_tok

"""The port's encoder-decoder family (``repro_torch.models.whisper``)
against the JAX reference (``repro.models.whisper``) on whisper's SMOKE
config (2 + 2 layers, d_model 64, T_enc 16).

The reference's weights are carried across with
``convert.params_from_numpy`` (its ``enc_layers.*`` and ``layers.*``
stacked over layers become the port's lists); the same numpy frames and
token ids enter both packages.  Tolerances: ``atol = rtol = 1e-5`` in
float32 and ``5e-2`` in bfloat16, as ``test_torch_models.py``; gradients
as ``test_torch_train.py`` holds them.  On the CPU the port's attention
runs the kernels' plain versions, float32 throughout like the
reference's jnp cross-attention (on the card the bfloat16 flash kernel
rounds P as the operand of P.V, which the reference's cross-attention
does not: ROADMAP queue 3).  In bfloat16 the reference runs eagerly
(``jax.disable_jit()``), as ``test_torch_moe.py`` says why.  The
reference stores the cross K/V (L, B, T_enc, KV, hd), the port
kv-major (L, B, KV, T_enc, hd): the tests transpose.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import serve_step as j_serve_step  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import _tree, configs as tconfigs  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, make_train_step)
from repro_torch.models import (backbone,  # noqa: E402
                                forward, init_decode_state, init_params,
                                serve_step)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.models.transformer import (attention_layers,  # noqa: E402
                                            check_trainable, param_shapes)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARCH = "whisper-large-v3"
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32"),
          "bf16-params": ("bfloat16", "bfloat16")}


def tol(dtype):
    return 1e-5 if dtype == "float32" else 5e-2


def close(got, want, dtype, msg=""):
    t = tol(dtype)
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


@functools.lru_cache(maxsize=None)
def models(dt="f32", remat=False):
    """(reference cfg, port cfg, reference params, port params)."""
    dtype, pdtype = DTYPES[dt]
    over = dict(dtype=dtype, param_dtype=pdtype, remat=remat)
    jcfg = dataclasses.replace(jconfigs.get(ARCH, smoke=True), **over)
    tcfg = dataclasses.replace(tconfigs.get(ARCH, smoke=True), **over)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def frames(cfg, b, seed=0):
    """(jax, torch) copies of one numpy draw of frame embeddings."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)
    return jnp.asarray(x), torch.tensor(x)


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def batch(cfg, b=2, s=8, seed=0, mask=False):
    """A training batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"inputs": rng.standard_normal(
               (b, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32),
           "decoder_tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                          ).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    return out


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def port_cross(x):
    """The reference's (L, B, T, KV, hd) cross K/V in the port's layout."""
    return np.swapaxes(np.asarray(x, np.float32), 2, 3)


# ---------------------------------------------------------------------------
# configs, parameters, layers
# ---------------------------------------------------------------------------


def test_configs_params_and_shapes_match_reference():
    for smoke in (False, True):
        got, want = tconfigs.get(ARCH, smoke=smoke), jconfigs.get(
            ARCH, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_params() == want.n_params()
    assert tconfigs.get(ARCH).n_params() == 1_603_409_920
    jcfg, tcfg, jp, tp = models()
    p = init_params(tcfg, seed=1, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in _tree.items(p)}
    assert shapes == {k: tuple(v.shape) for k, v in _tree.items(tp)}
    assert {k.replace("/", "."): s for k, s in shapes.items()} == \
        param_shapes(tcfg)
    assert set(p["enc_layers"][0]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(p["layers"][0]) == {"ln1", "self_attn", "ln2", "cross_attn",
                                   "ln3", "mlp"}
    assert len(p["enc_layers"]) == tcfg.n_encoder_layers
    assert attention_layers(tcfg) == list(range(tcfg.n_layers))
    check_trainable(tcfg)


def test_params_from_numpy_checks_whisper_shapes():
    jcfg, tcfg, jp, _ = models()
    tree = jax.tree.map(np.asarray, jp)
    tree["enc_layers"]["attn"]["wq"] = tree["enc_layers"]["attn"]["wq"][:, :3]
    with pytest.raises(ValueError, match="enc_layers.0.attn.wq"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_decoder_only_backbone_refuses_whisper():
    _, tcfg, _, tp = models()
    with pytest.raises(ValueError, match="whisper.decoder"):
        backbone(tp, tcfg, torch.zeros(1, 2, tcfg.d_model),
                 torch.zeros(1, 2, dtype=torch.long))


@pytest.mark.parametrize("t,d", [(16, 64), (1500, 1280)])
def test_sinusoidal_positions_match_reference(t, d):
    """Within 1e-5 at the SMOKE encoder's 16 frames; at the full 1500, the
    angles reach ~1500 rad, whose float32 ulp (1.2e-4) the two hosts'
    exp and products may round apart: within two ulps of the largest
    angle there."""
    got = tlayers.sinusoidal_positions(t, d)
    want = np.asarray(jlayers.sinusoidal_positions(t, d))
    assert got.dtype == torch.float32 and got.shape == (t, d)
    atol = max(1e-5, 2 * float(np.spacing(np.float32(t - 1))))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_logits_fn_ties_the_head_only_to_token_inputs():
    """The reference reads the embedding table for the logits only where
    the inputs are tokens (an embeddings front end has no table)."""
    base = dataclasses.replace(tconfigs.get("qwen3-8b", smoke=True),
                               tie_embeddings=True, dtype="float32")
    jbase = dataclasses.replace(jconfigs.get("qwen3-8b", smoke=True),
                                tie_embeddings=True, dtype="float32")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, base.d_model), dtype=np.float32)
    table = rng.standard_normal((base.vocab_size, base.d_model),
                                dtype=np.float32)
    head = rng.standard_normal((base.d_model, base.vocab_size),
                               dtype=np.float32)
    params = {"embedding": {"table": table}, "lm_head": {"w": head}}
    for mode in ("tokens", "embeddings"):
        tcfg = dataclasses.replace(base, input_mode=mode)
        jcfg = dataclasses.replace(jbase, input_mode=mode)
        got = tlayers.logits_fn(_tree.tree_map(torch.tensor, params), tcfg,
                                torch.tensor(x))
        close(got, jlayers.logits_fn(jax.tree.map(jnp.asarray, params), jcfg,
                                     jnp.asarray(x)), "float32", mode)
        want_head = tlayers.init_lm_head(
            tcfg, generator=torch.Generator().manual_seed(0))
        assert set(want_head) == set(jlayers.init_lm_head(
            jax.random.key(0), jcfg))
        assert tlayers.tied_head(tcfg) == (mode == "tokens")


# ---------------------------------------------------------------------------
# encoder, cross-attention, forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_encode_matches_reference(dt):
    jcfg, tcfg, jp, tp = models(dt)
    jx, tx = frames(tcfg, 2, seed=1)
    want = reference(lambda p, x: jwhisper.encode(p, jcfg, x), jcfg.dtype)(
        jp, jx)
    got = twhisper.encode(tp, tcfg, tx)
    assert got.dtype == torch_dtype(tcfg.dtype)
    close(got, want, tcfg.dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_matches_reference(dt, s):
    jcfg, tcfg, jp, tp = models(dt)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s, tcfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, tcfg.encoder_seq_len, tcfg.d_model),
                              dtype=np.float32)
    jx, jenc = (jnp.asarray(a).astype(jcfg.dtype) for a in (x, enc))
    tx, tenc = (torch.tensor(np.asarray(a, np.float32)).to(
        torch_dtype(tcfg.dtype)) for a in (jx, jenc))
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["cross_attn"])
    want = reference(lambda p, a, e: jwhisper._cross_attention(p, jcfg, a, e),
                     jcfg.dtype)(jl, jx, jenc)
    got = twhisper.cross_attention(tp["layers"][1]["cross_attn"], tcfg, tx,
                                   tenc)
    close(got, want, tcfg.dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_precompute_cross_kv_matches_reference(dt):
    jcfg, tcfg, jp, tp = models(dt)
    jx, tx = frames(tcfg, 3, seed=3)
    jenc = jwhisper.encode(jp, jcfg, jx)
    tenc = torch.tensor(np.asarray(jenc, np.float32)).to(
        torch_dtype(tcfg.dtype))
    jk, jv = reference(lambda p, e: jwhisper.precompute_cross_kv(p, jcfg, e),
                       jcfg.dtype)(jp, jenc)
    tk, tv = twhisper.precompute_cross_kv(tp, tcfg, tenc)
    shape = (tcfg.n_layers, 3, tcfg.n_kv_heads, tcfg.encoder_seq_len,
             tcfg.head_dim)
    assert tk.shape == tv.shape == shape
    close(tk, port_cross(jk), tcfg.dtype)
    close(tv, port_cross(jv), tcfg.dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mask", [False, True])
def test_forward_loss_matches_reference(dt, mask):
    jcfg, tcfg, jp, tp = models(dt)
    b = batch(tcfg, seed=4, mask=mask)
    jloss, jm = reference(lambda p, bt: j_forward(p, jcfg, bt), jcfg.dtype)(
        jp, as_jax(b))
    loss, m = forward(tp, tcfg, as_torch(b))
    t = tol(tcfg.dtype)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=t, atol=t)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=t,
                               atol=t)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_logits_match_reference(dt):
    jcfg, tcfg, jp, tp = models(dt)
    b = batch(tcfg, b=3, s=7, seed=5)
    b = {k: b[k] for k in ("inputs", "decoder_tokens")}
    want = reference(j_prefill(jcfg), jcfg.dtype)(jp, as_jax(b))
    got = make_prefill_step(tcfg, "cpu")(tp, b)
    assert got.shape == (3, tcfg.vocab_size)
    close(got, want, tcfg.dtype)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _reference_state(jp, jcfg, jx, b, max_len):
    enc = jwhisper.encode(jp, jcfg, jx)
    ck, cv = jwhisper.precompute_cross_kv(jp, jcfg, enc)
    return dict(j_init_state(jcfg, b, max_len), cross_k=ck, cross_v=cv)


def _port_state(tp, tcfg, tx, b, max_len):
    enc = twhisper.encode(tp, tcfg, tx)
    ck, cv = twhisper.precompute_cross_kv(tp, tcfg, enc)
    return dict(init_decode_state(tcfg, b, max_len, "cpu"), cross_k=ck,
                cross_v=cv)


def test_decode_state_layout():
    _, tcfg, _, _ = models()
    st = init_decode_state(tcfg, 3, 10, device="cpu")
    kv, hd, t = tcfg.n_kv_heads, tcfg.head_dim, tcfg.encoder_seq_len
    assert st["kv"]["k"].shape == (tcfg.n_layers, 3, kv, 10, hd)
    assert st["cross_k"].shape == st["cross_v"].shape == (
        tcfg.n_layers, 3, kv, t, hd)
    assert st["cross_len"].dtype == torch.int32
    assert int(st["cross_len"]) == t - 1 and int(st["cache_len"]) == 0


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_serve_steps_match_reference(dt):
    """Four steps from the encoded frames: logits, both caches and
    ``cache_len`` after each (the cross K/V unchanged by a step)."""
    jcfg, tcfg, jp, tp = models(dt)
    b, max_len = 2, 6
    jx, tx = frames(tcfg, b, seed=6)
    step = reference(lambda p, s, bt: j_serve_step(p, jcfg, s, bt),
                     jcfg.dtype)
    jst = reference(lambda p, x: _reference_state(p, jcfg, x, b, max_len),
                    jcfg.dtype)(jp, jx)
    tst = _port_state(tp, tcfg, tx, b, max_len)
    tstep = make_serve_step(tcfg, "cpu")
    toks = tokens(tcfg, b, 4, seed=6)
    for i in range(4):
        jl, jst = step(jp, jst, {"inputs": jnp.asarray(toks[:, i])})
        tl, tst = tstep(tp, tst, {"inputs": toks[:, i]})
        close(tl, jl, tcfg.dtype, f"step {i} logits")
        assert int(tst["cache_len"]) == int(jst["cache_len"]) == i + 1
        for name in ("k", "v"):
            close(tst["kv"][name], jst["kv"][name], tcfg.dtype,
                  f"step {i} kv {name}")
        for name in ("cross_k", "cross_v"):
            close(tst[name], port_cross(jst[name]), tcfg.dtype,
                  f"step {i} {name}")


def test_decode_matches_teacher_forced_forward():
    """Feeding the decoder token by token through the caches gives the
    teacher-forced logits at every position (the reference's
    ``test_decode_matches_forward_dense``, f32, within 2e-2), and the
    port's teacher-forced logits equal the reference's within 1e-5."""
    jcfg, tcfg, jp, tp = models("f32")
    b, s = 2, 9
    jx, tx = frames(tcfg, b, seed=7)
    toks = tokens(tcfg, b, s, seed=7)
    jenc = jwhisper.encode(jp, jcfg, jx)
    with torch.no_grad():
        enc = twhisper.encode(tp, tcfg, tx)
        full = tlayers.logits_fn(tp, tcfg, twhisper.decoder(
            tp, tcfg, enc, torch.tensor(toks)))
        st = _port_state(tp, tcfg, tx, b, s)
        outs = []
        for t in range(s):
            lg, st = serve_step(tp, tcfg, st, {"inputs": torch.tensor(
                toks[:, t])})
            outs.append(lg)
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-2,
                               rtol=2e-2)

    def j_full(p, e, tk):
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        x = jwhisper._dec_embed(p, jcfg, tk, pos)
        from repro.models.attention import attention_block
        from repro.models.layers import apply_mlp, apply_norm
        for i in range(jcfg.n_layers):
            lp = jax.tree.map(lambda a: a[i], p["layers"])
            h = apply_norm(lp["ln1"], jcfg, x)
            x = x + attention_block(lp["self_attn"], jcfg, h, pos)
            h = apply_norm(lp["ln2"], jcfg, x)
            x = x + jwhisper._cross_attention(lp["cross_attn"], jcfg, h, e)
            h = apply_norm(lp["ln3"], jcfg, x)
            x = x + apply_mlp(lp["mlp"], jcfg, h)
        x = apply_norm(p["final_norm"], jcfg, x)
        return jlayers.logits_fn(p, jcfg, x)

    close(full, jax.jit(j_full)(jp, jenc, jnp.asarray(toks)), "float32")
    # greedy tokens from the decode logits: exact, as integers
    assert torch.equal(dec.argmax(-1),
                       torch.tensor(np.asarray(jnp.argmax(
                           jax.jit(j_full)(jp, jenc, jnp.asarray(toks)),
                           -1))))


def test_decode_positions_clip_to_the_table():
    """At ``cache_len`` past 447 the learned position clips to 447 (RoPE
    takes the position unclipped), as in the reference."""
    jcfg, tcfg, jp, tp = models("f32")
    b = 2
    jx, tx = frames(tcfg, b, seed=8)
    jst = _reference_state(jp, jcfg, jx, b, 4)
    tst = _port_state(tp, tcfg, tx, b, 4)
    jst = dict(jst, cache_len=jnp.int32(500))
    tst = dict(tst, cache_len=torch.tensor(500, dtype=torch.int32))
    toks = tokens(tcfg, b, 1, seed=8)[:, 0]
    jl, _ = jax.jit(lambda p, s, bt: j_serve_step(p, jcfg, s, bt))(
        jp, jst, {"inputs": jnp.asarray(toks)})
    tl, tst = serve_step(tp, tcfg, tst, {"inputs": torch.tensor(toks)})
    close(tl, jl, "float32")
    assert int(tst["cache_len"]) == 501


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _grad_close(got, want, tol, what):
    """Leaf by leaf: within ``tol`` absolute, and within ``tol`` (float32:
    1e-4) of the leaf's largest magnitude (``test_torch_train.py``)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= max(tol, 1e-4 * scale if tol < 1e-4 else tol * scale), \
        f"{what}: max abs err {err} (largest {scale})"


def _as_port(jtree, tcfg):
    return dict(_tree.items(params_from_numpy(
        jax.tree.map(np.asarray, jtree), tcfg, device="cpu")))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(dtype, remat):
    dt = "f32" if dtype == "float32" else "bf16"
    jcfg, tcfg, jp, tp = models(dt, remat)
    b = batch(tcfg, seed=9, mask=True)
    (jloss, _), jg = reference(jax.value_and_grad(
        lambda p, bt: j_forward(p, jcfg, bt), has_aux=True), dtype)(
            jp, as_jax(b))
    leaves = dict(_tree.items(tp))
    trainable = {k: p.clone().requires_grad_(True) for k, p in leaves.items()}
    loss, _ = forward(_tree.unflatten(tp, trainable), tcfg, as_torch(b))
    grads = dict(zip(trainable, torch.autograd.grad(
        loss, list(trainable.values()))))
    t = tol(dtype)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=t,
                               atol=t)
    want = _as_port(jg, tcfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.shape == want[name].shape
        _grad_close(g, want[name].numpy(), t, f"{dtype} remat={remat} {name}")
    assert all(float(g.abs().max()) > 0 for name, g in grads.items()
               if name.endswith(("wq", "wk", "wv", "adapter")))


def test_remat_gives_the_same_gradients():
    out = []
    for remat in (False, True):
        _, tcfg, _, tp = models("bf16", remat)
        trainable = {k: p.clone().requires_grad_(True)
                     for k, p in _tree.items(tp)}
        loss, _ = forward(_tree.unflatten(tp, trainable), tcfg,
                          as_torch(batch(tcfg, seed=10)))
        out.append(torch.autograd.grad(loss, list(trainable.values())))
    assert all(torch.equal(a, b) for a, b in zip(*out))


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _rel_close(got, want, what, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


@pytest.mark.parametrize("eps,param_tol", [(1e-8, 5e-5), (1e-6, 1e-5)])
def test_three_train_steps_match_reference(eps, param_tol):
    """Three jitted reference steps against three port steps from the
    same weights and batches (``test_torch_train.py``'s test on
    whisper): metrics, every parameter and both moments after each step,
    and the step count."""
    jcfg, tcfg, jp, tp = models("f32")
    opt = dict(OPT, eps=eps)
    jstep = jax.jit(j_train_step(jcfg, JAdamWConfig(**opt)))
    tstep = make_train_step(tcfg, AdamWConfig(**opt), device="cpu")
    jst, tst = j_adamw_init(jp), adamw_init(tp)
    for i in range(3):
        b = batch(tcfg, seed=20 + i)
        jp, jst, jm = jstep(jp, jst, as_jax(b))
        tp, tst, tm = tstep(tp, tst, b)
        assert set(tm) == set(jm)
        for k in jm:
            _rel_close(tm[k], jm[k], f"step {i} {k}")
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        for name, tree, jtree in (("params", tp, jp), ("mu", tst["mu"],
                                                       jst["mu"]),
                                  ("nu", tst["nu"], jst["nu"])):
            want = _as_port(jtree, tcfg)
            got = dict(_tree.items(tree))
            assert set(got) == set(want)
            for k, t in got.items():
                _rel_close(t.numpy(), want[k].numpy(),
                           f"step {i} {name} {k}",
                           param_tol if name == "params" else 1e-5)
    # the reference's optimizer state carried across resumes the same
    st = opt_state_from_numpy(jax.tree.map(np.asarray, jst), tcfg, "cpu")
    assert int(st["step"]) == 3
    for name in ("mu", "nu"):
        mine = dict(_tree.items(tst[name]))
        for k, t in _tree.items(st[name]):
            _rel_close(mine[k].numpy(), t.numpy(), f"{name} {k} carried")


def test_donated_train_step_equals_the_kept_step():
    _, tcfg, _, tp = models("bf16", True)
    b = batch(tcfg, seed=30)
    kept = make_train_step(tcfg, AdamWConfig(**OPT), device="cpu")(
        tp, adamw_init(tp), b)
    mine = _tree.tree_map(torch.clone, tp)
    st = adamw_init(mine)
    donated = make_train_step(tcfg, AdamWConfig(**OPT), device="cpu",
                              donate=True)(mine, st, b)
    for x, y in zip(_tree.leaves(kept[0]), _tree.leaves(donated[0])):
        assert torch.equal(x, y)
    assert donated[0]["layers"][0]["mlp"]["wi"] is mine["layers"][0]["mlp"][
        "wi"]


# ---------------------------------------------------------------------------
# the reference's own smoke cases (tests/test_arch_smoke.py) on the port
# ---------------------------------------------------------------------------


def test_train_step_smoke():
    cfg = tconfigs.get(ARCH, smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    b = batch(cfg, b=2, s=16, seed=1)
    trainable = {k: p.clone().requires_grad_(True)
                 for k, p in _tree.items(params)}
    loss, metrics = forward(_tree.unflatten(params, trainable), cfg,
                            as_torch(b))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    assert np.isfinite(float(loss.detach()))
    assert 0.2 * np.log(cfg.vocab_size) < float(metrics["ce"]) \
        < 3.0 * np.log(cfg.vocab_size)
    gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    assert np.isfinite(gnorm) and gnorm > 0.0


def test_serve_step_smoke():
    cfg = tconfigs.get(ARCH, smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    batch_size, max_len = 2, 32
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (batch_size, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32))
    state = _port_state(params, cfg, x, batch_size, max_len)
    step = make_serve_step(cfg, "cpu")
    for i in range(2):
        logits, state = step(params, state, {"inputs": torch.full(
            (batch_size,), 5 + i, dtype=torch.int32)})
        assert logits.shape == (batch_size, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
    assert int(state["cache_len"]) == 2


def test_decoder_only_embeddings_front_end_still_refused():
    """No longer refused (ported with qwen2-vl): a decoder-only model with
    ``input_mode="embeddings"`` draws the reference's (d, d) adapter, not
    whisper's encoder, and its prefill over (B, S, d) embeddings gives the
    reference's logits (float32, within 1e-5)."""
    over = dict(input_mode="embeddings", dtype="float32",
                param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get("qwen3-8b", smoke=True), **over)
    jcfg = dataclasses.replace(jconfigs.get("qwen3-8b", smoke=True), **over)
    assert set(init_params(tcfg, device="cpu")) == {
        "embedding", "layers", "final_norm", "lm_head"}
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert set(tp["embedding"]) == {"adapter"}
    x = np.random.default_rng(0).standard_normal((2, 8, tcfg.d_model),
                                                 dtype=np.float32)
    got = make_prefill_step(tcfg, "cpu")(tp, {"inputs": x})
    want = jax.jit(j_prefill(jcfg))(jp, {"inputs": jnp.asarray(x)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# chip_smoke's path O: what runs on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_chip_whisper_rows_carry_every_key_and_o_launches(chip_smoke):
    """Path O's kernel rows: every key the ``{"kernels": ...}`` line
    needs, the launches of O1-O3 by part, and the merge into the full
    run's rows."""
    case = dict(max_abs_err=1e-3, ms=0.3, plain_ms=4.0, bound_ms=0.1,
                bound_by="operations", library_ms=0.25, wrapper_ms=0.4)
    o0 = {k: dict(case) for k in ("fwd_encoder", "fwd_cross", "fwd_self",
                                  "bwd_encoder", "bwd_cross", "bwd_self",
                                  "decode_cross", "decode_self")}
    launches = {"O1": {"O1": 96}, "O2": {"O2_encode": 32, "O2": 16384},
                "O3": {"flash_attention_fwd": 768,
                       "flash_attention_bwd": 384}}
    rows = chip_smoke.whisper_rows(o0, launches)
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    assert all(keys <= set(r) for r in rows)
    assert [(r["name"], r["launches"]) for r in rows] == [
        ("flash_attention", 96 + 32 + 768), ("flash_attention_bwd", 384),
        ("decode_attention", 16384)]
    partial = chip_smoke.whisper_rows(o0, {"O1": {"O1": 96}})
    assert [r["launches"] for r in partial] == [96, 0, 0]
    full = [dict(name=r["name"], launches=10, launches_by_path={"D1": 10},
                 max_abs_err=0.0) for r in rows]
    chip_smoke.merge_whisper_rows(full, rows)
    assert [k["launches"] for k in full] == [906, 394, 16394]
    assert full[0]["launches_by_path"] == {"D1": 10, "O1": 96, "O2": 32,
                                           "O3": 768}
    assert all(k["max_abs_err"] == 1e-3 and "whisper" in k for k in full)


def test_chip_whisper_step_bytes(chip_smoke):
    """The bytes a decode step must move: the decoder's weights but the
    cross wk and wv, the head, the filled self K/V, all the cross K/V."""
    _, tcfg, _, tp = models("bf16-params")
    st = init_decode_state(tcfg, 2, 8, "cpu")
    got = chip_smoke.whisper_step_bytes(tcfg, tp, st, 3)
    d, h, hd, f = tcfg.d_model, tcfg.n_heads, tcfg.head_dim, tcfg.d_ff
    layer = 6 * d * h * hd + 2 * d * f + 6 * d
    assert got["weights"] == 2 * (tcfg.n_layers * layer + 2 * d
                                  + d * tcfg.vocab_size)
    assert got["kv"] == 2 * 2 * tcfg.n_layers * 2 * tcfg.n_kv_heads * 4 * hd
    assert got["cross_kv"] == 2 * 2 * tcfg.n_layers * 2 * tcfg.n_kv_heads \
        * tcfg.encoder_seq_len * hd

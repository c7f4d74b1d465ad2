"""The port's dense LLM against the JAX reference: configs, layers,
attention and the prefill.

The reference's weights (``repro.models.init_params``) are carried across
with ``convert.params_from_numpy``; the same numpy token ids and
activations enter both packages. Smoke configs of qwen3 (GQA, qk-norm),
olmo (MHA, non-parametric LayerNorm, tied embeddings), granite (GQA,
d_ff 160) and deepseek (GQA, 3 layers, d_ff 160). Tolerances: ``atol =
rtol = 1e-5`` where the compute dtype is float32, ``5e-2`` in bfloat16
(the reference's own jnp and Pallas prefills differ by 2 bf16 ulps
there). The port's attention runs the kernels' plain versions on the
CPU; the reference runs both of its paths (``use_pallas`` True: its
Pallas kernel in interpret mode).
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch._tree import items as _tree_items  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_train_step)
from repro_torch.models import (NotPortedError, init_decode_state,  # noqa: E402
                                init_params)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

ARCHS = ("qwen3-8b", "olmo-1b", "granite-3-8b", "deepseek-67b")
#: archs whose layers are not [attention + MLP]; the family-agnostic
#: tests take them too (``tests/test_torch_rwkv.py``,
#: ``test_torch_moe.py``, ``test_torch_hybrid.py``,
#: ``test_torch_whisper.py`` and ``test_torch_vlm.py`` hold the rest)
OTHER_ARCHS = ("rwkv6-3b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
               "jamba-v0.1-52b", "whisper-large-v3", "qwen2-vl-72b")
#: compute dtype, parameter dtype
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32"),
          "bf16-params": ("bfloat16", "bfloat16")}


def tol(dtype):
    return 1e-5 if dtype == "float32" else 5e-2


def close(got, want, dtype):
    t = tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=t, rtol=t)


@functools.lru_cache(maxsize=None)
def models(arch, dt="f32"):
    """(reference cfg, port cfg, reference params, port params)."""
    dtype, pdtype = DTYPES[dt]
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), dtype=dtype,
                               param_dtype=pdtype)
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), dtype=dtype,
                               param_dtype=pdtype)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def activations(cfg, shape, seed=0):
    """(jax, torch) copies of one numpy draw in the compute dtype."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jx = jnp.asarray(x).astype(cfg.dtype)
    return jx, torch.tensor(np.asarray(jx, np.float32)).to(
        torch_dtype(cfg.dtype))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + OTHER_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference_field_for_field(arch, smoke):
    want = jconfigs.get(arch, smoke=smoke)
    got = tconfigs.get(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim


def test_arch_list_and_unported_archs():
    """Every arch of the reference is ported; an unknown id is a
    KeyError, an id outside ``PORTED`` a NotPortedError."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert set(jconfigs.list_archs()) == set(ARCHS + OTHER_ARCHS)
    for arch in jconfigs.list_archs():
        assert tconfigs.get(arch).name == jconfigs.get(arch).name
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")
    ported = tconfigs.PORTED
    try:
        tconfigs.PORTED = tuple(m for m in ported if m != "deepseek_67b")
        with pytest.raises(NotPortedError, match="not yet ported"):
            tconfigs.get("deepseek-67b")
    finally:
        tconfigs.PORTED = ported


@pytest.mark.parametrize("arch", ARCHS + OTHER_ARCHS)
def test_param_count_and_shapes_match_reference(arch):
    jcfg, tcfg, jp, tp = models(arch)
    assert tconfigs.get(arch).n_params() == jconfigs.get(arch).n_params()
    assert tcfg.n_params() == jcfg.n_params()
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    ref = {}
    period = tcfg.attn_layer_period
    for path, leaf in flat.items():
        name = ".".join(k.key for k in path)
        if name.startswith("layers.sub"):
            # a hybrid period's sub{j}.* stacked over periods: the port's
            # layer p * period + j
            j, rest = name[len("layers.sub"):].split(".", 1)
            for p in range(tcfg.n_layers // period):
                ref[f"layers.{p * period + int(j)}.{rest}"] = tuple(
                    leaf.shape[1:])
        elif name.startswith("enc_layers."):
            for i in range(tcfg.n_encoder_layers):
                ref["enc_layers." + str(i) + name[10:]] = tuple(
                    leaf.shape[1:])
        elif name.startswith("layers."):
            for i in range(tcfg.n_layers):
                ref["layers." + str(i) + name[6:]] = tuple(leaf.shape[1:])
        else:
            ref[name] = tuple(leaf.shape)
    assert param_shapes(tcfg) == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_truncated_scaled_normals(arch):
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              param_dtype="bfloat16")
    p = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    wq = p["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert torch.equal(wq, again["layers"][1]["attn"]["wq"])
    for w, fan_in in ((p["embedding"]["table"], cfg.d_model),
                      (p["layers"][0]["ffn"]["wo"], cfg.d_ff)):
        x = w.float() * fan_in ** 0.5
        assert float(x.abs().max()) <= 3.0 + 1e-2
        # a normal truncated at 3 sigma has std 0.9866
        assert abs(float(x.std()) - 0.9866) < 0.05
    assert set(p["layers"][0]) == {"ln1", "attn", "ln2", "ffn"}


@pytest.mark.parametrize("opt", [
    dict(moe=True, n_experts=4, experts_per_token=2, decode_tail_window=4),
    dict(rwkv=True, wkv_impl="kernel_stub"), dict(mrope_sections=(2, 3, 3)),
    dict(encoder_decoder=True, n_encoder_layers=2, encoder_seq_len=16),
    dict(input_mode="embeddings"), dict(decode_tail_window=4),
], ids=("moe_tailed", "rwkv", "mrope", "encoder_decoder", "embeddings",
        "tailed"))
def test_unported_options_raise(opt):
    """RWKV's ``wkv_impl="kernel_stub"`` (the dry run's roofline stand-in)
    is the one option the port still refuses.  The others, ported since
    (``encoder_decoder`` with whisper; M-RoPE, the embeddings front end
    and the tailed decode with qwen2-vl and deepseek), draw the
    reference's tree: every parameter's shape as the reference's
    ``init_params`` of the same config, and every decode-state leaf's
    shape and dtype as its ``init_decode_state`` (the tail's too)."""
    cfg = dataclasses.replace(tconfigs.get("qwen3-8b", smoke=True), **opt)
    if cfg.rwkv:
        with pytest.raises(NotPortedError, match="not yet ported"):
            init_params(cfg, device="cpu")
        return
    jcfg = dataclasses.replace(jconfigs.get("qwen3-8b", smoke=True), **opt)
    want = jax.eval_shape(lambda k: j_init_params(k, jcfg),
                          jax.random.key(0))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), want)
    want = params_from_numpy(zeros, cfg, device="cpu")
    got = init_params(cfg, device="cpu")
    assert ({k: tuple(v.shape) for k, v in _tree_items(got)}
            == {k: tuple(v.shape) for k, v in _tree_items(want)})
    if cfg.encoder_decoder:
        return
    jstate = jax.eval_shape(lambda: j_init_state(jcfg, 2, 8))
    state = init_decode_state(cfg, 2, 8, device="cpu")
    assert ({k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for k, v in _tree_items(state)}
            == {k: (tuple(v.shape), str(v.dtype))
                for k, v in _tree_items(jstate)})
    assert ("tail" in state) == (cfg.decode_tail_window > 0)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_train_step_refuses_moe_and_hybrid(arch, smoke):
    """The port serves the MoE and hybrid families but does not train
    them yet: ``make_train_step`` (through ``check_trainable``) raises
    before it touches a device."""
    cfg = tconfigs.get(arch, smoke=smoke)
    with pytest.raises(NotPortedError, match="not yet ported"):
        make_train_step(cfg, AdamWConfig(), device="cpu")
    init_params(tconfigs.get(arch, smoke=True), device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm",
                                       "nonparametric_ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(norm_type, dtype):
    jcfg = dataclasses.replace(jconfigs.get("qwen3-8b", smoke=True),
                               norm_type=norm_type, dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get("qwen3-8b", smoke=True),
                               norm_type=norm_type, dtype=dtype)
    rng = np.random.default_rng(1)
    jx, tx = activations(jcfg, (2, 5, 64), seed=1)
    p = {k: rng.standard_normal(64, dtype=np.float32)
         for k in jlayers.init_norm(None, jcfg)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    close(tlayers.apply_norm(tp, tcfg, tx), jlayers.apply_norm(jp, jcfg, jx),
          dtype)
    jh, th = activations(jcfg, (2, 5, 4, 16), seed=2)
    scale = rng.standard_normal(16, dtype=np.float32)
    close(tlayers.rms_norm_headwise(th, torch.tensor(scale)),
          jlayers.rms_norm_headwise(jh, jnp.asarray(scale)), dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hd", [16, 128])
def test_rope_matches_reference(arch, hd):
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), d_head=hd,
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), d_head=hd,
                               dtype="float32")
    # float32 pow on the two hosts: within 1 ulp (XLA's pow and the C
    # library's round 1 of the 64 qwen3 frequencies differently)
    np.testing.assert_array_max_ulp(tlayers.rope_freqs(tcfg).numpy(),
                                    np.asarray(jlayers.rope_freqs(jcfg)), 1)
    jx, tx = activations(jcfg, (2, 6, 3, hd), seed=3)
    pos = np.stack([np.arange(6), np.arange(1000, 1006)]).astype(np.int32)
    close(tlayers.apply_rope(tx, torch.tensor(pos), tcfg),
          jlayers.apply_rope(jx, jnp.asarray(pos), jcfg), "float32")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_matches_reference(arch, gated, dt):
    jcfg, tcfg, jp, tp = models(arch, dt)
    jcfg = dataclasses.replace(jcfg, gated_mlp=gated)
    tcfg = dataclasses.replace(tcfg, gated_mlp=gated)
    jx, tx = activations(jcfg, (2, 5, jcfg.d_model), seed=4)
    jf = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    close(tlayers.apply_mlp(tp["layers"][0]["ffn"], tcfg, tx),
          jlayers.apply_mlp(jf, jcfg, jx), jcfg.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_attention_block_matches_reference(arch, dt, use_pallas):
    jcfg, tcfg, jp, tp = models(arch, dt)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    jx, tx = activations(jcfg, (2, 12, jcfg.d_model), seed=5)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    ja = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    want = jax.jit(lambda p, x: jattn.attention_block(
        p, jcfg, x, jnp.asarray(pos)))(ja, jx)
    got = tattn.attention_block(tp["layers"][1]["attn"], tcfg, tx,
                                torch.tensor(pos))
    close(got, want, jcfg.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_attention_matches_reference(arch):
    """Four decode steps of one layer: outputs and the cache contents."""
    jcfg, tcfg, jp, tp = models(arch)
    b, s = 2, 8
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jk = jnp.zeros((b, jcfg.n_kv_heads, s, jcfg.head_dim), jnp.float32)
    jv = jk
    tk = torch.zeros(tuple(jk.shape))
    tv = torch.zeros(tuple(jk.shape))
    step = jax.jit(lambda p, x, k, v, n, pos: jattn.decode_attention(
        p, jcfg, x, k, v, n, pos))
    for t in range(4):
        jx, tx = activations(jcfg, (b, 1, jcfg.d_model), seed=10 + t)
        pos = np.full((b, 1), t, np.int32)
        jy, jk, jv = step(ja, jx, jk, jv, jnp.int32(t), jnp.asarray(pos))
        ty, tk2, tv2 = tattn.decode_attention(
            tp["layers"][0]["attn"], tcfg, tx, tk, tv,
            torch.tensor(t, dtype=torch.int32), torch.tensor(pos))
        assert tk2 is tk and tv2 is tv          # written in place
        close(ty, jy, "float32")
        close(tk, jk, "float32")
        close(tv, jv, "float32")
    assert not tk[:, :, 4:].any()


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_logits_match_reference(arch, dt):
    jcfg, tcfg, jp, tp = models(arch, dt)
    toks = tokens(jcfg, 2, 16, seed=6)
    got = make_prefill_step(tcfg, device="cpu")(tp, {"inputs": toks})
    assert got.shape == (2, jcfg.vocab_size) and got.dtype == tcfg.adtype
    for use_pallas in (True, False):
        cfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
        want = jax.jit(j_prefill(cfg))(jp, {"inputs": jnp.asarray(toks)})
        close(got, want, jcfg.dtype)

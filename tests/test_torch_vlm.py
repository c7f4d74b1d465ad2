"""The port's VLM (qwen2-vl: the decoder-only embeddings front end and
M-RoPE) against the JAX reference, and deepseek-67b's training step.

M-RoPE is held with three really different streams: the image-grid
layout of ``chip_smoke.mrope_positions`` (a text prefix, one image whose
patches read t = const, h = row, w = col, and text resuming after the
image's largest stream), beside the reference's own t = h = w case
(``tests/test_arch_smoke.py``).  A section map off by one slot passes any
test with t = h = w; only the grid shows it.  The reference's weights
come across with ``convert.params_from_numpy`` (the adapter's shape
checked); the same numpy embeddings and positions enter both packages.
Tolerances: ``1e-6`` for the rotation alone, ``1e-5`` in float32 and
``5e-2`` in bfloat16 for the model.
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
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, make_train_step)
from repro_torch.models import (forward, init_decode_state,  # noqa: E402
                                init_params)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

VLM = "qwen2-vl-72b"
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32")}
#: SMOKE layouts: the image grid (3 text, a 2 x 3 image, 4 text) and text
#: only (t = h = w), 13 positions each
LAYOUTS = ("grid", "text")


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


chip_smoke = _chip_smoke()


def tol(dtype):
    return 1e-5 if dtype == "float32" else 5e-2


def close(got, want, dtype, msg=""):
    t = tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=t, rtol=t,
                               err_msg=msg)


def positions(layout, b=2):
    """(3, B, 13) int32 numpy positions."""
    if layout == "grid":
        pos = chip_smoke.mrope_positions(b, 3, (2, 3), 4)
    else:
        pos = np.tile(np.arange(13), (3, b, 1))
    return np.ascontiguousarray(pos, np.int32)


@functools.lru_cache(maxsize=None)
def models(arch=VLM, dt="f32"):
    """(reference cfg, port cfg, reference params, port params)."""
    dtype, pdtype = DTYPES[dt]
    jcfg, tcfg = (dataclasses.replace(m.get(arch, smoke=True), dtype=dtype,
                                      param_dtype=pdtype)
                  for m in (jconfigs, tconfigs))
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def embeddings(cfg, shape, seed=0):
    """Standard-normal patch and text embeddings, f32 numpy (both packages
    cast them to the activation dtype themselves)."""
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def labels(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


def test_mrope_positions_lay_out_the_image_grid():
    """Path P's layout: 64 text, 24 x 32 patches (t 64, h 64 + row, w 64 +
    col), 192 text from 96; the three streams differ on the image only."""
    pos = chip_smoke.mrope_positions(3, 64, (24, 32), 192)
    assert pos.shape == (3, 3, 1024) and pos.dtype == np.int64
    t, h, w = pos[:, 1]
    np.testing.assert_array_equal(t[:64], np.arange(64))
    assert (t[:64] == h[:64]).all() and (h[:64] == w[:64]).all()
    assert (t[64:832] == 64).all()
    np.testing.assert_array_equal(h[64:832], 64 + np.arange(768) // 32)
    np.testing.assert_array_equal(w[64:832], 64 + np.arange(768) % 32)
    assert h[831] == 64 + 23 and w[831] == 64 + 31
    np.testing.assert_array_equal(t[832:], 96 + np.arange(192))
    assert (t[832:] == h[832:]).all() and (h[832:] == w[832:]).all()
    assert t[-1] == 287 and (pos[:, 0] == pos[:, 2]).all()


def test_section_map_of_the_full_config():
    """(16, 24, 24) over hd / 2 = 64 slots: 0-15 read t, 16-39 h, 40-63
    w."""
    cfg = tconfigs.get(VLM)
    assert cfg.head_dim == 128 and cfg.mrope_sections == (16, 24, 24)
    sec = tlayers._sections(cfg.mrope_sections, "cpu")
    want = np.array([0] * 16 + [1] * 24 + [2] * 24)
    np.testing.assert_array_equal(sec.numpy(), want)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("case", ["grid", "text", "no_sections", "2d"])
def test_rope_tables_match_reference(smoke, case):
    """``rotate(x, rope_tables(pos))`` against the reference's
    ``apply_rope`` in float32, within 1e-6: 3-stream positions with
    sections (the grid and t = h = w), 3-stream positions without sections
    (stream 0) and (B, S) positions with sections (1-D RoPE, a decode
    step's default)."""
    cfg = tconfigs.get(VLM, smoke=smoke)
    jcfg = jconfigs.get(VLM, smoke=smoke)
    if case == "no_sections":
        cfg = dataclasses.replace(cfg, mrope_sections=())
        jcfg = dataclasses.replace(jcfg, mrope_sections=())
    if smoke:
        pos = positions("text" if case == "text" else "grid")
    else:
        pos = chip_smoke.mrope_positions(2, 8, (4, 6), 5).astype(np.int32)
        if case == "text":
            pos = np.ascontiguousarray(np.broadcast_to(pos[0], pos.shape))
    if case == "2d":
        pos = pos[1]          # the h stream alone, as (B, S)
    b, s = pos.shape[-2:]
    x = np.random.default_rng(1).standard_normal(
        (b, s, 3, cfg.head_dim), dtype=np.float32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = tlayers.rotate(torch.tensor(x),
                         tlayers.rope_tables(torch.tensor(pos), cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_grid_positions_rotate_otherwise_than_text_positions():
    """With the image grid the three streams give another rotation than
    stream t alone: the sections are really read."""
    cfg = tconfigs.get(VLM, smoke=True)
    pos = torch.tensor(positions("grid"))
    x = torch.randn(2, 13, 2, cfg.head_dim)
    mrope = tlayers.rotate(x, tlayers.rope_tables(pos, cfg))
    plain = tlayers.rotate(x, tlayers.rope_tables(pos[0], cfg))
    image = slice(3, 9)
    assert not torch.allclose(mrope[:, image], plain[:, image])
    assert torch.equal(mrope[:, :3], plain[:, :3])


# ---------------------------------------------------------------------------
# the embeddings front end
# ---------------------------------------------------------------------------


def test_adapter_draw_and_shapes():
    """The embeddings front end draws a (d, d) adapter and no token table;
    the head is its own (``tie_embeddings`` ties only token models)."""
    cfg = tconfigs.get(VLM, smoke=True)
    p = init_params(cfg, seed=3, device="cpu")
    assert set(p["embedding"]) == {"adapter"}
    assert tuple(p["embedding"]["adapter"].shape) == (cfg.d_model,
                                                      cfg.d_model)
    assert tuple(p["lm_head"]["w"].shape) == (cfg.d_model, cfg.vocab_size)
    x = p["embedding"]["adapter"].float() * cfg.d_model ** 0.5
    assert float(x.abs().max()) <= 3.0 + 1e-2
    with pytest.raises(ValueError, match="embedding.adapter"):
        jcfg, tcfg, jp, _ = models()
        bad = jax.tree.map(np.asarray, jp)
        bad["embedding"]["adapter"] = bad["embedding"]["adapter"][:, :-1]
        params_from_numpy(bad, tcfg, device="cpu")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_embed_inputs_matches_reference(dt):
    jcfg, tcfg, jp, tp = models(dt=dt)
    x = embeddings(jcfg, (2, 5, jcfg.d_model), seed=2)
    want = jlayers.embed_inputs(jp["embedding"], jcfg, jnp.asarray(x))
    got = tlayers.embed_inputs(tp["embedding"], tcfg, torch.tensor(x))
    assert got.dtype == torch_dtype(jcfg.dtype)
    close(got, want, jcfg.dtype)


# ---------------------------------------------------------------------------
# prefill, decode, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_logits_match_reference(layout, dt):
    jcfg, tcfg, jp, tp = models(dt=dt)
    x = embeddings(jcfg, (2, 13, jcfg.d_model), seed=4)
    pos = positions(layout)
    got = make_prefill_step(tcfg, device="cpu")(
        tp, {"inputs": x, "positions": pos})
    assert got.shape == (2, jcfg.vocab_size) and got.dtype == tcfg.adtype
    want = jax.jit(j_prefill(jcfg))(
        jp, {"inputs": jnp.asarray(x), "positions": jnp.asarray(pos)})
    close(got, want, jcfg.dtype)


@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_serve_step_matches_reference(explicit, dt):
    """Six steps of (B, 1, d) embeddings: with explicit (3, B, 1)
    positions continuing a text stream from 20, and with the default
    (``cache_len``, 1-D RoPE): logits, ``cache_len`` and the cache."""
    jcfg, tcfg, jp, tp = models(dt=dt)
    jstep = jax.jit(lambda p, s, b: j_serve_step(p, jcfg, s, b))
    step = make_serve_step(tcfg, device="cpu")
    x = embeddings(jcfg, (2, 6, jcfg.d_model), seed=5)
    jstate = j_init_state(jcfg, 2, 8)
    tstate = init_decode_state(tcfg, 2, 8, device="cpu")
    for t in range(6):
        batch = {"inputs": x[:, t:t + 1]}
        if explicit:
            batch["positions"] = np.full((3, 2, 1), 20 + t, np.int32)
        jl, jstate = jstep(jp, jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        tl, tstate = step(tp, tstate, batch)
        close(tl, jl, jcfg.dtype, f"step {t}")
        assert int(tstate["cache_len"]) == t + 1
    for name in ("k", "v"):
        close(tstate["kv"][name], jstate["kv"][name], jcfg.dtype)


def test_decode_with_text_positions_matches_prefill():
    """The port alone, float32: embeddings fed one by one with their
    positions give the full-sequence logits at every position (t = h =
    w, where a decode step's explicit positions are exact)."""
    _, tcfg, _, tp = models()
    x = embeddings(tcfg, (2, 6, tcfg.d_model), seed=6)
    prefill = make_prefill_step(tcfg, device="cpu")
    step = make_serve_step(tcfg, device="cpu")
    state = init_decode_state(tcfg, 2, 8, device="cpu")
    for t in range(6):
        pos = np.full((3, 2, 1), t, np.int32)
        logits, state = step(tp, state, {"inputs": x[:, t:t + 1],
                                         "positions": pos})
        text = np.tile(np.arange(t + 1, dtype=np.int32), (3, 2, 1))
        full = prefill(tp, {"inputs": x[:, :t + 1], "positions": text})
        close(logits, full.numpy(), "float32", f"position {t}")


def _reference_as_port(jtree, tcfg):
    return dict(_tree.items(params_from_numpy(
        jax.tree.map(np.asarray, jtree), tcfg, device="cpu")))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_forward_loss_and_every_gradient_match_reference(layout, dt):
    jcfg, tcfg, jp, tp = models(dt=dt)
    batch = {"inputs": embeddings(jcfg, (2, 13, jcfg.d_model), seed=7),
             "labels": labels(jcfg, 2, 13, seed=8),
             "positions": positions(layout)}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: j_forward(p, jcfg, bt), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = dict(_tree.items(tp))
    trainable = {k: p.clone().requires_grad_(True) for k, p in leaves.items()}
    loss, metrics = forward(_tree.unflatten(tp, trainable), tcfg,
                            {k: torch.tensor(v) for k, v in batch.items()})
    grads = dict(zip(trainable, torch.autograd.grad(
        loss, list(trainable.values()))))
    t = tol(jcfg.dtype)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=t,
                               atol=t)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jm["ce"]),
                               rtol=t, atol=t)
    want = _reference_as_port(jg, tcfg)
    assert set(grads) == set(want)
    assert f"embedding{_tree.SEP}adapter" in grads
    for name, g in grads.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= max(t, t * scale), \
            f"{dt} {layout} {name}: max abs err {err} (largest {scale})"


@pytest.mark.parametrize("arch", [VLM, "deepseek-67b"])
def test_train_step_matches_reference(arch):
    """One SMOKE train step of each newly ported arch (both dense, so
    ``check_trainable`` accepts them) against the reference's jitted step:
    metrics, every parameter and both moments within 1e-5 of each leaf's
    largest magnitude (eps 1e-6)."""
    jcfg, tcfg, jp, tp = models(arch)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6, eps=1e-6)
    if jcfg.input_mode == "embeddings":
        batch = {"inputs": embeddings(jcfg, (2, 13, jcfg.d_model), seed=9),
                 "positions": positions("grid")}
    else:
        batch = {"inputs": labels(jcfg, 2, 16, seed=9)}
    batch["labels"] = labels(jcfg, 2, batch["inputs"].shape[1], seed=10)
    jp2, jst, jm = jax.jit(j_train_step(jcfg, JAdamWConfig(**opt)))(
        jp, j_adamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, tst, tm = make_train_step(tcfg, AdamWConfig(**opt), device="cpu")(
        tp, adamw_init(tp), batch)
    assert set(tm) == set(jm)

    def rel_close(got, want, what):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * scale, f"{what}: max abs err {err}"

    for k in jm:
        rel_close(tm[k], jm[k], k)
    for name, tree, jtree in (("params", tp2, jp2), ("mu", tst["mu"],
                                                     jst["mu"]),
                              ("nu", tst["nu"], jst["nu"])):
        want = _reference_as_port(jtree, tcfg)
        got = dict(_tree.items(tree))
        assert set(got) == set(want)
        for k, t in got.items():
            rel_close(t.numpy(), want[k].numpy(), f"{name} {k}")


def test_chip_step_bytes_of_the_vlm_and_a_tailed_state():
    """``chip_smoke.step_bytes``: an embeddings model reads its whole
    adapter (it has no token table); a token model all weights but its
    table; a tailed state's filled rows of K and V once, as untailed."""
    from repro_torch.models import param_bytes

    _, vcfg, _, vp = models()
    state = init_decode_state(vcfg, 2, 8, device="cpu")
    got = chip_smoke.step_bytes(vcfg, vp, state, 3)
    kv = state["kv"]["k"]
    assert got["weights"] == param_bytes(vp)
    assert got["kv"] == 2 * param_bytes(kv) * 4 // 8 and got["state"] == 0
    _, dcfg, _, dp = models("deepseek-67b")
    tailed = dataclasses.replace(dcfg, decode_tail_window=4)
    st = init_decode_state(tailed, 2, 8, device="cpu")
    assert "tail" in st
    got = chip_smoke.step_bytes(tailed, dp, st, 5)
    assert got["weights"] == param_bytes(dp) - param_bytes(
        dp["embedding"]["table"])
    assert got["kv"] == 2 * param_bytes(st["kv"]["k"]) * 6 // 8
    assert got["bound_ms"] == pytest.approx(
        (got["weights"] + got["kv"]) / chip_smoke.HBM_BW * 1e3)

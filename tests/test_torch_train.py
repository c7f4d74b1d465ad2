"""The port's training path against the JAX reference: the flash backward,
the loss, every parameter's gradient, and whole AdamW train steps.

The reference's weights are carried across with
``convert.params_from_numpy``; the same numpy tokens enter both packages.
On the CPU the port's flash forward and backward run their plain
versions; the CUDA kernels are held against those by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` path K on the card.

The reference's ``kernels/ops.py::flash_attention`` cannot be
differentiated on this tree: its ``custom_vjp`` forward rule takes
``(causal, q, k, v)`` where JAX passes ``(q, k, v, causal)``, so
``jax.vjp`` of it fails (ROADMAP queue 3).  The port's backward is held
against that ``custom_vjp``'s own backward rule (``_flash_bwd_rule``:
``jax.vjp`` of the reference's online-softmax attention, which its
Pallas forward computes) and against ``torch.autograd`` of the plain
forward.  The reference expands K/V over the query heads before its VJP,
so its dk/dv are summed over each group.

Tolerances (``atol = rtol``): the attention backward 2e-5 in float32 and
2e-2 in bfloat16 (the attention kernels' own); loss and gradients 1e-5
in float32 with gradients also relative to the largest gradient of the
leaf (1e-4; sums of up to 2 x 16 x 256 terms in another order), 5e-2 in
bfloat16 (the reference rounds q, P and every activation to bf16 where
the port's attention keeps float32); train steps' parameters, moments
and metrics 1e-5 relative to each leaf's largest magnitude in float32
(parameters at Adam's default eps 5e-5: see the test).
"""
import dataclasses
import functools
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ops import _flash_bwd_rule  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.layers import cross_entropy as j_cross_entropy  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import _tree, configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, bwd_entry, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.ref import (attention_ref,  # noqa: E402
                                    attention_scores)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import (NotPortedError, cross_entropy,  # noqa: E402
                                forward)
from repro_torch.models.transformer import check_trainable  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARCHS = ("qwen3-8b", "olmo-1b", "granite-3-8b")
ATTN = {"float32": (jnp.float32, torch.float32, 2e-5),
        "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------


def _attn_inputs(seed, b, h, kv, sq, skv, hd, dtype):
    """q, k, v, do as (jax, torch) pairs of one numpy draw in ``dtype``,
    in the port's layout: q/do (B, H, Sq, hd), k/v (B, KV, Skv, hd)."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = ATTN[dtype]
    shapes = [(b, h, sq, hd), (b, kv, skv, hd), (b, kv, skv, hd),
              (b, h, sq, hd)]
    js = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(jdt)
          for s in shapes]
    return js, [torch.tensor(np.asarray(x, np.float32)).to(tdt) for x in js]


def _reference_bwd(js, causal):
    """The reference custom_vjp's backward rule on the (B, S, H, hd)
    layout with K/V expanded; dk/dv summed back over each group."""
    q, k, v, do = js
    b, h, sq, hd = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    tr = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    dq, dk, dv = _flash_bwd_rule(causal, (tr(q), tr(jnp.repeat(k, g, 1)),
                                          tr(jnp.repeat(v, g, 1))), tr(do))
    grouped = lambda x: np.asarray(tr(x), np.float32).reshape(  # noqa: E731
        b, kv, g, skv, hd).sum(2)
    return np.asarray(tr(dq), np.float32), grouped(dk), grouped(dv)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# the reference kernel tests' sweep (tests/test_kernels.py:27-32), and the
# smoke configs' head dim 16
BWD_SHAPES = [
    (1, 4, 4, 128, 128, 64),       # MHA square
    (2, 8, 2, 128, 256, 64),       # GQA, rectangular
    (1, 4, 1, 256, 256, 128),      # MQA, bigger head
    (1, 2, 2, 64, 192, 32),        # uneven kv blocks
    (2, 4, 2, 24, 24, 16),         # the smoke configs' heads
    # lengths no tile of the kernels divides, Skv > Sq and Sq > Skv
    (1, 4, 2, 100, 150, 64),
    (2, 8, 2, 77, 45, 128),
]


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", BWD_SHAPES)
@pytest.mark.parametrize("dtype", sorted(ATTN))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_reference(b, h, kv, sq, skv, hd, dtype,
                                           causal):
    js, (q, k, v, do) = _attn_inputs(1, b, h, kv, sq, skv, hd, dtype)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = _reference_bwd(js, causal)
    tol = ATTN[dtype][2]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == q.dtype and g.shape == w.shape, name
        _close(g, w, tol)


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_autograd_of_the_plain_forward(
        b, h, kv, sq, skv, hd, causal):
    _, (q, k, v, do) = _attn_inputs(2, b, h, kv, sq, skv, hd, "float32")
    o, lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    attention_ref(*leaves, causal=causal).backward(do)
    for g, x in zip(got, leaves):
        _close(g, x.grad, 2e-5)


def test_flash_attention_function_gradients():
    """``FlashAttention`` through autograd: the plain versions' gradients
    on the CPU, one backward call, no kernel launch counted; under
    ``no_grad`` one forward call and nothing saved."""
    _, (q, k, v, do) = _attn_inputs(3, 2, 4, 2, 40, 40, 32, "float32")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    calls = []

    def bwd(*a, **kw):
        calls.append(1)
        return flash_attention_bwd(*a, **kw)

    _build.reset_launches()
    out = flash_attention(*leaves, causal=True, bwd=bwd)
    assert out.grad_fn is not None and out.grad_fn.name().startswith(
        "FlashAttention")
    out.backward(do)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    assert calls == [1]
    with torch.no_grad():
        plain = flash_attention(*leaves, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())
    assert _build.launch_counts()["flash_attention_bwd"] == 0
    assert _build.launch_counts()["flash_attention_fwd"] == 0
    assert FlashAttention.apply(q, k, v, False, flash_attention_fwd,
                                flash_attention_bwd).grad_fn is None


def test_flash_bwd_rejects_bad_shapes():
    _, (q, k, v, do) = _attn_inputs(4, 1, 4, 2, 8, 8, 16, "float32")
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="q's shape"):
        flash_attention_bwd(q, k, v, q[:, :, :4], do, lse)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention_bwd(q, k[:, :, :4], v, q, do, lse)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd(q, k, v, q, do, lse[:, :, :4])
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd(q, k, v, q, do, lse.double())


def _reference_lse(js, causal):
    """``jax.nn.logsumexp`` of the reference's scaled, masked scores (the
    first lines of ``repro.kernels.ref.attention_ref``: K expanded over
    each group, float32 products, ``NEG_INF`` where causal masks)."""
    q, k = js[0], js[1]
    b, h, sq, hd = q.shape
    kv, skv = k.shape[1], k.shape[2]
    k = jnp.repeat(k, h // kv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                   k.astype(jnp.float32)) * hd ** -0.5
    if causal:
        mask = jnp.arange(sq)[:, None] >= jnp.arange(skv)[None, :]
        s = jnp.where(mask[None, None], s, jref.NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1), np.float32)


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", BWD_SHAPES)
@pytest.mark.parametrize("dtype", sorted(ATTN))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_lse_matches_reference_logsumexp(b, h, kv, sq, skv, hd,
                                                       dtype, causal):
    """The forward's lse (B, H, Sq), float32, natural log, within 1e-5 of
    the reference's; asking for it leaves the output's bits alone."""
    js, (q, k, v, _) = _attn_inputs(7, b, h, kv, sq, skv, hd, dtype)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    np.testing.assert_allclose(lse.numpy(), _reference_lse(js, causal),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(o, flash_attention_fwd(q, k, v, causal=causal))


def test_flash_attention_saves_lse_and_asks_for_none_under_no_grad():
    """Under grad ``FlashAttention`` asks ``fwd`` for lse, saves it beside
    q, k, v and the output, and hands it to ``bwd``; under ``no_grad``
    ``fwd`` is called once without asking for it."""
    _, (q, k, v, do) = _attn_inputs(8, 1, 4, 2, 33, 33, 16, "float32")
    asked, handed = [], []

    def fwd(*a, **kw):
        asked.append(kw.get("return_lse", False))
        return flash_attention_fwd(*a, **kw)

    def bwd(*a, **kw):
        handed.append(a[5])
        return flash_attention_bwd(*a, **kw)

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=True, fwd=fwd, bwd=bwd)
    assert asked == [True]
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and torch.equal(saved[3], o)
    assert torch.equal(saved[4], lse)
    out.backward(do)
    assert len(handed) == 1 and torch.equal(handed[0], lse)
    with torch.no_grad():
        plain = flash_attention(*leaves, causal=True, fwd=fwd, bwd=bwd)
    assert asked == [True, False] and torch.equal(plain, o)


def test_kernel_and_plain_pairs_share_one_signature():
    """K2 and the serving agreement swap the plain pair in for the
    kernels: both pairs take the same arguments."""
    assert (inspect.signature(flash_attention_fwd)
            == inspect.signature(flash_attention_plain))
    assert (inspect.signature(flash_attention_bwd)
            == inspect.signature(flash_attention_bwd_plain))
    assert list(inspect.signature(flash_attention_bwd).parameters) == [
        "q", "k", "v", "o", "do", "lse", "causal"]


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_bwd_routes(hd):
    """bfloat16 at hd 64 and 128 takes the tensor-core kernels; float32
    and the other bfloat16 head dims the CUDA-core ones."""
    want = ("flash_attention_bwd_bf16_wgmma" if hd in (64, 128)
            else "flash_attention_bwd_bf16")
    assert bwd_entry(torch.bfloat16, hd) == want
    assert bwd_entry(torch.float32, hd) == "flash_attention_bwd_f32"


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _operand_rounded_bwd(q, k, v, o, do, lse, causal):
    """The plain backward with P and dS rounded to bf16 as the operands
    of dV, dQ and dK, as the tensor-core kernels round them."""
    b, h, sq, hd = q.shape
    kvh = k.shape[1]
    rows = (b, kvh, h // kvh * sq)
    bf = lambda x: x.bfloat16().float()  # noqa: E731
    p = torch.exp(attention_scores(q, k, causal=causal)
                  - lse.reshape(*rows, 1))
    dof = do.float().reshape(*rows, hd)
    d = (dof * o.float().reshape(*rows, hd)).sum(-1, keepdim=True)
    ds = bf(p * (dof @ v.float().transpose(-1, -2) - d))
    return ((ds @ k.float() * hd ** -0.5).reshape(q.shape).to(q.dtype),
            (ds.transpose(-1, -2) @ q.float().reshape(*rows, hd)
             * hd ** -0.5).to(k.dtype),
            (bf(p).transpose(-1, -2) @ dof).to(v.dtype))


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", BWD_SHAPES + [
    (1, 4, 1, 1, 70, 64), (1, 4, 4, 1, 1, 128), (2, 8, 2, 300, 250, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_relative_check_takes_rounding_and_sees_the_controls(
        chip_smoke, b, h, kv, sq, skv, hd, causal):
    """The backward's relative check (``chip_smoke.bwd_verdict``) takes
    the kernels' bf16 rounding of P and dS, single-key rows whose
    gradient cancels to noise included, and rejects each of
    ``chip_smoke.bwd_controls`` that changes a gradient."""
    _, (q, k, v, do) = _attn_inputs(12, b, h, kv, sq, skv, hd, "bfloat16")
    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    got = _operand_rounded_bwd(q, k, v, o, do, lse, causal)
    verdict = chip_smoke.bwd_verdict(got, want, "bfloat16")
    assert all(c["close"] and c["rel_ok"] for c in verdict.values()), verdict
    controls = chip_smoke.bwd_controls(q, k, v, o, do, lse, got, causal)
    assert len(controls) == 3
    for name, bad in controls.items():
        if all(torch.equal(x, y) for x, y in zip(bad, got)):
            continue          # the last keys no query sees: no fault
        verdict = chip_smoke.bwd_verdict(bad, want, "bfloat16")
        assert not all(c["rel_ok"] for c in verdict.values()), (name,
                                                                verdict)


@pytest.mark.parametrize("shape,causal,control", [
    # causal: the last keys' dK and dV are small against the largest
    ((1, 2, 1, 1024, 1024, 128), True, "last key block zeroed"),
    # one query over 200 keys: D is small against dP
    ((1, 4, 4, 1, 200, 128), False, "D dropped")])
def test_bwd_relative_check_sees_what_the_scaled_tolerance_misses(
        chip_smoke, shape, causal, control):
    """Faults that pass the attention tolerance alone (its absolute part
    scaled by the largest gradient) and fail the relative check."""
    _, (q, k, v, do) = _attn_inputs(12, *shape, "bfloat16")
    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    bad = chip_smoke.bwd_controls(q, k, v, o, do, lse, want,
                                  causal)[control]
    verdict = chip_smoke.bwd_verdict(bad, want, "bfloat16")
    assert all(c["close"] for c in verdict.values()), verdict
    assert not all(c["rel_ok"] for c in verdict.values()), verdict


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(masked, dtype):
    rng = np.random.default_rng(5)
    logits = jnp.asarray(rng.standard_normal((3, 7, 50), dtype=np.float32)
                         * 4).astype(dtype)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    want = j_cross_entropy(logits, jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = cross_entropy(
        torch.tensor(np.asarray(logits, np.float32)).to(getattr(torch,
                                                                dtype)),
        torch.tensor(labels), None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_cross_entropy_all_masked_out_is_zero():
    got = cross_entropy(torch.randn(2, 3, 5), torch.zeros(2, 3,
                                                          dtype=torch.long),
                        torch.zeros(2, 3))
    assert float(got) == 0.0


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def models(arch, dtype, remat):
    """(reference cfg, port cfg, reference params, port params)."""
    over = dict(dtype=dtype, param_dtype="float32", remat=remat)
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **over)
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), **over)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def batch_of(cfg, seed, b=2, s=16):
    return TokenPipeline(b, s, cfg.vocab_size, seed=seed).next_batch()


def _grad_close(got, want, tol, what):
    """Leaf by leaf: within ``tol`` absolute, and within ``tol`` (float32:
    1e-4) of the leaf's largest magnitude."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= max(tol, 1e-4 * scale if tol < 1e-4 else tol * scale), \
        f"{what}: max abs err {err} (largest {scale})"


def _reference_grads_as_port(jgrads, tcfg):
    return dict(_tree.items(params_from_numpy(
        jax.tree.map(np.asarray, jgrads), tcfg, device="cpu")))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_every_gradient_match_reference(arch, dtype, remat):
    jcfg, tcfg, jp, tp = models(arch, dtype, remat)
    batch = batch_of(tcfg, seed=7)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: j_forward(p, jcfg, bt), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = dict(_tree.items(tp))
    trainable = {k: p.clone().requires_grad_(True) for k, p in leaves.items()}
    loss, metrics = forward(_tree.unflatten(tp, trainable), tcfg,
                            {k: torch.tensor(v) for k, v in batch.items()})
    grads = dict(zip(trainable, torch.autograd.grad(
        loss, list(trainable.values()))))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jm["ce"]),
                               rtol=tol, atol=tol)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = _reference_grads_as_port(jg, tcfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[name].shape
        _grad_close(g, want[name].numpy(), tol, f"{arch} {dtype} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """Checkpointing each layer changes what is kept, not what is
    computed: bit for bit on the CPU."""
    out = []
    for remat in (False, True):
        _, tcfg, _, tp = models(arch, "bfloat16", remat)
        trainable = {k: p.clone().requires_grad_(True)
                     for k, p in _tree.items(tp)}
        loss, _ = forward(_tree.unflatten(tp, trainable), tcfg,
                          {k: torch.tensor(v)
                           for k, v in batch_of(tcfg, 8).items()})
        out.append([loss.detach()] + list(torch.autograd.grad(
            loss, list(trainable.values()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_attention_gradients_reach_every_projection():
    """The fault the Function fixes: with the kernel's output outside
    autograd, wq/wk/wv would get no gradient."""
    _, tcfg, _, tp = models("qwen3-8b", "float32", False)
    trainable = {k: p.clone().requires_grad_(True)
                 for k, p in _tree.items(tp)}
    loss, _ = forward(_tree.unflatten(tp, trainable), tcfg,
                      {k: torch.tensor(v)
                       for k, v in batch_of(tcfg, 9).items()})
    loss.backward()
    for k, p in trainable.items():
        if k.split("/")[-1] in ("wq", "wk", "wv"):
            assert float(p.grad.abs().max()) > 0, k


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _rel_close(got, want, what, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("eps,param_tol", [(1e-8, 5e-5), (1e-6, 1e-5)])
def test_three_train_steps_match_reference(arch, eps, param_tol):
    """Three jitted reference steps against three port steps from the
    same weights and batches: loss, ce, aux, lr and grad_norm, every
    parameter and both moments after each step, and the step count.

    Moments and metrics within 1e-5 of each leaf's largest magnitude.  A
    parameter moves by lr * mhat / (sqrt(nhat) + eps) a step; where a
    gradient is near zero (|g| about eps) Adam turns the packages' last-bit
    differences into up to lr * |dg| / eps, so at the default eps = 1e-8
    parameters are held within 5e-5 (lr / 20), and at eps = 1e-6 within
    1e-5 like the rest."""
    jcfg, tcfg, jp, tp = models(arch, "float32", False)
    opt = dict(OPT, eps=eps)
    jstep = jax.jit(j_train_step(jcfg, JAdamWConfig(**opt)))
    tstep = make_train_step(tcfg, AdamWConfig(**opt), device="cpu")
    jst, tst = j_adamw_init(jp), adamw_init(tp)
    pipe = TokenPipeline(2, 16, tcfg.vocab_size, seed=3)
    for i in range(3):
        batch = pipe.next_batch()
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, tst, tm = tstep(tp, tst, batch)
        assert set(tm) == set(jm)
        for k in jm:
            _rel_close(tm[k], jm[k], f"step {i} {k}")
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        for name, tree, jtree in (("params", tp, jp), ("mu", tst["mu"],
                                                       jst["mu"]),
                                  ("nu", tst["nu"], jst["nu"])):
            want = _reference_grads_as_port(jtree, tcfg)
            got = dict(_tree.items(tree))
            assert set(got) == set(want)
            for k, t in got.items():
                _rel_close(t.numpy(), want[k].numpy(),
                           f"step {i} {name} {k}",
                           param_tol if name == "params" else 1e-5)


def test_train_step_leaves_its_inputs_as_they_were():
    _, tcfg, _, tp = models("olmo-1b", "float32", False)
    before = {k: v.clone() for k, v in _tree.items(tp)}
    st = adamw_init(tp)
    step = make_train_step(tcfg, AdamWConfig(**OPT), device="cpu")
    p2, st2, _ = step(tp, st, batch_of(tcfg, 1))
    for k, v in _tree.items(tp):
        assert torch.equal(v, before[k]) and not v.requires_grad
    assert int(st["step"]) == 0 and int(st2["step"]) == 1
    assert all(not t.requires_grad for t in _tree.leaves(p2))


def test_rwkv_training_is_ported(monkeypatch):
    """RWKV-6 trains (its recurrence's gradient is the WKV backward
    kernel); its roofline stand-in ``wkv_impl="kernel_stub"`` is still
    refused; and a WKV call on tensors off the CPU (the meta device stands
    for the card on a host without one) goes to the kernels, which raise
    without ``nvcc``, rather than running the plain pair."""
    from repro_torch.kernels import rwkv6_scan as ws

    for smoke in (False, True):
        check_trainable(tconfigs.get("rwkv6-3b", smoke=smoke))
    stub = dataclasses.replace(tconfigs.get("rwkv6-3b", smoke=True),
                               wkv_impl="kernel_stub")
    with pytest.raises(NotPortedError, match="kernel_stub"):
        check_trainable(stub)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", ())
    monkeypatch.setattr(_build, "BUILD_ROOT",
                        _build.BUILD_ROOT / "nonexistent-for-this-test")
    monkeypatch.setattr(_build, "_LIB", None)
    ran = []
    plain = lambda *a, **kw: ran.append(1)  # noqa: E731
    xs = [torch.zeros(s, device="meta", requires_grad=True) for s in (
        (1, 4, 2, 64),) * 4 + ((2, 64), (1, 2, 64, 64))]
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        ws.wkv(*xs, bwd=plain)
    assert not ran

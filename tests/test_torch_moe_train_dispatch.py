"""The gradients of the MoE expert dispatch (capacity factors, dropped
entries, exact ties, the load count) and of the Mamba scan (the
associative scan, the chunked selective SSM, the block, the causal conv)
against the reference's.  Split from ``test_torch_moe_train.py``; its
module docstring says more."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_moe_train_common import *  # noqa: E402,F401,F403
from _torch_moe_train_common import _tree  # noqa: E402,F401


# ---------------------------------------------------------------------------
# the expert dispatch's gradients
# ---------------------------------------------------------------------------


def moe_layer(arch, cf, dtype="float32", shared=True, tie=False):
    """(reference cfg, port cfg, reference weights, port weights) of the
    first MoE layer at capacity factor ``cf``; ``tie`` copies router
    column 0 into column 1 (every token's two probabilities tie
    exactly); ``shared=False`` leaves the shared expert out."""
    jcfg, tcfg = configs(arch, dtype, capacity_factor=cf)
    if not shared:
        jcfg, tcfg = (dataclasses.replace(c, n_shared_experts=0)
                      for c in (jcfg, tcfg))
    _, _, jp, _ = models(arch)
    j = next(j for j in range(tcfg.n_layers) if tcfg.is_moe_layer(j))
    layers = jp["layers"][f"sub{j}"] if tcfg.attn_layer_period else \
        jp["layers"]
    w = {k: np.asarray(v[0]) for k, v in layers["ffn"].items()
         if k != "shared"}
    if shared and "shared" in layers["ffn"]:
        w["shared"] = {k: np.asarray(v[0])
                       for k, v in layers["ffn"]["shared"].items()}
    if tie:
        w["router"] = w["router"].copy()
        w["router"][:, 1] = w["router"][:, 0]
    jw = jax.tree.map(jnp.asarray, w)
    tw = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), w)
    return jcfg, tcfg, jw, tw


def moe_grads(jcfg, tcfg, jw, tw, shape, seed, with_aux=True):
    """The gradients of ``sum(y * r) + aux`` (``r`` a fixed draw) with
    respect to x and every weight, in both packages: ``(port, reference)``
    as flat ``{name: numpy}``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    r = rng.standard_normal(shape, dtype=np.float32)

    def jloss(w, x):
        y, aux = jmoe.apply_moe(w, jcfg, x)
        return (y.astype(jnp.float32) * r).sum() + (aux if with_aux else 0.0)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jw, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _tree.items(tw)}
    tx = torch.tensor(x).requires_grad_(True)
    y, aux = tmoe.apply_moe(_tree.unflatten(tw, leaves), tcfg, tx)
    loss = (y.float() * torch.tensor(r)).sum() + (aux if with_aux else 0.0)
    tg = torch.autograd.grad(loss, [tx, *leaves.values()])
    got = {"x": tg[0].numpy(), **{k: g.numpy()
                                  for k, g in zip(leaves, tg[1:])}}
    want = {"x": np.asarray(jg[1]),
            **{k: np.asarray(v) for k, v in _tree.items(jg[0])}}
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.01, 1.25, 8.0])
def test_apply_moe_gradients_match_reference(arch, cf):
    """x, router, experts and shared expert: at cf 8 nothing drops, at
    1.25 some entries do, at 0.01 every expert keeps one slot a row."""
    jcfg, tcfg, jw, tw = moe_layer(arch, cf)
    got, want = moe_grads(jcfg, tcfg, jw, tw, (2, 40, tcfg.d_model), 12)
    assert set(got) == set(want)
    for k in got:
        grad_close(torch.tensor(got[k]), want[k], 1e-5, f"{arch} cf {cf} {k}")
    assert float(np.abs(got["router"]).max()) > 0


def test_a_dropped_entry_gives_its_token_no_gradient_through_its_expert():
    """At capacity 1 an expert, most (token, expert) entries are dropped.
    Pulling back from one token's output alone (no shared expert, no
    auxiliary loss): no expert it was dropped from gets a gradient, nor
    does any other token; a token whose every entry was dropped passes no
    gradient to x or the router at all.  The overflow column the dropped
    entries are sent to is cut off, so nothing leaks from it."""
    arch = "qwen2-moe-a2.7b"
    jcfg, tcfg, jw, tw = moe_layer(arch, 0.01, shared=False)
    b, s, d = 1, 24, tcfg.d_model
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (b, s, d), dtype=np.float32))
    assert tmoe._capacity(tcfg, s) == 1
    _, gate, eidx = tmoe.route(tw, tcfg, x)
    y, _ = tmoe.apply_moe(tw, tcfg, x)
    served = (y[0].abs() > 0).any(-1)
    # the entries kept: the first token of each expert (in token order)
    first = {}
    for t in range(s):
        for e in eidx[0, t].tolist():
            first.setdefault(e, t)
    checked_dropped_token = False
    for t in range(s):
        kept = {e for e in eidx[0, t].tolist() if first[e] == t}
        dropped = set(eidx[0, t].tolist()) - kept
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in _tree.items(tw)}
        tx = x.clone().requires_grad_(True)
        yt, _ = tmoe.apply_moe(_tree.unflatten(tw, leaves), tcfg, tx)
        g = dict(zip(["x", *leaves], torch.autograd.grad(
            yt[0, t].sum(), [tx, *leaves.values()])))
        others = torch.ones(s, dtype=torch.bool)
        others[t] = False
        assert float(g["x"][0, others].abs().max()) == 0.0, t
        for w in ("wi", "wg", "wo"):
            for e in range(tcfg.n_experts):
                nz = float(g[w][e].abs().max()) > 0
                assert nz == (e in kept), (t, w, e, kept, dropped)
        if not kept:
            assert not bool(served[t])
            assert float(g["x"].abs().max()) == 0.0
            assert float(g["router"].abs().max()) == 0.0
            checked_dropped_token = True
    assert checked_dropped_token


@pytest.mark.parametrize("arch", ARCHS)
def test_router_gradient_with_exact_ties_matches_reference(arch):
    """Router columns 0 and 1 equal: every token's two probabilities tie
    exactly; both packages pick the lower expert (``lax.top_k`` and a
    stable descending sort) and pass the gradient to the value picked."""
    jcfg, tcfg, jw, tw = moe_layer(arch, 8.0, tie=True)
    probs, _, eidx = tmoe.route(tw, tcfg, torch.randn(2, 8, tcfg.d_model))
    assert torch.equal(probs[..., 0], probs[..., 1])
    got, want = moe_grads(jcfg, tcfg, jw, tw, (2, 24, tcfg.d_model), 14)
    for k in got:
        grad_close(torch.tensor(got[k]), want[k], 1e-5, f"{arch} tie {k}")
    assert float(np.abs(got["router"][:, :2]).max()) > 0


def test_the_load_count_takes_no_gradient():
    """Only the gate and the mean probability carry the router's
    gradient: the auxiliary loss alone pulls back through ``me`` (the
    per-expert count is a constant), equal to the reference's."""
    jcfg, tcfg, jw, tw = moe_layer(MOE, 1.25)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, tcfg.d_model), dtype=np.float32)
    jg = jax.jit(jax.grad(lambda w, x: jmoe.apply_moe(w, jcfg, x)[1]))(
        jw, jnp.asarray(x))
    router = tw["router"].clone().requires_grad_(True)
    _, aux = tmoe.apply_moe(dict(tw, router=router), tcfg, torch.tensor(x))
    (g,) = torch.autograd.grad(aux, [router])
    grad_close(g, np.asarray(jg["router"]), 1e-5, "router from aux alone")
    probs, _, eidx = tmoe.route(tw, tcfg, torch.tensor(x))
    ce = torch.nn.functional.one_hot(eidx, tcfg.n_experts).float().mean(
        (0, 1, 2))
    me = probs.mean((0, 1))
    np.testing.assert_allclose(float(aux), float(tcfg.n_experts
                                                 * (me * ce).sum()),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the selective scan's gradients
# ---------------------------------------------------------------------------


def combine(x, y):
    (a1, b1), (a2, b2) = x, y
    return a1 * a2, b1 * a2 + b2


@pytest.mark.parametrize("num", [1, 2, 3, 7, 8, 13, 16])
def test_associative_scan_gradients_match_reference(num):
    """The recursion's gradient (slices, the interleave's slice writes and
    the concatenations, through autograd) against ``jax.grad`` of
    ``lax.associative_scan`` on the same pairs and cotangents."""
    rng = np.random.default_rng(num)
    a = rng.uniform(0.2, 1.0, (2, num, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, num, 3, 4)).astype(np.float32)
    ca, cb = (rng.standard_normal((2, num, 3, 4)).astype(np.float32)
              for _ in range(2))

    def jloss(a, b):
        sa, sb = jax.lax.associative_scan(combine, (a, b), axis=1)
        return (sa * ca).sum() + (sb * cb).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a),
                                                   jnp.asarray(b))
    ta, tb = (torch.tensor(v).requires_grad_(True) for v in (a, b))
    sa, sb = tmamba._associative_scan(ta, tb)
    got = torch.autograd.grad((sa * torch.tensor(ca)).sum()
                              + (sb * torch.tensor(cb)).sum(), [ta, tb])
    for g, w, name in zip(got, want, ("a", "b")):
        grad_close(g, w, 1e-5, f"num {num} d{name}")


def mamba_layer(chunk):
    jcfg, tcfg = configs(HYBRID, mamba_chunk=chunk)
    _, _, jp, _ = models(HYBRID)
    w = {k: np.asarray(v[0]) for k, v in jp["layers"]["sub0"]["mix"].items()}
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, w),
            {k: torch.tensor(v) for k, v in w.items()})


@pytest.mark.parametrize("chunk,s", [(4, 16), (8, 16), (5, 16), (7, 13),
                                     (16, 9)])
def test_selective_ssm_gradients_match_reference(chunk, s):
    """Chunks that divide S and chunks that pad the last one; a nonzero
    state carried in; cotangents on y and on the last state (which has
    passed the padding, as in the reference)."""
    jcfg, tcfg, jw, tw = mamba_layer(chunk)
    d_in, n = tw["A_log"].shape
    rng = np.random.default_rng(chunk * 100 + s)
    x = rng.standard_normal((2, s, d_in), dtype=np.float32)
    h0 = rng.standard_normal((2, d_in, n), dtype=np.float32) * 0.3
    cy = rng.standard_normal((2, s, d_in), dtype=np.float32)
    ch = rng.standard_normal((2, d_in, n), dtype=np.float32)

    def jloss(w, x, h):
        y, last = jmamba._selective_ssm(w, jcfg, x, h)
        return (y * cy).sum() + (last * ch).sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jw, jnp.asarray(x),
                                                    jnp.asarray(h0))
    leaves = {k: tw[k].clone().requires_grad_(True)
              for k in ("w_x", "w_dt", "dt_bias", "A_log", "D")}
    tx, th = (torch.tensor(v).requires_grad_(True) for v in (x, h0))
    y, last = tmamba._selective_ssm(leaves, tcfg, tx, th)
    tg = torch.autograd.grad((y * torch.tensor(cy)).sum()
                             + (last * torch.tensor(ch)).sum(),
                             [tx, th, *leaves.values()])
    want = {"x": jg[1], "h0": jg[2], **jg[0]}
    got = dict(zip(["x", "h0", *leaves], tg))
    for k in ("x", "h0", "w_x", "w_dt", "dt_bias", "A_log", "D"):
        grad_close(got[k], want[k], 1e-5, f"chunk {chunk} S {s} {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [6, 19])
def test_mamba_block_gradients_match_reference(dtype, s):
    """The whole mixer (in-projection, causal conv, scan, gate,
    out-projection): every weight's gradient and x's."""
    jcfg, tcfg, jw, tw = mamba_layer(8)
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    rng = np.random.default_rng(50 + s)
    x = rng.standard_normal((2, s, tcfg.d_model), dtype=np.float32)
    r = rng.standard_normal((2, s, tcfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(dtype)

    def jloss(w, x):
        return (jmamba.mamba_block(w, jcfg, x).astype(jnp.float32) * r).sum()

    jg = reference(jax.grad(jloss, argnums=(0, 1)), dtype)(jw, jx)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tw.items()}
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        tcfg.adtype).requires_grad_(True)
    y = tmamba.mamba_block(leaves, tcfg, tx)
    tg = torch.autograd.grad((y.float() * torch.tensor(r)).sum(),
                             [tx, *leaves.values()])
    want = {"x": jg[1], **jg[0]}
    tol = 1e-5 if dtype == "float32" else 5e-2
    for k, g in zip(["x", *leaves], tg):
        grad_close(g, np.asarray(want[k], np.float32), tol,
                   f"{dtype} S {s} {k}")


@pytest.mark.parametrize("s", [1, 5, 13])
def test_causal_conv_gradients_match_reference(s):
    jcfg, tcfg, jw, tw = mamba_layer(8)
    d_in = tw["conv"].shape[1]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, d_in), dtype=np.float32)
    r = rng.standard_normal((2, s, d_in), dtype=np.float32)
    jg = jax.jit(jax.grad(lambda w, x: (jmamba._causal_conv(w, x) * r).sum(),
                          argnums=(0, 1)))(jw, jnp.asarray(x))
    leaves = {k: tw[k].clone().requires_grad_(True)
              for k in ("conv", "conv_b")}
    tx = torch.tensor(x).requires_grad_(True)
    tg = torch.autograd.grad((tmamba._causal_conv(leaves, tx)
                              * torch.tensor(r)).sum(),
                             [tx, *leaves.values()])
    for k, g in zip(("x", "conv", "conv_b"), tg):
        grad_close(g, jg[1] if k == "x" else jg[0][k], 1e-5, f"S {s} {k}")


"""The port's mixture-of-experts layer and MoE models against the JAX
reference (``repro.models.moe``, qwen2-moe and llama4-scout).

The reference's weights (``init_moe`` / ``init_params``) are carried
across with ``convert.params_from_numpy``; the same numpy activations and
token ids enter both packages.  Tolerances: ``atol = rtol = 1e-5`` where
the compute dtype is float32, ``5e-2`` in bfloat16 (as
``test_torch_models.py``); capacities, expert choices and the dispatch's
drops are exact.  Where an expert choice differs, the message gives the
smallest gap between a token's k-th and (k+1)-th expert probability the
reference saw: a gap of a float32 ulp or so is a routing tie that a
last-bit difference upstream flips, anything larger a fault.

In bfloat16 the reference's models run eagerly (``jax.disable_jit``),
each op rounding its output to bfloat16 as written.  Jitted on the CPU, XLA's
excess precision keeps fused bfloat16 intermediates in float32: the
router's input then moves by bfloat16 ulps and top-k choices with a
margin below that flip (qwen2-moe-smoke's prefill: one token a layer),
which no tolerance on the logits absorbs.  The port rounds as the eager
reference does, and equals its ``use_pallas=True`` prefill exactly.  A
lone MoE layer is fed equal inputs, so the router's input is the same in
both and the reference's layer runs jitted.

Decode is compared in float32 only.  In bfloat16 a decode step's
attention output rounds by a bfloat16 ulp against the reference's
interpreted decode kernel (both sum in float32, in other orders), and
that flips near-tie top-k choices: qwen2-moe-smoke at batch 4 flips one
at step 2, layer 1, whose margin is 1.1e-3 (ROADMAP queue 3).  The
bfloat16 MoE layer is held by the ``apply_moe`` tests, on equal inputs.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import serve_step as j_serve_step  # noqa: E402
from repro.serving.llm_replica import SharedModel as JSharedModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import forward, init_decode_state  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.serving import SharedModel  # noqa: E402

#: the MoE archs; the hybrid one (jamba) is ``test_torch_hybrid.py``'s
ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
#: every arch whose layers route (jamba's every second layer)
ROUTED = ARCHS + ("jamba-v0.1-52b",)
#: compute dtype, parameter dtype
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
    """The reference's ``fn``: jitted in float32, eager in bfloat16 (see
    the module's docstring)."""
    if dtype == "float32":
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def configs(arch, dt="f32", **over):
    dtype, pdtype = DTYPES[dt]
    return tuple(dataclasses.replace(m.get(arch, smoke=True), dtype=dtype,
                                     param_dtype=pdtype, **over)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def models(arch, dt="f32"):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = configs(arch, dt)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def moe_weights(arch, dt="f32"):
    """(reference, port) weights of the model's first MoE layer (jamba's
    ``sub1`` of period 0), carried across by ``params_from_numpy``."""
    jcfg, tcfg, jp, tp = models(arch, dt)
    j = next(j for j in range(tcfg.n_layers) if tcfg.is_moe_layer(j))
    layers = jp["layers"][f"sub{j}"] if tcfg.attn_layer_period else \
        jp["layers"]
    return (jax.tree.map(lambda a: a[0], layers["ffn"]),
            tp["layers"][j]["ffn"])


def activations(cfg, shape, seed=0, scale=1.0):
    """(jax, torch) copies of one numpy draw in the compute dtype."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jx = jnp.asarray(x * scale).astype(cfg.dtype)
    return jx, torch.tensor(np.asarray(jx, np.float32)).to(
        torch_dtype(cfg.dtype))


def reference_routing(jp, jcfg, jx):
    """The reference's routing, as ``apply_moe`` computes it: (probs,
    gate, experts, the smallest top-k margin)."""
    logits = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32),
                        jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = jax.lax.top_k(probs, jcfg.experts_per_token)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    top = -np.sort(-np.asarray(probs), axis=-1)
    k = jcfg.experts_per_token
    margin = float((top[..., k - 1] - top[..., k]).min())
    return np.asarray(probs), np.asarray(gate), np.asarray(eidx), margin


# ---------------------------------------------------------------------------
# capacity and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.01, 1.0, 1.25, 8.0, 15.0])
def test_capacity_equals_reference_over_a_grid(cf):
    base = jconfigs.get("qwen2-moe-a2.7b")
    for e, k in ((2, 1), (4, 2), (6, 2), (16, 1), (16, 2), (60, 4)):
        jcfg = dataclasses.replace(base, n_experts=e, experts_per_token=k,
                                   capacity_factor=cf)
        tcfg = dataclasses.replace(tconfigs.get("qwen2-moe-a2.7b"),
                                   n_experts=e, experts_per_token=k,
                                   capacity_factor=cf)
        for tokens in (1, 2, 3, 8, 16, 31, 32, 33, 64, 65, 100, 1000, 1024,
                       4096):
            assert tmoe._capacity(tcfg, tokens) == jmoe._capacity(
                jcfg, tokens), (e, k, tokens)


def test_capacity_at_the_chip_paths_shapes():
    """The capacities the card's paths M and N run at (``chip_smoke``):
    prefill rows of 1024 tokens, and decode groups of 8 tokens."""
    moe = tconfigs.get("qwen2-moe-a2.7b")
    hybrid = tconfigs.get("jamba-v0.1-52b")
    assert tmoe._capacity(moe, 1024) == 128
    assert tmoe._capacity(hybrid, 1024) == 256
    assert tmoe._capacity(moe, 8) == tmoe._capacity(hybrid, 8) == 1


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("ties", [False, True])
def test_expert_choices_equal_reference(arch, ties):
    """``route``'s experts equal ``jax.lax.top_k``'s, order included; with
    ``ties`` the router has duplicated columns, so every token's
    probabilities tie exactly in pairs and only the tie-break (the lower
    expert index first) decides."""
    jcfg, tcfg = configs(arch)
    jp, tp = moe_weights(arch)
    if ties:
        router = np.asarray(jp["router"]).copy()
        router[:, 1::2] = router[:, 0::2][:, :router[:, 1::2].shape[1]]
        jp = dict(jp, router=jnp.asarray(router))
        tp = dict(tp, router=torch.tensor(router))
    jx, tx = activations(jcfg, (3, 17, jcfg.d_model), seed=11)
    probs, gate, eidx, margin = reference_routing(jp, jcfg, jx)
    tprobs, tgate, teidx = tmoe.route(tp, tcfg, tx)
    np.testing.assert_array_equal(
        teidx.numpy(), eidx,
        err_msg=f"expert choices differ; smallest top-k margin {margin!r}")
    close(tprobs, probs, "float32")
    close(tgate, gate, "float32")


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------


def _drops(cfg, eidx, group):
    """The number of (token, expert) entries past capacity in a group of
    ``group`` tokens a row (the reference's rule, counted in numpy)."""
    cap = jmoe._capacity(cfg, group)
    rows = eidx.reshape(-1, group * cfg.experts_per_token)
    return int(sum(max(0, c - cap) for r in rows
                   for c in np.bincount(r, minlength=cfg.n_experts)))


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cf", [0.01, 1.25, 8.0])
def test_apply_moe_matches_reference(arch, dt, cf):
    """(y, aux) at a prefill shape (2 rows of 40 tokens: 80 entries a row
    at k = 2, so capacities are unpadded): at cf 8 nothing drops, at 1.25
    some entries do, at 0.01 every expert keeps one."""
    jcfg, tcfg = configs(arch, dt, capacity_factor=cf)
    jp, tp = moe_weights(arch, dt)
    jx, tx = activations(jcfg, (2, 40, jcfg.d_model), seed=12)
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, jcfg, x))(jp, jx)
    ty, taux = tmoe.apply_moe(tp, tcfg, tx)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    _, _, eidx, margin = reference_routing(jp, jcfg, jx)
    drops = _drops(jcfg, eidx, 40)
    if cf == 8.0:
        assert drops == 0
    elif cf == 0.01:
        assert drops > 0
    msg = f"{drops} drops; smallest top-k margin {margin!r}"
    close(ty, jy, jcfg.dtype, msg)
    close(taux, jaux, "float32", msg)


@pytest.mark.parametrize("arch", ROUTED)
@pytest.mark.parametrize("batch", [1, 2, 6, 8, 32])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_moe_decode_regrouping_matches_reference(arch, batch, dt):
    """One token a row (decode): batch 1 routes alone; 2 and 6 in groups
    of 2, 8 in one group of 8, 32 in groups of 16, each group one
    dispatch row with its own (small) capacity, collisions dropped."""
    jcfg, tcfg = configs(arch, dt)
    jp, tp = moe_weights(arch, dt)
    jx, tx = activations(jcfg, (batch, 1, jcfg.d_model), seed=13 + batch)
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, jcfg, x))(jp, jx)
    ty, taux = tmoe.apply_moe(tp, tcfg, tx)
    _, _, eidx, margin = reference_routing(jp, jcfg, jx)
    group = next((g for g in (16, 8, 4, 2) if batch % g == 0), 1)
    msg = (f"groups of {group}, {_drops(jcfg, eidx, group)} drops; "
           f"smallest top-k margin {margin!r}")
    close(ty, jy, jcfg.dtype, msg)
    close(taux, jaux, "float32", msg)


def test_apply_moe_takes_no_host_sync():
    """The dispatch reads no tensor value on the host (``.item()``,
    boolean-mask indexing, ``nonzero``): none of the operators that do so
    is dispatched, prefill or decode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    syncing = {"aten._local_scalar_dense.default", "aten.nonzero.default",
               "aten.masked_select.default", "aten.item.default"}

    class Ops(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(str(func))
            return func(*args, **(kwargs or {}))

    jcfg, tcfg = configs("qwen2-moe-a2.7b")
    _, tp = moe_weights("qwen2-moe-a2.7b")
    for shape in ((2, 40, tcfg.d_model), (8, 1, tcfg.d_model)):
        with Ops() as ops:
            tmoe.apply_moe(tp, tcfg, torch.randn(shape))
        assert not ops.seen & syncing, ops.seen & syncing


# ---------------------------------------------------------------------------
# the reference's invariants (tests/test_moe_invariants.py) on the port
# ---------------------------------------------------------------------------


def _inv_cfg(e, k, cf):
    return dataclasses.replace(tconfigs.get("qwen2-moe-a2.7b", smoke=True),
                               n_experts=e, experts_per_token=k,
                               capacity_factor=cf, n_shared_experts=0,
                               dtype="float32", param_dtype="float32")


def _inv_weights(cfg, seed):
    return tmoe.init_moe(cfg, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("e,k,b,s,seed", [
    (4, 1, 1, 4, 0), (4, 2, 2, 16, 1), (6, 1, 2, 4, 2), (6, 2, 1, 16, 3),
    (8, 1, 1, 16, 4), (8, 2, 2, 4, 5), (8, 2, 2, 16, 6), (4, 2, 1, 4, 7)])
def test_moe_output_finite_and_gate_weighted(e, k, b, s, seed):
    cfg = _inv_cfg(e, k, cf=8.0)  # no drops
    p = _inv_weights(cfg, 0)
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    y, aux = tmoe.apply_moe(p, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux) >= 0.0
    assert float(y.abs().max()) > 0.0


@pytest.mark.parametrize("seed", range(6))
def test_moe_dropped_tokens_contribute_zero(seed):
    """Capacity 1 an expert (cf 0.01, 2 experts, top-1): at most 2 of 8
    tokens are served; every other row of y is exactly zero."""
    cfg = _inv_cfg(e=2, k=1, cf=0.01)
    p = _inv_weights(cfg, 1)
    s = 8
    x = torch.randn((1, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    assert tmoe._capacity(cfg, s) == 1
    y, _ = tmoe.apply_moe(p, cfg, x)
    assert int((y[0].abs() > 0).any(-1).sum()) <= 2


@pytest.mark.parametrize("seed", range(3))
def test_moe_permutation_equivariance_within_row(seed):
    """Shuffling tokens within a row and unshuffling the output gives the
    same result when nothing is dropped."""
    cfg = _inv_cfg(e=4, k=2, cf=8.0)
    p = _inv_weights(cfg, 2)
    s = 12
    x = torch.randn((1, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(100 + seed))
    y, _ = tmoe.apply_moe(p, cfg, x)
    perm = torch.tensor(np.random.default_rng(seed).permutation(s))
    y_p, _ = tmoe.apply_moe(p, cfg, x[:, perm])
    torch.testing.assert_close(y_p[0], y[0][perm], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# models: prefill, serve_step, forward, generate
# ---------------------------------------------------------------------------


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_logits_match_reference(arch, dt):
    jcfg, tcfg, jp, tp = models(arch, dt)
    toks = tokens(jcfg, 2, 16, seed=6)
    got = make_prefill_step(tcfg, device="cpu")(tp, {"inputs": toks})
    assert got.shape == (2, jcfg.vocab_size) and got.dtype == tcfg.adtype
    cfg = dataclasses.replace(jcfg, use_pallas=True)
    want = reference(j_prefill(cfg), jcfg.dtype)(
        jp, {"inputs": jnp.asarray(toks)})
    close(got, want, jcfg.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference(arch):
    """Six decode steps of a batch of 3 (no group divides it: each row
    routes its one token alone) and of 4 (one dispatch group of 4):
    logits, ``cache_len`` and the cache."""
    jcfg, tcfg, jp, tp = models(arch)
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    jstep = reference(lambda p, s, b: j_serve_step(p, jcfg, s, b),
                      jcfg.dtype)
    step = make_serve_step(tcfg, device="cpu")
    for batch in (3, 4):
        toks = tokens(jcfg, batch, 6, seed=7 + batch)
        jstate = j_init_state(jcfg, batch, 8)
        tstate = init_decode_state(tcfg, batch, 8, device="cpu")
        for t in range(6):
            jl, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
            tl, tstate = step(tp, tstate, {"inputs": toks[:, t]})
            assert tl.shape == (batch, jcfg.vocab_size)
            close(tl, jl, jcfg.dtype, f"batch {batch} step {t}")
            assert int(tstate["cache_len"]) == t + 1
        for name in ("k", "v"):
            close(tstate["kv"][name], jstate["kv"][name], jcfg.dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_loss_ce_and_aux_match_reference(arch, dt):
    """The training loss: ``ce + AUX_LOSS_COEF * aux``, aux summed over
    the MoE layers, with a mask."""
    jcfg, tcfg, jp, tp = models(arch, dt)
    toks = tokens(jcfg, 2, 12, seed=8)
    mask = (np.random.default_rng(9).random((2, 12)) > 0.3).astype(np.float32)
    batch = {"inputs": toks, "labels": np.roll(toks, -1, axis=1),
             "mask": mask}
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    jl, jm = reference(lambda p, b: j_forward(p, jcfg, b), jcfg.dtype)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, tm = forward(tp, tcfg, {k: torch.tensor(v)
                                    for k, v in batch.items()})
    close(tl, jl, jcfg.dtype)
    close(tm["ce"], jm["ce"], jcfg.dtype)
    close(tm["aux"], jm["aux"], jcfg.dtype)
    assert float(tm["aux"]) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """Unequal prompts padded to a batch of four (decode groups of 4),
    six greedy tokens: equal."""
    jcfg, tcfg = configs(arch)
    ref = JSharedModel(jcfg, max_len=24, max_batch=4, seed=2)
    port = SharedModel(tcfg, max_len=24, max_batch=4, device="cpu",
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, ref.params), tcfg,
                           device="cpu"))
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, jcfg.vocab_size, n)) for n in (5, 2, 7)]
    np.testing.assert_array_equal(port.generate(prompts, 6),
                                  ref.generate(prompts, 6))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_without_drops(arch):
    """The port alone, float32, at a capacity factor where nothing drops
    (E / k): one token at a time through the cache gives the
    full-sequence logits at every position."""
    _, cfg = configs(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                              / cfg.experts_per_token)
    from repro_torch.models import init_params

    params = init_params(cfg, seed=0, device="cpu")
    toks = tokens(cfg, 2, 6, seed=9)
    prefill = make_prefill_step(cfg, device="cpu")
    step = make_serve_step(cfg, device="cpu")
    state = init_decode_state(cfg, 2, 8, device="cpu")
    for t in range(6):
        logits, state = step(params, state, {"inputs": toks[:, t]})
        torch.testing.assert_close(
            logits, prefill(params, {"inputs": toks[:, :t + 1]}),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ROUTED)
def test_bf16_conversion_keeps_the_router_float32(arch):
    """``params_from_numpy`` in bfloat16 parameters casts every leaf but
    the routers, which stay float32 (their values exact), as the
    reference draws them."""
    jcfg, tcfg, jp, tp = models(arch, "bf16-params")
    routers = [lp["ffn"]["router"] for lp in tp["layers"]
               if "router" in lp["ffn"]]
    assert routers
    assert all(r.dtype == torch.float32 for r in routers)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = [np.asarray(v, np.float32) for path, v in flat
            if path[-1].key == "router"]
    got = np.concatenate([r.numpy().ravel() for r in routers])
    np.testing.assert_array_equal(
        np.sort(got), np.sort(np.concatenate([w.ravel() for w in want])))
    assert tp["layers"][0]["ffn"]["wi"].dtype == torch.bfloat16
    from repro_torch.models import init_params

    drawn = init_params(tcfg, seed=0, device="cpu")
    assert all(lp["ffn"]["router"].dtype == torch.float32
               for lp in drawn["layers"] if "router" in lp["ffn"])


def test_interleaved_moe_needs_a_period():
    """As in the reference, MoE on every k-th layer (``moe_every`` > 1)
    comes only with a hybrid period; a homogeneous stack refuses it."""
    cfg = dataclasses.replace(tconfigs.get("qwen2-moe-a2.7b", smoke=True),
                              moe_every=2)
    with pytest.raises(NotImplementedError, match="attn_layer_period"):
        init_decode_state(cfg, 1, 4, device="cpu")
    jcfg = dataclasses.replace(jconfigs.get("qwen2-moe-a2.7b", smoke=True),
                               moe_every=2)
    with pytest.raises(NotImplementedError, match="attn_layer_period"):
        j_init_params(jax.random.key(0), jcfg)

"""The port's RWKV-6 against the JAX reference: the WKV recurrence, the
time-mix and channel-mix layers, prefill, the serve step and greedy
generation on ``rwkv6-smoke``.

The same numpy inputs enter both packages; the reference's weights are
carried across with ``convert.params_from_numpy`` after ``bonus_u`` and
``decay_w0`` are perturbed in the numpy tree (at init ``u = 0``, which
would leave the bonus term untested, and ``w0 = -6`` gives every decay
~0.9975).  The port's ``rwkv6_wkv_fwd`` runs its plain version on the
CPU; the reference's WKV Pallas kernel runs in interpret mode.
Tolerances: ``1e-5`` where the compute dtype is float32, ``5e-2`` in
bfloat16 (as in ``test_torch_models.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ops import rwkv6_wkv as j_wkv_chunked  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_wkv_fwd as j_wkv  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import serve_step as j_serve_step  # noqa: E402
from repro.serving.llm_replica import SharedModel as JSharedModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (rwkv6_wkv,  # noqa: E402
                                            rwkv6_wkv_fwd, rwkv6_wkv_plain)
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import init_decode_state, init_params  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.models.layers import embed_inputs, logits_fn  # noqa: E402
from repro_torch.models.transformer import backbone  # noqa: E402
from repro_torch.serving import SharedModel  # noqa: E402

ARCH = "rwkv6-3b"
#: compute dtype, parameter dtype
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "float32"),
          "bf16-params": ("bfloat16", "bfloat16")}
WKV_TOL = 1e-5


def close(got, want, dtype, tol=None):
    t = tol or (1e-5 if dtype == "float32" else 5e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=t, rtol=t)


def configs(dt):
    dtype, pdtype = DTYPES[dt]
    return tuple(dataclasses.replace(m.get(ARCH, smoke=True), dtype=dtype,
                                     param_dtype=pdtype)
                 for m in (jconfigs, tconfigs))


def perturbed_tree(jp, seed=11):
    """The reference's params as float32 numpy, with a non-zero bonus and
    spread decays."""
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    rng = np.random.default_rng(seed)
    tm = tree["layers"]["tm"]
    tm["bonus_u"] = rng.standard_normal(tm["bonus_u"].shape).astype(
        np.float32) * 0.5
    tm["decay_w0"] = rng.uniform(-4.0, 0.5, tm["decay_w0"].shape).astype(
        np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def models(dt, seed=0):
    """(reference cfg, port cfg, reference params, port params, numpy
    tree), the same perturbed weights on both sides."""
    jcfg, tcfg = configs(dt)
    tree = perturbed_tree(j_init_params(jax.random.key(seed), jcfg))
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jcfg.pdtype), tree)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu"), tree


def activations(cfg, shape, seed=0):
    """(jax, torch) copies of one numpy draw in the compute dtype."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jx = jnp.asarray(x).astype(cfg.dtype)
    return jx, torch.tensor(np.asarray(jx, np.float32)).to(
        torch_dtype(cfg.dtype))


def wkv_inputs(b, t, h, hd, seed=3):
    """Drawn as ``tests/test_kernels.py`` draws them: w in (0.45, 0.95),
    non-zero u and s0."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    w = 0.5 / (1.0 + np.exp(-n(b, t, h, hd))) + 0.45
    return [n(b, t, h, hd), n(b, t, h, hd) * 0.3, n(b, t, h, hd),
            w.astype(np.float32), n(h, hd) * 0.1, n(b, h, hd, hd) * 0.1]


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------

# the reference's sweep (tests/test_kernels.py:92) and one decode step
WKV_SHAPES = [(1, 16, 2, 16), (2, 64, 4, 32), (1, 128, 1, 64), (2, 1, 4, 16)]


@pytest.mark.parametrize("b,t,h,hd", WKV_SHAPES)
def test_wkv_plain_matches_reference_oracle_and_pallas(b, t, h, hd):
    xs = wkv_inputs(b, t, h, hd)
    out, s_last = rwkv6_wkv_plain(*map(torch.tensor, xs))
    assert out.shape == (b, t, h, hd) and s_last.shape == (b, h, hd, hd)
    js = [jnp.asarray(x) for x in xs]
    for want, s_want in (jref.rwkv6_wkv_ref(*js),
                         j_wkv(*js, interpret=True)):
        close(out, want, "float32", WKV_TOL)
        close(s_last, s_want, "float32", WKV_TOL)


def wkv_in_kernel_order(r, k, v, w, u, s0):
    """The recurrence in float32 in the CUDA kernel's order
    (``csrc/rwkv6_wkv.cu``): the bonus factored out, ``a_t = sum_i r_i
    u_i k_i``, ``o = r S + a_t v``, ``S = w S + k v^T``.  Lane p of a
    column group (hd / 8 lanes, 8 rows each) sums its rows 4p .. 4p + 3
    and 4P + 4p .. 4P + 4p + 3 in that order, its partial of a_t times v
    folded in, and the lane partials are summed as a pairwise tree in
    lane order."""
    b, t, h, hd = r.shape
    lanes = hd // 8
    mine = torch.tensor([[4 * p + e for e in range(4)]
                         + [4 * lanes + 4 * p + e for e in range(4)]
                         for p in range(lanes)])          # (lanes, 8)
    s = s0.clone()
    uu = u[:, mine]                                       # (h, lanes, 8)
    outs = []
    for step in range(t):
        rt, kt = (x[:, step][:, :, mine] for x in (r, k))  # (b, h, lanes, 8)
        vt, wt = v[:, step], w[:, step]
        rows = s[:, :, mine]                              # (b, h, lanes, 8, hd)
        a = torch.zeros((b, h, lanes))
        q = torch.zeros((b, h, lanes, hd))
        for i in range(8):
            a = a + rt[..., i] * (uu[..., i] * kt[..., i])
            q = q + rt[..., i, None] * rows[:, :, :, i]
        q = q + a[..., None] * vt[:, :, None]
        while q.shape[2] > 1:
            q = q[:, :, 0::2] + q[:, :, 1::2]
        outs.append(q[:, :, 0])
        s = wt[..., None] * s + k[:, step, :, :, None] * vt[:, :, None]
    return torch.stack(outs, 1), s


def test_wkv_kernel_order_matches_reference_oracle():
    """The factored sum's drift over a prefill-length T at the main path's
    head size, before any chip time: within the kernel's tolerance on the
    card, 1e-4 of the reference's largest magnitude."""
    xs = wkv_inputs(1, 1024, 2, 64, seed=9)
    out, s_last = wkv_in_kernel_order(*map(torch.tensor, xs))
    want, s_want = jref.rwkv6_wkv_ref(*map(jnp.asarray, xs))
    for got, ref in ((out, want), (s_last, s_want)):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_wkv_fwd_on_the_cpu_runs_the_plain_version_in_place():
    xs = [torch.tensor(x) for x in wkv_inputs(2, 5, 4, 16)]
    want, s_want = rwkv6_wkv_plain(*xs)
    before = rwkv6_wkv_fwd.launches
    s0 = xs[5].clone()
    out, s_last = rwkv6_wkv_fwd(*xs[:5], s0, s_last=s0)
    assert s_last is s0 and rwkv6_wkv_fwd.launches == before
    assert torch.equal(out, want) and torch.equal(s0, s_want)


@pytest.mark.parametrize("bad", ["float64", "u_shape", "t0", "s_last"])
def test_wkv_fwd_rejects_bad_inputs(bad):
    r, k, v, w, u, s0 = (torch.tensor(x) for x in wkv_inputs(1, 4, 2, 16))
    s_last = None
    if bad == "float64":
        r = r.double()
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "t0":
        r, k, v, w = (x[:, :0] for x in (r, k, v, w))
    else:
        s_last = torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError, match="rwkv6_wkv"):
        rwkv6_wkv_fwd(r, k, v, w, u, s0, s_last=s_last)


@pytest.mark.parametrize("b", [1, 2])
def test_wkv_chunked_matches_reference_wrapper(b):
    """``chunk=16`` over T = 64, the state carried across four launches:
    against the reference's chunked wrapper and the unchunked call."""
    xs = wkv_inputs(b, 64, 2, 16, seed=4)
    got, s_got = rwkv6_wkv(*map(torch.tensor, xs), chunk=16)
    want, s_want = j_wkv_chunked(*map(jnp.asarray, xs), chunk=16)
    close(got, want, "float32", WKV_TOL)
    close(s_got, s_want, "float32", WKV_TOL)
    whole, s_whole = rwkv6_wkv(*map(torch.tensor, xs))
    torch.testing.assert_close(got, whole, rtol=WKV_TOL, atol=WKV_TOL)
    torch.testing.assert_close(s_got, s_whole, rtol=WKV_TOL, atol=WKV_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv6_wkv(*map(torch.tensor, xs), chunk=24)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer_state(cfg, b, seed, names):
    """A random incoming state as (jax dict, torch dict), shifts in the
    activation dtype, the WKV state in float32."""
    h, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    j, t = {}, {}
    for i, name in enumerate(names):
        if name == "wkv":
            x = np.random.default_rng(seed + i).standard_normal(
                (b, h, hd, hd), dtype=np.float32)
            j[name], t[name] = jnp.asarray(x), torch.tensor(x)
        else:
            j[name], t[name] = activations(cfg, (b, cfg.d_model),
                                           seed=seed + i)
    return j, t


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(dt, with_state):
    jcfg, tcfg, jp, tp, _ = models(dt)
    jx, tx = activations(jcfg, (2, 7, jcfg.d_model), seed=5)
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["tm"])
    js, ts = (_layer_state(jcfg, 2, 20, ("shift", "wkv")) if with_state
              else (None, None))
    want, wstate = jax.jit(lambda p, x, s: jrwkv.rwkv_time_mix(
        p, jcfg, x, s))(jl, jx, js)
    got, gstate = trwkv.rwkv_time_mix(tp["layers"][1]["tm"], tcfg, tx, ts)
    assert got.dtype == tcfg.adtype and gstate["wkv"].dtype == torch.float32
    if with_state:
        assert gstate is ts                       # written in place
    close(got, want, jcfg.dtype)
    close(gstate["shift"], wstate["shift"], jcfg.dtype)
    # the WKV state is float32 whatever the activations: 5e-2 in bf16
    # covers the bf16 projections feeding it
    close(gstate["wkv"], wstate["wkv"], jcfg.dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(dt, with_state):
    jcfg, tcfg, jp, tp, _ = models(dt)
    jx, tx = activations(jcfg, (2, 7, jcfg.d_model), seed=6)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["cm"])
    js, ts = (_layer_state(jcfg, 2, 30, ("shift",)) if with_state
              else (None, None))
    want, wstate = jax.jit(lambda p, x, s: jrwkv.rwkv_channel_mix(
        p, jcfg, x, s))(jl, jx, js)
    got, gstate = trwkv.rwkv_channel_mix(tp["layers"][0]["cm"], tcfg, tx, ts)
    assert got.dtype == tcfg.adtype
    close(got, want, jcfg.dtype)
    close(gstate["shift"], wstate["shift"], jcfg.dtype)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def test_params_from_numpy_takes_the_reference_tree():
    jcfg, tcfg, _, tp, tree = models("f32")
    for i in range(tcfg.n_layers):
        for part in ("tm", "cm"):
            for name, leaf in tree["layers"][part].items():
                np.testing.assert_array_equal(
                    tp["layers"][i][part][name].numpy(), leaf[i])
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["tm"]["bonus_u"] = bad["layers"]["tm"]["bonus_u"][:, :, :4]
    with pytest.raises(ValueError, match="tm.bonus_u"):
        params_from_numpy(bad, tcfg, device="cpu")


def test_init_params_draws_the_reference_laws():
    cfg = dataclasses.replace(tconfigs.get(ARCH, smoke=True),
                              param_dtype="bfloat16")
    p = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    lp = p["layers"][1]
    assert set(lp) == {"ln1", "tm", "ln2", "cm"}
    assert torch.equal(lp["tm"]["w_r"], again["layers"][1]["tm"]["w_r"])
    d, h, hd = cfg.d_model, cfg.d_model // cfg.rwkv_head_size, \
        cfg.rwkv_head_size
    for x in (*lp["tm"].values(), *lp["cm"].values()):
        assert x.dtype == torch.bfloat16
    assert torch.equal(lp["tm"]["decay_w0"].float(), torch.full((d,), -6.0))
    assert torch.equal(lp["tm"]["bonus_u"].float(), torch.zeros(h, hd))
    assert torch.equal(lp["tm"]["ln_x"].float(), torch.ones(d))
    for mix, rows in ((lp["tm"]["mix"], 5), (lp["cm"]["mix"], 2)):
        assert mix.shape == (rows, d)
        assert 0.0 <= float(mix.min()) and float(mix.max()) < 1.0
        assert abs(float(mix.float().mean()) - 0.5) < 0.05
    for w, fan_in in ((lp["tm"]["w_r"], d), (lp["tm"]["decay_w1"], d),
                      (lp["tm"]["decay_w2"], trwkv.LORA_RANK),
                      (lp["cm"]["w_v"], cfg.d_ff)):
        x = w.float() * fan_in ** 0.5
        assert float(x.abs().max()) <= 3.0 + 1e-2
        # a normal truncated at 3 sigma has std 0.9866
        assert abs(float(x.std()) - 0.9866) < 0.05


# ---------------------------------------------------------------------------
# prefill, serve step, generate
# ---------------------------------------------------------------------------


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prefill_logits_match_reference(dt):
    jcfg, tcfg, jp, tp, _ = models(dt)
    toks = tokens(jcfg, 2, 16, seed=6)
    got = make_prefill_step(tcfg, device="cpu")(tp, {"inputs": toks})
    assert got.shape == (2, jcfg.vocab_size) and got.dtype == tcfg.adtype
    want = jax.jit(j_prefill(jcfg))(jp, {"inputs": jnp.asarray(toks)})
    close(got, want, jcfg.dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_serve_step_matches_reference(dt):
    """Six steps: logits, ``cache_len`` and every state leaf of every
    layer."""
    jcfg, tcfg, jp, tp, _ = models(dt, seed=1)
    toks = tokens(jcfg, 3, 6, seed=7)
    jstate = j_init_state(jcfg, 3, 8)
    tstate = init_decode_state(tcfg, 3, 8, device="cpu")
    jstep = jax.jit(lambda p, s, b: j_serve_step(p, jcfg, s, b))
    step = make_serve_step(tcfg, device="cpu")
    for t in range(6):
        jl, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(toks[:, t])})
        tl, tstate = step(tp, tstate, {"inputs": toks[:, t]})
        assert tl.shape == (3, jcfg.vocab_size) and tl.dtype == tcfg.adtype
        close(tl, jl, jcfg.dtype)
        assert int(tstate["cache_len"]) == int(jstate["cache_len"]) == t + 1
    assert len(tstate["rwkv"]) == tcfg.n_layers
    for i, st in enumerate(tstate["rwkv"]):
        for name in ("tm_shift", "wkv", "cm_shift"):
            assert st[name].dtype == (torch.float32 if name == "wkv"
                                      else tcfg.adtype)
            close(st[name], jstate["rwkv"][name][i], jcfg.dtype)


def test_generate_matches_reference():
    """Unequal prompts (right-padded with 0 and teacher-forced), three
    prompts padded to a batch of four, six greedy tokens: equal."""
    jcfg, tcfg = configs("f32")
    ref = JSharedModel(jcfg, max_len=24, max_batch=4, seed=2)
    tree = perturbed_tree(ref.params, seed=12)
    ref.params = jax.tree.map(jnp.asarray, tree)
    port = SharedModel(tcfg, max_len=24, max_batch=4, device="cpu",
                       params=params_from_numpy(tree, tcfg, device="cpu"))
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(1, jcfg.vocab_size, n)) for n in (5, 2, 7)]
    want = ref.generate(prompts, 6)
    got = port.generate(prompts, 6)
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_decode_matches_prefill():
    """Feeding tokens one by one through the state reproduces the
    full-sequence logits at every position (float32, the port alone; the
    counterpart of ``tests/test_arch_smoke.py``'s RWKV check)."""
    _, cfg, _, params, _ = models("f32")
    toks = tokens(cfg, 2, 6, seed=9)
    x = embed_inputs(params["embedding"], cfg, torch.tensor(toks))
    with torch.no_grad():
        full = logits_fn(params, cfg, backbone(params, cfg, x, None))
    step = make_serve_step(cfg, device="cpu")
    state = init_decode_state(cfg, 2, 8, device="cpu")
    for t in range(6):
        logits, state = step(params, state, {"inputs": toks[:, t]})
        torch.testing.assert_close(logits, full[:, t], atol=1e-5, rtol=1e-5)

"""Training the MoE and hybrid Mamba families in the port against the JAX
reference: gradients through the expert dispatch (``models.moe``) and
the chunked selective scan (``models.mamba``), the whole loss and every
gradient of qwen2-moe, llama4-scout and jamba SMOKE, remat, AdamW train
steps and the training CLI (``launch.train``).

The reference's weights are carried across with
``convert.params_from_numpy``; inputs are drawn with numpy from a seed.
Tolerances are ``tests/test_torch_train.py``'s: the loss, ce, aux and
every gradient within 1e-5 in float32 (the gradients also within 1e-4 of
the leaf's largest magnitude), 5e-2 in bfloat16; train steps' moments
and metrics within 1e-5 of each leaf's largest.  Parameters after the
AdamW steps are held within 1e-4 of each leaf's largest (lr / 10) at
Adam's eps 1e-8 and 1e-6: where a gradient element is about eps, Adam
turns a last-bit difference of the gradient into up to lr * |dg| / eps
(see ``test_three_train_steps_match_reference``).

In bfloat16 the reference runs eagerly (``jax.disable_jit``): jitted on
the CPU, XLA keeps fused bfloat16 intermediates in float32, which moves
the router's input and flips near-tie expert choices (ROADMAP queue 3,
"Routing ties").  The gradient reaches the router through the
renormalised gate and the auxiliary loss's mean probability only: the
load count is a one-hot (reference) or a scatter of ones (port), with no
gradient.
"""
import contextlib
import dataclasses
import functools
import io
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import _tree, configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

#: the routed families: two MoE archs and the hybrid Mamba one
ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")
MOE = "qwen2-moe-a2.7b"
HYBRID = "jamba-v0.1-52b"


def configs(arch, dtype="float32", **over):
    over = dict(dtype=dtype, param_dtype="float32", **over)
    return tuple(dataclasses.replace(m.get(arch, smoke=True), **over)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def models(arch, dtype="float32", remat=False):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = configs(arch, dtype, remat=remat)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def batch_of(cfg, seed, b=2, s=16):
    return TokenPipeline(b, s, cfg.vocab_size, seed=seed).next_batch()


def reference(fn, dtype):
    """The reference's ``fn``: jitted in float32, eager in bfloat16."""
    if dtype == "float32":
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def as_port(jtree, tcfg):
    """A reference tree (parameters, gradients, moments) as the port's
    flat ``{name: tensor}``."""
    return dict(_tree.items(params_from_numpy(
        jax.tree.map(np.asarray, jtree), tcfg, device="cpu")))


def grad_close(got, want, tol, what):
    """Within ``tol`` absolute, and within ``tol`` (float32: 1e-4) of the
    leaf's largest magnitude."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= max(tol, 1e-4 * scale if tol < 1e-4 else tol * scale), \
        f"{what}: max abs err {err} (largest {scale})"


def port_loss_and_grads(tp, tcfg, batch):
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in _tree.items(tp)}
    loss, metrics = forward(_tree.unflatten(tp, leaves), tcfg,
                            {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(arch, dtype, remat, seed):
    jcfg, tcfg, jp, _ = models(arch, dtype, remat)
    batch = batch_of(tcfg, seed)
    (loss, m), g = reference(jax.value_and_grad(
        lambda p, bt: j_forward(p, jcfg, bt), has_aux=True), dtype)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(m["ce"]), float(m["aux"]), as_port(g, tcfg)


# ---------------------------------------------------------------------------
# what trains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_train_step_accepts_moe_and_hybrid(arch, smoke):
    """``make_train_step`` (through ``check_trainable``) takes the MoE and
    hybrid families, SMOKE and FULL, and touches no tensor doing so: no
    torch operator is dispatched until the step is called."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tconfigs.get(arch, smoke=smoke)
    with Ops() as ops:
        transformer.check_trainable(cfg)
        step = make_train_step(cfg, AdamWConfig(), device="cpu")
    assert callable(step) and ops.n == 0


def test_check_trainable_refuses_only_what_check_ported_refuses():
    """Both checks take every arch and RWKV's ``kernel_stub``, whose
    training loss equals the reference's within 1e-5 in float32."""
    jstub, stub = (dataclasses.replace(m.get("rwkv6-3b", smoke=True),
                                       wkv_impl="kernel_stub",
                                       dtype="float32")
                   for m in (jconfigs, tconfigs))
    for check in (transformer.check_ported, transformer.check_trainable):
        check(stub)
    for arch in tconfigs.PORTED:
        transformer.check_trainable(tconfigs.get(arch, smoke=True))
    jp = j_init_params(jax.random.key(2), jstub)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), stub, device="cpu")
    batch = TokenPipeline(2, 16, stub.vocab_size, seed=3).next_batch()
    jloss, _ = j_forward(jp, jstub, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    loss, _ = forward(tp, stub, {k: torch.tensor(v)
                                 for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the whole loss and every gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_every_gradient_match_reference(arch, dtype, remat):
    _, tcfg, _, tp = models(arch, dtype, remat)
    jloss, jce, jaux, want = reference_loss_and_grads(arch, dtype, remat, 7)
    loss, metrics, grads = port_loss_and_grads(tp, tcfg, batch_of(tcfg, 7))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for got, ref in ((loss, jloss), (metrics["ce"], jce),
                     (metrics["aux"], jaux)):
        np.testing.assert_allclose(float(got.detach()), ref, rtol=tol,
                                   atol=tol)
    assert float(metrics["aux"].detach()) > 0
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[name].shape
        grad_close(g, want[name].numpy(), tol, f"{arch} {dtype} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_routed_layer_trains_its_router_and_experts(arch):
    """The router gets a gradient in every MoE layer (through the gate
    and the auxiliary loss), and so does every expert that took a
    token."""
    _, tcfg, _, tp = models(arch)
    batch = batch_of(tcfg, 8)
    _, _, grads = port_loss_and_grads(tp, tcfg, batch)
    routed = [i for i in range(tcfg.n_layers)
              if "router" in tp["layers"][i]["ffn"]]
    assert routed
    for i in routed:
        assert float(grads[f"layers/{i}/ffn/router"].abs().max()) > 0, i
        for w in ("wi", "wg", "wo"):
            per_expert = grads[f"layers/{i}/ffn/{w}"].abs().flatten(1)
            assert int((per_expert.amax(1) > 0).sum()) > 0, (i, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """Checkpointing each layer changes what is kept, not what is
    computed: the loss, aux and every gradient bit for bit on the CPU
    (the routing recomputed in the backward routes as the forward did).
    The reference checkpoints a hybrid model a period at a time; a layer
    at a time is the same arithmetic."""
    out = []
    for remat in (False, True):
        _, tcfg, _, tp = models(arch, "bfloat16", remat)
        loss, m, grads = port_loss_and_grads(tp, tcfg, batch_of(tcfg, 9))
        out.append([loss, m["aux"].detach()] + list(grads.values()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_remat_checkpoints_and_recomputes_each_layer(arch, monkeypatch):
    """With remat every layer runs under its own checkpoint, and the
    backward runs each layer's forward once more: two calls a routed
    layer of ``apply_moe``, two a Mamba layer of ``mamba_block``."""
    calls = []
    for name in ("apply_moe", "mamba_block"):
        real = getattr(transformer, name)
        monkeypatch.setattr(transformer, name,
                            lambda *a, _f=real, _n=name: (calls.append(_n),
                                                          _f(*a))[1])
    real_ckpt = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: (calls.append("checkpoint"),
                                         real_ckpt(*a, **k))[1])
    for remat in (False, True):
        calls.clear()
        _, tcfg, _, tp = models(arch, "float32", remat)
        port_loss_and_grads(tp, tcfg, batch_of(tcfg, 10))
        kinds = [transformer._kinds(tcfg, i) for i in range(tcfg.n_layers)]
        n_moe = sum(ffn == "moe" for _, ffn in kinds)
        n_mamba = sum(mixer == "mamba" for mixer, _ in kinds)
        assert n_moe and (n_mamba > 0) == (arch == HYBRID)
        times = 2 if remat else 1
        assert calls.count("checkpoint") == (tcfg.n_layers if remat else 0)
        assert calls.count("apply_moe") == times * n_moe
        assert calls.count("mamba_block") == times * n_mamba


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def rel_close(got, want, what, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("eps", [1e-8, 1e-6])
def test_three_train_steps_match_reference(arch, eps):
    """Three jitted reference steps against three port steps from the
    same weights and batches: loss, ce, aux, lr and grad_norm, every
    parameter and both moments after each step, and the step count (the
    conventions of ``tests/test_torch_train.py``: metrics and moments
    within 1e-5 of each leaf's largest magnitude).

    A parameter moves by lr * mhat / (sqrt(nhat) + eps) a step; where a
    gradient element is about eps, Adam turns a last-bit difference of
    the gradient into up to lr * |dg| / eps.  The routed models have such
    elements at both eps (llama4-scout-smoke's ``shared/wo`` moves 5.2e-5
    apart at eps 1e-8, jamba-smoke's embedding 4.8e-5 at eps 1e-6, lr
    1e-3, while the moments agree within 7e-8), so parameters are held
    within 1e-4 (lr / 10; the dense archs' 5e-5 at eps 1e-8 is lr / 20)."""
    param_tol = 1e-4
    jcfg, tcfg, jp, tp = models(arch)
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
            rel_close(tm[k], jm[k], f"step {i} {k}")
        assert float(tm["aux"]) > 0
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        for name, tree, jtree in (("params", tp, jp),
                                  ("mu", tst["mu"], jst["mu"]),
                                  ("nu", tst["nu"], jst["nu"])):
            want = as_port(jtree, tcfg)
            got = dict(_tree.items(tree))
            assert set(got) == set(want)
            for k, t in got.items():
                rel_close(t.numpy(), want[k].numpy(), f"step {i} {name} {k}",
                          param_tol if name == "params" else 1e-5)


@pytest.mark.parametrize("arch", [MOE, HYBRID])
def test_donated_step_gives_the_same_bits_in_place(arch):
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True), remat=True)
    params = transformer.init_params(cfg, seed=2, device="cpu")
    state = adamw_init(params)
    kept = make_train_step(cfg, AdamWConfig(**OPT), device="cpu")
    donated = make_train_step(cfg, AdamWConfig(**OPT), device="cpu",
                              donate=True)
    p2, s2 = (_tree.tree_map(torch.clone, t) for t in (params, state))
    before = _tree.leaves(p2)
    pipe = TokenPipeline(2, 16, cfg.vocab_size, seed=5)
    for _ in range(2):
        batch = pipe.next_batch()
        params, state, m = kept(params, state, batch)
        out_p, out_s, m2 = donated(p2, s2, batch)
        assert out_p is p2 and out_s is s2
        for a, b in zip(_tree.leaves({"p": params, "s": state, "m": m}),
                        _tree.leaves({"p": p2, "s": s2, "m": m2})):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(a is b for a, b in zip(before, _tree.leaves(p2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_cli_prints_the_reference_clis_losses(dtype, monkeypatch):
    """``python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke
    --device cpu --steps 3`` against the reference's CLI with the same
    arguments, both from the reference's weights: each step's loss and
    the same printed lines.  The SMOKE config computes in bfloat16, where
    the two packages' attention rounds apart (ROADMAP queue 3,
    "Attention and RoPE"): its losses are held within 5e-2, with the
    reference run eagerly; both CLIs given the config in float32 compute
    (``configs.get`` patched alike) print losses within 1e-5."""
    recorded = {}
    for mod, key in ((jtrain, "reference"), (ttrain, "port")):
        real = mod.train
        monkeypatch.setattr(
            mod, "train", lambda *a, _r=real, _k=key, **kw:
            recorded.setdefault(_k, _r(*a, **kw)))
        real_get = mod.configs.get
        monkeypatch.setattr(
            mod.configs, "get", lambda *a, _g=real_get, **kw:
            dataclasses.replace(_g(*a, **kw), dtype=dtype))
    jcfg = jconfigs.get(MOE, smoke=True)
    jp = j_init_params(jax.random.key(0), jcfg)
    monkeypatch.setattr(ttrain, "init_params", lambda cfg, **kw:
                        params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device=kw["device"]))
    argv = ["--arch", MOE, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32" if dtype == "float32" else "16"]
    printed = []
    for main, extra in ((jtrain.main, []),
                        (ttrain.main, ["--device", "cpu"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), (
                jax.disable_jit() if dtype == "bfloat16"
                else contextlib.nullcontext()):
            main(argv + extra)
        printed.append(out.getvalue())
    want, got = recorded["reference"]["losses"], recorded["port"]["losses"]
    assert len(got) == len(want) == 3
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert "[train] done: 3 steps" in printed[1]
    if dtype == "float32":
        assert printed[0] == printed[1]


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_chip_gradient_check_sees_a_dead_router_or_expert(chip_smoke):
    """Path R1's check of the first moment after a step
    (``chip_smoke.dead_moe_leaves``): nothing dead in a sound step; a
    zeroed router, a zeroed shared expert or the zeroed ``wo`` of an
    expert that took a token is named; an expert that took no token is
    not required to move."""
    _, tcfg, _, tp = models(MOE)
    seen = []
    with chip_smoke._routed_experts(seen):
        _, st, _ = make_train_step(tcfg, AdamWConfig(**OPT), device="cpu")(
            tp, adamw_init(tp), batch_of(tcfg, 11))
    assert len(seen) == tcfg.n_layers
    assert chip_smoke.dead_moe_leaves(st["mu"], seen) == []
    took = chip_smoke.experts_taken(seen[1])
    mu = st["mu"]["layers"]
    mu[0]["ffn"]["router"].zero_()
    mu[1]["ffn"]["shared"]["wg"].zero_()
    mu[1]["ffn"]["wo"][took[0]].zero_()
    assert chip_smoke.dead_moe_leaves(st["mu"], seen) == [
        "layers.0.ffn.router", "layers.1.ffn.shared.wg",
        f"layers.1.ffn.wo[{took[0]}]"]
    idle = [e for e in range(tcfg.n_experts) if e not in took]
    if idle:
        mu[1]["ffn"]["wi"][idle[0]].zero_()
        assert len(chip_smoke.dead_moe_leaves(st["mu"], seen)) == 3


@pytest.mark.parametrize("arch", [MOE, HYBRID, "llama4-scout-17b-a16e"])
def test_chip_train_agreement_takes_a_sound_step_and_rejects_its_control(
        chip_smoke, arch, monkeypatch):
    """Paths R2's and R3's check (``chip_smoke.train_agreement``) run on
    the CPU, where the flash wrappers run their plain versions: the
    kernels' steps equal the plain steps, so the losses and every update
    agree; the bfloat16 backward of ``agreement_controls`` reads above
    the float32 update limit and is rejected; only the launch counts
    (none on the CPU) fail."""
    failed = []
    monkeypatch.setattr(chip_smoke, "_require",
                        lambda ok, msg: ok or failed.append(msg))
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              dtype="float32", remat=True)
    pipe = TokenPipeline(2, 16, cfg.vocab_size, seed=5)
    out = chip_smoke.train_agreement(
        torch.device("cpu"), cfg, [pipe.next_batch()],
        AdamWConfig(lr=1e-3, warmup_steps=1, eps=1e-3), arch,
        controls=chip_smoke.agreement_controls())
    assert len(failed) == 1 and "launches" in failed[0], failed
    got_l, want_l = out["losses"]
    assert got_l == want_l
    assert out["verdict"]["rel_norm"] <= chip_smoke.F32_UPDATE_REL_TOL
    assert out["verdict"]["max_rel"] <= chip_smoke.K2_TOL
    assert out["margin"] > 0
    (reading,) = out["controls"].values()
    assert reading > chip_smoke.F32_UPDATE_REL_TOL


class _CpuTimed:
    """A profiler event whose self device time reads its self CPU time,
    so that a CPU profile can stand in for a card's."""

    def __init__(self, event, memo):
        self._event, self._memo = event, memo

    def __getattr__(self, name):
        return getattr(self._event, name)

    @property
    def self_device_time_total(self):
        return self._event.self_cpu_time_total

    @property
    def cpu_children(self):
        return [_cpu_timed(c, self._memo) for c in self._event.cpu_children]


def _cpu_timed(event, memo):
    if id(event) not in memo:
        memo[id(event)] = _CpuTimed(event, memo)
    return memo[id(event)]


def test_chip_moe_step_parts_split_a_profiled_step(chip_smoke):
    """Path R1's split of a profiled train step (``chip_smoke.
    moe_step_parts``), on a CPU profile of a donated qwen2-moe-smoke step
    whose events' CPU times stand in for device times: AdamW found under
    its ``record_function`` range (``chip_smoke._ranged``), the expert
    einsums, the other matmuls, the loss's
    operators on (.., vocab) tensors, the dispatch gathers and their
    scatter-add backward each nonzero, and no operator counted twice."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    _, tcfg, _, tp = models(MOE, remat=True)
    params = _tree.tree_map(torch.clone, tp)
    step = make_train_step(tcfg, AdamWConfig(**OPT), device="cpu",
                           donate=True)
    batch = batch_of(tcfg, 3)
    with chip_smoke._swapped([chip_smoke._ranged(steps, "adamw_update")]), \
            profile(activities=[ProfilerActivity.CPU],
                    record_shapes=True) as prof:
        step(params, adamw_init(params), batch)
    memo = {}
    events = [_cpu_timed(e, memo) for e in prof.events()]
    fake = type("Profile", (), {"events": lambda self: events})()
    parts = chip_smoke.moe_step_parts(tcfg.vocab_size)(fake, {})
    for k in ("AdamW",
              "expert einsums (aten::bmm)",
              "other matmuls (aten::mm, aten::addmm)",
              "f32 loss (ops on (.., vocab) tensors)",
              "dispatch gathers (aten::gather)",
              "their backward (aten::scatter_add)"):
        assert parts[k] > 0, (k, parts)
    total = sum(e.self_cpu_time_total for e in prof.events()) / 1e3
    assert sum(parts.values()) <= total * (1 + 1e-9)


def test_chip_r_row_carries_r1s_call_and_rs_launches(chip_smoke):
    """Path R's flash forward row (``chip_smoke.r_row``): every key the
    ``{"kernels": ...}`` line needs, R1-R3's launches by part (a part
    that did not run counts none), R1's call among its ``calls``; merged
    into the full run's row (``merge_rows``) it adds its launches, error
    and call and leaves the row's own figures."""
    call = dict(shape=[4, 16, 16, 2048, 128], ms=0.18, wrapper_ms=0.2,
                plain_ms=3.0, library_ms=0.14, bound_ms=0.07,
                bound_by="operations", max_abs_err=2e-3,
                lse_max_abs_err=1e-6)
    out = {"R1": {"flash_attention_fwd": 32, "call": call},
           "R3": {"flash_attention_fwd": 12}}
    row = chip_smoke.r_row(out)
    assert {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"} <= set(row)
    assert row["launches"] == 44
    assert row["launches_by_path"] == {"R1": 32, "R3": 12}
    assert row["calls"][0]["ms"] == 0.18 and "R1" in row["calls"][0]["at"]
    full = [dict(name="flash_attention", launches=10, ms=0.5,
                 launches_by_path={"D1": 10}, max_abs_err=1e-3)]
    chip_smoke.merge_rows(full, [row])
    assert full[0]["launches"] == 54 and full[0]["ms"] == 0.5
    assert full[0]["launches_by_path"] == {"D1": 10, "R1": 32, "R3": 12}
    assert full[0]["max_abs_err"] == 2e-3 and full[0]["calls"] == row["calls"]


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

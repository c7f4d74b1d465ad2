"""Training the MoE and hybrid Mamba families in the port against the JAX
reference: gradients through the expert dispatch (``models.moe``) and
the chunked selective scan (``models.mamba``), the whole loss and every
gradient of qwen2-moe, llama4-scout and jamba SMOKE, remat, AdamW train
steps and the training CLI (``launch.train``).  This file holds what
trains and the chip helpers; ``test_torch_moe_train_grads.py`` the whole
loss and every gradient, ``test_torch_moe_train_steps.py`` the AdamW
steps and the CLI, ``test_torch_moe_train_dispatch.py`` the dispatch's
and the scan's gradients (split so that ``--dist loadfile`` spreads them
over workers; the helpers are ``_torch_moe_train_common.py``).

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
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_moe_train_common import *  # noqa: E402,F401,F403
from _torch_moe_train_common import _tree  # noqa: E402,F401


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



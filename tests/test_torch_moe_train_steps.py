"""Three AdamW train steps of the MoE and hybrid Mamba families against
the reference's jitted steps, the donated step in place, and the
training CLI's losses against the reference CLI's.  Split from
``test_torch_moe_train.py``; its module docstring says more."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_moe_train_common import *  # noqa: E402,F401,F403
from _torch_moe_train_common import _tree  # noqa: E402,F401


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------



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



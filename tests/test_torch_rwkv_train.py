"""RWKV-6 training in the port against the JAX reference: the WKV
recurrence's backward, the ``WKV`` autograd function, the time-mix
layer's gradients, the whole loss and every gradient, AdamW train steps,
the training driver, and the optimizer state and checkpoints of an RWKV
tree across packages.

The reference has no backward kernel of the recurrence: it takes the
gradient of its ``lax.scan`` (``repro.models.rwkv6._wkv_scan``) by
autodiff, which ``jax.vjp`` gives here.  The port's ``rwkv6_wkv_bwd``
runs its plain version on the CPU (``rwkv6_wkv_bwd_plain``, the explicit
reverse sweep); the CUDA kernel is held against that on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` path L.  Inputs are
drawn with numpy from a seed; the reference's weights are carried across
with ``convert.params_from_numpy`` after ``bonus_u`` and ``decay_w0`` are
perturbed (at init u = 0, which would leave the bonus's gradient
untested, and every decay is ~0.9975).

Tolerances: the recurrence's gradients within 1e-5 of each gradient's
largest magnitude (float32 sums over up to 70 steps in another order);
the loss and the gradients of the layer and of the model as in
``tests/test_torch_train.py`` (1e-5 in float32, the gradients also
within 1e-4 of the leaf's largest; 5e-2 in bfloat16); train steps under
that file's conventions (parameters within 5e-5 of each leaf's largest
at Adam's eps 1e-8, 1e-5 at eps 1e-6; moments and metrics 1e-5).
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

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import _tree, configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rwkv6_scan as ws  # noqa: E402
from repro_torch.kernels.ref import rwkv6_wkv_ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models.base import torch_dtype  # noqa: E402
from repro_torch.models.transformer import backbone  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARCH = "rwkv6-3b"
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


# ---------------------------------------------------------------------------
# the recurrence's backward
# ---------------------------------------------------------------------------


def wkv_case(b, t, h, hd, seed=0):
    """r, k, v, w, u, s0, do, ds_last as numpy float32: nonzero u and s0;
    w = exp(-exp(wlog)) with wlog spread over [-8, 6], so that w holds
    exact zeros (wlog > ~4.65) and values within 3.4e-4 of 1."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    wlog = rng.uniform(-8.0, 6.0, (b, t, h, hd)).astype(np.float32)
    w = np.exp(-np.exp(wlog)).astype(np.float32)
    return [n(b, t, h, hd), n(b, t, h, hd) * 0.5, n(b, t, h, hd), w,
            n(h, hd) * 0.5, n(b, h, hd, hd) * 0.3, n(b, t, h, hd),
            n(b, h, hd, hd)]


def _rel_max(got, want, what, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= tol * scale, \
        f"{what}: max abs err {err} (largest {scale})"


def _plain_grads(xs):
    """The plain pair on xs (r, k, v, w, u, s0, do, ds_last as tensors):
    the forward with checkpoints every ``BWD_CHUNK[hd]`` steps, then the
    backward that reads them."""
    *_, ckpt = ws.rwkv6_wkv_plain(*xs[:6], checkpoints=True)
    return ws.rwkv6_wkv_bwd_plain(*xs[:5], ckpt, *xs[6:])


def _autograd_grads(xs):
    """Autograd of the plain loop ``rwkv6_wkv_ref`` on xs: the same
    gradients as the plain pair, summed in another order."""
    leaves = [x.clone().requires_grad_(True) for x in xs[:6]]
    out, s_last = rwkv6_wkv_ref(*leaves)
    return torch.autograd.grad((out * xs[6]).sum() + (s_last * xs[7]).sum(),
                               leaves)


def _reference_vjp(xs):
    """``jax.vjp`` of the reference's ``_wkv_scan`` at xs[:6], pulled back
    from the cotangents xs[6:] (do, ds_last)."""
    js = [jnp.asarray(x) for x in xs]
    _, vjp = jax.vjp(jrwkv._wkv_scan, *js[:6])
    return vjp((js[6], js[7]))


BWD_SHAPES = [(2, 37, 3, 16), (1, 70, 2, 64)]


def test_the_draw_holds_exact_zeros_and_values_near_one():
    for shape in BWD_SHAPES:
        w = wkv_case(*shape)[3]
        assert (w == 0).sum() > 0 and w.max() > 0.999


@pytest.mark.parametrize("b,t,h,hd", BWD_SHAPES)
@pytest.mark.parametrize("chunk", [64, 16, 1])
def test_plain_bwd_matches_reference_vjp(b, t, h, hd, chunk, monkeypatch):
    """The plain backward, reading the checkpoints the plain forward
    wrote every ``chunk`` steps (the stride table set to ``chunk`` for
    the test: the pair is right at any stride, one longer than T too),
    against ``jax.vjp`` within 1e-5 of each gradient's largest (w exactly
    0 and within 3.4e-4 of 1)."""
    monkeypatch.setitem(ws.BWD_CHUNK, hd, chunk)
    xs = wkv_case(b, t, h, hd)
    got = _plain_grads(list(map(torch.tensor, xs)))
    want = _reference_vjp(xs)
    for name, g, wt in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == wt.shape
        _rel_max(g, wt, f"{name} {(b, t, h, hd)} chunk {chunk}")


@pytest.mark.parametrize("b,t,h,hd", BWD_SHAPES + [(2, 1, 2, 32)])
def test_plain_bwd_matches_autograd_of_the_plain_loop(b, t, h, hd):
    xs = [torch.tensor(x) for x in wkv_case(b, t, h, hd, seed=1)]
    want = _autograd_grads(xs)
    got = _plain_grads(xs)
    for name, g, wt in zip(GRADS, got, want):
        _rel_max(g, wt.numpy(), f"{name} {(b, t, h, hd)}")


def test_plain_bwd_gradient_where_w_is_zero_is_finite_and_right():
    """Steps whose decay underflows to 0 have a finite dw (the reference's
    gradient is finite there); the sweep never divides by w."""
    xs = wkv_case(1, 40, 2, 16, seed=2)
    xs[3][:, ::3] = 0.0
    got = _plain_grads(list(map(torch.tensor, xs)))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert float(got[3][:, ::3].abs().max()) > 0
    for name, g, wt in zip(GRADS, got, _reference_vjp(xs)):
        _rel_max(g, wt, name)


@pytest.mark.parametrize("b,t,h,hd", [(2, 37, 3, 16), (1, 70, 2, 64),
                                      (2, 21, 2, 128), (2, 1, 2, 64),
                                      (1, 1, 2, 32)])
def test_plain_checkpoints_are_the_states_every_chunk(b, t, h, hd):
    """The plain training forward: out and the last state bit-equal to the
    forward without checkpoints, and checkpoint c bit-equal to the state
    of ``rwkv6_wkv_plain`` after the first c * BWD_CHUNK[hd] steps (the
    first is s0), with T ragged and T = 1; the wrapper on CPU tensors
    gives the same."""
    xs = [torch.tensor(x) for x in wkv_case(b, t, h, hd, seed=8)][:6]
    out, s_last = ws.rwkv6_wkv_plain(*xs)
    got = ws.rwkv6_wkv_plain(*xs, checkpoints=True)
    assert torch.equal(got[0], out) and torch.equal(got[1], s_last)
    ckpt, chunk = got[2], ws.BWD_CHUNK[hd]
    assert tuple(ckpt.shape) == ws.ckpt_shape(b, t, h, hd) == (
        b, h, -(-t // chunk), hd, hd)
    assert torch.equal(ckpt[:, :, 0], xs[5])
    for c in range(1, ckpt.shape[2]):
        _, s = ws.rwkv6_wkv_plain(*(x[:, :c * chunk] for x in xs[:4]),
                                  *xs[4:])
        assert torch.equal(ckpt[:, :, c], s), c
    wrapped = ws.rwkv6_wkv_fwd(*xs, checkpoints=True)
    assert all(torch.equal(x, y) for x, y in zip(wrapped, got))


def test_kernel_and_plain_pairs_share_one_signature():
    import inspect

    for kern, plain in ((ws.rwkv6_wkv_fwd, ws.rwkv6_wkv_plain),
                        (ws.rwkv6_wkv_bwd, ws.rwkv6_wkv_bwd_plain)):
        kp = list(inspect.signature(kern).parameters)
        pp = list(inspect.signature(plain).parameters)
        assert pp[:len(kp)] == kp


def test_bwd_rejects_bad_shapes_and_dtypes():
    xs = [torch.tensor(x) for x in wkv_case(1, 5, 2, 16)]
    *_, ckpt = ws.rwkv6_wkv_plain(*xs[:6], checkpoints=True)
    with pytest.raises(ValueError, match="do must have"):
        ws.rwkv6_wkv_bwd(*xs[:5], ckpt, xs[6][:, :4], xs[7])
    with pytest.raises(ValueError, match="ckpt"):
        ws.rwkv6_wkv_bwd(*xs[:5], ckpt[:, :, :0], xs[6], xs[7])
    with pytest.raises(ValueError, match="float32"):
        ws.rwkv6_wkv_bwd(*xs[:5], ckpt, xs[6], xs[7].double())


@pytest.mark.parametrize("hd,t", [(16, 37), (32, 64), (64, 2048),
                                  (128, 9)])
def test_bwd_scratch_holds_checkpoints_partials_and_du(hd, t):
    """The checkpoints come from the forward (the state every
    ``BWD_CHUNK[hd]`` steps), dv's row-block partials stay on chip, and
    the backward's scratch holds du's partials, one a batch row; a
    chunk's recomputed states fit the kernel's ~32 KB of shared memory
    (``csrc/rwkv6_chunk.cuh``)."""
    b, h = 2, 3
    chunks = -(-t // ws.BWD_CHUNK[hd])
    assert ws.ckpt_shape(b, t, h, hd) == (b, h, chunks, hd, hd)
    assert ws.bwd_scratch_floats(b, t, h, hd) == b * h * hd
    assert hd % ws.BWD_ROWS == 0 and hd // ws.BWD_ROWS <= 8  # a cluster
    assert (ws.BWD_CHUNK[hd] - 1) * ws.BWD_ROWS * (hd + 4) * 4 <= 40_000


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("b,t,h,hd", [(2, 100, 3, 16), (1, 70, 2, 64),
                                      (2, 37, 2, 128)])
def test_chip_checks_take_a_sound_backward_and_reject_the_controls(
        chip_smoke, b, t, h, hd):
    """``chip_smoke.wkv_bwd_verdict`` (path L0) passes a sound backward
    that sums in another order (autograd of the plain loop) and each of
    ``wkv_bwd_controls`` fails its relative check, on the CPU before any
    chip time."""
    xs = [torch.tensor(x) for x in wkv_case(b, t, h, hd, seed=6)]
    want = _plain_grads(xs)
    sound = _autograd_grads(xs)
    verdict = chip_smoke.wkv_bwd_verdict(sound, want)
    assert all(c["close"] and c["rel_ok"] for c in verdict.values()), \
        verdict
    controls = chip_smoke.wkv_bwd_controls(xs, sound, ws.BWD_CHUNK[hd])
    assert len(controls) == 3
    for name, bad in controls.items():
        cv = chip_smoke.wkv_bwd_verdict(bad, want)
        assert not all(c["rel_ok"] for c in cv.values()), name


def test_chip_relative_check_sees_a_fault_in_one_block(chip_smoke):
    """A fault confined to one 64-step block of a head whose gradients are
    small (its output gradient scaled by 1e-2): an error far below the
    gradient's largest magnitude fails the blocked relative check where
    the scaled tolerance passes it."""
    xs = [torch.tensor(x) for x in wkv_case(2, 256, 4, 16, seed=7)]
    xs[6][1, :, 2] *= 1e-2
    xs[7][1, 2] *= 1e-2
    want = _plain_grads(xs)
    bad = [g.clone() for g in want]
    bad[2][1, 64:128, 2] *= 1.0 + 1e-3
    cv = chip_smoke.wkv_bwd_verdict(bad, want)
    assert cv["dv"]["close"] and not cv["dv"]["rel_ok"]


def test_chip_checkpoint_check_sees_a_fault_in_one_state(chip_smoke):
    """``chip_smoke.wkv_ckpt_rel_err`` (path L0's check of the training
    forward's checkpoints): the plain checkpoints against themselves give
    0; one checkpoint of a head whose state is small (its k and v scaled
    by 1e-1, its s0 by 1e-2) off by 1e-3 of itself passes the
    largest-magnitude check and fails the relative check by (batch row,
    head, checkpoint)."""
    xs = [torch.tensor(x) for x in wkv_case(2, 100, 4, 64, seed=10)][:6]
    for i in (1, 2):
        xs[i][1, :, 2] *= 1e-1
    xs[5][1, 2] *= 1e-2
    *_, ckpt = ws.rwkv6_wkv_plain(*xs, checkpoints=True)
    assert chip_smoke.wkv_ckpt_rel_err(ckpt, ckpt) == 0.0
    bad = ckpt.clone()
    bad[1, 2, 5] *= 1.0 + 1e-3
    assert float((bad - ckpt).abs().max()) <= chip_smoke.WKV_TOL * float(
        ckpt.abs().max())
    assert chip_smoke.wkv_ckpt_rel_err(bad, ckpt) > chip_smoke.WKV_BWD_REL_TOL


def test_chip_update_check_sees_a_fault_in_one_leaf(chip_smoke):
    """``chip_smoke.update_verdict`` (path L2's check of the updates): a
    sound pair of updates (1e-3 relative noise, and one element of a leaf
    off by 15% of the leaf's largest update, the gap bf16 leaves near
    g = 0) passes its relative norms; the same with one leaf's update
    wrong by 10% fails them, at that leaf."""
    gen = torch.Generator().manual_seed(9)
    want = {f"layers.{i}.tm.{n}": torch.randn(64, 48, generator=gen) * 1e-3
            for i in range(2) for n in ("w_k", "bonus_u", "decay_w0")}
    got = {n: w * (1 + 1e-3 * torch.randn(w.shape, generator=gen))
           for n, w in want.items()}
    got["layers.1.tm.bonus_u"][3, 5] += 0.15 * float(
        want["layers.1.tm.bonus_u"].abs().max())
    sound = chip_smoke.update_verdict((n, got[n], want[n]) for n in want)
    assert sound["max_rel"] > 0.1 and sound["rel_ok"], sound
    bad = dict(got)
    bad["layers.0.tm.w_k"] = want["layers.0.tm.w_k"] * 1.1
    verdict = chip_smoke.update_verdict((n, bad[n], want[n]) for n in want)
    assert not verdict["rel_ok"]
    assert verdict["rel_norm_at"] == "layers.0.tm.w_k"
    assert verdict["rel_norm"] > chip_smoke.L2_UPDATE_REL_TOL


def test_chip_paths_selector_keeps_the_full_runs_order(chip_smoke):
    """``--paths``: names and letters pick parts of ``PATH_NAMES`` in the
    full run's order; a name that is not a path raises."""
    assert chip_smoke.select_paths("L1, l0") == ["L0", "L1"]
    assert chip_smoke.select_paths("L,K") == [
        "K0", "K1", "K2", "K3", "L0", "L1", "L2"]
    assert chip_smoke.select_paths("J2,A") == ["A", "J2"]
    assert chip_smoke.select_paths("N,M,E") == ["E", "M", "N"]
    assert chip_smoke.select_paths("O") == ["O0", "O1", "O2", "O3"]
    assert chip_smoke.select_paths("q,P") == ["P", "Q"]
    assert chip_smoke.select_paths("P,D") == ["D", "P"]
    assert chip_smoke.select_paths("R") == ["R1", "R2", "R3"]
    assert chip_smoke.select_paths("s,R2,q") == ["Q", "R2", "S"]
    assert chip_smoke.select_paths("t,S") == ["S", "T"]
    for bad in ("L3", "R4", "U", "P1", ""):
        with pytest.raises(ValueError):
            chip_smoke.select_paths(bad)


def test_chip_runs_every_path_through_one_dispatcher(chip_smoke,
                                                     monkeypatch):
    """The full run and ``--paths`` share ``run_named_paths``: each named
    path runs once, in the given order, and paths A, B, C1, G and H get
    the traffic the full run makes for them (B's made once for four
    paths), which is dropped after the last path that reads it (the
    kernel rows make it again)."""
    calls = []

    def path(name):
        def run(*args):
            calls.append((name, args[-2:] if name in "A B C1 G H".split()
                          else ()))
            return {name: len(calls)}
        return run

    for name, fn in (("A", "run_path_a"), ("B", "run_path_b"),
                     ("C1", "run_path_c1"), ("C2", "run_path_c2"),
                     ("F", "run_path_f"), ("G", "run_path_g"),
                     ("H", "run_path_h"), ("I", "run_path_i"),
                     ("D", "run_path_d"), ("E", "run_path_e"),
                     ("M", "run_path_m"), ("N", "run_path_n"),
                     ("J1", "run_path_j1"), ("J2", "run_path_j2"),
                     ("K0", "run_path_k0"), ("K1", "run_path_k1"),
                     ("K2", "run_path_k2"), ("K3", "run_path_k3"),
                     ("L0", "run_path_l0"), ("L1", "run_path_l1"),
                     ("L2", "run_path_l2"), ("O0", "run_path_o0"),
                     ("O1", "run_path_o1"), ("O2", "run_path_o2"),
                     ("O3", "run_path_o3"), ("P", "run_path_p"),
                     ("Q", "run_path_q"), ("R1", "run_path_r1"),
                     ("R2", "run_path_r2"), ("R3", "run_path_r3"),
                     ("S", "run_path_s"), ("T", "run_path_t")):
        monkeypatch.setattr(chip_smoke, fn, path(name))
    made = []
    monkeypatch.setattr(chip_smoke, "path_a_traffic",
                        lambda dev, seed: made.append("a") or ("ra", "aa"))
    monkeypatch.setattr(chip_smoke, "path_b_traffic",
                        lambda dev, seed: made.append("b") or ("rb", "ab"))
    out = chip_smoke.run_named_paths("cpu", 0, list(chip_smoke.PATH_NAMES))
    assert [c[0] for c in calls] == list(chip_smoke.PATH_NAMES)
    assert made == ["a", "b"]
    assert dict(calls)["A"] == ("ra", "aa")
    assert all(dict(calls)[p] == ("rb", "ab") for p in ("B", "C1", "G", "H"))
    assert "traffic_a" not in out and "traffic_b" not in out
    assert all(out[p] == {p: i + 1}
               for i, p in enumerate(chip_smoke.PATH_NAMES))
    calls.clear()
    out = chip_smoke.run_named_paths("cpu", 0, ["B", "C1"])
    assert [c[0] for c in calls] == ["B", "C1"] and made == ["a", "b", "b"]
    assert set(out) == {"B", "C1"}
    calls.clear()
    out = chip_smoke.run_named_paths("cpu", 0, ["L0", "L1"])
    assert [c[0] for c in calls] == ["L0", "L1"]
    assert set(out) == {"L0", "L1"}


def test_chip_last_line_names_the_paths_of_a_partial_run(chip_smoke,
                                                         monkeypatch,
                                                         capsys):
    """The full run's last line is ``{"ok": true, "device": ...}`` and
    nothing more; a ``--paths`` run's names its paths."""
    import json

    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700 W")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    device = {"platform": "gpu", "kind": "card", "count": 1}
    assert chip_smoke.finish([]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last == {"ok": True, "device": device}
    assert chip_smoke.finish([], ["L0", "L1"]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last == {"ok": True, "device": device, "paths": ["L0", "L1"]}


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------


def _spy(fn, calls):
    def spy(*args, **kw):
        calls.append(fn.__name__)
        return fn(*args, **kw)
    return spy


def test_wkv_function_runs_the_given_pair_and_matches_the_plain_bwd():
    xs = [torch.tensor(x) for x in wkv_case(2, 21, 2, 16, seed=3)]
    leaves = [x.clone().requires_grad_(True) for x in xs[:6]]
    s0_before = leaves[5].detach().clone()
    calls = []
    out, s_last = ws.WKV.apply(*leaves, _spy(ws.rwkv6_wkv_plain, calls),
                               _spy(ws.rwkv6_wkv_bwd_plain, calls))
    assert s_last.data_ptr() != leaves[5].data_ptr()
    assert torch.equal(leaves[5].detach(), s0_before)   # s0 never written
    want_out, want_s = ws.rwkv6_wkv_plain(*xs[:6])
    assert torch.equal(out.detach(), want_out)
    assert torch.equal(s_last.detach(), want_s)
    got = torch.autograd.grad((out * xs[6]).sum() + (s_last * xs[7]).sum(),
                              leaves)
    assert calls == ["rwkv6_wkv_plain", "rwkv6_wkv_bwd_plain"]
    for name, g, wt in zip(GRADS, got, _plain_grads(xs)):
        assert torch.equal(g, wt), name


def test_wkv_without_autograd_is_one_forward_call():
    xs = [torch.tensor(x) for x in wkv_case(1, 9, 2, 16)][:6]
    calls = []
    fwd = _spy(ws.rwkv6_wkv_plain, calls)
    out, _ = ws.wkv(*xs, fwd=fwd)               # nothing requires grad
    leaves = [x.clone().requires_grad_(True) for x in xs]
    with torch.no_grad():
        out2, _ = ws.wkv(*leaves, fwd=fwd)
    assert calls == ["rwkv6_wkv_plain"] * 2
    assert out.grad_fn is None and out2.grad_fn is None
    out3, _ = ws.wkv(*leaves, fwd=fwd)
    assert type(out3.grad_fn).__name__ == "WKVBackward"


def test_chunked_entry_is_differentiable_one_function_a_chunk():
    xs = [torch.tensor(x) for x in wkv_case(2, 48, 2, 16, seed=4)]
    leaves = [x.clone().requires_grad_(True) for x in xs[:6]]
    out, s_last = ws.rwkv6_wkv(*leaves, chunk=16)
    got = torch.autograd.grad((out * xs[6]).sum() + (s_last * xs[7]).sum(),
                              leaves)
    for name, g, wt in zip(GRADS, got, _reference_vjp(xs)):
        _rel_max(g, wt, f"chunked {name}")


def test_off_the_cpu_the_wrappers_raise_and_never_run_the_plain_pair(
        monkeypatch):
    """A tensor that is not on the CPU (the meta device stands for the
    card on a host without one; the stream handle is stubbed) goes to the
    kernels, which must be built: without ``nvcc`` both wrappers raise,
    and neither plain version runs."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", ())
    monkeypatch.setattr(_build, "BUILD_ROOT",
                        _build.BUILD_ROOT / "nonexistent-for-this-test")
    monkeypatch.setattr(_build, "_LIB", None)
    calls = []
    monkeypatch.setattr(ws, "rwkv6_wkv_plain",
                        _spy(ws.rwkv6_wkv_plain, calls))
    monkeypatch.setattr(ws, "rwkv6_wkv_bwd_plain",
                        _spy(ws.rwkv6_wkv_bwd_plain, calls))
    xs = [torch.tensor(x).to("meta") for x in wkv_case(1, 4, 2, 64)]
    leaves = [x.requires_grad_(True) for x in xs[:6]]
    with pytest.raises(_build.KernelBuildError):
        ws.WKV.apply(*leaves, ws.rwkv6_wkv_fwd, ws.rwkv6_wkv_bwd)
    ckpt = torch.empty(ws.ckpt_shape(1, 4, 2, 64), device="meta")
    with pytest.raises(_build.KernelBuildError):
        ws.rwkv6_wkv_bwd(*xs[:5], ckpt, *xs[6:])
    assert calls == []


# ---------------------------------------------------------------------------
# the time-mix layer and the whole model
# ---------------------------------------------------------------------------


def _configs(dtype, remat=False):
    over = dict(dtype=dtype, param_dtype="float32", remat=remat)
    return tuple(dataclasses.replace(m.get(ARCH, smoke=True), **over)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def models(dtype, remat=False, seed=0):
    """(reference cfg, port cfg, reference params, port params) with the
    same perturbed weights: a nonzero bonus and decays spread so that
    some steps decay to ~0 and others barely."""
    jcfg, tcfg = _configs(dtype, remat)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 11)
    tm = tree["layers"]["tm"]
    tm["bonus_u"] = rng.standard_normal(tm["bonus_u"].shape).astype(
        np.float32) * 0.5
    tm["decay_w0"] = rng.uniform(-4.0, 2.0, tm["decay_w0"].shape).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def _grad_close(got, want, tol, what):
    """Within ``tol`` absolute, and within ``tol`` (float32: 1e-4) of the
    leaf's largest magnitude, as ``tests/test_torch_train.py`` holds
    gradients."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= max(tol, 1e-4 * scale if tol < 1e-4 else tol * scale), \
        f"{what}: max abs err {err} (largest {scale})"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_gradients_match_reference(dtype):
    jcfg, tcfg, jp, tp = models(dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, jcfg.d_model), dtype=np.float32)
    cot = rng.standard_normal((2, 19, jcfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["tm"])

    def jloss(p, xx):
        y, _ = jrwkv.rwkv_time_mix(p, jcfg, xx)
        return jnp.sum(y.astype(jnp.float32) * cot)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jl, jx)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tp["layers"][1]["tm"].items()}
    tx = torch.tensor(np.asarray(jx, np.float32)).to(
        torch_dtype(jcfg.dtype)).requires_grad_(True)
    y, state = trwkv.rwkv_time_mix(leaves, tcfg, tx)
    assert state["wkv"].grad_fn is not None     # a new state, not in place
    grads = torch.autograd.grad(
        (y.float() * torch.tensor(cot)).sum(), [tx, *leaves.values()])
    tol = 1e-5 if dtype == "float32" else 5e-2
    _grad_close(grads[0], jg_x, tol, f"{dtype} dx")
    for (name, _), g in zip(leaves.items(), grads[1:]):
        _grad_close(g, jg_p[name], tol, f"{dtype} tm.{name}")


def test_time_mix_without_autograd_keeps_its_in_place_state():
    _, tcfg, _, tp = models("float32")
    h, hd = tcfg.d_model // tcfg.rwkv_head_size, tcfg.rwkv_head_size
    x = torch.randn(2, 5, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    state = {"shift": torch.zeros(2, tcfg.d_model),
             "wkv": torch.zeros(2, h, hd, hd)}
    wkv = state["wkv"]
    _, out = trwkv.rwkv_time_mix(tp["layers"][0]["tm"], tcfg, x, state)
    assert out is state and out["wkv"] is wkv and float(wkv.abs().max()) > 0


def _batch(cfg, seed, b=2, s=24):
    return TokenPipeline(b, s, cfg.vocab_size, seed=seed).next_batch()


def _reference_as_port(jtree, tcfg):
    return dict(_tree.items(params_from_numpy(
        jax.tree.map(np.asarray, jtree), tcfg, device="cpu")))


def _port_loss_and_grads(tp, tcfg, batch):
    trainable = {k: p.clone().requires_grad_(True)
                 for k, p in _tree.items(tp)}
    loss, metrics = forward(_tree.unflatten(tp, trainable), tcfg,
                            {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss.detach(), metrics, dict(zip(trainable, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_every_gradient_match_reference(dtype, remat):
    jcfg, tcfg, jp, tp = models(dtype, remat)
    batch = _batch(tcfg, seed=7)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: j_forward(p, jcfg, bt), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_loss_and_grads(tp, tcfg, batch)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jm["ce"]), rtol=tol, atol=tol)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    want = _reference_as_port(jg, tcfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[name].shape
        _grad_close(g, want[name].numpy(), tol, f"{dtype} {name}")


def test_every_layer_gets_a_gradient_through_the_recurrence():
    """Every layer's key projection, decay LoRA and bonus reach the loss
    only through the recurrence: each gradient is nonzero."""
    _, tcfg, _, tp = models("float32")
    _, _, grads = _port_loss_and_grads(tp, tcfg, _batch(tcfg, 8))
    for i in range(tcfg.n_layers):
        for leaf in ("w_k", "decay_w1", "bonus_u"):
            assert float(grads[f"layers/{i}/tm/{leaf}"].abs().max()) > 0, \
                (i, leaf)


def test_remat_gives_the_same_gradients_bit_for_bit():
    """Checkpointing each layer changes what is kept, not what is
    computed: the backbone's output, the loss and every gradient."""
    out = []
    for remat in (False, True):
        _, tcfg, _, tp = models("bfloat16", remat)
        x = torch.randn(2, 16, tcfg.d_model,
                        generator=torch.Generator().manual_seed(3)).to(
                            tcfg.adtype).requires_grad_(True)
        layers = {k: p.clone().requires_grad_(True)
                  for k, p in _tree.items(tp["layers"])}
        h = backbone(dict(tp, layers=_tree.unflatten(tp["layers"], layers)),
                     tcfg, x, None)
        loss, _, grads = _port_loss_and_grads(tp, tcfg, _batch(tcfg, 10))
        out.append([h.detach(), loss] + list(torch.autograd.grad(
            h.float().square().mean(), [x, *layers.values()]))
            + list(grads.values()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_remat_recomputes_each_layers_recurrence(monkeypatch):
    """With remat the backward runs each layer's forward again: two
    forward calls of the recurrence a layer and one backward."""
    calls = []
    monkeypatch.setattr(trwkv, "rwkv6_wkv_fwd",
                        _spy(ws.rwkv6_wkv_fwd, calls))
    monkeypatch.setattr(trwkv, "rwkv6_wkv_bwd",
                        _spy(ws.rwkv6_wkv_bwd, calls))
    for remat in (False, True):
        calls.clear()
        _, tcfg, _, tp = models("float32", remat)
        _port_loss_and_grads(tp, tcfg, _batch(tcfg, 9))
        n = tcfg.n_layers
        assert calls.count("rwkv6_wkv_fwd") == (2 * n if remat else n)
        assert calls.count("rwkv6_wkv_bwd") == n


# ---------------------------------------------------------------------------
# train steps and the driver
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _rel_close(got, want, what, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} (scale {scale})"


@pytest.mark.parametrize("eps,param_tol", [(1e-8, 5e-5), (1e-6, 1e-5)])
def test_three_train_steps_match_reference(eps, param_tol):
    """Three jitted reference steps against three port steps of
    rwkv6-smoke from the same weights and batches: every metric, every
    parameter and both moments after each step (the conventions of
    ``tests/test_torch_train.py``)."""
    jcfg, tcfg, jp, tp = models("float32")
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
        for name, tree, jtree in (("params", tp, jp),
                                  ("mu", tst["mu"], jst["mu"]),
                                  ("nu", tst["nu"], jst["nu"])):
            want = _reference_as_port(jtree, tcfg)
            got = dict(_tree.items(tree))
            assert set(got) == set(want)
            for k, t in got.items():
                _rel_close(t.numpy(), want[k].numpy(),
                           f"step {i} {name} {k}",
                           param_tol if name == "params" else 1e-5)


@pytest.mark.parametrize("arch", [ARCH, "olmo-1b"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_donated_step_gives_the_same_bits_in_place(arch, pdtype):
    """``donate=True`` (the reference driver's donated buffers) updates
    the given parameters and state in place, to the same bits as the step
    that leaves them as they were."""
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              param_dtype=pdtype)
    params = init_params(cfg, seed=2, device="cpu")
    state = adamw_init(params)
    kept = make_train_step(cfg, AdamWConfig(**OPT), device="cpu")
    donated = make_train_step(cfg, AdamWConfig(**OPT), device="cpu",
                              donate=True)
    p2, s2 = _tree.tree_map(torch.clone, params), _tree.tree_map(
        torch.clone, state)
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


def test_train_driver_trains_rwkv_on_the_cpu(tmp_path):
    cfg = tconfigs.get(ARCH, smoke=True)
    out = train(cfg, steps=8, batch=2, seq=32, ckpt_dir=str(tmp_path),
                save_every=4, lr=3e-3, log_every=4, device="cpu")
    assert out["final_step"] == 8 and len(out["losses"]) == 8
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    # a second run resumes from the last checkpoint and takes no step
    again = train(cfg, steps=8, batch=2, seq=32, ckpt_dir=str(tmp_path),
                  device="cpu")
    assert again["losses"] == []
    for a, b in zip(_tree.leaves(out["params"]), _tree.leaves(
            again["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# optimizer state and checkpoints across packages
# ---------------------------------------------------------------------------


def _reference_state_after_a_step():
    jcfg, tcfg, jp, _ = models("float32")
    jstep = jax.jit(j_train_step(jcfg, JAdamWConfig(**OPT)))
    batch = TokenPipeline(2, 16, tcfg.vocab_size, seed=6).next_batch()
    jp, jst, _ = jstep(jp, j_adamw_init(jp), {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    return jcfg, tcfg, jp, jst


def test_opt_state_from_numpy_takes_the_reference_rwkv_state():
    _, tcfg, _, jst = _reference_state_after_a_step()
    st = opt_state_from_numpy(jax.tree.map(np.asarray, jst), tcfg,
                              device="cpu")
    assert int(st["step"]) == 1 and st["step"].dtype == torch.int32
    assert set(st["mu"]["layers"][0]) == {"ln1", "tm", "ln2", "cm"}
    for name in ("mu", "nu"):
        want = _reference_as_port(jst[name], tcfg)
        got = dict(_tree.items(st[name]))
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.dtype == torch.float32 and torch.equal(t, want[k]), k
    assert float(st["mu"]["layers"][1]["tm"]["bonus_u"].abs().max()) > 0


def test_a_reference_rwkv_checkpoint_resumes_in_the_port(tmp_path):
    """The reference saves its RWKV parameters and state; the port reads
    the checkpoint without a target and carries it over, equal leaf for
    leaf."""
    pytest.importorskip("msgpack")
    _, tcfg, jp, jst = _reference_state_after_a_step()
    d = str(tmp_path / "ref")
    jckpt.save_checkpoint(d, 1, {"params": jp, "opt": jst})
    tree = restore_checkpoint(d, 1)
    tp = params_from_numpy(tree["params"], tcfg, device="cpu")
    ts = opt_state_from_numpy(tree["opt"], tcfg, device="cpu")
    for got, want in ((tp, jp), (ts["mu"], jst["mu"]), (ts["nu"],
                                                        jst["nu"])):
        want = _reference_as_port(want, tcfg)
        for k, t in _tree.items(got):
            assert torch.equal(t, want[k]), k
    assert int(ts["step"]) == 1


def test_a_port_rwkv_checkpoint_reads_in_the_reference(tmp_path):
    """The port saves its RWKV parameters and AdamW state (a list of
    layers); the reference restores them against a target of the same
    structure, equal leaf for leaf, and the port reads them back."""
    _, tcfg, _, tp = models("float32")
    step = make_train_step(tcfg, AdamWConfig(**OPT), device="cpu")
    tp, ts, _ = step(tp, adamw_init(tp), _batch(tcfg, 4))
    tree = {"params": tp, "opt": ts}
    d = str(tmp_path / "port")
    save_checkpoint(d, 1, tree)
    target = _tree.tree_map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    out = jckpt.restore_checkpoint(d, 1, target)
    for (k, a), b in zip(_tree.items(tree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    back = restore_checkpoint(d, 1, tree)
    for (k, a), b in zip(_tree.items(tree), _tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k

"""The one-card dry run (``repro_torch.launch.dryrun``) and what it reads
and writes: the abstract inputs and ``model_flops`` against the
reference's for all 10 FULL archs, RWKV's ``kernel_stub`` against the
reference's, the records of SMOKE cells, and the capacity bridge on the
port's own records (the counterpart of ``tests/test_capacity_bridge.py``).
Steps run at SMOKE width under fake tensors."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch.steps import make_prefill_step as j_prefill  # noqa: E402
from repro.launch.steps import make_serve_step as j_serve  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_decode_state as j_init_state  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch import _tree, configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.controller import ControllerConfig  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch.mesh import HBM_BYTES, MESH_NAME  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import (forward, init_decode_state,  # noqa: E402
                                serve_step)
from repro_torch.serving import capacity  # noqa: E402

ARCHS = jconfigs.list_archs()
#: the reference's int32 ids and positions are the port's int64
DTYPES = {"int32": torch.int64, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def reference_n_params():
    """Each FULL arch's parameter count, once: the reference traces its
    ``init_params`` under ``eval_shape`` for every call."""
    return {a: jconfigs.get(a).n_params() for a in ARCHS}


def test_the_ten_archs_are_the_references():
    assert tconfigs.list_archs() == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_model_flops_equal_the_reference(arch, reference_n_params,
                                                   monkeypatch):
    monkeypatch.setattr(jbase.ArchConfig, "n_params",
                        lambda self: reference_n_params[self.name])
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert tcfg.n_params() == reference_n_params[arch]
    assert tcfg.n_active_params() == jcfg.n_active_params()
    for name, jshape in jshapes.SHAPES.items():
        shape = tshapes.SHAPES[name]
        assert tshapes.model_flops(tcfg, shape) == \
            jshapes.model_flops(jcfg, jshape)
        want = jshapes.input_specs(jcfg, jshape)
        got = tshapes.input_specs(tcfg, shape)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == w.shape
            assert got[k].dtype == DTYPES[str(w.dtype)]
        assert tshapes.batch_logical_specs(tcfg, shape) == \
            jshapes.batch_logical_specs(jcfg, jshape)
        # a card's share of the batch changes the leading dimension only
        some = tshapes.input_specs(tcfg, shape, batch=1)
        assert {k: tuple(v.shape) for k, v in some.items()} == {
            k: tuple(1 if d == shape.global_batch else d for d in w.shape)
            if k != "positions" else (3, 1, w.shape[2])
            for k, w in want.items()}


# ---------------------------------------------------------------------------
# RWKV's kernel_stub against the reference's
# ---------------------------------------------------------------------------

def _stub(dtype):
    over = dict(wkv_impl="kernel_stub", dtype=dtype, param_dtype="float32")
    jcfg, tcfg = (dataclasses.replace(m.get("rwkv6-3b", smoke=True), **over)
                  for m in (jconfigs, tconfigs))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init_params(jax.random.key(3), jcfg))
    rng = np.random.default_rng(4)
    tm = tree["layers"]["tm"]
    tm["bonus_u"] = rng.standard_normal(tm["bonus_u"].shape).astype(
        np.float32) * 0.5
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def test_kernel_stub_forward_and_serve_step_equal_the_reference():
    jcfg, tcfg, jp, tp = _stub("float32")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tcfg.vocab_size, (2, 16))
    want = j_prefill(jcfg)(jp, {"inputs": jnp.asarray(ids, jnp.int32)})
    got = make_prefill_step(tcfg, device="cpu")(tp, {"inputs": ids})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jstate = j_init_state(jcfg, 2, 8)
    state = init_decode_state(tcfg, 2, 8, device="cpu")
    jstep, step = j_serve(jcfg), make_serve_step(tcfg, device="cpu")
    for t in range(3):
        tok = rng.integers(0, tcfg.vocab_size, (2,))
        jl, jstate = jstep(jp, jstate, {"inputs": jnp.asarray(tok,
                                                              jnp.int32)})
        tl, state = step(tp, state, {"inputs": tok})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    for i, st in enumerate(state["rwkv"]):
        for k, v in st.items():
            np.testing.assert_allclose(v.float().numpy(), np.asarray(
                jstate["rwkv"][k][i], np.float32), rtol=1e-5, atol=1e-5)
    # a decode step writes the stub's state in place
    wkv = state["rwkv"][0]["wkv"]
    _, again = serve_step(tp, tcfg, state, {"inputs": torch.tensor(tok)})
    assert again["rwkv"][0]["wkv"] is wkv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_stub_train_step_loss_and_gradients(dtype):
    """One train step's loss and every gradient against
    ``jax.value_and_grad`` of the reference's ``forward``, at
    ``tests/test_torch_rwkv_train.py``'s tolerances (1e-5 in f32, 5e-2 in
    bf16, of each leaf's largest where that is larger)."""
    jcfg, tcfg, jp, tp = _stub(dtype)
    batch = TokenPipeline(2, 24, tcfg.vocab_size, seed=9).next_batch()
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: j_forward(p, jcfg, bt), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    trainable = {k: p.clone().requires_grad_(True)
                 for k, p in _tree.items(tp)}
    loss, _ = forward(_tree.unflatten(tp, trainable), tcfg,
                      {k: torch.tensor(v) for k, v in batch.items()})
    grads = dict(zip(trainable, torch.autograd.grad(
        loss, list(trainable.values()))))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol,
                               atol=tol)
    want = dict(_tree.items(params_from_numpy(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu")))
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= max(tol, (1e-4 if tol < 1e-4 else tol) * scale), name


# ---------------------------------------------------------------------------
# records of SMOKE cells
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    """The dry run over SMOKE configs (full shapes: nothing allocates)."""
    get = tconfigs.get
    monkeypatch.setattr(tconfigs, "get",
                        lambda arch, smoke=False: get(arch, smoke=True))


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_records_and_skips_of_smoke_cells(tmp_path, smoke, capsys):
    out = tmp_path / "dryrun.jsonl"
    assert dryrun.main(["--arch", "qwen3-8b", "--out", str(out)]) == 0
    recs = _records(out)
    assert [(r["shape"], "skipped" in r) for r in recs] == [
        ("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
        ("long_500k", True)]
    for r in recs[:3]:
        assert (r["arch"], r["mesh"], r["rules"], r["chips"]) == (
            "qwen3-8b", MESH_NAME, "baseline", 1)
        shape = tshapes.SHAPES[r["shape"]]
        assert r["kind"] == shape.kind
        assert r["global_batch"] == shape.global_batch
        # SMOKE widths fit: a card takes the whole global batch
        assert r["batch_per_device"] == shape.global_batch
        assert r["memory"]["fits_hbm"] is True
        assert 0 < r["memory"]["live_bytes_per_device"] <= HBM_BYTES
        assert r["memory"]["live_bytes_per_device"] >= \
            r["memory"]["inputs_bytes"]
        rl = r["roofline"]
        assert rl["t_collective_s"] == 0.0
        assert rl["bottleneck"] == ("compute" if rl["t_compute_s"]
                                    > rl["t_memory_s"] else "memory")
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["model_flops_global"] == tshapes.model_flops(
            tconfigs.get("qwen3-8b"), shape)
    # resumable: a second run writes nothing new
    assert dryrun.main(["--arch", "qwen3-8b", "--out", str(out)]) == 0
    assert len(_records(out)) == 4
    assert "[skip-done]" in capsys.readouterr().out
    # a sharding variant means nothing on one card: skipped, pointing on
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--rules", "ep", "--out", str(out)]) == 0
    assert _records(out)[-1]["skipped"].startswith("SKIP(sharding)")


def test_the_batch_is_the_largest_power_of_two_within_the_budget():
    cfg = dataclasses.replace(tconfigs.get("qwen3-8b", smoke=True),
                              param_dtype="bfloat16")
    shape = tshapes.SHAPES["decode_32k"]
    w1, _ = dryrun.walk_step(cfg, shape, 1)
    w2, _ = dryrun.walk_step(cfg, shape, 2)
    per_row = w2.peak_bytes - w1.peak_bytes
    budget = w1.peak_bytes + 5.5 * per_row        # fits 6 rows, not 7
    b, w, _, fits, fitted = dryrun.choose_batch(cfg, shape, budget)
    assert (b, fits) == (4, True) and w.peak_bytes <= budget
    assert fitted["per_row"] == per_row
    b, w, _, fits, _ = dryrun.choose_batch(cfg, shape,
                                           w1.peak_bytes - 1)
    assert (b, fits) == (1, False) and w.peak_bytes == w1.peak_bytes


# ---------------------------------------------------------------------------
# the capacity bridge
# ---------------------------------------------------------------------------

@pytest.fixture
def bridge_records(tmp_path, smoke):
    out = tmp_path / "dryrun_results_torch.jsonl"
    for rules in ("baseline", "tail256"):
        assert dryrun.main(["--arch", "deepseek-67b", "--shape",
                            "decode_32k", "--rules", rules,
                            "--out", str(out)]) == 0
    return str(out)


def test_derived_capacity_feeds_controller(bridge_records):
    """The reference asserts its tailed variant serves over 1.2x its
    baseline: a property of XLA's handling of the donated cache, whose
    untailed update rewrites the whole sharded cache.  The port writes one
    token's rows in place either way, so its count gives the two within
    10% of each other (the card agrees: the tailed step ran within 3.6%
    of its control)."""
    kw = dict(mesh=MESH_NAME, results_path=bridge_records)
    base = capacity.derived_replica_capacity("deepseek-67b", "decode_32k",
                                             **kw)
    opt = capacity.derived_replica_capacity("deepseek-67b", "decode_32k",
                                            rules="tail256", **kw)
    assert base["tokens_per_s"] > 0
    assert abs(opt["tokens_per_s"] / base["tokens_per_s"] - 1) < 0.1
    rec = [r for r in _records_of(bridge_records) if r["rules"] == "tail256"]
    assert rec[0]["flush_amortized"]["window"] == 256
    b = rec[0]["batch_per_device"]
    rl = rec[0]["roofline"]
    step = max(rl["t_compute_s"], rl["t_memory_s"]) + \
        rec[0]["flush_amortized"]["t_memory_s"]
    assert opt["step_seconds"] == step
    assert opt["tokens_per_s"] == b / step
    cfg = ControllerConfig(capacity=opt["tokens_per_s"], algorithm="MBFP")
    assert cfg.capacity == opt["tokens_per_s"]


def _records_of(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_a_card_record_that_does_not_fit_raises_with_its_bytes(tmp_path):
    rec = {"arch": "deepseek-67b", "shape": "decode_32k", "mesh": MESH_NAME,
           "rules": "baseline", "batch_per_device": 1,
           "roofline": {"t_compute_s": 1e-3, "t_memory_s": 4e-2,
                        "t_collective_s": 0.0, "bottleneck": "memory"},
           "memory": {"live_bytes_per_device": 147_000_000_000,
                      "fits_hbm": False, "hbm_bytes": HBM_BYTES}}
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    with pytest.raises(ValueError, match="147000000000 live bytes"):
        capacity.derived_replica_capacity("deepseek-67b", mesh=MESH_NAME,
                                          results_path=str(path))


def test_serve_reads_the_cards_record_and_falls_back_without_one(
        tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve

    rec = {"arch": "qwen3-8b", "shape": "decode_32k", "mesh": MESH_NAME,
           "rules": "baseline", "batch_per_device": 8,
           "roofline": {"t_compute_s": 1e-3, "t_memory_s": 0.016,
                        "t_collective_s": 0.0, "bottleneck": "memory"},
           "memory": {"live_bytes_per_device": 55e9, "fits_hbm": True}}
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    monkeypatch.setattr(capacity, "DEFAULT_RESULTS", str(path))
    serve.main(["--arch", "qwen3-8b", "--rules", "baseline", "--seconds",
                "5"])
    assert "C = 500 tokens/s [dry-run roofline (memory-bound, 16 ms/step)]" \
        in capsys.readouterr().out
    serve.main(["--arch", "olmo-1b", "--rules", "baseline", "--seconds",
                "5"])
    assert "C = 500 tokens/s [default (no dry-run results" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# chip_smoke's path T: its helpers on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_chip_t_rows_plain_equals_the_plain_versions_last_rows(chip_smoke):
    """T2's flash check: the plain formula on a causal call's last rows,
    masked at their absolute positions, equals those rows of the plain
    version over the whole call."""
    from repro_torch.kernels.ref import attention_ref

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in (
        (2, 8, 96, 16), (2, 2, 96, 16), (2, 2, 96, 16)))
    want = attention_ref(q, k, v, causal=True)[:, :, 80:]
    got = chip_smoke._t_flash_rows_plain(q[:, :, 80:], k, v, 80)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_chip_t_rows_join_the_kernel_rows(chip_smoke):
    out = {"T1": {"launches": {"decode_attention_fwd": 36}},
           "T2": {"launches": {"flash_attention_fwd": 36}},
           "T3": {"launches": {"flash_attention_fwd": 32,
                               "flash_attention_bwd": 16}},
           "calls": {k: (1e-4, dict(at=f"{k} call", max_abs_err=1e-4,
                                    ms=1.0, plain_ms=2.0, bound_ms=0.5,
                                    bound_by="bytes", library_ms=1.0,
                                    wrapper_ms=1.1))
                     for k in ("flash_attention", "decode_attention")}}
    rows = chip_smoke.t_rows(out)
    by = {r["name"]: r for r in rows}
    assert by["flash_attention"]["launches_by_path"] == {
        "T1": 0, "T2": 36, "T3": 32}
    assert by["flash_attention_bwd"]["launches"] == 16
    assert by["decode_attention"]["calls"][0]["at"] == "decode_attention call"
    kernels = [dict(name=n, launches=1, launches_by_path={"X": 1},
                    max_abs_err=0.0, calls=[])
               for n in ("flash_attention", "flash_attention_bwd",
                         "decode_attention")]
    chip_smoke.merge_rows(kernels, rows)
    assert [k["launches"] for k in kernels] == [69, 17, 37]
    assert kernels[2]["max_abs_err"] == 1e-4 and len(kernels[2]["calls"]) == 1
    # a --paths T run prints only the rows with T's own timed calls
    assert [r["name"] for r in rows if "ms" in r] == [
        "flash_attention", "decode_attention"]


def test_chip_bounds_use_the_cards_constants(chip_smoke):
    """Every kernel row's bound_ms and the dry run's roofline divide by one
    set of peaks: the script's are ``launch.mesh``'s own."""
    from repro_torch.launch import mesh

    assert (chip_smoke.HBM_BW, chip_smoke.PEAK_FLOPS_BF16,
            chip_smoke.PEAK_FLOPS_F32) == (mesh.HBM_BW, mesh.PEAK_FLOPS_BF16,
                                           mesh.PEAK_FLOPS_F32)
    ms, by = chip_smoke.bound_ms(mesh.HBM_BW * 1e-3, 0.0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")


@pytest.mark.parametrize("off", [1e-3, 5e-3])
def test_chip_t2_flash_tolerance_is_scaled_to_its_outputs(chip_smoke, off):
    """T2's rows (outputs of ~0.009, the largest ~0.05) are held at
    T_FLASH_TOL: an element off by 5e-3, half a typical output, fails
    there though bfloat16's ATTN_TOL would pass it; 1e-3 passes."""
    want = torch.full((4, 8), 0.05).to(torch.bfloat16)
    got = (want.float() + off).to(torch.bfloat16)
    loose = chip_smoke._attn_close(got, want, "bfloat16", "loose")
    assert loose == pytest.approx(off, rel=0.1)
    if off < chip_smoke.T_FLASH_TOL:
        assert chip_smoke._attn_close(got, want, "bfloat16", "T2",
                                      tol=chip_smoke.T_FLASH_TOL) == loose
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match="T2"):
            chip_smoke._attn_close(got, want, "bfloat16", "T2",
                                   tol=chip_smoke.T_FLASH_TOL)
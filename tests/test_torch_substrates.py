"""The port's training substrates against the JAX reference: AdamW and its
schedule, error-feedback int8 compression, the token pipeline and its
loader pool, and the checkpoint store (both packages reading each
other's checkpoints).

Every case of the reference's ``tests/test_substrates.py`` runs on the
port too, and each function is held against the reference's on the same
numpy inputs.  Tolerances: float32 results within 1e-6 relative (one
step of the same elementwise formula; XLA may fuse a multiply-add where
PyTorch rounds twice), the int8 residuals (a difference of two nearly
equal values) within 5e-7 absolute, the schedule within 3e-7 relative
(``cos`` differs by an ulp), a bfloat16 parameter after an update within
1e-2 (one bf16 rounding of float32 results that differ in the last
bits); integers, token streams, loader assignments
and checkpointed bytes exactly.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch import _tree, configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    load_manifest, restore_checkpoint,
                                    save_checkpoint, store)
from repro_torch.checkpoint.msgpack_lite import packb, unpackb  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.data import LoaderPool, ShardSpec, TokenPipeline  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, clip_by_global_norm,
                               ef_int8_compress_state, ef_int8_psum,
                               warmup_cosine)
from repro_torch.optim.compress import _dequantize, _quantize  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}
    target = {"w": torch.tensor([1.0, 1.0]), "b": torch.tensor(-1.0)}
    state = adamw_init(params)
    loss = lambda p: sum(((p[k] - target[k]) ** 2).sum()  # noqa: E731
                         for k in p)
    for _ in range(200):
        grads = {k: 2 * (v - target[k]) for k, v in params.items()}
        params, state, _ = adamw_update(grads, state, params, cfg)
    assert float(loss(params)) < 1e-3


def test_warmup_cosine_matches_reference_at_every_step():
    for cfg in ({"lr": 1.0, "warmup_steps": 10, "total_steps": 100,
                 "min_lr_ratio": 0.1},
                {"lr": 3e-4, "warmup_steps": 0, "total_steps": 7},
                {"lr": 1e-3, "warmup_steps": 20, "total_steps": 20}):
        steps = np.arange(0, cfg["total_steps"] + 5, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: joptim.warmup_cosine(
            joptim.AdamWConfig(**cfg), s))(jnp.asarray(steps)))
        got = warmup_cosine(AdamWConfig(**cfg), torch.tensor(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-7, atol=1e-12)
    lrs = [float(warmup_cosine(AdamWConfig(lr=1.0, warmup_steps=10,
                                           total_steps=100),
                               torch.tensor(s))) for s in range(101)]
    assert lrs[0] == pytest.approx(0.0)
    assert lrs[10] == pytest.approx(1.0, abs=1e-6)
    assert lrs[100] == pytest.approx(0.1, abs=1e-6)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


def _trees(seed, scale=1.0):
    """(jax, torch) copies of one nested tree of numpy draws, with a list
    in it (the port's layers)."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: (rng.standard_normal(s) * scale).astype(  # noqa: E731
        np.float32)
    tree = {"a": draw(4, 3), "layers": [{"w": draw(5)}, {"w": draw(5)}],
            "z": {"b": draw(2, 2)}}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = _tree.tree_map(torch.tensor, tree)
    return jt, tt


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    jg, tg = _trees(1, scale=3.0)
    jc, jn = joptim.clip_by_global_norm(jg, max_norm)
    tc, tn = clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(_tree.leaves(tc), jax.tree.leaves(jc)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-5)


@pytest.mark.parametrize("bf16_param", [False, True])
def test_adamw_update_matches_reference_over_steps(bf16_param):
    """Four updates from the same parameters, gradients and state:
    parameters (cast back to their dtype), moments, step, lr and the
    global norm."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, eps=1e-6)
    jp, tp = _trees(2)
    if bf16_param:
        jp["a"] = jp["a"].astype(jnp.bfloat16)
        tp["a"] = torch.tensor(np.asarray(jp["a"], np.float32)).to(
            torch.bfloat16)
    js, ts = joptim.adamw_init(jp), adamw_init(tp)
    for i in range(4):
        jg, tg = _trees(10 + i, scale=2.0)
        jp, js, jm = joptim.adamw_update(jg, js, jp, joptim.AdamWConfig(**cfg))
        tp, ts, tm = adamw_update(tg, ts, tp, AdamWConfig(**cfg))
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for tt, jt in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
            for got, want in zip(_tree.leaves(tt), jax.tree.leaves(jt)):
                assert str(got.dtype).split(".")[-1] == str(want.dtype)
                tol = 1e-2 if got.dtype == torch.bfloat16 else 1e-6
                np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                           atol=tol)


# ---------------------------------------------------------------------------
# error-feedback int8 compression
# ---------------------------------------------------------------------------


def test_quantize_matches_reference():
    from repro.optim.compress import _dequantize as j_deq
    from repro.optim.compress import _quantize as j_q

    x = np.random.default_rng(3).standard_normal(300).astype(np.float32) * 5
    jq, js = j_q(jnp.asarray(x))
    tq, ts = _quantize(torch.tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(_dequantize(tq, ts).numpy(),
                                  np.asarray(j_deq(jq, js)))


def test_ef_int8_psum_matches_the_reference_vmap():
    """The reference's own test builds the pod axis with
    ``jax.vmap(axis_name="pod")``; the port takes the pods on the leading
    dim: the reduced gradients and residuals of 6 steps agree."""
    pods, steps = 4, 6

    @jax.jit
    def j_step(g, r):
        return jax.vmap(lambda gg, rr: joptim.ef_int8_psum(gg, rr, "pod"),
                        axis_name="pod")(g, r)

    rng = np.random.default_rng(0)
    shapes = {"g": (16,), "w": (3, 5)}
    jr = {k: jnp.zeros((pods,) + s, jnp.float32) for k, s in shapes.items()}
    tr = ef_int8_compress_state({k: torch.zeros((pods,) + s)
                                 for k, s in shapes.items()})
    tot_true = np.zeros(16, np.float32)
    tot_hat = np.zeros(16, np.float32)
    for _ in range(steps):
        g = {k: rng.normal(size=(pods,) + s).astype(np.float32)
             for k, s in shapes.items()}
        jout, jr = j_step({k: jnp.asarray(v) for k, v in g.items()}, jr)
        tout, tr = ef_int8_psum({k: torch.tensor(v) for k, v in g.items()},
                                tr)
        for k in shapes:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       rtol=1e-6, atol=5e-7)
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                       rtol=1e-6, atol=5e-7)
            np.testing.assert_array_equal(tout[k].numpy()[0],
                                          tout[k].numpy()[-1])
        tot_true += g["g"].mean(0)
        tot_hat += tout["g"].numpy()[0]
    np.testing.assert_allclose(tot_hat, tot_true, atol=0.05)
    assert float(tr["g"].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the token pipeline and the loader pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,seq,vocab,shards,seed", [
    (4, 32, 1000, 16, 1), (3, 70000, 50304, 5, 2), (8, 64, 2048, 16, 0)])
def test_token_pipeline_equals_reference_batch_for_batch(batch, seq, vocab,
                                                         shards, seed):
    """Counter-based streams bit for bit (the second case crosses a 65,536
    token block inside one row), and the same cursor state."""
    j = jdata.TokenPipeline(batch, seq, vocab, n_shards=shards, seed=seed)
    t = TokenPipeline(batch, seq, vocab, n_shards=shards, seed=seed)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch()
        for k in ("inputs", "labels"):
            assert tb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])
    assert t.state() == j.state()
    assert t.pool.assignment == j.pool.assignment


def test_pipeline_determinism_and_resume():
    p1 = TokenPipeline(batch_size=4, seq_len=32, vocab_size=1000, seed=1)
    batches = [p1.next_batch() for _ in range(3)]
    state = p1.state()
    b4 = p1.next_batch()
    p2 = TokenPipeline(batch_size=4, seq_len=32, vocab_size=1000, seed=1)
    p2.load_state(state)
    np.testing.assert_array_equal(b4["inputs"], p2.next_batch()["inputs"])
    np.testing.assert_array_equal(batches[0]["inputs"][:, 1:],
                                  batches[0]["labels"][:, :-1])
    # a reference cursor resumes the port's stream where the reference's
    # own would go on
    j = jdata.TokenPipeline(batch_size=4, seq_len=32, vocab_size=1000, seed=1)
    for _ in range(2):
        j.next_batch()
    p3 = TokenPipeline(batch_size=4, seq_len=32, vocab_size=1000, seed=1)
    p3.load_state(j.state())
    np.testing.assert_array_equal(p3.next_batch()["labels"],
                                  j.next_batch()["labels"])


@pytest.mark.parametrize("n,capacity,rates", [
    (8, 3.0, None), (16, 4.0, "cycle"), (13, 2.5, "skew")])
def test_loader_pool_equals_reference_assignment_for_assignment(
        n, capacity, rates):
    """The initial packing and three re-packs under drifting rates, with
    the port's own ``py`` Modified Best Fit."""
    rng = np.random.default_rng(n)
    rate = {None: lambda i: 1.0, "cycle": lambda i: 1.0 + (i % 3),
            "skew": lambda i: 0.2 + 2.0 * (i % 5 == 0)}[rates]
    specs = [(i, i, rate(i)) for i in range(n)]
    j = jdata.LoaderPool([jdata.ShardSpec(*s) for s in specs], capacity)
    t = LoaderPool([ShardSpec(*s) for s in specs], capacity)
    assert t.assignment == j.assignment and t.n_loaders() == j.n_loaders()
    for _ in range(3):
        drift = {i: float(r * rng.uniform(0.8, 1.25)) for i, _, r in specs}
        assert t.repack(drift) == j.repack(drift)
        assert t.assignment == j.assignment
        assert all(t.loader_of(i) == j.loader_of(i) for i in range(n))


def test_loader_pool_packs_and_sticks():
    pool = LoaderPool([ShardSpec(i, i, rate=1.0) for i in range(8)],
                      capacity=3.0)
    assert pool.n_loaders() >= 3
    before = dict(pool.assignment)
    pool.repack(rates={i: 1.05 for i in range(8)})
    assert sum(1 for k in before if pool.assignment[k] != before[k]) <= 2


# ---------------------------------------------------------------------------
# the checkpoint store
# ---------------------------------------------------------------------------


def _tree_with_bf16():
    return {"layers": [{"w": torch.arange(12, dtype=torch.float32
                                          ).reshape(3, 4)},
                       {"w": torch.full((3, 4), -2.5)}],
            "b": (torch.arange(4, dtype=torch.float32) / 3).to(
                torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32),
            "ids": torch.arange(5, dtype=torch.int64)}


def test_checkpoint_roundtrip_bf16_included(tmp_path):
    tree = _tree_with_bf16()
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, tree, extra={"note": "hi", "cursor": [1, 2]})
    assert latest_step(d) == 3
    out = restore_checkpoint(d, 3, tree)
    for (k, a), (k2, b) in zip(_tree.items(tree), _tree.items(out)):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), k
    assert isinstance(out["layers"], list)
    manifest = load_manifest(d, 3)
    assert manifest["extra"] == {"note": "hi", "cursor": [1, 2]}
    assert manifest["leaves"]["b"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["layers/1/w"]["shape"] == [3, 4]
    flat = restore_checkpoint(d, 3)           # no target: numpy, nested
    np.testing.assert_array_equal(flat["layers"]["1"]["w"],
                                  np.full((3, 4), -2.5, np.float32))
    assert flat["b"].dtype == np.float32
    np.testing.assert_array_equal(flat["b"], tree["b"].float().numpy())


def test_checkpoint_manager_rotation_and_async_save(tmp_path):
    for async_save in (False, True):
        d = str(tmp_path / f"ckpt{int(async_save)}")
        mgr = CheckpointManager(d, keep=2, async_save=async_save)
        x = torch.zeros(2)
        for s in range(5):
            x.fill_(s)
            mgr.save(s, {"x": x})        # copied before x changes again
        mgr.wait()
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                       if n.startswith("step_"))
        assert steps == [3, 4]
        step, tree = mgr.restore_latest({"x": torch.zeros(2)})
        assert step == 4 and float(tree["x"][0]) == 4.0
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        {"x": x}) == (None, None)


def test_checkpoint_detects_corruption_and_shape_mismatch(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"x": torch.ones(8)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, 1, {"x": torch.ones(4)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(d, 1, {"y": torch.ones(8)})
    base = os.path.join(d, "step_00000001")
    blob = [f for f in os.listdir(base) if f.endswith((".zst", ".zz"))][0]
    with open(os.path.join(base, blob), "r+b") as f:
        f.seek(4)
        f.write(b"\x00\x01")
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(d, 1, {"x": torch.ones(8)})


def test_checkpoint_zlib_fallback_and_zstd_without_zstandard(tmp_path,
                                                             monkeypatch):
    """Without zstandard the blobs are zlib ``.zz`` files and restore
    exactly; a zstd blob on such a host raises."""
    d = str(tmp_path / "zz")
    monkeypatch.setattr(store, "zstd", None)
    save_checkpoint(d, 1, {"w": torch.arange(6.0)})
    files = os.listdir(os.path.join(d, "step_00000001"))
    assert all(f.endswith(".zz") for f in files if f != "MANIFEST.msgpack")
    assert torch.equal(restore_checkpoint(d, 1, {"w": torch.zeros(6)})["w"],
                       torch.arange(6.0))
    monkeypatch.undo()
    if store.zstd is None:
        pytest.skip("zstandard is not installed: no zstd blob to write")
    d = str(tmp_path / "zst")
    save_checkpoint(d, 1, {"w": torch.arange(6.0)})
    assert load_manifest(d, 1)["leaves"]["w"]["codec"] == "zstd"
    monkeypatch.setattr(store, "zstd", None)
    with pytest.raises(ImportError, match="zstandard is not"):
        restore_checkpoint(d, 1, {"w": torch.zeros(6)})


def test_store_imports_neither_msgpack_nor_zstandard():
    """In a process where both packages are missing, the store imports,
    saves with zlib and restores."""
    code = (
        "import sys; sys.modules['msgpack'] = None; "
        "sys.modules['zstandard'] = None\n"
        "import tempfile, torch\n"
        "from repro_torch.checkpoint import save_checkpoint, "
        "restore_checkpoint, load_manifest\n"
        "d = tempfile.mkdtemp()\n"
        "t = {'a': torch.arange(3.0).to(torch.bfloat16)}\n"
        "save_checkpoint(d, 2, t)\n"
        "assert torch.equal(restore_checkpoint(d, 2, t)['a'], t['a'])\n"
        "assert load_manifest(d, 2)['leaves']['a']['codec'] == 'zlib'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300)


VALUES = [None, True, False, 0, 127, 128, 255, 256, 65536, 2 ** 32,
          2 ** 64 - 1, -1, -32, -33, -129, -32769, -2 ** 63, 0.5, -1e300,
          "", "é" * 40, "x" * 300, [], list(range(20)), {},
          {str(i): [i, float(i)] for i in range(20)}, (1, "a")]


@pytest.mark.parametrize("value", VALUES, ids=range(len(VALUES)))
def test_msgpack_lite_reads_and_writes_msgpack(value):
    msgpack = pytest.importorskip("msgpack")
    want = list(value) if isinstance(value, tuple) else value
    assert packb(value) == msgpack.packb(value)
    assert msgpack.unpackb(packb(value)) == want
    assert unpackb(msgpack.packb(value)) == want


def test_msgpack_lite_rejects_what_it_cannot_encode():
    with pytest.raises(ValueError, match="cannot encode"):
        packb({"x": object()})
    with pytest.raises(ValueError, match="cannot encode"):
        packb(b"bytes")
    with pytest.raises(ValueError, match="unsupported"):
        unpackb(b"\xc4\x01\x00")              # bin: not in the subset
    with pytest.raises(ValueError, match="after the value"):
        unpackb(packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpackb(packb("abcdef")[:3])


def test_manifests_read_across_packages(tmp_path):
    """A port checkpoint restored by the reference (its target a pytree of
    the port's structure, a list of layers), and a reference checkpoint
    restored by the port; bf16 and the manifest's ``extra`` included."""
    pytest.importorskip("msgpack")
    tree = _tree_with_bf16()
    d = str(tmp_path / "port")
    save_checkpoint(d, 5, tree, extra={"pipeline": {"offsets": [3, 4],
                                                    "next_shard": 1}})
    target = _tree.tree_map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), {torch.bfloat16: jnp.bfloat16}.get(
            t.dtype, str(t.dtype).split(".")[-1])), tree)
    out = jckpt.restore_checkpoint(d, 5, target)
    for (k, a), b in zip(_tree.items(tree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(_np(a), _np(b))
        if a.dtype != torch.int64:   # JAX without x64 holds int32
            assert str(b.dtype) == str(a.dtype).split(".")[-1]

    jtree = {"layers": {"w": jnp.arange(24.0).reshape(2, 3, 4)},
             "b": jnp.ones((4,), jnp.bfloat16) / 3,
             "step": jnp.int32(9)}
    d = str(tmp_path / "ref")
    jckpt.save_checkpoint(d, 2, jtree, extra={"note": "ref"})
    got = restore_checkpoint(d, 2, {"layers": {"w": torch.zeros(2, 3, 4)},
                                    "b": torch.zeros(4),
                                    "step": torch.tensor(0)})
    assert got["b"].dtype == torch.bfloat16 and got["step"].dtype == \
        torch.int32
    np.testing.assert_array_equal(_np(got["b"]), _np(jtree["b"]))
    np.testing.assert_array_equal(got["layers"]["w"].numpy(),
                                  np.asarray(jtree["layers"]["w"]))
    assert load_manifest(d, 2)["extra"] == {"note": "ref"}


def test_a_reference_checkpoint_resumes_training_in_the_port(tmp_path):
    """The reference trains one step and saves; the port restores the
    checkpoint as numpy, carries it with ``params_from_numpy`` and
    ``opt_state_from_numpy``, and both take one more step on one batch:
    the same loss, parameters and moments (1e-5 of each leaf's scale)."""
    pytest.importorskip("msgpack")
    jcfg = dataclasses.replace(jconfigs.get("olmo-1b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get("olmo-1b", smoke=True),
                               dtype="float32")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-6)
    jstep = jax.jit(j_train_step(jcfg, joptim.AdamWConfig(**opt)))
    pipe = TokenPipeline(2, 16, tcfg.vocab_size, seed=4)
    jp = j_init_params(jax.random.key(1), jcfg)
    jp, js, _ = jstep(jp, joptim.adamw_init(jp),
                      jax.tree.map(jnp.asarray, pipe.next_batch()))
    d = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(d, 1, {"params": jp, "opt": js},
                          extra={"pipeline": pipe.state()})
    tree = restore_checkpoint(d, 1)
    tp = params_from_numpy(tree["params"], tcfg, device="cpu")
    ts = opt_state_from_numpy(tree["opt"], tcfg, device="cpu")
    assert int(ts["step"]) == 1 and ts["step"].dtype == torch.int32
    resumed = TokenPipeline(2, 16, tcfg.vocab_size, seed=4)
    resumed.load_state(load_manifest(d, 1)["extra"]["pipeline"])
    batch = resumed.next_batch()
    np.testing.assert_array_equal(batch["inputs"],
                                  pipe.next_batch()["inputs"])
    jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
    tp, ts, tm = make_train_step(tcfg, AdamWConfig(**opt), "cpu")(tp, ts,
                                                                  batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 2
    for tt, jt in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        want = dict(_tree.items(params_from_numpy(
            jax.tree.map(np.asarray, jt), tcfg, device="cpu")))
        for k, got in _tree.items(tt):
            scale = max(float(want[k].abs().max()), 1.0)
            assert float((got - want[k]).abs().max()) <= 1e-5 * scale, k

"""The port's mesh, rule tables and logical specs against the reference's
(``repro.launch.rules``, ``repro.models.sharding``, the ``*_specs``
functions): the tables entry for entry, ``resolve_axis`` /
``logical_spec`` / ``rule_axis_size`` on the reference's
``AbstractMesh``, every spec tree of the 10 archs at full width name for
name (the port's per-layer lists without the stacked layer dim), and
every leaf's shard shape on the fake 16x16 and 2x16x16 meshes (DTensor's
own local shapes) against ``NamedSharding(AbstractMesh, spec)``'s.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import rules as jrules  # noqa: E402
from repro.launch.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch.shapes import batch_logical_specs as j_batch_specs  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    decode_state_specs as j_state_specs, param_specs as j_param_specs)
from repro.optim.adamw import opt_state_specs as j_opt_specs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import rules as trules  # noqa: E402
from repro_torch.launch.shapes import SHAPES, batch_logical_specs  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_state_specs, init_decode_state, param_shapes, param_specs)
from repro_torch.optim.adamw import opt_state_specs  # noqa: E402

TRAIN_VARIANTS = ("baseline", "no_sp", "ep", "moe_local", "fsdp_model")
SERVE_VARIANTS = ("baseline", "cache_batch", "ep", "weights_2d")
ARCHS = tconfigs.list_archs()


def _amesh(multi_pod: bool) -> AbstractMesh:
    shape, names = tmesh.mesh_layout(multi_pod)
    return AbstractMesh(shape, names)


def _mshape(multi_pod: bool) -> tsharding.MeshShape:
    shape, names = tmesh.mesh_layout(multi_pod)
    return tsharding.MeshShape(names, shape)


def _ptuple(spec: P) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# the rule tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind,variants", [("train", TRAIN_VARIANTS),
                                           ("serve", SERVE_VARIANTS)])
def test_rule_tables_equal_the_reference(kind, variants, multi_pod):
    for v in variants:
        assert getattr(trules, f"{kind}_rules")(multi_pod, v) == \
            getattr(jrules, f"{kind}_rules")(multi_pod, v), v
    with pytest.raises(ValueError) as te:
        getattr(trules, f"{kind}_rules")(multi_pod, "nope")
    with pytest.raises(ValueError) as je:
        getattr(jrules, f"{kind}_rules")(multi_pod, "nope")
    assert str(te.value) == str(je.value)


def test_mesh_layouts_and_chip_counts():
    assert tmesh.mesh_layout(False) == ((16, 16), ("data", "model"))
    assert tmesh.mesh_layout(True) == ((2, 16, 16), ("pod", "data", "model"))
    assert (tmesh.n_chips(False), tmesh.n_chips(True)) == (256, 512)
    assert tmesh.NODE_CARDS == 8 and tmesh.NVLINK_BW > tmesh.IB_BW > 0


# ---------------------------------------------------------------------------
# resolve_axis, logical_spec, rule_axis_size
# ---------------------------------------------------------------------------

CASES = [
    # names, shape: the plain cases, a tuple axis (batch over pod and
    # data), keep-first (p_embed and batch both ask for data), and the
    # divisibility fallback (8 kv heads, 60 experts, 1500 frames)
    (("batch", "seq_sp", None), (256, 4096, 4096)),
    (("batch", None, "heads", None), (256, 4096, 32, 128)),
    (("batch", None, "kv", None), (256, 4096, 8, 128)),
    (("p_embed", "p_heads", None), (4096, 32, 128)),
    (("p_experts", "p_embed", "p_ffn"), (60, 2048, 1408)),
    (("p_experts", "p_embed", "p_ffn"), (64, 2048, 1408)),
    (("batch", "p_experts", "exp_cap", None), (256, 64, 512, 2048)),
    (("batch", "p_experts", "exp_cap", "ffn"), (256, 60, 512, 1408)),
    (("batch", "p_kv", "cache_seq", None), (128, 8, 32768, 128)),
    ((None, "batch", "cache_seq", "p_kv", None), (32, 128, 1500, 20, 64)),
    (("batch", "p_embed"), (256, 4096)),
    (("p_vocab", "p_embed"), (151936, 2048)),
    (("batch",), (1,)),
    (("batch",), (32,)),
    ((), ()),
]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_resolve_logical_spec_and_axis_size_equal_the_reference(multi_pod):
    amesh, mshape = _amesh(multi_pod), _mshape(multi_pod)
    tables = [(k, v, getattr(jrules, f"{k}_rules")(multi_pod, v))
              for k, vs in (("train", TRAIN_VARIANTS),
                            ("serve", SERVE_VARIANTS)) for v in vs]
    for kind, variant, rules in tables:
        for names, shape in CASES:
            for n, d in zip(names, shape):
                assert tsharding.resolve_axis(n, d, mshape, rules) == \
                    jsharding.resolve_axis(n, d, amesh, rules)
            assert tsharding.logical_spec(names, shape, mshape, rules) == \
                _ptuple(jsharding.logical_spec(names, shape, amesh, rules)), \
                (kind, variant, names, shape)
        with tsharding.axis_rules(mshape, rules), \
                jsharding.axis_rules(amesh, rules):
            for name in rules:
                assert tsharding.rule_axis_size(name) == \
                    jsharding.rule_axis_size(name)
    assert tsharding.rule_axis_size("p_experts") == 1    # no context


def test_keep_first_and_tuple_axes():
    mshape = _mshape(True)
    rules = trules.train_rules(True, "fsdp_model")
    # batch takes (pod, data); p_embed's (data, model) then loses data
    assert tsharding.logical_spec(("batch", "p_embed"), (512, 4096), mshape,
                                  rules) == (("pod", "data"), None)
    assert tsharding.shard_shape((512, 4096), (("pod", "data"), None),
                                 mshape) == (16, 4096)


def test_shard_is_the_tensor_itself_outside_a_context():
    x = torch.ones(4, 4)
    assert tsharding.shard(x, "batch", None) is x
    with tsharding.axis_rules(_mshape(False), trules.train_rules()):
        assert tsharding.shard(x, "batch", None) is x    # not a DTensor


# ---------------------------------------------------------------------------
# spec trees, name for name
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """{path: spec} of a spec tree (the port's or the reference's)."""
    if tsharding.is_spec(tree):
        return {prefix[:-1]: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _ref_leaf(cfg, path: str):
    """The reference's path of a port leaf, and how many stacked dims its
    spec carries in front."""
    parts = path.split("/")
    if parts[0] in ("mu", "nu"):
        ref, stacked = _ref_leaf(cfg, "/".join(parts[1:]))
        return f"{parts[0]}/{ref}", stacked
    hybrid = cfg.attn_layer_period > 0 and not cfg.rwkv
    if parts[0] in ("layers", "enc_layers") and len(parts) > 2:
        i = int(parts[1])
        sub = [f"sub{i % cfg.attn_layer_period}"] if hybrid else []
        return "/".join([parts[0]] + sub + parts[2:]), 1
    if parts[0] == "rwkv":
        return "/".join(["rwkv"] + parts[2:]), 1
    if parts[0] == "mamba":
        return "/".join(["mamba"] + parts[2:]), 2
    return path, 0


def _port_as_ref(cfg, port_tree):
    """The port's spec tree read in the reference's names: each per-layer
    leaf under its stacked name, with the stacked dims' ``None`` put back;
    whisper's kv-major cross K/V read back to (L, B, T, KV, hd)."""
    out = {}
    for path, spec in _flat(port_tree).items():
        if path == "cross_len":
            assert spec == ()
            continue
        ref, stacked = _ref_leaf(cfg, path)
        if path in ("cross_k", "cross_v"):
            spec = spec[:2] + (spec[3], spec[2]) + spec[4:]
        full = (None,) * stacked + spec
        assert out.setdefault(ref, full) == full, path
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference_name_for_name(arch):
    cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    ps, jps = param_specs(cfg), j_param_specs(jcfg)
    assert _port_as_ref(cfg, ps) == _flat(jps)
    assert _port_as_ref(cfg, decode_state_specs(cfg)) == \
        _flat(j_state_specs(jcfg))
    assert _port_as_ref(cfg, opt_state_specs(ps)) == _flat(j_opt_specs(jps))
    for name, shape in SHAPES.items():
        assert batch_logical_specs(cfg, shape) == j_batch_specs(
            jcfg, JSHAPES[name])
    # every port leaf has a spec of its rank
    shapes = param_shapes(cfg)
    flat = _flat(ps)
    assert set(flat) == {k.replace(".", "/") for k in shapes}
    for k, s in shapes.items():
        assert len(flat[k.replace(".", "/")]) == len(s), k


# ---------------------------------------------------------------------------
# shard shapes on the fake meshes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    """The 16x16 and 2x16x16 meshes over the fake 512-rank group, torn
    down with the module."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    tmesh.fake_world()
    try:
        yield {mp: dryrun.production_mesh(mp) for mp in (False, True)}
    finally:
        dryrun._MESHES.clear()
        dist.destroy_process_group()


def _state_shapes(cfg):
    state = init_decode_state(cfg, 128, 32768, device="meta")
    return {k: tuple(v.shape) for k, v in _flat_tensors(state).items()}


def _flat_tensors(tree, prefix=""):
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_flat_tensors(v, f"{prefix}{k}/"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_on_the_fake_meshes_equal_the_references(arch, meshes):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    cfg = tconfigs.get(arch)
    pspec = {k: v for k, v in _flat(param_specs(cfg)).items()}
    pshape = {k.replace(".", "/"): s for k, s in param_shapes(cfg).items()}
    sspec = _flat(decode_state_specs(cfg))
    sshape = _state_shapes(cfg)
    trees = {"train": [(pspec, pshape)],
             "serve": [(pspec, pshape), (sspec, sshape)]}
    for mp, mesh in meshes.items():
        amesh = _amesh(mp)
        for kind, variants in (("train", TRAIN_VARIANTS),
                               ("serve", SERVE_VARIANTS)):
            for v in variants:
                rules = getattr(trules, f"{kind}_rules")(mp, v)
                seen = set()
                for specs, shapes in trees[kind]:
                    for path, names in specs.items():
                        shape = tuple(shapes[path])
                        if (names, shape) in seen:
                            continue
                        seen.add((names, shape))
                        spec = tsharding.logical_spec(names, shape, mesh,
                                                      rules)
                        local, _ = compute_local_shape_and_global_offset(
                            shape, mesh, tsharding.placements(spec, mesh))
                        want = NamedSharding(amesh, P(*spec)).shard_shape(
                            shape)
                        assert tuple(local) == tuple(want), \
                            (arch, mp, kind, v, path)


def test_batch_offsets_follow_the_reference_rank_order():
    """A batch split over ``("pod", "data")``: the shard of the device at
    (pod p, data d) starts at row ``(p * 16 + d) * local``, pod-major, as
    a ``PartitionSpec(("pod", "data"))`` places it."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_at

    mshape = _mshape(True)
    spec = tsharding.logical_spec(("batch", None), (256, 8), mshape,
                                  trules.train_rules(True))
    assert spec == (("pod", "data"), None)
    pl = tsharding.placements(spec, mshape)
    for p, d, m in ((0, 0, 0), (0, 1, 5), (1, 0, 3), (1, 15, 15)):
        shape, off = local_at((256, 8), (2, 16, 16), [p, d, m], pl)
        assert shape == (8, 8) and off == ((p * 16 + d) * 8, 0)


def test_placements_refuse_axes_out_of_the_mesh_order():
    with pytest.raises(ValueError):
        tsharding.placements((("data", "pod"),), _mshape(True))


def test_a_mesh_dim_of_one_rank_replicates():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tsharding.MeshShape(("data", "model"), (4, 1))
    spec = tsharding.logical_spec(("batch", "seq_sp", None), (8, 1, 16),
                                  mesh, trules.train_rules())
    assert spec == ("data", "model", None)
    assert tsharding.placements(spec, mesh) == (Shard(0), Replicate())


# ---------------------------------------------------------------------------
# the walk's collective bytes: one hand-computed case a kind
# ---------------------------------------------------------------------------

def _walked(mesh, fn):
    from repro_torch.launch.cost_walk import CostWalk

    with tsharding.axis_rules(mesh, trules.train_rules()), CostWalk() as w:
        fn()
    return w.stats


def test_each_collective_kind_against_its_ring_closed_form(meshes):
    """A (64, 8) float32 tensor (2048 bytes) on the 16x16 mesh, n = 16:
    all-gather of a (4, 8) shard sends 15 x 128 bytes; reduce-scatter of
    the whole 15/16 x 2048; all-reduce 2 x 15/16 x 2048; the all-to-all
    that moves a (64, 32) tensor's (4, 32) shard from dim 0 to dim 1 (an
    all-gather and a chunk on this CPU group) 15/16 x 512.  ``wait_tensor`` is free.  The model
    axis's ranks 0..15 span two nodes of 8: InfiniBand."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    mesh = meshes[False]
    x = torch.ones(64, 8)
    rep = [Replicate(), Replicate()]
    cases = {
        "all_gather_into_tensor": (
            lambda: distribute_tensor(x, mesh, [Replicate(), Shard(0)]
                                      ).redistribute(mesh, rep), 15 * 128),
        "reduce_scatter_tensor": (
            lambda: DTensor.from_local(x, mesh, [Replicate(), Partial()]
                                       ).redistribute(
                mesh, [Replicate(), Shard(0)]), 15 / 16 * 2048),
        "all_reduce": (
            lambda: DTensor.from_local(x, mesh, [Replicate(), Partial()]
                                       ).redistribute(mesh, rep),
            2 * 15 / 16 * 2048),
        "all_to_all_single": (
            lambda: distribute_tensor(torch.ones(64, 32), mesh,
                                      [Replicate(), Shard(0)]).redistribute(
                mesh, [Replicate(), Shard(1)]), 15 / 16 * 512),
    }
    for kind, (fn, sent) in cases.items():
        s = _walked(mesh, fn)
        assert dict(s.collectives) == {f"{kind}/model": [1, sent]}, kind
        assert s.collective_bytes == s.ib_bytes == sent
        assert s.nvlink_bytes == 0.0
        assert s.t_collective_s() == sent / tmesh.IB_BW


def test_a_group_within_one_node_moves_over_nvlink(meshes):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = DeviceMesh("cpu", torch.arange(64).reshape(8, 8),
                      mesh_dim_names=("data", "model"))
    x = torch.ones(64, 8)
    s = _walked(mesh, lambda: distribute_tensor(
        x, mesh, [Replicate(), Shard(0)]).redistribute(
            mesh, [Replicate(), Replicate()]))
    assert s.nvlink_bytes == 7 * 256 and s.ib_bytes == 0.0
    assert s.t_collective_s() == 7 * 256 / tmesh.NVLINK_BW


def test_a_sequence_sharded_decode_off_the_cpu_raises(monkeypatch):
    """A shard's part of a decode over a sequence-sharded cache: CPU
    tensors run the plain version; tensors off the CPU reach the decode
    kernel's partial entry (here a stand-in library that records the
    call) and never the plain version, and raise where no kernel can be
    built."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    q = torch.randn(1, 2, 2, 16)
    k = torch.randn(1, 2, 5, 16)
    m, l_, acc = da.decode_attention_partial(q, k, k, 2)
    assert m.shape == (1, 2, 2) and acc.shape == (1, 2, 2, 16)
    assert torch.isfinite(l_).all() and (l_ > 0).all()

    plain, calls = [], []
    monkeypatch.setattr(da, "decode_attention_partial_plain",
                        lambda *a: plain.append(a))

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "_LIB", Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    before = da.decode_attention_partial.launches
    for dtype, entry in ((torch.float32, "decode_attention_partial_f32"),
                         (torch.bfloat16, "decode_attention_partial_bf16")):
        qm, km = q.to(dtype).to("meta"), k.to(dtype).to("meta")
        m, l_, acc = da.decode_attention_partial(qm, km, km, -1)
        name, args = calls[-1]
        assert name == entry
        assert args[8:14] == (1, 2, 2, 5, 16, da.decode_splits(1, 2, 5))
        assert (m.shape, l_.shape, acc.shape) == ((1, 2, 2), (1, 2, 2),
                                                  (1, 2, 2, 16))
        assert {t.dtype for t in (m, l_, acc)} == {torch.float32}
        assert {t.device.type for t in (m, l_, acc)} == {"meta"}
    assert len(calls) == 2
    assert da.decode_attention_partial.launches == before + 2
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", ())
    monkeypatch.setattr(_build, "BUILD_ROOT",
                        _build.BUILD_ROOT / "nonexistent-for-this-test")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        da.decode_attention_partial(q.to("meta"), k.to("meta"),
                                    k.to("meta"), 2)
    assert not plain

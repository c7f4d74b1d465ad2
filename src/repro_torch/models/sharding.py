"""Logical-axis sharding on ``torch.distributed`` device meshes: the
counterpart of the reference's ``models/sharding.py``.

The models annotate activations with logical names (``shard(x, "batch",
"seq_sp", None)``); the launcher installs a rules table mapping logical
names to mesh axes (``launch.rules``).  Where the reference's annotation
is a GSPMD sharding constraint, the port's is a ``DTensor`` redistribute
to the placements the names resolve to.

Outside a rules context every annotation returns its tensor itself and
issues no torch op, so every unsharded path (the tests on the CPU, the
one-card steps) runs exactly as before.  Inside one, an annotation on a
tensor that is not a ``DTensor`` does the same.  Divisibility is checked
per annotation: a logical dim that does not divide over its mesh axes
falls back to replication (8 kv heads over a 16-way model axis, 60
experts over 16), and a mesh axis shards at most one dim of a tensor (the
first that asks for it).

A per-dim spec is a tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of names that shard the dim together, the first
name the major one, as in a ``jax.sharding.PartitionSpec``.  A mesh is a
``DeviceMesh`` with named dims, or a :class:`MeshShape` (names and sizes,
no process group) where only shapes are planned.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

AxisSpec = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisSpec, ...]

_state = threading.local()
#: the innermost context entered in any thread: autograd runs a CUDA
#: backward (and the recomputation of a checkpointed layer) on threads of
#: its own, which must see the rules the forward ran under
_last: List[Any] = [None]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group:
    enough to resolve specs and shard shapes."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _current() -> Optional[Tuple[Any, Dict[str, AxisSpec]]]:
    return getattr(_state, "ctx", None) or _last[0]


def current_mesh():
    """The mesh of the innermost rules context, or ``None``."""
    ctx = _current()
    return None if ctx is None else ctx[0]


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, AxisSpec]):
    """Install (mesh, logical -> mesh axes) rules for the enclosed model
    calls: this thread's, and, while entered, those of a thread that has
    none of its own (autograd's device threads)."""
    prev, prev_last = getattr(_state, "ctx", None), _last[0]
    _state.ctx = _last[0] = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx, _last[0] = prev, prev_last


def _total(axes, sizes: Dict[str, int]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    total = 1
    for a in axes:
        total *= sizes[a]
    return total


def resolve_axis(name: Optional[str], dim: int, mesh,
                 rules: Dict[str, AxisSpec]) -> AxisSpec:
    """Mesh axes for one logical dim, with the divisibility fallback."""
    if name is None:
        return None
    axes = rules.get(name)
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    if dim % _total(axes, axis_sizes(mesh)) != 0:
        return None  # replicate rather than pad
    return axes if len(axes) > 1 else axes[0]


def logical_spec(names: Sequence[Optional[str]], shape: Sequence[int], mesh,
                 rules: Dict[str, AxisSpec]) -> Spec:
    """The per-dim spec of a tensor of ``shape`` named ``names`` (keep-first:
    a mesh axis shards at most one dim)."""
    assert len(names) == len(shape), (names, shape)
    out: List[AxisSpec] = []
    used: set = set()
    for n, d in zip(names, shape):
        axes = resolve_axis(n, d, mesh, rules)
        tup = (axes,) if isinstance(axes, str) else (axes or ())
        if any(a in used for a in tup):
            axes = None        # keep-first
        else:
            used.update(tup)
        out.append(axes)
    return tuple(out)


def rule_axis_size(name: str) -> int:
    """Total mesh-axis size a logical name maps to (1 outside a context or
    when unmapped), so that a module can adapt its structure to the rules
    (the MoE's expert padding)."""
    ctx = _current()
    if ctx is None:
        return 1
    mesh, rules = ctx
    axes = rules.get(name)
    return 1 if axes is None else _total(axes, axis_sizes(mesh))


def placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements (one per mesh dim) of a per-dim spec: ``Shard(i)``
    on every mesh dim that shards tensor dim ``i``, ``Replicate()`` on the
    rest.  A dim sharded over several mesh dims is split over them in
    mesh-dim order, the first the major one, which is the spec's order
    when the spec lists them as the mesh does (the reference's tuples
    do); another order raises.  A mesh dim of one rank replicates (its one
    shard is the whole dim, and DTensor would refuse to view a dim
    "sharded" over it)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    names = list(sizes)
    out: List[Any] = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in tup]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {tup} of dim {i} are not "
                             f"in the mesh's order {tuple(names)}")
        for j in idx:
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` under ``spec`` (every
    sharded dim divides, as :func:`logical_spec` guarantees)."""
    sizes = axis_sizes(mesh)
    return tuple(d // (1 if a is None else _total(a, sizes))
                 for d, a in zip(shape, spec))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing anything outside
    a rules context)."""
    if _current() is None or not hasattr(x, "placements"):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_placements(x, *names: Optional[str]) -> Optional[Tuple]:
    """The placements ``names`` give ``x`` under the current rules, or
    ``None`` outside a rules context or where ``x`` is not a DTensor."""
    if not is_dtensor(x):
        return None
    mesh, rules = _current()
    return placements(logical_spec(names, x.shape, mesh, rules), mesh)


def distribute_like(ref, t, *names: Optional[str]):
    """``t``, a tensor the model makes itself (positions), placed as
    ``names`` resolve where ``ref`` is a DTensor: each rank keeps its
    chunk, with no collective.  Otherwise ``t`` as it is."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import distribute_tensor

    mesh, rules = _current()
    pl = placements(logical_spec(names, t.shape, mesh, rules), mesh)
    return distribute_tensor(t, ref.device_mesh, pl, src_data_rank=None)


def mm(x, w):
    """``x @ w``.  For a DTensor x (B, S, d) and a DTensor matrix w (d, f)
    the product runs per shard (``local_map``) in a layout chosen here,
    not by DTensor: DTensor plans a 3-dim product (and its backward) by
    flattening B and S, which, both split, it refuses (torch 2.11) or
    searches for minutes on a 3-dim mesh (torch 2.13).  On each mesh
    dim: where x splits d, w splits its rows alike and the output is a
    partial sum; where x splits B or S, w is gathered there (FSDP) and
    its gradient is a partial sum; where x is whole, w keeps its columns
    split (tensor parallel) and x's gradient is a partial sum."""
    if not (is_dtensor(x) and is_dtensor(w) and x.dim() == 3
            and w.dim() == 2):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    x = _reduced(x)
    mesh = x.device_mesh
    rep, part = Replicate(), Partial()
    cols = []       # per mesh dim: x, w, out, x's gradient, w's gradient
    for j, p in enumerate(x.placements):
        if mesh.size(j) == 1:
            cols.append((rep,) * 5)
        elif p == Shard(2):
            cols.append((p, Shard(0), part, p, Shard(0)))
        elif p in (Shard(0), Shard(1)):
            cols.append((p, rep, p, p, part))
        elif w.placements[j] == Shard(1):
            cols.append((rep, Shard(1), Shard(2), part, Shard(1)))
        else:
            cols.append((rep,) * 5)
    x_pl, w_pl, out_pl, gx_pl, gw_pl = zip(*cols)
    return local_call(lambda a, b: a @ b, out_pl, (x_pl, w_pl), mesh,
                      in_grad_placements=(gx_pl, gw_pl))(x, w)


def _reduced(x):
    """DTensor ``x`` with its partial sums reduced."""
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def shard(x, *names: Optional[str]):
    """Annotate activation ``x`` with logical axis names: a DTensor is
    redistributed to the placements they resolve to; anything else (and
    everything outside a rules context) is returned as it is, with no
    torch op issued."""
    target = spec_placements(x, *names)
    if target is None or tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def local_call(fn, out_placements, in_placements, mesh,
               in_grad_placements=None):
    """``local_map(fn, ...)`` with every per-tensor placement a list (a
    tuple of placements would read as one entry per output) and the
    inputs redistributed to ``in_placements``: ``fn`` runs on each rank's
    local tensors."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    def one(pl):
        return None if pl is None else list(pl)

    def many(pls):
        return None if pls is None else tuple(one(p) for p in pls)

    single = all(isinstance(p, Placement) for p in out_placements)
    return local_map(fn, out_placements=(one(out_placements) if single
                                         else many(out_placements)),
                     in_placements=many(in_placements),
                     in_grad_placements=many(in_grad_placements),
                     device_mesh=mesh, redistribute_inputs=True)


def _reshapeable(t, shape):
    """DTensor ``t`` ready to be viewed as ``shape``: the mesh dims that
    shard a tensor dim the view merges or splits are gathered (a dim split
    unevenly over a mesh dim cannot be viewed in place)."""
    from torch.distributed.tensor import Replicate, Shard

    old = tuple(t.shape)
    pre = 0
    while pre < min(len(old), len(shape)) and old[pre] == shape[pre]:
        pre += 1
    suf = 0
    while (suf < min(len(old), len(shape)) - pre
           and old[-1 - suf] == shape[-1 - suf]):
        suf += 1
    involved = range(pre, len(old) - suf)
    pl = [Replicate() if isinstance(p, Shard) and p.dim in involved else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


class _View(torch.autograd.Function):
    """A reshape whose forward and backward views go through
    :func:`_view`."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _view(g, ctx.shape), None


def reshape(t, shape):
    """``t.reshape(shape)`` of a DTensor in either direction of autograd:
    where DTensor cannot view a dim split unevenly over a mesh dim (4
    heads over 16 ranks), that mesh dim is gathered first."""
    return _View.apply(t, tuple(shape))


def _view(t, shape):
    try:
        return t.reshape(shape)
    except RuntimeError:
        return _reshapeable(t, shape).reshape(shape)


def is_spec(x) -> bool:
    """A spec leaf: a tuple of ``None``, axis names or tuples of names
    (``()`` for a scalar)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def spec_map(fn, spec_tree, *rest):
    """``fn(spec, *matching leaves of rest)`` over a spec tree (nested
    dicts and lists whose leaves are specs)."""
    if is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(spec_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(spec_tree))
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def resolve_tree(spec_tree, shape_tree, mesh, rules: Dict[str, AxisSpec]):
    """A tree of resolved per-dim specs: each logical spec of ``spec_tree``
    against the matching tensor (or shape) of ``shape_tree``."""
    return spec_map(lambda names, leaf: logical_spec(names, _shape(leaf),
                                                     mesh, rules),
                    spec_tree, shape_tree)


def spec_tree_to_shardings(spec_tree, shape_tree, mesh,
                           rules: Dict[str, AxisSpec]):
    """A tree of DTensor placements (one tuple per leaf), the counterpart
    of the reference's tree of ``NamedSharding``\\ s."""
    return spec_map(lambda spec: placements(spec, mesh),
                    resolve_tree(spec_tree, shape_tree, mesh, rules))


def distribute_tree(tree, spec_tree, mesh, rules: Dict[str, AxisSpec]):
    """``tree`` (nested dicts and lists of tensors) placed on ``mesh`` by
    its logical specs: a tree of ``DTensor``\\ s, each holding its rank's
    shard."""
    from torch.distributed.tensor import distribute_tensor

    shardings = spec_tree_to_shardings(spec_tree, tree, mesh, rules)
    return spec_map(lambda spec, t, pl: distribute_tensor(t, mesh, pl),
                    spec_tree, tree, shardings)


__all__ = ["AxisSpec", "MeshShape", "axis_rules", "axis_sizes",
           "current_mesh", "distribute_like", "distribute_tree",
           "local_call", "mm", "reshape", "is_dtensor", "is_spec",
           "logical_spec", "placements", "resolve_axis", "resolve_tree",
           "rule_axis_size", "shard", "shard_shape", "spec_map",
           "spec_placements", "spec_tree_to_shardings"]

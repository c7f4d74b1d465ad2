"""Cost accounting of a traced step: the counterpart of the reference's
``hlo_walker.walk``.

The reference parses XLA's partitioned HLO and multiplies each op's cost
by its enclosing ``while`` loops' trip counts.  The port runs eagerly, so
every iteration of a Python loop dispatches its own operators: a
:class:`CostWalk` (a ``TorchDispatchMode``) sees each operator once a
time it runs and needs no trip counts.  Run under ``FakeTensorMode``, no
tensor is allocated, so a full-size step walks on a host without the
card.  It accumulates

* flops            -- each operator of ``torch.utils.flop_counter``'s
                      registry (products, convolutions, attention), by
                      the dtype of its first input; elementwise work is
                      not counted, as the reference counts only ``dot``;
* hbm bytes        -- each operator's inputs read once and outputs
                      written once (the unique elements a strided view
                      spans); views and empty allocations cost nothing;
                      a copy or fill writes its destination without
                      reading it; an indexed write into a buffer
                      (``index_copy_``, ``index_put_``, ``scatter_``...)
                      counts the region written, not the buffer, as the
                      reference counts a dynamic-update-slice;
* live bytes       -- each new storage rounded up to the CUDA caching
                      allocator's 512-byte blocks, freed when its last
                      tensor dies (a weakref finalizer on the storage),
                      and the peak of their sum, so that the count can be
                      held against ``torch.cuda.max_memory_allocated``;
* collective bytes -- the bytes one rank sends in each ``_c10d_functional``
                      collective, by kind and by the group's mesh axis,
                      as a ring moves them over a group of n ranks (the
                      counterpart of the reference's ``hlo_walker``
                      collective counts):

                        all_gather_into_tensor   (n - 1) * in
                        reduce_scatter_tensor    (n - 1) / n * in
                        all_reduce               2 (n - 1) / n * in
                        all_to_all_single        (n - 1) / n * in

                      with ``in`` the rank's input bytes; ``wait_tensor``
                      is free.  Where DTensor falls back from an
                      all-to-all to an all-gather and a chunk (it does on
                      a CPU process group, e.g. the fake one), the walk
                      counts the all-to-all NCCL would run.  A group
                      whose ranks lie in one node of ``NODE_CARDS`` moves
                      its bytes over NVLink, any other over InfiniBand.

On DTensors (a sharded step) the walk costs each rank's local operators:
for an operator on DTensors it returns ``NotImplemented``, so that DTensor
runs the local operators and collectives it stands for, which come back to
the walk on plain (fake) tensors.  The operators DTensor runs on its own
fake tensors to propagate shapes are not counted.

A stand-in for a hand-written kernel (``launch.dryrun``) adds its own
closed-form cost through :meth:`CostWalk.add`, found by :func:`current`.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import (HBM_BW, IB_BW, NODE_CARDS, NVLINK_BW,
                                     PEAK_FLOPS_BF16, PEAK_FLOPS_F32)

#: the CUDA caching allocator's block: every allocation is rounded up to it
BLOCK = 512

aten = torch.ops.aten
#: operators that move no bytes (allocation without initialisation, and
#: metadata)
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.lift_fresh,
         aten._unsafe_view, aten.resize_, aten.set_}
#: operators that write their output (or in-place destination) without
#: reading it
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.zeros,
               aten.zeros_like, aten.ones, aten.ones_like, aten.full,
               aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full,
               aten.arange, aten.normal_, aten.uniform_, aten.scalar_tensor}
#: in-place indexed writes: the source's region is written (and the
#: source and index read), not the whole destination
_INDEXED = {aten.index_copy_, aten.index_put_, aten._index_put_impl_,
            aten.scatter_, aten.scatter_add_, aten.index_add_,
            aten.masked_scatter_}
#: indexed reads: the rows gathered are read (their output's size) and
#: written, beside the index, not the whole source
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding}


#: ``_c10d_functional`` collectives: kind -> bytes a rank sends on a ring
#: of n ranks, from its input bytes
RING_BYTES = {
    "all_gather_into_tensor": lambda b, n: (n - 1) * b,
    "reduce_scatter_tensor": lambda b, n: (n - 1) / n * b,
    "all_reduce": lambda b, n: 2 * (n - 1) / n * b,
    "all_to_all_single": lambda b, n: (n - 1) / n * b,
}
#: DTensor's function that falls back to an all-gather on a CPU group
_A2A_FALLBACK = "shard_dim_alltoall"
#: DTensor's functions that run an operator on global shapes (under the
#: fake mode in force) to learn its output's shape
_SHAPE_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                      "_propagate_tensor_meta")


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as the caching allocator holds it: 0, or a whole number
    of 512-byte blocks."""
    return -(-nbytes // BLOCK) * BLOCK


def span_bytes(t: torch.Tensor) -> int:
    """Bytes of the unique elements ``t`` spans (a broadcast dimension, of
    stride 0, is read once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size() if t.numel() else 0


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of a tree, a DTensor as its rank's local tensor."""
    out = []
    for a in tree_leaves(x):
        if isinstance(a, torch.Tensor):
            out.append(getattr(a, "_local_tensor", a))
    return out


def _fake_mode(t):
    return getattr(t, "fake_mode", None)


def _on_stack(*names: str) -> bool:
    """Whether a function of one of ``names`` is on the Python stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in names:
            return True
        f = f.f_back
    return False


def group_info(group_name: str):
    """``(ranks, axis)`` of a process group by name: its global ranks and
    the mesh axis of the current rules context whose group it is (else
    ``group<size>``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    from repro_torch.models.sharding import current_mesh

    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    mesh = current_mesh()
    if mesh is not None and hasattr(mesh, "get_group"):
        for j, name in enumerate(mesh.mesh_dim_names):
            if mesh.get_group(j).group_name == group_name:
                return ranks, name
    return ranks, f"group{len(ranks)}"


def _aliases(func) -> bool:
    """A view: a return that aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _mutated(func, args, kwargs) -> List[torch.Tensor]:
    """The arguments ``func`` writes in place."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += _tensors(v)
    return out


@dataclasses.dataclass
class WalkStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    #: bytes a rank sends within one node (NVLink) and across nodes (IB)
    nvlink_bytes: float = 0.0
    ib_bytes: float = 0.0
    #: "kind/axis" -> [calls, bytes a rank sends]
    collectives: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0]))
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    #: operator name -> [calls, flops, bytes]
    by_op: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0]))
    #: live bytes when the walk began (the tracked inputs), at its end,
    #: and at their peak, each allocation rounded to BLOCK
    start_bytes: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0

    def t_compute_s(self) -> float:
        """bfloat16 (and float16) flops at the tensor cores' peak, the rest
        at the float32 peak."""
        low = sum(v for k, v in self.flops_by_dtype.items()
                  if k in ("bfloat16", "float16"))
        return low / PEAK_FLOPS_BF16 + (self.flops - low) / PEAK_FLOPS_F32

    def t_memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    def t_nvlink_s(self) -> float:
        return self.nvlink_bytes / NVLINK_BW

    def t_ib_s(self) -> float:
        return self.ib_bytes / IB_BW

    def t_collective_s(self) -> float:
        return self.t_nvlink_s() + self.t_ib_s()

    def collectives_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for key, (_, b) in self.collectives.items():
            out[key.split("/")[0]] += b
        return dict(out)

    def summary(self, top: int = 12) -> Dict:
        ops = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:top]
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": {k: {"calls": int(c), "bytes": b}
                            for k, (c, b) in sorted(self.collectives.items())},
            "nvlink_bytes": self.nvlink_bytes,
            "ib_bytes": self.ib_bytes,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "top_byte_ops": {k: {"calls": int(c), "flops": f, "bytes": b}
                             for k, (c, f, b) in ops},
            "peak_bytes": self.peak_bytes,
        }


_ACTIVE: List["CostWalk"] = []


def current() -> Optional["CostWalk"]:
    """The innermost active walk, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


class CostWalk(TorchDispatchMode):
    """Counts every operator dispatched while active (enter it inside a
    ``FakeTensorMode`` to walk without allocating).  :meth:`track` the
    step's inputs first, so that their storages count as live and their
    in-place updates as no allocation."""

    def __init__(self):
        super().__init__()
        self.stats = WalkStats()
        self._live: Dict[int, int] = {}
        self._fake = None       # the fake mode of the walked tensors
        self._sharded = False   # whether it walks DTensors

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.stats.live_bytes -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = block_bytes(st.nbytes())
        self._live[key] = n
        weakref.finalize(st, self._free, key)
        s = self.stats
        s.live_bytes += n
        s.peak_bytes = max(s.peak_bytes, s.live_bytes)

    def track(self, *trees: Any) -> None:
        """Count the storages of ``trees``' tensors (a DTensor's local
        shard) as live from now on."""
        from torch.utils._pytree import tree_leaves

        self._sharded = any(hasattr(a, "_local_tensor")
                            for a in tree_leaves(trees))
        for t in _tensors(trees):
            self._hold(t)
            self._fake = self._fake or _fake_mode(t)
        self.stats.start_bytes = self.stats.live_bytes

    # -- cost ----------------------------------------------------------------
    def add(self, name: str, flops: float, dtype: torch.dtype,
            nbytes: float) -> None:
        """Charge a kernel's closed-form cost (a stand-in's)."""
        s = self.stats
        s.flops += flops
        s.flops_by_dtype[str(dtype).replace("torch.", "")] += flops
        s.hbm_bytes += nbytes
        rec = s.by_op[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def add_collective(self, kind: str, group_name: str,
                       in_bytes: float) -> None:
        """Charge one rank's share of a ring collective."""
        ranks, axis = group_info(group_name)
        n = len(ranks)
        sent = RING_BYTES[kind](in_bytes, n) if n > 1 else 0.0
        s = self.stats
        s.collective_bytes += sent
        rec = s.collectives[f"{kind}/{axis}"]
        rec[0] += 1
        rec[1] += sent
        if len({r // NODE_CARDS for r in ranks}) == 1:
            s.nvlink_bytes += sent
        else:
            s.ib_bytes += sent

    def _collective(self, func, args) -> bool:
        """Charge a ``_c10d_functional`` collective; whether it was one."""
        if func.namespace != "_c10d_functional":
            return False
        name = func.overloadpacket.__name__.rstrip("_")
        if name in RING_BYTES:
            kind = name
            if kind == "all_gather_into_tensor" and _on_stack(_A2A_FALLBACK):
                kind = "all_to_all_single"
            group = args[-1]
            self.add_collective(kind, group, span_bytes(args[0]))
        return True            # wait_tensor and the rest: free

    def _foreign(self, args, kwargs, out) -> bool:
        """An operator DTensor runs on global shapes to propagate them (on
        fake tensors of another fake mode, or of this one, from its shape
        propagation): not a rank's work."""
        if self._fake is not None:
            for t in _tensors((args, kwargs, out)):
                m = _fake_mode(t)
                if m is not None and m is not self._fake:
                    return True
        return self._sharded and _on_stack(*_SHAPE_PROPAGATION)

    def _cost(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        flops = 0.0
        if packet in flop_registry and ins:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        mutated = _mutated(func, args, kwargs)
        if packet in _FREE or _aliases(func) or not (outs or mutated):
            nbytes = 0          # metadata: views, empties, scalars
        elif packet in _GATHER:
            src = ins[0]            # the table or source gathered from
            nbytes = (sum(span_bytes(t) for t in ins if t is not src)
                      + 2 * sum(span_bytes(t) for t in outs))
        elif packet in _INDEXED:
            dst = mutated
            rest = [t for t in ins if not any(t is d for d in dst)]
            src = max((span_bytes(t) for t in rest), default=0)
            nbytes = sum(span_bytes(t) for t in rest) + src
        elif packet in _WRITE_ONLY:
            dst = mutated or outs
            nbytes = (sum(span_bytes(t) for t in ins
                          if not any(t is d for d in dst))
                      + sum(span_bytes(t) for t in dst))
        else:
            nbytes = (sum(span_bytes(t) for t in ins)
                      + sum(span_bytes(t) for t in outs))
        dtype = ins[0].dtype if ins else (outs[0].dtype if outs
                                          else torch.float32)
        self.add(packet.__name__, flops, dtype, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._foreign(args, kwargs, out):
            return out
        if self._collective(func, args):
            for t in _tensors(out):
                self._hold(t)
            return out
        self._cost(func, args, kwargs, out)
        if not _aliases(func) and not _mutated(func, args, kwargs):
            for t in _tensors(out):
                self._hold(t)
        return out

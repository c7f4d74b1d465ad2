"""Cost change of every single-item move, and the annealer's whole step:
CUDA kernels and their plain versions.

The annealer (``repro_torch.opt.anneal``) runs many chains at once; each
anneal step every chain needs the cost change of every relocation of one
partition ``p`` to one bin name ``b`` under

    cost = bins_used + (lam / C) * sum_{moved p} speed(p)

(the paper's consumer count plus the Eq. 10 R-score weighted by ``lam``),
an ``f32[K, N, M]`` plane.  A move is allowed iff

    b != assign[p]  and  (loads[b] + w <= C   or
                          counts[b] == 0 and w > C)

(an item wider than a bin may sit alone in its own overflow bin) and, with
a mask, the item is active; every other move reads ``MOVE_BLOCKED``.

``move_delta_reference`` is the plain PyTorch version of the plane and
``move_delta_batch`` dispatches it on the tensors' device.
``anneal_step_reference`` is one whole anneal step of every chain in
plain PyTorch (the plane, the Gumbel-max choice, the move and the best
state, written into a ``ChainState`` in place) and ``anneal_step`` its
one-launch kernel, which never writes the plane: the annealer runs it on
the card.  CPU tensors run the plain versions (the yardsticks the kernels
are held against on the card); CUDA tensors launch or raise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import _build

#: large finite sentinel for masked moves (finite, so -MOVE_BLOCKED / T
#: stays inside the float32 range for any sane temperature)
MOVE_BLOCKED = 1e30


def move_delta_reference(loads, counts, assign, speeds, prev, lam, capacity,
                         *, active: Optional[torch.Tensor] = None):
    """Plain version over ``(..., M)`` bin state and ``(..., N)`` items.

    loads f32[..., M] load per bin name; counts int[..., M] items per bin
    name; assign int[..., N] current bin name per item (>= 0); speeds
    f32[..., N]; prev int[..., N] previous bin name (-1 = unassigned: the
    R-score prices moves of previously-assigned items only); lam, capacity
    f32[...]; active optional bool/int[..., N] (0 blocks every move of the
    item).  Returns f32[..., N, M]: ``delta[..., p, b]``, or
    ``MOVE_BLOCKED`` for a no-op or infeasible move.  The arithmetic runs
    in the reference's order, so the two agree bit for bit.
    """
    loads = loads.to(torch.float32)
    counts = counts.to(torch.int32)
    assign = assign.long()
    speeds = speeds.to(torch.float32)
    prev = prev.long()
    m = loads.shape[-1]
    lam = torch.as_tensor(lam, dtype=torch.float32,
                          device=loads.device)[..., None, None]
    cap = torch.as_tensor(capacity, dtype=torch.float32,
                          device=loads.device)[..., None, None]
    count_a = counts.gather(-1, assign)                          # (..., N)
    names = torch.arange(m, device=loads.device)
    w = speeds.unsqueeze(-1)                                     # (..., N, 1)
    empty = (counts == 0).unsqueeze(-2)                          # (..., 1, M)
    d_bins = empty.float() - (count_a == 1).float().unsqueeze(-1)
    sticky = prev >= 0
    was_moved = ((assign != prev) & sticky).float()
    now_moved = ((names != prev.unsqueeze(-1))
                 & sticky.unsqueeze(-1)).float()
    d_r = (now_moved - was_moved.unsqueeze(-1)) * w * (lam / cap)
    allowed = ((assign.unsqueeze(-1) != names)
               & ((loads.unsqueeze(-2) + w <= cap) | (empty & (w > cap))))
    if active is not None:
        allowed = allowed & active.bool().unsqueeze(-1)
    return torch.where(allowed, d_bins + d_r, MOVE_BLOCKED)


@_build.counted
def move_delta_batch(loads, counts, assign, speeds, prev, lam, cap, *,
                     active: Optional[torch.Tensor] = None):
    """Every move's cost change over a batch of chains, one launch.

    loads f32[K, M]; counts int[K, M]; assign, prev int[K, N]; speeds
    f32[K, N]; lam, cap f32[K]; active optional int/bool[K, N].  Returns
    f32[K, N, M] (``MOVE_BLOCKED`` where blocked).

    Replaces the Pallas kernel ``src/repro/kernels/move_eval.py:135``
    (``move_delta_batch`` over ``_move_eval_kernel``).  On the H100 it is
    bound by bytes: the ``[K, N, M]`` plane is written once.  A block
    covers a contiguous run of the flattened plane (several whole chains,
    or a piece of a wide one), reads those chains' bins and items once,
    and walks the run with a running (chain, item, bin) counter in 16-byte
    streaming stores.  No path launches it: the annealer runs
    ``anneal_step``, which consumes each delta where it is computed.

    CPU tensors run ``move_delta_reference``; CUDA tensors launch the
    kernel (``csrc/move_eval.cu``) or raise.
    """
    k, m = loads.shape
    n = assign.shape[-1]
    if loads.device.type == "cpu":
        return move_delta_reference(loads, counts, assign, speeds, prev, lam,
                                    cap, active=active)
    dev = loads.device
    f32 = lambda x: x.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    i32 = lambda x: x.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    args = [f32(loads), i32(counts), i32(assign), f32(speeds), i32(prev),
            f32(lam), f32(cap)]
    want = ((k, m), (k, m), (k, n), (k, n), (k, n), (k,), (k,))
    names = ("loads", "counts", "assign", "speeds", "prev", "lam", "cap")
    for name, x, shape in zip(names, args, want):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {list(shape)}; got "
                             f"{list(x.shape)}")
    act = None if active is None else i32(active)
    if act is not None and tuple(act.shape) != (k, n):
        raise ValueError(f"active must have shape [{k}, {n}]; got "
                         f"{list(act.shape)}")
    out = torch.empty((k, n, m), dtype=torch.float32, device=dev)
    _build.launch("move_eval_f32", *(x.data_ptr() for x in args),
                  None if act is None else act.data_ptr(), out.data_ptr(),
                  k, n, m, _build.stream_ptr(dev))
    move_delta_batch.launches += 1
    return out


class ChainState(NamedTuple):
    """The annealer's per-chain state, which a step updates in place:
    ``assign`` i32[C, N], ``loads`` f32[C, M], ``counts`` i32[C, M], the
    incremental ``cost`` f32[C], and the best state so far, ``best_cost``
    f32[C] and ``best_assign`` i32[C, N]."""

    assign: torch.Tensor
    loads: torch.Tensor
    counts: torch.Tensor
    cost: torch.Tensor
    best_cost: torch.Tensor
    best_assign: torch.Tensor


def anneal_step_reference(state: ChainState, speeds, prev, lam, cap, gumbel,
                          temps, step: int, *,
                          active: Optional[torch.Tensor] = None) -> None:
    """One anneal step of every chain, plain PyTorch, ``state`` updated in
    place.  Arguments as ``anneal_step`` takes them.

    The chain's move is the first maximum of ``-delta / T + g`` over its
    ``N * M`` moves, unless the "stay" draw ``g[N * M]`` is larger; a
    blocked move is never made.  The arithmetic runs in the reference
    annealer's order, so the kernel, the reference and this agree bit for
    bit."""
    assign, loads, counts, cost, best_cost, best_assign = state
    c, n = assign.shape
    m = loads.shape[1]
    k = gumbel.shape[0]
    nm = n * m
    dev = assign.device
    delta = move_delta_reference(loads, counts, assign, speeds, prev, lam,
                                 cap, active=active).view(c, nm)
    # first maximum of [-delta / T, 0] + g; "stay" is the last column
    z = delta.view(c // k, k, nm).neg().div_(temps[step]).add_(gumbel[:, :nm])
    zmax, zarg = z.view(c, nm).max(1)
    choice = torch.where(zmax >= gumbel[:, nm].repeat(c // k), zarg, nm)
    idx = torch.clamp(choice, max=nm - 1)
    p, b = idx // m, idx % m
    d = delta.gather(1, idx[:, None])[:, 0]
    do = (choice < nm) & (d < MOVE_BLOCKED / 2)
    w = speeds.gather(1, p[:, None])
    a = assign.gather(1, p[:, None]).long()
    new_assign = torch.where(
        do[:, None] & (torch.arange(n, device=dev) == p[:, None]),
        b[:, None].to(torch.int32), assign)
    m_iota = torch.arange(m, device=dev)
    hit_a = do[:, None] & (m_iota == a)
    hit_b = do[:, None] & (m_iota == b[:, None])
    new_loads = torch.where(hit_a, loads - w, loads)
    new_loads = torch.where(hit_b, new_loads + w, new_loads)
    new_counts = counts - hit_a.to(torch.int32) + hit_b.to(torch.int32)
    new_cost = torch.where(do, cost + d, cost)
    better = new_cost < best_cost
    best_cost.copy_(torch.where(better, new_cost, best_cost))
    best_assign.copy_(torch.where(better[:, None], new_assign, best_assign))
    assign.copy_(new_assign)
    loads.copy_(new_loads)
    counts.copy_(new_counts)
    cost.copy_(new_cost)


def _want(name: str, x, dtype, shape, dev) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {list(shape)} on {dev}; got {x.dtype} "
                         f"{list(x.shape)} on {x.device}")


class _KernelSteps:
    """The kernel's launches for a run of steps over one state: the state
    and the inputs are checked once, here, and held (the kernel reads
    them through their pointers); each call checks only its step's draws
    and index."""

    def __init__(self, state: ChainState, speeds, prev, lam, cap, temps,
                 draws: int, active: Optional[torch.Tensor]):
        dev = state.assign.device
        c, n = state.assign.shape
        m = state.loads.shape[1]
        if draws <= 0 or c % draws:
            raise ValueError(f"{c} chains are not whole rows of the {draws} "
                             f"draws a step")
        f32, i32 = torch.float32, torch.int32
        steps = temps.shape[0] if temps.dim() == 1 else -1
        for name, x, dtype, shape in (
                ("assign", state.assign, i32, (c, n)),
                ("loads", state.loads, f32, (c, m)),
                ("counts", state.counts, i32, (c, m)),
                ("cost", state.cost, f32, (c,)),
                ("best_cost", state.best_cost, f32, (c,)),
                ("best_assign", state.best_assign, i32, (c, n)),
                ("speeds", speeds, f32, (c, n)), ("prev", prev, i32, (c, n)),
                ("lam", lam, f32, (c,)), ("cap", cap, f32, (c,)),
                ("temps", temps, f32, (steps,))):
            _want(name, x, dtype, shape, dev)
        if active is not None:
            _want("active", active, i32, (c, n), dev)
        self._held = (state, speeds, prev, lam, cap, temps, active)
        self._head = (*(x.data_ptr() for x in state), speeds.data_ptr(),
                      prev.data_ptr(), lam.data_ptr(), cap.data_ptr(),
                      None if active is None else active.data_ptr())
        self._temps = temps.data_ptr()
        self._tail = (c // draws, draws, n, m)
        self._dev, self._steps = dev, steps
        self._shape = (draws, n * m + 1)
        self._launch = _build.entry("anneal_step_f32")

    def __call__(self, gumbel: torch.Tensor, index: int) -> None:
        if gumbel.dtype != torch.float32 or gumbel.device != self._dev \
                or gumbel.shape != self._shape or not gumbel.is_contiguous():
            _want("gumbel", gumbel, torch.float32, self._shape, self._dev)
        if not 0 <= index < self._steps:
            raise ValueError(f"step {index} outside temps of length "
                             f"{self._steps}")
        self._launch(*self._head, gumbel.data_ptr(), self._temps, index,
                     *self._tail, _build.stream_ptr(self._dev))
        anneal_step.launches += 1


def anneal_step_launcher(state: ChainState, speeds, prev, lam, cap, temps,
                         draws: int, *,
                         active: Optional[torch.Tensor] = None
                         ) -> Callable[[torch.Tensor, int], None]:
    """``step(gumbel, index)``: one anneal step of every chain of
    ``state``, updated in place, for a run of steps over the same state and
    inputs (arguments as ``anneal_step`` takes them; ``draws`` is K, the
    rows of each step's ``gumbel``).  CPU tensors step with
    ``anneal_step_reference``; CUDA tensors launch the kernel, the state
    and the inputs checked once, here, and each step's draws at its
    call."""
    if state.assign.device.type == "cpu":
        return lambda gumbel, step: anneal_step_reference(
            state, speeds, prev, lam, cap, gumbel, temps, step, active=active)
    return _KernelSteps(state, speeds, prev, lam, cap, temps, draws, active)


@_build.counted
def anneal_step(state: ChainState, speeds, prev, lam, cap, gumbel, temps,
                step: int, *, active: Optional[torch.Tensor] = None) -> None:
    """One anneal step of every chain in one launch, ``state`` updated in
    place.

    ``state`` holds ``C = R * K`` chains (row-major: chain ``c`` is row
    ``c // K``, draw ``c % K``); speeds f32[C, N]; prev i32[C, N]; lam,
    cap f32[C]; gumbel f32[K, N*M + 1], the step's draws shared by the
    rows (column ``N*M`` is "stay"); temps f32[steps] on the card, of which
    the kernel reads ``temps[step]``; active optional i32[C, N].  Every
    tensor must already have its dtype and be contiguous on one device:
    nothing is converted, so a step dispatches no torch op.  A run of
    steps over the same state takes ``anneal_step_launcher``, which checks
    the state once.

    Replaces the JAX annealer's step (``src/repro/opt/anneal.py:147-186``:
    ``body`` around ``move_delta_batch``, ``src/repro/kernels/
    move_eval.py:135``, and ``chain_update``).  On the H100 it is bound by
    bytes: the chains' state read and written once and the Gumbel block
    read once.  The delta plane never leaves the chip: a warp a chain at
    ``N*M <= 8192`` (the 8 warps of a block share their Gumbel row in
    shared memory), a cluster of 8 blocks a chain above (the blocks' best
    moves meet through distributed shared memory).  An item's moves have
    four possible costs, so ``-cost / T`` is divided once an item.

    CPU tensors run ``anneal_step_reference``; CUDA tensors launch the
    kernel (``csrc/move_eval.cu``) or raise.  The launch, and the count
    of launches kept on this function, happen in
    ``anneal_step_launcher``'s stepper.
    """
    anneal_step_launcher(state, speeds, prev, lam, cap, temps,
                         gumbel.shape[0], active=active)(gumbel, step)

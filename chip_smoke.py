#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (the lag twin, the fleet layer, the
packers' sweep, the optimizer, the adversarial search and trace replay,
and LLM serving of a dense model and of RWKV-6) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from a checkout of the repository on a machine with a CUDA card and
``nvcc``.  Phases, each of which fails the script if it fails:

1. the card's name and power limit, torch and CUDA versions;
2. building the CUDA kernels from ``src/repro_torch/kernels/csrc``; the
   built library's SASS (``cuobjdump -sass``) must show the bfloat16
   flash-attention kernel on ``wgmma`` (``HGMMA``) with its K/V loaded by
   TMA (``UTMALDG``) at every head dim, and the float32 one without
   ``HGMMA``; the build's ``-Xptxas -v`` report must show every
   ``loop_fused`` instantiation (n = 1..14) with a 0-byte stack frame and
   no spills (its state in registers), and every ``rwkv6_wkv`` head size
   (16, 32, 64, 128) with no spills;
3. every kernel against its plain PyTorch version on the card
   (integers exact, floats ``rtol = atol = 1e-5``; the attention
   kernels at ``2e-5`` in float32 and ``2e-2`` in bfloat16; the WKV
   kernel within ``1e-4`` of the largest magnitude of its plain result),
   at stress shapes and at the shapes the paths give it (the drain
   ``lag_update`` in the lag twin's dtypes -- bool masks, int64 ``assign``
   -- and in int32, the same bits; decode attention
   also at fills on either side of a split boundary, and captured once in
   a CUDA graph and replayed at other fills set in place on the card; the
   packing kernel ``pack_rows`` for all 12 packers, masked and unmasked,
   at n = 6, 7, 32 and 256, with ties, oversized items and out-of-range
   previous names, exact and ``loads`` bit for bit; the annealer's step
   ``anneal_step`` against ``anneal_step_reference`` over 48 steps at
   path C1's, C2's and I1's shapes, masked and unmasked, every state
   tensor bit for bit);
4. path A: ``repro_torch.api.simulate`` with the 8 heuristic packers
   through the ``loop_fused`` kernel (``fused_steps=8, fused_kernel=True``)
   over 4096 consumer groups x 2880 steps (one day at a 30 s monitor
   window) x 14 partitions, a mix of diurnal, bursty and masked
   topic-lifecycle traffic made on the card from ``--seed``, each rate
   clipped to one consumer's capacity (the paper's Sec. II feasibility
   assumption: one consumer can drain any single partition);
5. path B: ``api.simulate`` with MWF, MBF, MWFP, MBFP, KEDA_LAG,
   RATE_THRESHOLD and BFD through the per-step loop with
   ``use_kernel=True`` over 1024 groups x 480 steps x 32 partitions:
   exactly one ``pack_rows`` launch a packing policy a step (2400), no
   ``select_slot_grid`` launch, 3360 ``lag_update`` launches; then the
   torch ops a step of each policy, with the packing kernel and with the
   plain packers swapped in, and the 7 policies' total beside the
   ``lag_update`` launches;
6. path C1: ``api.simulate`` with the annealer policies ANNEAL and
   ANNEAL_STICKY (6 chains, 48 anneal steps a decision) over path B's
   traffic, every anneal step one ``anneal_step`` launch (exactly 46,080,
   and no ``move_delta_batch`` launch); the first 16 groups x 48 steps run
   once more on the CPU with the card's draws injected and must give the
   same integers; then the torch ops an anneal step, with the kernel
   (fewer than 10) and with the plain step;
7. path C2: ``api.optimize`` on one 256-partition topic (a diurnal step,
   ``prev`` from 32 steps of BFD): the 7-lambda x 4-restart frontier over
   250 anneal steps, all 12 packers scored against it (exactly 250
   ``anneal_step``, 12 ``pack_rows`` and no ``move_delta_batch``
   launches); the same instance and seed with the plain anneal step on
   the card must give the same frontier;
8. path F, a ragged fleet through ``FleetRunner.simulate``: 4096
   consumer groups, 512 of each of the 8 registered scenario families at
   their default knobs (churn, topic_lifecycle and adversarial masked),
   drawn on the card at 960 steps x 64 partitions from ``--seed`` and
   clipped to one consumer's capacity, each cut to its own T_i in {240,
   480, 720, 960} steps and N_i in 4..64 partitions (numpy, from
   ``--seed``), bucketed into (480, 960) x (8, 16, 32, 64); BFD, MBF,
   MWFP and KEDA_LAG through the per-step loop with ``use_kernel=True``
   and a replica cap of 64: exactly 8 bucket groups, 3 x sum(T_b) =
   17,280 ``pack_rows`` and 4 x sum(T_b) = 23,040 ``lag_update``
   launches, no ``select_slot_grid``; the same call after ``reset()``
   hits all 8 cache entries (no miss, no eviction); 8 groups of each
   bucket that share a shape, run at that shape through ``sweep_lag``,
   equal the padded run (integers exact, lag within ``1e-5``);
9. path G: ``api.sweep`` of the 12 packers over path B's traffic
   (exactly 12 x 480 ``pack_rows`` launches, none of ``select_slot_grid``),
   its first 16 streams x 48 steps once more on the CPU (bins and
   migrations exact, R-scores within ``1e-5``); ``api.evaluate()`` at the
   paper's defaults (12 x 120 launches) equal to the CPU's (CBS and
   Pareto lists exact, average R-score within ``1e-5``); ``api.pack`` of
   one 256-partition instance for each of the 12 packers equal to the
   CPU's; G4: ``api.pack(backend="py")`` (the pure-Python packers, the
   facade's default) for the 12 packers on that instance, its speeds
   quantized to k/1024, equal to ``backend="torch"`` on the card
   (assignment, ``n_bins``, loads);
10. path H, the scalers as deployed, observed in the loop: H1 is
   ``api.simulate`` over path B's traffic with ``use_kernel=True`` and
   in-loop telemetry (per-step frames, the default sketch, the four
   default alert rules): (a) KEDA_LAG_REAL and CLOUD_RUN_CPU_LAG at their
   registry defaults, (b) MBF, BFD and KEDA_LAG behind
   ``control_plane=ControlPlaneConfig(polling_interval=1,
   observation_delay=1, actuation_delay=1, cooldown_period=10,
   max_replicas=16, warmup_steps=2)``: exactly policies x 480
   ``lag_update`` and packers x 480 ``pack_rows`` launches; the SLO
   metrics, incidents per policy and rule and a lint-clean Prometheus
   exposition; the first 16 groups x 48 steps once more on the card and
   on the CPU (the plain versions): integers, sketch counts and
   histograms and incident tables exact, floats within ``1e-5``; then
   the torch ops a policy-step with the telemetry and the control plane
   on, each alone and both off.  H2 is path A's heuristics at [1024, 960,
   14] under ``fused_steps=8, fused_kernel=True`` with a sketch and
   alerts on: no ``loop_fused`` launch (the kernel carries no
   telemetry), trajectories equal to the kernel's with telemetry off bit
   for bit.  H3 is a ragged fleet of 256 of path F's groups with BFD, MBF
   and KEDA_LAG_REAL through ``FleetRunner.simulate``, a sketch and
   alerts on: exact launch counts, and 16 groups at their own shapes with
   equal sketches and incident tables;
11. path I, adversarial search and trace replay, every fitness step
   through the drain and packing kernels (``use_kernel=True``): I1 is
   ``api.attack`` of each registry family's representative (NF, MWF,
   KEDA_LAG, ANNEAL) at the reference's own search budget
   (``benchmarks/adversarial_bench.py``: pop 8, 6 generations, 96 steps x
   6 partitions, ``incident_weight=0.05``, the four default alert rules
   in the loop), the random baseline on: exactly 96 ``lag_update``
   launches a generation of the search and of the baseline, as many
   ``pack_rows`` for NF and MWF, none for KEDA_LAG, 48 ``anneal_step``
   a step for ANNEAL; NF's search once more, bit for bit; for each
   policy, one fitness batch of the oracle's rows at I1's shape through
   the loop on the card against the CPU run of the same rows (plain
   versions; ANNEAL with the card's draws injected), integers and
   incident tables exact, lag within ``1e-5``.  I2 is
   ``api.attack("MBF")`` at a capacity planner's size (pop 32 x 4
   scenarios of 960 steps x 32 partitions a fitness call, 8
   generations) through a fresh ``FleetRunner``: exactly 960 x 2 x
   ``generations_run`` launches of each kernel, one cache miss and
   ``2 x generations_run - 1`` hits, the oracle's batch at its shape
   (the kept genome and 31 random ones, [128, 960, 32]) against the CPU
   transform of the same draws, masks exact; its witness saved as
   ``.npz`` and ``.json`` (equal once loaded) and replayed through
   ``api.replay`` (MBF, BFD, KEDA_LAG; as recorded, and resampled to 480
   steps), each equal to a direct ``api.simulate`` of the same arrays
   bit for bit;
12. path D, dense-LLM serving: qwen3-8b at full width and depth (36
   layers) in bfloat16 with bfloat16 weights drawn on the card from
   ``--seed``; D1 is ``make_prefill_step`` on 8 requests x 1024 prompt
   tokens (36 flash-attention launches), D2 is ``SharedModel.generate``
   on the same requests with a 1152-token cache: 1024 teacher-forced steps
   and 128 greedy ones (36 x 1152 decode-attention launches);
13. the agreement check of the LLM kernels: qwen3-8b at full width with 4
   layers in float32, prefill and 48 + 16 decode steps once with the
   kernels and once with their plain versions on the card: logits within
   1e-4, the same tokens; the decode logits at every prompt position
   equal to the full-sequence logits within 2e-2 (the reference's own
   property); the same prefill on the CPU, printed;
14. path E, RWKV-6 serving: rwkv6-3b at full width and depth (32 layers)
   in bfloat16 with bfloat16 weights drawn on the card from ``--seed``;
   E1 is ``make_prefill_step`` on 8 requests x 1024 prompt tokens (32
   WKV launches), E2 is ``SharedModel.generate`` on the same requests,
   1024 teacher-forced steps and 128 greedy ones (32 x 1152 WKV
   launches, each writing its layer's state in place);
15. the RWKV agreement check: rwkv6-3b at full width with 4 layers in
   float32 (bonus and decay perturbed from their init constants), prefill
   and 48 + 16 decode steps once with the WKV kernel and once with its
   plain version on the card, with the same checks as phase 13;
16. each kernel's time at its path's shapes beside its bound, its plain
   version's time and, for the attention kernels, the time of PyTorch's
   ``scaled_dot_product_attention`` on the same inputs (``library_ms``,
   a yardstick the port never calls; the flash row also in float32 at
   D1's shape; no PyTorch call computes the WKV recurrence; ``pack_rows``
   at path B's Modified Any Fit call, MBF over [1024, 32]; ``anneal_step``
   at C1's and C2's shapes; the move plane ``move_eval``, which no path
   launches any more, at C1's); ``loop_fused`` and its plain version also
   run path A's whole input once more, assignments recorded, and their
   outputs must be equal bit for bit.

Kernel times (``ms``) and plain times (``plain_ms``) are device time per
call: ``loop_fused`` is one long launch timed with CUDA events, and the
small per-step kernels are timed as a CUDA graph of back-to-back calls,
so that no host work is counted.  ``wrapper_ms`` is the time per eager
call of the kernel's Python wrapper, which is what the per-step loop
pays.

Kernel launch counts are zeroed just before each path and read just
after it; a path that launched none of its kernels fails.  The line
before the last is a JSON object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed first and again just before them.  Without a CUDA card, or
outside a checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

HEURISTICS = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD")
PATH_B = ("MWF", "MBF", "MWFP", "MBFP", "KEDA_LAG", "RATE_THRESHOLD", "BFD")
PATH_C1 = ("ANNEAL", "ANNEAL_STICKY")
TOL = 1e-5
CAPACITY = 1.0                # a consumer's drain rate (LagSimConfig's default)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM data sheet, outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM data sheet, dense bf16 tensor cores
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LLM = "qwen3-8b"
D_BATCH, D_PROMPT, D_GEN = 8, 1024, 128     # paths D, E: requests, tokens
RWKV = "rwkv6-3b"
WKV_TOL = 1e-4                # of the plain result's largest magnitude


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int, warmup: int = 1):
    """``(mean milliseconds per call on the card, the last call's result)``
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def graph_ms(fn, calls: int) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph, replayed and timed with CUDA events, so
    that the host's per-call work is not counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()                         # first replay uploads the graph
    ms, _ = cuda_ms(graph.replay, 3, warmup=0)
    return ms / calls


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def traffic_mix(batch: int, iters: int, n: int, seed: int, dev):
    """Diurnal, bursty and masked topic-lifecycle groups, in thirds, each
    rate clipped to ``CAPACITY``: at the families' default knobs a few
    percent of partition-steps exceed one consumer's drain rate, and such
    a partition's backlog grows under every policy."""
    import torch

    from repro_torch.core import scenarios

    sizes = (batch - 2 * (batch // 3), batch // 3, batch // 3)
    rates, masks = [], []
    for i, (fam, b) in enumerate(zip(("diurnal", "bursty", "topic_lifecycle"),
                                     sizes)):
        sp, act = scenarios.generate_masked_scenario(fam, seed + i, b, iters,
                                                     n, device=dev)
        rates.append(torch.clamp(sp, max=CAPACITY))
        masks.append(act)
    return torch.cat(rates), torch.cat(masks)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _close(got, want, what: str) -> float:
    import torch

    err = _max_err(got, want)
    _require(torch.allclose(got, want, rtol=TOL, atol=TOL),
             f"{what}: kernel disagrees with its plain version "
             f"(max abs err {err})")
    return err


def _exact(got, want, what: str) -> None:
    import torch

    _require(torch.equal(got, want),
             f"{what}: kernel integers differ from its plain version")


def check_lag_update(dev, gen, b, n, m, names):
    """Kernel against plain at ``[b, n]`` partitions and ``m`` bins, with
    bin names drawn below ``names``: masked and unmasked, with the lag
    twin's dtypes (bool masks, ``active`` one step of a [B, 2, N] mask,
    int64 ``assign``) and with int32 ones; both dtypes give the same
    bits."""
    import torch

    from repro_torch.kernels import lag_update as lu

    worst = 0.0
    for masked in (False, True):
        lag = torch.rand((b, n), generator=gen, device=dev) * 2
        produced = torch.rand((b, n), generator=gen, device=dev)
        assign = torch.randint(-1, names, (b, n), generator=gen, device=dev)
        readable = torch.rand((b, n), generator=gen, device=dev) > 0.2
        cap = torch.rand((b, m), generator=gen, device=dev) * 4
        act = (torch.rand((b, 2, n), generator=gen, device=dev) > 0.1
               if masked else None)
        i32 = lambda x: x.to(torch.int32)  # noqa: E731
        got = lu.lag_update_batch(lag, produced, assign, readable, cap,
                                  active=None if act is None else act[:, 1])
        got32 = lu.lag_update_batch(
            lag, produced, i32(assign), i32(readable), cap,
            active=None if act is None else i32(act[:, 1]))
        want = lu.lag_update_reference(
            lag, produced, assign, readable, cap, m=m,
            active=None if act is None else act[:, 1])
        torch.cuda.synchronize()
        _require(torch.equal(got.view(torch.int32), got32.view(torch.int32)),
                 f"lag_update masked={masked}: bool/int64 and int32 inputs "
                 f"give different bits")
        worst = max(worst, _close(got, want, f"lag_update masked={masked}"))
    print(f"check lag_update B={b} N={n} M={m} names<{names} masked and "
          f"unmasked, bool/int64 and int32 inputs (the same bits): "
          f"max_abs_err={worst!r}")
    return worst


def check_select_slot(dev, gen, b, n, m):
    """Kernel against plain at ``[b, n, m]``, every strategy, masked and
    not (the packers pass no mask)."""
    import torch

    from repro_torch.kernels import binpack_select as bs

    for strategy in ("first", "best", "worst"):
        for masked in (False, True):
            # loads on a coarse grid so that ties are common
            loads = torch.randint(0, 9, (b, n, m), generator=gen,
                                  device=dev).float() / 8
            w = torch.randint(0, 5, (b, n), generator=gen,
                              device=dev).float() / 8
            k = torch.randint(0, m + 1, (b, n), generator=gen, device=dev)
            cap = torch.ones((b, n), device=dev)
            act = (torch.rand((b, n), generator=gen, device=dev) > 0.2
                   if masked else None)
            got = bs.select_slot_grid(loads, w, k, cap, strategy=strategy,
                                      active=act)
            want = bs.select_slot_plain(loads, w, k, cap, strategy=strategy,
                                        active=act)
            torch.cuda.synchronize()
            _exact(got, want, f"select_slot_grid [{b},{n},{m}] {strategy} "
                              f"masked={masked}")
    print(f"check select_slot_grid B={b} N={n} M={m} first/best/worst "
          f"masked and unmasked: exact")
    return 0.0


PACKERS = HEURISTICS + ("MWF", "MBF", "MWFP", "MBFP")


def plain_packer(name):
    """The registered packer's plain version (the per-insert walk of torch
    ops, launching nothing)."""
    from repro_torch.core.pack import modified_any_fit_plain, pack_plain
    from repro_torch.registry import get_spec

    hyper = get_spec(name).hyperparams
    if "fit" in hyper:
        return lambda *a, **k: modified_any_fit_plain(
            *a, fit=hyper["fit"], sort_key=hyper["sort_key"], **k)
    return lambda *a, **k: pack_plain(
        *a, strategy=hyper["strategy"], decreasing=hyper["decreasing"], **k)


def _pack_instances(dev, gen, rows, n, masked):
    """Rows with tied speeds (a coarse grid on even rows), oversized items
    (w > C), a few large consumers, and ``prev`` holding -1, lower
    negatives and names past the 2n + 2 of the name range."""
    import torch

    speeds = torch.rand((rows, n), generator=gen, device=dev)
    speeds[::2] = torch.round(speeds[::2] * 4) / 4
    speeds[1::3, 0] = 1.3 * CAPACITY
    prev = torch.randint(-3, 2 * n + 5, (rows, n), generator=gen, device=dev)
    prev[3::4] = torch.randint(0, 3, prev[3::4].shape, generator=gen,
                               device=dev)
    act = (torch.rand((rows, n), generator=gen, device=dev) > 0.3
           if masked else None)
    return speeds, prev, act


def check_pack_rows(dev, gen, rows, n):
    """The packing kernel against the plain packers at ``[rows, n]``: all
    12 packers, masked and unmasked; ``bin_of``, ``names`` and ``n_bins``
    equal, ``loads`` bit for bit."""
    import torch

    from repro_torch.registry import get_spec

    for masked in (False, True):
        speeds, prev, act = _pack_instances(dev, gen, rows, n, masked)
        for name in PACKERS:
            got = get_spec(name).packer(speeds, prev, CAPACITY, active=act)
            want = plain_packer(name)(speeds, prev, CAPACITY, active=act)
            torch.cuda.synchronize()
            what = f"pack_rows {name} [{rows}, {n}] masked={masked}"
            for f in ("bin_of", "names", "n_bins"):
                _exact(getattr(got, f), getattr(want, f), f"{what} {f}")
            _require(torch.equal(got.loads.view(torch.int32),
                                 want.loads.view(torch.int32)),
                     f"{what}: loads differ from the plain version's bits "
                     f"(max abs err {_max_err(got.loads, want.loads)})")
    print(f"check pack_rows R={rows} N={n} all 12 packers masked and "
          f"unmasked, ties, oversized items, prev -1 / negative / out of "
          f"range: exact, loads bit for bit")
    return 0.0


def _anneal_state(dev, gen, k, n, masked):
    """Random chain states over ``m = 2n + 2`` names: loads and counts
    from the assignment (inactive items excluded), some unassigned items
    (prev = -1), some oversized ones (w > C), lambda 0 or 4 per chain."""
    import torch

    m = 2 * n + 2
    speeds = torch.rand((k, n), generator=gen, device=dev) * 1.3 * CAPACITY
    assign = torch.randint(0, m, (k, n), generator=gen, device=dev)
    prev = torch.randint(-1, m, (k, n), generator=gen, device=dev)
    act = (torch.rand((k, n), generator=gen, device=dev) > 0.1 if masked
           else torch.ones((k, n), dtype=torch.bool, device=dev))
    w = torch.where(act, speeds, 0.0)
    loads = torch.zeros((k, m), device=dev).scatter_add_(1, assign, w)
    counts = torch.zeros((k, m), dtype=torch.int32, device=dev).scatter_add_(
        1, assign, act.to(torch.int32))
    lam = (torch.rand(k, generator=gen, device=dev) > 0.5).float() * 4.0
    cap = torch.full((k,), CAPACITY, device=dev)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return ((loads, counts, i32(assign), speeds, i32(prev), lam, cap),
            i32(act) if masked else None)


def check_move_eval(dev, gen, k, n):
    """Kernel against plain at ``[k, n, 2n + 2]``, bit for bit, masked and
    unmasked."""
    import torch

    from repro_torch.kernels import move_eval as me

    for masked in (False, True):
        args, act = _anneal_state(dev, gen, k, n, masked)
        got = me.move_delta_batch(*args, active=act)
        want = me.move_delta_reference(*args, active=act)
        torch.cuda.synchronize()
        _require(torch.equal(got, want),
                 f"move_eval [{k},{n},{2 * n + 2}] masked={masked}: kernel "
                 f"differs from its plain version (max abs err "
                 f"{_max_err(got, want)})")
        blocked = want >= me.MOVE_BLOCKED / 2
        _require(bool(blocked.any()) and bool((~blocked).any()),
                 "move_eval check instance has no blocked or no open move")
        del got, want
    print(f"check move_eval K={k} N={n} M={2 * n + 2} masked and unmasked, "
          f"prev=-1, oversized items, empty bins: bit-exact")
    return 0.0


def _step_inputs(dev, gen, rows, k, n, masked):
    """An anneal step's inputs over ``rows * k`` chains in random states
    (``_anneal_state``'s), a cost and best cost of their own, the step's
    Gumbel draws and a temperature schedule of 48 steps."""
    import torch

    from repro_torch.kernels import move_eval as me

    c, m = rows * k, 2 * n + 2
    (loads, counts, assign, speeds, prev, lam, cap), act = _anneal_state(
        dev, gen, c, n, masked)
    cost = torch.rand(c, generator=gen, device=dev) * n
    state = me.ChainState(assign, loads.contiguous(), counts, cost,
                          cost + 0.5, assign.clone())
    u = torch.rand((k, n * m + 1), generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-30)))
    temps = torch.logspace(0, -2, 48, device=dev)
    return state, (speeds, prev, lam, cap), act, gumbel, temps


def check_anneal_step(dev, gen, rows, k, n, steps=48):
    """The anneal step's kernel against its plain version over ``steps``
    steps from the same random states of ``rows * k`` chains, masked and
    unmasked (the masked run's draws on a coarse grid, so that moves tie
    in z and the "stay" draw ties the best move): every state tensor bit
    for bit after each step."""
    import torch

    from repro_torch.kernels import move_eval as me

    for masked in (False, True):
        got, args, act, _, temps = _step_inputs(dev, gen, rows, k, n, masked)
        want = me.ChainState(*(x.clone() for x in got))
        start = got.assign.clone()
        for t in range(steps):
            u = torch.rand((k, n * (2 * n + 2) + 1), generator=gen,
                           device=dev)
            g = -torch.log(-torch.log(u.clamp_(min=1e-30)))
            if masked:
                g = torch.round(g * 2) / 2
            me.anneal_step(got, *args, g, temps, t, active=act)
            me.anneal_step_reference(want, *args, g, temps, t, active=act)
            for name, a, b in zip(me.ChainState._fields, got, want):
                _require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                         f"anneal_step rows={rows} K={k} N={n} masked="
                         f"{masked} step {t}: {name} differs from the plain "
                         f"version's bits")
        torch.cuda.synchronize()
        _require(not torch.equal(got.assign, start),
                 "anneal_step check made no move")
    print(f"check anneal_step rows={rows} K={k} N={n} ({rows * k} chains) "
          f"{steps} steps masked (coarse draws) and unmasked: every state "
          f"tensor bit for bit")
    return 0.0


def _attn_close(got, want, dtype, what: str) -> float:
    import torch

    err = _max_err(got, want)
    tol = ATTN_TOL[dtype]
    _require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
             f"{what}: kernel disagrees with its plain version (max abs err "
             f"{err})")
    return err


def _normal(gen, shape, dtype, dev):
    import torch

    return torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, dtype))


def check_flash(dev, gen, b, h, kv, sq, skv, hd, causal=True):
    """Kernel against plain at q [b, h, sq, hd] over k/v [b, kv, skv, hd],
    float32 and bfloat16."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q = _normal(gen, (b, h, sq, hd), dtype, dev)
        k = _normal(gen, (b, kv, skv, hd), dtype, dev)
        v = _normal(gen, (b, kv, skv, hd), dtype, dev)
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = _attn_close(got, want, dtype,
                          f"flash_attention q={[b, h, sq, hd]} kv={kv} "
                          f"skv={skv} causal={causal} {dtype}")
        print(f"check flash_attention q=[{b}, {h}, {sq}, {hd}] kv_heads={kv} "
              f"skv={skv} causal={causal} {dtype}: max_abs_err={err!r}")
        worst = max(worst, err)
        del q, k, v, got, want
    return worst


def check_decode(dev, gen, b, kv, g, s, hd, fills):
    """Kernel against plain at q [b, kv, g, hd] over caches [b, kv, s, hd]
    for each fill, float32 and bfloat16."""
    import torch

    from repro_torch.kernels import decode_attention as da

    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q = _normal(gen, (b, kv, g, hd), dtype, dev)
        k = _normal(gen, (b, kv, s, hd), dtype, dev)
        v = _normal(gen, (b, kv, s, hd), dtype, dev)
        for fill in fills:
            clen = torch.tensor(fill, dtype=torch.int32, device=dev)
            got = da.decode_attention_fwd(q, k, v, clen)
            want = da.decode_attention_plain(q, k, v, clen)
            torch.cuda.synchronize()
            err = _attn_close(got, want, dtype, f"decode_attention q="
                              f"{[b, kv, g, hd]} S={s} fill={fill} {dtype}")
            print(f"check decode_attention q=[{b}, {kv}, {g}, {hd}] S={s} "
                  f"fill={fill} {dtype}: max_abs_err={err!r}")
            worst = max(worst, err)
        del q, k, v
    return worst


def check_decode_graph(dev, gen, b, kv, g, s, hd, fills):
    """One decode call at q [b, kv, g, hd] over caches [b, kv, s, hd],
    captured once in a CUDA graph and replayed after ``cache_len`` is set
    in place on the card to each fill: equal to the plain version each
    time, in float32 and bfloat16 (the split plan never reads the host's
    fill)."""
    import torch

    from repro_torch.kernels import decode_attention as da

    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        q = _normal(gen, (b, kv, g, hd), dtype, dev)
        k = _normal(gen, (b, kv, s, hd), dtype, dev)
        v = _normal(gen, (b, kv, s, hd), dtype, dev)
        clen = torch.tensor(fills[0], dtype=torch.int32, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            da.decode_attention_fwd(q, k, v, clen)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = da.decode_attention_fwd(q, k, v, clen)
        for fill in fills:
            clen.fill_(fill)
            graph.replay()
            torch.cuda.synchronize()
            err = _attn_close(got, da.decode_attention_plain(q, k, v, clen),
                              dtype, f"decode_attention graph replay at "
                              f"fill={fill} {dtype}")
            worst = max(worst, err)
        del q, k, v, got, graph
    print(f"check decode_attention q=[{b}, {kv}, {g}, {hd}] S={s}: one call "
          f"captured in a CUDA graph, replayed at fills {list(fills)} set on "
          f"the card, float32 and bfloat16: max_abs_err={worst!r}; "
          f"{da.decode_splits(b, kv, s)} splits a (batch row, kv head)")
    return worst


def check_sass(lib) -> None:
    """``HGMMA`` (wgmma) and ``UTMALDG`` (TMA tile loads) in every
    instantiation of the bfloat16 flash kernel, and no ``HGMMA`` in the
    float32 one, read from the built library's SASS."""
    import shutil

    from repro_torch.kernels.flash_attention import HEAD_DIMS

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    counts = {}
    for name, lines in funcs.items():
        if "flash_attention_bf16_kernel" in name:
            body = "\n".join(lines)
            counts[name] = (body.count("HGMMA"), body.count("UTMALDG"))
    _require(len(counts) == len(HEAD_DIMS),
             f"sass: {len(counts)} flash_attention_bf16 kernels in {lib}, "
             f"want one for each head dim of {HEAD_DIMS}")
    _require(all(h and t for h, t in counts.values()),
             f"sass: a flash_attention_bf16 kernel lacks HGMMA or UTMALDG: "
             f"{counts}")
    f32 = [n for n in funcs if "flash_attention_kernel" in n]
    _require(f32 and not any("HGMMA" in "\n".join(funcs[n]) for n in f32),
             "sass: the float32 flash kernel is missing or runs HGMMA")
    print(f"check sass: {len(counts)} flash_attention_bf16 kernels, (HGMMA, "
          f"UTMALDG) instructions each: {sorted(counts.values())}; "
          f"{len(f32)} float32 flash kernels without HGMMA")


def check_ptxas() -> None:
    """Every ``loop_fused`` instantiation (n = 1..14) in the build's
    ``-Xptxas -v`` report with a 0-byte stack frame and no spill: its
    rows' state lives in registers; every ``rwkv6_wkv`` head size (16, 32,
    64, 128) with no spill (32 state registers a thread)."""
    import re

    from repro_torch.kernels import _build

    report = _build.ptxas_report().read_text()
    found = {}
    for name, stack, st, ld, regs in re.findall(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
            r"(\d+) registers", report):
        m = re.search(r"loop_fused_kernelILi(\d+)E", name)
        if m:
            found[int(m.group(1))] = (int(stack), int(st), int(ld),
                                      int(regs))
    _require(sorted(found) == list(range(1, 15)),
             f"ptxas: loop_fused instantiations {sorted(found)}, want 1..14")
    bad = {n: v for n, v in found.items() if v[:3] != (0, 0, 0)}
    _require(not bad, f"ptxas: loop_fused with a stack frame or spills "
                      f"(n: stack, spill stores, spill loads, registers): "
                      f"{bad}")
    print(f"check ptxas: loop_fused n = 1..14, 0-byte stack frame and no "
          f"spill each; registers {[found[n][3] for n in range(1, 15)]}")
    wkv = {}
    for name, stack, st, ld, regs in re.findall(
            r"Function properties for (\S+rwkv6_wkv_kernelILi(?:\d+)E\S*)\n"
            r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads\n.*?Used (\d+) registers", report):
        hd = int(re.search(r"rwkv6_wkv_kernelILi(\d+)E", name).group(1))
        wkv[hd] = (int(stack), int(st), int(ld), int(regs))
    _require(sorted(wkv) == [16, 32, 64, 128],
             f"ptxas: rwkv6_wkv instantiations {sorted(wkv)}, want 16..128")
    bad = {hd: v for hd, v in wkv.items() if v[1:3] != (0, 0)}
    _require(not bad, f"ptxas: rwkv6_wkv spills (hd: stack, spill stores, "
                      f"spill loads, registers): {bad}")
    print(f"check ptxas: rwkv6_wkv hd = 16, 32, 64, 128 (hd: stack frame, "
          f"spill stores, spill loads, registers): {dict(sorted(wkv.items()))}")


#: the serving paths' kernel wrappers: each phase of a serving path
#: launches its own kernel and none of the others
SERVING_KERNELS = ("flash_attention_fwd", "decode_attention_fwd",
                   "rwkv6_wkv_fwd")


def _heads(cfg) -> str:
    if cfg.rwkv:
        return (f"heads={cfg.d_model // cfg.rwkv_head_size}x"
                f"{cfg.rwkv_head_size}")
    return f"heads={cfg.n_heads}/{cfg.n_kv_heads}"


def _launched(kernel: str, want: int, what: str) -> int:
    """The launches of ``kernel`` since the counts were zeroed; fails
    unless they are ``want`` and no other serving kernel launched."""
    from repro_torch.kernels import _build

    counts = _build.launch_counts()
    _require(counts[kernel] == want,
             f"{what}: {kernel} launched {counts[kernel]} times, want {want}")
    others = {k: counts[k] for k in SERVING_KERNELS
              if k != kernel and counts[k]}
    _require(not others, f"{what} launched {others}")
    return counts[kernel]


def run_serving_path(dev, seed, tag, name, prefill_kernel, decode_kernel):
    """``name`` serving at full width and depth in bfloat16: ``tag``1
    prefills D_BATCH x D_PROMPT tokens (one ``prefill_kernel`` launch a
    layer), ``tag``2 is greedy generation for them through
    ``SharedModel.generate`` (one ``decode_kernel`` launch a layer a step).
    Returns the two phases' launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_params, param_bytes
    from repro_torch.serving import SharedModel

    cfg = dataclasses.replace(configs.get(name), dtype="bfloat16",
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"path {tag}: {cfg.name} {cfg.n_layers} layers d_model="
          f"{cfg.d_model} {_heads(cfg)} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size} bf16: {cfg.n_params()} parameters, "
          f"{param_bytes(params)} bytes on the card, drawn in "
          f"{time.perf_counter() - t0!r} s")
    gen = torch.Generator(dev).manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (D_BATCH, D_PROMPT),
                            generator=gen, device=dev)
    prefill = make_prefill_step(cfg, dev)
    prefill(params, {"inputs": prompts[:1, :16]})     # cuBLAS warm-up

    # prefill
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, {"inputs": prompts})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f"{tag}1": _launched(prefill_kernel, cfg.n_layers,
                                     f"path {tag}1")}
    _require(tuple(logits.shape) == (D_BATCH, cfg.vocab_size)
             and bool(torch.isfinite(logits).all()),
             f"path {tag}1: logits {tuple(logits.shape)} not finite of "
             f"shape [{D_BATCH}, {cfg.vocab_size}]")
    first = logits.argmax(-1)
    print(f"path {tag}1 (prefill): {D_BATCH} x {D_PROMPT} tokens "
          f"wall_s={wall!r} prefill_tokens_per_s={D_BATCH * D_PROMPT / wall!r} "
          f"launches={{'{prefill_kernel}': {launches[tag + '1']}}} "
          f"logits_absmax={float(logits.float().abs().max())!r}")
    del logits

    # greedy generation through the decode path
    model = SharedModel(cfg, max_len=D_PROMPT + D_GEN, max_batch=D_BATCH,
                        device=dev, params=params)
    host_prompts = prompts.cpu().tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = model.generate(host_prompts, D_GEN)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = D_PROMPT + D_GEN
    launches[f"{tag}2"] = _launched(decode_kernel, cfg.n_layers * steps,
                                    f"path {tag}2")
    _require(out.shape == (D_BATCH, D_GEN) and (out >= 0).all()
             and (out < cfg.vocab_size).all(),
             f"path {tag}2: generated tokens {out.shape} out of range")
    agree = int((out[:, 0] == first.cpu().numpy()).sum())
    del model
    state = init_decode_state(cfg, D_BATCH, steps, dev)
    print(f"path {tag}2 (generate): {D_BATCH} requests x ({D_PROMPT} "
          f"teacher-forced + {D_GEN} greedy) steps, decode state "
          f"{param_bytes(state)} bytes: wall_s={wall!r} "
          f"ms_per_decode_step={wall / steps * 1e3!r} "
          f"decode_tokens_per_s={D_BATCH * steps / wall!r} "
          f"generated_tokens_per_s={D_BATCH * D_GEN / wall!r} "
          f"peak_mem_bytes={peak} "
          f"launches={{'{decode_kernel}': {launches[tag + '2']}}}")
    print(f"  first generated token equals {tag}1's argmax in {agree} of "
          f"{D_BATCH} requests (bf16, prefill and decode paths: printed, "
          f"not required)")
    print(f"  tokens[0, :16]={np.asarray(out[0, :16]).tolist()}")

    # one decode step at the last fill: its device time replayed as a
    # CUDA graph (no host work in it) and the torch ops it dispatches
    state["cache_len"].fill_(steps - 1)
    step = make_serve_step(cfg, dev)
    tok = prompts[:, 0]
    step_ms = graph_ms(lambda: step(params, state, {"inputs": tok}), 1)
    with _op_counter() as ops:
        step(params, state, {"inputs": tok})
    print(f"  one decode step at fill {steps - 1}: device_ms={step_ms!r} "
          f"(CUDA graph replay) torch_ops={ops.n} "
          f"({ops.n / cfg.n_layers!r} a layer) against "
          f"{wall / steps * 1e3!r} ms a step in {tag}2")
    return launches


def _op_counter():
    """A dispatch mode whose ``n`` counts the torch operators dispatched
    inside its block."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return OpCount()


@contextlib.contextmanager
def _swapped(plain):
    """Within the block, each ``(module, attribute, plain version)`` of
    ``plain`` has the module's kernel attribute replaced by its plain
    version (on the card)."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in plain]
    for mod, attr, fn in plain:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def agreement(dev, seed, name, plain, layers=4, batch=2, prompt=48,
              steps=16):
    """``name`` at full width with ``layers`` layers in float32: prefill
    and ``prompt`` teacher-forced + ``steps`` greedy decode steps with the
    kernels, then with their plain versions on the card (``plain`` as
    :func:`_swapped` takes it): logits within 1e-4, the same tokens.  Then
    the reference's own property (``tests/test_arch_smoke.py``): decoding
    token by token gives the full-sequence logits at every prompt position,
    within 2e-2.  RWKV's bonus and decay are perturbed from their init
    constants (u = 0 would leave the bonus term out)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.models.layers import embed_inputs, logits_fn
    from repro_torch.models.transformer import backbone

    cfg = dataclasses.replace(configs.get(name), n_layers=layers,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, seed=seed + 1, device=dev)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    if cfg.rwkv:
        for lp in params["layers"]:
            tm = lp["tm"]
            tm["bonus_u"] = torch.randn(tm["bonus_u"].shape, generator=gen,
                                        device=dev) * 0.5
            tm["decay_w0"] = torch.rand(tm["decay_w0"].shape, generator=gen,
                                        device=dev) * 4.5 - 4.0
    toks = torch.randint(1, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)

    def run():
        logits = [make_prefill_step(cfg, dev)(params, {"inputs": toks})]
        step = make_serve_step(cfg, dev)
        state = init_decode_state(cfg, batch, prompt + steps, dev)
        forced = []
        for t in range(prompt):
            out, state = step(params, state, {"inputs": toks[:, t]})
            forced.append(out)
        cur, chosen = out.argmax(-1), []
        logits.append(out)
        for _ in range(steps - 1):
            chosen.append(cur)
            out, state = step(params, state, {"inputs": cur})
            logits.append(out)
            cur = out.argmax(-1)
        chosen.append(cur)
        torch.cuda.synchronize()
        return (torch.stack(logits), torch.stack(chosen, 1),
                torch.stack(forced, 1))

    got, got_tok, forced = run()
    with _swapped(plain):
        want, want_tok, _ = run()
    err = _max_err(got, want)
    _require(torch.equal(got_tok, want_tok),
             f"{cfg.name} agreement: greedy tokens differ between the "
             f"kernels and their plain versions")
    _require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
             f"{cfg.name} agreement: logits differ by {err} (> 1e-4)")
    print(f"agreement {cfg.name} d_model={cfg.d_model} {layers} layers "
          f"float32, prefill {batch} x {prompt} then {prompt} teacher-forced "
          f"+ {steps} greedy decode steps: kernels vs plain versions on the "
          f"card max_abs_err={err!r} (logits absmax "
          f"{float(want.abs().max())!r}), tokens equal")
    positions = torch.arange(prompt, device=dev).expand(batch, prompt)
    with torch.no_grad():
        x = embed_inputs(params["embedding"], cfg, toks)
        full = logits_fn(params, cfg, backbone(params, cfg, x, positions))
    drift = _max_err(forced, full)
    _require(torch.allclose(forced, full, rtol=2e-2, atol=2e-2),
             f"{cfg.name} decode vs prefill: logits differ by {drift} "
             f"(> 2e-2)")
    print(f"  decode vs prefill at all {prompt} positions (kernels): "
          f"max_abs_diff={drift!r} (within 2e-2)")
    # the same prefill on the host's CPU (plain versions): how far the
    # card's float32 (norms, products, kernels) drifts from it
    host = make_prefill_step(cfg, "cpu")(_tree_to(params, "cpu"),
                                         {"inputs": toks.cpu()})
    drift = _max_err(got[0].cpu(), host)
    same = int((got[0].argmax(-1).cpu() == host.argmax(-1)).sum())
    print(f"  card vs CPU, float32 prefill logits: max_abs_diff={drift!r}, "
          f"argmax equal in {same} of {batch} (printed, not required)")


def _tree_to(tree, device):
    """A copy of a parameter tree (dicts, lists, tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def attention_rows(dev, seed, launches, errs):
    """Kernel rows of flash_attention (path D1's call) and decode_attention
    (path D2's call at the full cache)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(dev).manual_seed(seed)
    b, h, kv, s, hd = D_BATCH, 32, 8, D_PROMPT, 128
    q = _normal(gen, (b, h, s, hd), "bfloat16", dev)
    k = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    v = _normal(gen, (b, kv, s, hd), "bfloat16", dev)
    kern = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(  # noqa: E731
        q, k, v, causal=True)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    bnd, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       4 * b * h * s * s * hd / 2, BF16_OPS_PER_S)
    rows = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
        replaces="src/repro/kernels/flash_attention.py:73",
        launches=launches["D1"],
        max_abs_err=errs["flash_attention_fwd"], ms=graph_ms(kern, 10),
        plain_ms=graph_ms(plain, 3), bound_ms=bnd, bound_by=by,
        library_ms=graph_ms(lib, 10), wrapper_ms=cuda_ms(kern, 10)[0])]
    del q, k, v
    # the float32 kernel (csrc/flash_attention.cu, on the CUDA cores) at
    # the same shape, against the float32 peak outside the tensor cores
    q = _normal(gen, (b, h, s, hd), "float32", dev)
    k = _normal(gen, (b, kv, s, hd), "float32", dev)
    v = _normal(gen, (b, kv, s, hd), "float32", dev)
    _attn_close(kern(), plain(), "float32", "flash_attention float32 at "
                                            "D1's shape")
    bnd, by = bound_ms(4 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       4 * b * h * s * s * hd / 2)
    rows[0].update(ms_f32=graph_ms(kern, 5), plain_ms_f32=graph_ms(plain, 2),
                   bound_ms_f32=bnd, bound_by_f32=by,
                   library_ms_f32=graph_ms(lib, 5),
                   wrapper_ms_f32=cuda_ms(kern, 5)[0],
                   source_f32="src/repro_torch/kernels/csrc/flash_attention.cu")
    del q, k, v

    g, smax = h // kv, D_PROMPT + D_GEN
    fill = smax - 1
    q = _normal(gen, (b, kv, g, hd), "bfloat16", dev)
    kc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    vc = _normal(gen, (b, kv, smax, hd), "bfloat16", dev)
    clen = torch.tensor(fill, dtype=torch.int32, device=dev)
    q4 = q.reshape(b, h, 1, hd)
    kern = lambda: da.decode_attention_fwd(q, kc, vc, clen)  # noqa: E731
    plain = lambda: da.decode_attention_plain(q, kc, vc, clen)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, kc[:, :, :fill + 1], vc[:, :, :fill + 1], enable_gqa=True)
    _require(torch.allclose(lib().reshape(q.shape).float(), kern().float(),
                            rtol=2e-2, atol=2e-2),
             "decode_attention and scaled_dot_product_attention disagree")
    bnd, by = bound_ms(2 * (2 * q.numel() + 2 * b * kv * (fill + 1) * hd),
                       4 * b * h * (fill + 1) * hd, BF16_OPS_PER_S)
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:65",
        launches=launches["D2"],
        max_abs_err=errs["decode_attention_fwd"], ms=graph_ms(kern, 200),
        plain_ms=graph_ms(plain, 50), bound_ms=bnd, bound_by=by,
        library_ms=graph_ms(lib, 200), wrapper_ms=cuda_ms(kern, 200)[0]))
    return rows


def _wkv_inputs(gen, b, t, h, hd, dev):
    """r, k, v, w, u, s0 as ``tests/test_kernels.py`` draws them: w in
    (0.45, 0.95), non-zero u and s0."""
    import torch

    n = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return [n(b, t, h, hd), n(b, t, h, hd) * 0.3, n(b, t, h, hd),
            torch.sigmoid(n(b, t, h, hd)) * 0.5 + 0.45, n(h, hd) * 0.1,
            n(b, h, hd, hd) * 0.1]


def _wkv_close(got, want, what: str):
    """``(max abs err, max abs err / the plain result's largest
    magnitude)``; fails above ``WKV_TOL`` of that magnitude."""
    err, scale = _max_err(got, want), float(want.abs().max())
    _require(err <= WKV_TOL * scale,
             f"{what}: kernel disagrees with its plain version (max abs err "
             f"{err}, {WKV_TOL} x max |plain| = {WKV_TOL * scale})")
    return err, err / scale


def _worst(*errs):
    """The largest (abs, rel) error of each kind."""
    return tuple(max(e) for e in zip(*errs))


def check_wkv(dev, gen, b, t, h, hd, chunk=None):
    """Kernel against plain at r [b, t, h, hd], with a new ``s_last`` and
    in place (``s_last`` = s0); with ``chunk``, the chunked entry point
    against the one-launch call too.  Returns the worst (abs, rel) error."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    xs = _wkv_inputs(gen, b, t, h, hd, dev)
    want, s_want = ws.rwkv6_wkv_plain(*xs)
    worst = (0.0, 0.0)
    for in_place in (False, True):
        s0 = xs[5].clone()
        got, s_got = ws.rwkv6_wkv_fwd(*xs[:5], s0,
                                      s_last=s0 if in_place else None)
        torch.cuda.synchronize()
        _require((s_got is s0) == in_place, "rwkv6_wkv: s_last not honoured")
        tag = f"rwkv6_wkv r={[b, t, h, hd]} in_place={in_place}"
        worst = _worst(worst, _wkv_close(got, want, tag + " out"),
                       _wkv_close(s_got, s_want, tag + " s_last"))
    msg = ""
    if chunk is not None:
        got_c, s_c = ws.rwkv6_wkv(*xs, chunk=chunk)
        torch.cuda.synchronize()
        tag = f"rwkv6_wkv r={[b, t, h, hd]} chunk={chunk} vs one launch"
        c_err = _worst(_wkv_close(got_c, got, tag + " out"),
                       _wkv_close(s_c, s_got, tag + " s_last"))
        msg = f"; chunk={chunk} vs one launch max_abs_err={c_err[0]!r}"
    print(f"check rwkv6_wkv r=[{b}, {t}, {h}, {hd}] new s_last and in place: "
          f"max_abs_err={worst[0]!r} (relative {worst[1]!r}){msg}")
    return worst


def wkv_row(dev, seed, launches, errs):
    """Kernel row of rwkv6_wkv: E1's call (8 x 1024 tokens, a new state)
    and E2's (one token, each layer's state in place in turn)."""
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    gen = torch.Generator(dev).manual_seed(seed)
    h, hd, n_layers = 40, 64, 32               # rwkv6-3b's

    def bound(b, t):
        # o_t = r_t S + (sum_i r_i u_i k_i) v_t and S = w S + k^T v: 5 hd^2
        # + 5 hd operations a (b, t, h); the streams, u and the state's
        # read and write in bytes
        return bound_ms(4 * (5 * b * t * h * hd + 2 * b * h * hd * hd
                             + h * hd), b * t * h * (5 * hd * hd + 5 * hd))

    xs = _wkv_inputs(gen, D_BATCH, D_PROMPT, h, hd, dev)
    kern = lambda: ws.rwkv6_wkv_fwd(*xs)  # noqa: E731
    plain = lambda: ws.rwkv6_wkv_plain(*xs)  # noqa: E731
    bnd, by = bound(D_BATCH, D_PROMPT)
    row = dict(
        name="rwkv6_wkv", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:47",
        launches=launches["E1"] + launches["E2"],
        launches_by_path=launches, max_abs_err=errs["rwkv6_wkv_fwd"][0],
        max_rel_err=errs["rwkv6_wkv_fwd"][1], ms=graph_ms(kern, 10),
        plain_ms=graph_ms(plain, 1), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 10)[0],
        design="state split over lanes (8 rows x 4 columns, 32 registers, "
        "float4 loads and stores) and 4 independent column blocks a head; "
        "partial outputs reduce-scattered by shuffles; r, k, v, w step "
        "rows through a 3-stage ring of bulk copies (TMA) on mbarriers")
    del xs
    # E2's call on every layer's state in turn, as a decode step makes it:
    # the 32 states (168 MB) do not fit the 50 MB L2, so each call reads
    # its state from HBM; times are per call
    layers = [_wkv_inputs(gen, D_BATCH, 1, h, hd, dev)
              for _ in range(n_layers)]

    def each(fn):
        def calls():
            for xs in layers:
                fn(*xs[:5], xs[5], s_last=xs[5])
        return calls

    kern, plain = each(ws.rwkv6_wkv_fwd), each(ws.rwkv6_wkv_plain)
    bnd, by = bound(D_BATCH, 1)
    # a yardstick, used nowhere in the port: copying the same state bytes
    # (read once, written once) in the same replay
    spare = [torch.empty_like(xs[5]) for xs in layers]

    def copies():
        for xs, dst in zip(layers, spare):
            dst.copy_(xs[5])

    row.update(ms_decode=graph_ms(kern, 10) / n_layers,
               state_copy_ms_decode=graph_ms(copies, 10) / n_layers,
               plain_ms_decode=graph_ms(plain, 5) / n_layers,
               bound_ms_decode=bnd, bound_by_decode=by,
               wrapper_ms_decode=cuda_ms(kern, 10)[0] / n_layers)
    return row


def anneal_step_row(dev, gen, launches_c1, launches_c2, launches_i, errs):
    """Kernel row of anneal_step: one step of path C1's 1024 rows x 6
    chains at N = 32 (the warp layout), and of C2's 28 chains at N = 256
    (the cluster layout), each beside its plain step.  Bound: the state
    read and written once, the step's inputs and its Gumbel block read
    once (bytes), against about ten float32 operations a move."""
    from repro_torch.kernels import move_eval as me

    def timed(rows, k, n):
        state, args, act, gumbel, temps = _step_inputs(dev, gen, rows, k, n,
                                                       masked=True)
        c, m = rows * k, 2 * n + 2
        kern = lambda: me.anneal_step(  # noqa: E731
            state, *args, gumbel, temps, 0, active=act)
        plain = lambda: me.anneal_step_reference(  # noqa: E731
            state, *args, gumbel, temps, 0, active=act)
        # the annealer's loop launches through a launcher that checks the
        # state once: its call is what a step pays on the host
        step = me.anneal_step_launcher(state, *args, temps, k, active=act)
        state_bytes = 4 * (2 * c * n + 2 * c * m + 2 * c)
        inputs = 4 * (3 * c * n + 2 * c + k * (n * m + 1) + 1)
        bnd, by = bound_ms(2 * state_bytes + inputs, 10 * c * n * m)
        return dict(ms=graph_ms(kern, 50), plain_ms=graph_ms(plain, 10),
                    bound_ms=bnd, bound_by=by,
                    wrapper_ms=cuda_ms(lambda: step(gumbel, 0), 50)[0])

    c1, c2 = timed(1024, 6, 32), timed(1, 28, 256)
    return dict(
        name="anneal_step", route="cuda",
        source="src/repro_torch/kernels/csrc/move_eval.cu",
        replaces="src/repro/kernels/move_eval.py:135",
        replaces_note="the move plane with the reference annealer's step "
        "around it (src/repro/opt/anneal.py:147-186, chain_update and "
        "body): one launch an anneal step, the plane never written",
        launches=launches_c1["anneal_step"] + launches_c2["anneal_step"]
        + launches_i["anneal_step"],
        launches_by_path={"C1": launches_c1["anneal_step"],
                          "C2": launches_c2["anneal_step"],
                          "I": launches_i["anneal_step"]},
        max_abs_err=errs["anneal_step"], library_ms=None, **c1,
        **{f"{key}_c2": val for key, val in c2.items()})


def heuristic_kwargs():
    from repro_torch.registry import get_spec

    hyper = [get_spec(p).hyperparams for p in HEURISTICS]
    return dict(strategies=[h["strategy"] for h in hyper],
                decreasing=[h["decreasing"] for h in hyper],
                capacity=CAPACITY, dt=1.0, migration_steps=2)


def compare_loop_fused(got, want, tag: str) -> float:
    """Every output equal bit for bit (lag total and max too)."""
    import torch

    torch.cuda.synchronize()
    worst = max(_max_err(got[i], want[i]) for i in (0, 1))
    for i in range(len(want)):
        _require(torch.equal(got[i].view(torch.int32),
                             want[i].view(torch.int32)),
                 f"{tag}: output {i} differs from the plain version's bits "
                 f"(max abs err {worst})")
    return worst


def check_loop_fused(dev, seed, b=512, t=480, n=14):
    import torch

    from repro_torch.kernels import loop_fused as lf

    kw = dict(heuristic_kwargs(), record_assign=True)
    rates, act = traffic_mix(b, t, n, seed, dev)
    lag0 = torch.rand((b, n), generator=torch.Generator(dev).manual_seed(
        seed), device=dev)
    worst = 0.0
    for mask in (None, act):
        want = lf.loop_fused_reference(rates, active=mask, initial_lag=lag0,
                                       **kw)
        got = lf.loop_fused(rates, active=mask, initial_lag=lag0, **kw)
        worst = max(worst, compare_loop_fused(
            got, want, f"loop_fused masked={mask is not None}"))
    print(f"check loop_fused 8 heuristics B={b} T={t} N={n} masked and "
          f"unmasked, with initial lag: bit for bit")
    return worst


FAMILIES = ("diurnal", "bursty", "topic_lifecycle")


def _family_slices(batch: int):
    """The rows of each family in ``traffic_mix``'s output."""
    first = batch - 2 * (batch // 3)
    return dict(zip(FAMILIES, (slice(0, first),
                               slice(first, first + batch // 3),
                               slice(first + batch // 3, batch))))


def _print_metrics(out) -> None:
    """Per policy: the SLO metrics over all groups, the share of steps
    with no backlog at all (every bin drained empty), and violation_frac
    per traffic family."""
    fams = _family_slices(out.lag_total.shape[1])
    for p, name in enumerate(out.policies):
        row = {k: float(v[p].mean()) for k, v in out.metrics.items()}
        row["zero_backlog_frac"] = float((out.lag_total[p] == 0).mean())
        for fam, rows in fams.items():
            row[f"violation_frac_{fam}"] = float(
                out.metrics["violation_frac"][p, rows].mean())
        print(f"  {name:>15s} " + " ".join(f"{k}={v!r}"
                                           for k, v in row.items()))


def _check_outcome(out, shape) -> None:
    import numpy as np

    _require(out.lag_total.shape == shape, f"lag_total shape "
             f"{out.lag_total.shape}, want {shape}")
    for name in ("lag_total", "consumers", "migrations"):
        _require(np.isfinite(getattr(out, name)).all(),
                 f"{name} holds non-finite values")
    _require((out.lag_total >= 0).all(), "negative backlog")
    _require((out.consumers >= 0).all() and (out.migrations >= 0).all(),
             "negative consumer or migration count")


def _agree(small, big, streams: int, steps: int, what: str) -> None:
    """Path outputs on a slice against an independent run of the slice."""
    import numpy as np

    lt = big.lag_total[:, :streams, :steps]
    _require(np.allclose(lt, small.lag_total, rtol=TOL, atol=TOL),
             f"{what}: lag_total differs on the cross-check slice "
             f"(max {np.abs(lt - small.lag_total).max()!r})")
    for name in ("consumers", "migrations"):
        _require(np.array_equal(getattr(big, name)[:, :streams, :steps],
                                getattr(small, name)),
                 f"{what}: {name} differ on the cross-check slice")


class _Host:
    """A ``sweep_lag`` result as numpy fields, for ``_agree``."""

    def __init__(self, res):
        for f in ("lag_total", "consumers", "migrations"):
            setattr(self, f, getattr(res, f).cpu().numpy())


def path_c1_agreement(out, rates, act, streams: int = 16, steps: int = 48):
    """The first ``streams`` groups x ``steps`` steps of path C1 once more
    on the CPU, with the draws the card's generators made injected."""
    import torch

    from repro_torch.lagsim import LagSimConfig, sweep_lag
    from repro_torch.opt import AnnealNoise
    from repro_torch.registry import builtin

    gen = torch.Generator(device=rates.device).manual_seed(
        builtin.ANNEAL_SEED)
    noise = []
    for _ in range(steps):
        nz = AnnealNoise.draw(builtin.ANNEAL_STEPS, builtin.ANNEAL_CHAINS,
                              rates.shape[2], generator=gen)
        noise.append(AnnealNoise(nz.gumbel.cpu(), nz.temps.cpu()))
    t0 = time.perf_counter()
    small = sweep_lag(PATH_C1, rates[:streams, :steps].cpu(), LagSimConfig(),
                      active=act[:streams, :steps].cpu(), device="cpu",
                      policy_options={p: {"noise": noise} for p in PATH_C1})
    _agree(_Host(small), out, streams, steps,
           "path C1 against the CPU run with the same draws")
    print(f"path C1 agreement: {streams} groups x {steps} steps on the CPU "
          f"with the card's draws injected: integers exact, lag within "
          f"{TOL} (cpu_s={time.perf_counter() - t0!r})")


def run_path_c2(dev, seed):
    """``api.optimize`` on one 256-partition topic; the same instance and
    seed once more with the plain move evaluation must agree."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.opt import anneal_frontier, incumbent_assignment

    rates, _ = traffic_mix(3, 33, 256, seed + 20, dev)   # row 0: diurnal
    trace = rates[0].cpu().numpy()
    prev = incumbent_assignment(trace[:32], CAPACITY, 32, "BFD", device=dev)
    speeds = trace[32]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.optimize(speeds, prev, capacity=CAPACITY, seed=seed,
                       device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    # one anneal_step a step, 12 packers scored, no move plane written
    launches = {"anneal_step": 250, "pack_rows": 12, "move_delta_batch": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path C2: {k} launched {counts[k]} "
                 f"times, want {want}")
    _require(len(out.heuristics) == 12 and out.hypervolume > 0
             and all(b >= 1 for b, _ in out.front),
             "path C2: malformed frontier")
    print(f"path C2: optimize N={speeds.shape[0]} sum(speeds)="
          f"{float(speeds.sum())!r} 7 lambdas x 4 restarts x 250 steps: "
          f"wall_s={wall!r} launches={launches}")
    print(f"  per_lambda={out.per_lambda}")
    print(f"  front={out.front} hypervolume={out.hypervolume!r}")
    print("  hv_ratio " + " ".join(
        f"{k}={v['hv_ratio']!r}{'(dominated)' if v['dominated'] else ''}"
        for k, v in out.heuristics.items()))
    plain = anneal_frontier(speeds, prev, CAPACITY, seed=seed,
                            use_kernel=False, device=dev)
    _require((plain.per_lambda, plain.front, plain.hypervolume)
             == (out.per_lambda, out.front, out.hypervolume),
             "path C2: the plain anneal step gives another frontier")
    print("path C2 agreement: the plain anneal step on the card gives the "
          "same per_lambda, front and hypervolume")
    # the scoring's 12 packing calls once more, timed alone (eager, CUDA
    # events): their share of the wall above
    from repro_torch.registry import packer_for

    sp = torch.tensor(speeds[None], dtype=torch.float32, device=dev)
    pv = torch.tensor(prev[None], dtype=torch.long, device=dev)
    packers = [packer_for(name) for name in PACKERS]
    ms, _ = cuda_ms(lambda: [f(sp, pv, CAPACITY) for f in packers], 5)
    print(f"  the 12 packing calls of the scoring at N={speeds.shape[0]}: "
          f"{ms!r} ms together")
    return launches


FAMILIES_F = ("random_walk", "diurnal", "ramp", "bursty", "churn",
              "heavy_tail", "topic_lifecycle", "adversarial")
PATH_F = ("BFD", "MBF", "MWFP", "KEDA_LAG")      # 3 of the 4 pack
F_GROUPS, F_T, F_N = 4096, 960, 64
F_STEPS = (240, 480, 720, 960)                    # 2-8 h at 30 s a step
F_T_BUCKETS, F_N_BUCKETS = (480, 960), (8, 16, 32, 64)


def fleet_traffic(seed, dev):
    """Path F's fleet: 512 groups of each registered family at its
    default knobs (churn, topic_lifecycle and adversarial masked), drawn
    on the card at 960 steps x 64 partitions, rates clipped to one
    consumer's capacity; group i is then cut to its own T_i steps and N_i
    partitions (numpy, from ``seed``).  Returns the [4096, 960, 64] rates
    and masks and the cuts."""
    import numpy as np
    import torch

    from repro_torch.core import scenarios

    per = F_GROUPS // len(FAMILIES_F)
    rates, masks = [], []
    for i, fam in enumerate(FAMILIES_F):
        sp, act = scenarios.generate_masked_scenario(
            fam, seed + 30 + i, per, F_T, F_N, device=dev)
        rates.append(torch.clamp(sp, max=CAPACITY))
        masks.append(act)
        del sp, act
    t_i, n_i = fleet_cuts(seed)
    return torch.cat(rates), torch.cat(masks), t_i, n_i


def fleet_cuts(seed):
    """Path F's cuts, from ``seed`` with numpy: each group's T_i steps
    and N_i partitions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t_i = rng.choice(F_STEPS, size=F_GROUPS)
    n_i = rng.integers(4, F_N + 1, size=F_GROUPS)
    return t_i, n_i


def fleet_groups(seed):
    """Path F's bucket groups as ``{(T_b, N_b): scenarios}``: each group
    is one batch of that many rows of width N_b for ``pack_rows`` and
    ``lag_update``."""
    groups = {}
    for t, n in zip(*fleet_cuts(seed)):
        key = (_bucket(int(t), F_T_BUCKETS), _bucket(int(n), F_N_BUCKETS))
        groups[key] = groups.get(key, 0) + 1
    return dict(sorted(groups.items()))


def _bucket(x, buckets):
    return next(b for b in buckets if b >= x)


def run_path_f(dev, seed):
    """A ragged fleet through ``FleetRunner.simulate``: 4096 groups of the
    8 families, each at its own (T_i, N_i), in (480, 960) x (8, 16, 32,
    64) buckets; the per-step loop with ``use_kernel=True``.  The same
    call again after ``reset()`` hits every entry; 8 groups of each
    bucket at their own shapes through ``sweep_lag`` equal the padded
    run."""
    import numpy as np
    import torch

    from repro_torch.fleet import FleetConfig, FleetRunner
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig, sweep_lag
    from repro_torch.telemetry import default_tracer

    t0 = time.perf_counter()
    rates, masks, t_i, n_i = fleet_traffic(seed, dev)
    torch.cuda.synchronize()
    print(f"path F data: {len(FAMILIES_F)} families x "
          f"{F_GROUPS // len(FAMILIES_F)} groups drawn at {F_T} x {F_N} "
          f"({rates.numel() * 4 / 1e9!r} GB of rates), "
          f"setup_s={time.perf_counter() - t0!r}")
    pairs = [(rates[i, :t, :n], masks[i, :t, :n])
             for i, (t, n) in enumerate(zip(t_i.tolist(), n_i.tolist()))]
    # a fleet-wide replica cap (KEDA's maxReplicaCount): with the default
    # (each group's own N) every distinct N would be a group of its own
    cfg = LagSimConfig(use_kernel=True, max_consumers=F_N)
    runner = FleetRunner(FleetConfig(t_buckets=F_T_BUCKETS,
                                     n_buckets=F_N_BUCKETS))
    tb = np.array([_bucket(t, F_T_BUCKETS) for t in t_i])
    nb = np.array([_bucket(n, F_N_BUCKETS) for n in n_i])
    # each bucket group runs T_b steps of its per-step loop
    sum_tb = sum(t for t, _ in set(zip(tb.tolist(), nb.tolist())))
    torch.cuda.synchronize()
    default_tracer().reset()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = runner.simulate(PATH_F, pairs, cfg, device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    stats = runner.stats()
    spans = {name: [r.dur_us / 1e3 for r in default_tracer().records(name)]
             for name in ("fleet.simulate", "fleet.dispatch", "fleet.build")}
    _require(len(stats["buckets"]) == 8, f"path F: {stats['buckets']}, "
             f"want 8 bucket groups")
    launches = {"pack_rows": 3 * sum_tb, "lag_update_batch": 4 * sum_tb,
                "select_slot_grid": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path F: {k} launched {counts[k]} "
                 f"times, want {want}")
    true_steps = int(t_i.sum())
    padded = float((tb * nb).sum()) / float((t_i * n_i).sum())
    print(f"path F: FleetRunner.simulate {PATH_F} over {F_GROUPS} groups "
          f"(T_i in {F_STEPS}, N_i in 4..{F_N}), buckets {F_T_BUCKETS} x "
          f"{F_N_BUCKETS}, use_kernel=True: wall_s={wall!r} "
          f"policy_stream_steps_per_s={len(PATH_F) * true_steps / wall!r} "
          f"padded_share={padded!r} launches={launches}")
    print(f"  stats={stats}")
    # the fleet's own host time: the call less its groups' runs (each
    # run's dispatch span holds its per-step loop and its D2H copies);
    # then each group's padding and D2H alone, timed again at its shapes
    outside = spans["fleet.simulate"][0] - sum(spans["fleet.dispatch"])
    print(f"  fleet spans (ms): dispatch per group "
          f"{[round(d, 1) for d in spans['fleet.dispatch']]}, build "
          f"{sum(spans['fleet.build'])!r} in all; outside the runs "
          f"(normalise, group, pad, slice) {outside!r} in all, "
          f"{outside / len(spans['fleet.dispatch'])!r} a group")
    members = {}
    for i in range(F_GROUPS):
        members.setdefault((int(tb[i]), int(nb[i])), []).append(
            (i, *pairs[i]))
    pad_ms, d2h_ms = [], []
    for (bt, bn), group in sorted(members.items()):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner._pad_and_stack(group, bt, bn, True, (dev,))
        torch.cuda.synchronize()
        pad_ms.append((time.perf_counter() - t1) * 1e3)
        fields = [torch.zeros((len(PATH_F), len(group), bt), device=dev)
                  for _ in range(5)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        [x.cpu().numpy() for x in fields]
        d2h_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"  per group (sorted by bucket): pad+stack ms "
          f"{[round(x, 2) for x in pad_ms]}, D2H of its 5 trajectory "
          f"fields ms {[round(x, 2) for x in d2h_ms]}")
    for name in ("lag_total", "consumers", "migrations"):
        _require(all(np.isfinite(x).all() and x.shape == (len(PATH_F), t)
                     for x, t in zip(getattr(res, name), t_i)),
                 f"path F: {name} malformed")
    _require(all((c >= 0).all() for c in res.consumers),
             "path F: negative consumer count")

    # pack_rows at F's widest rows: MBF over the 960x64 bucket's groups
    # at step 8, with steps 0-7's assignment as prev
    from repro_torch.core.pack import modified_any_fit

    rows = np.flatnonzero((tb == 960) & (nb == F_N))
    width = (torch.arange(F_N, device=dev)
             < torch.as_tensor(n_i[rows], device=dev)[:, None])
    prev = torch.full((len(rows), F_N), -1, dtype=torch.long, device=dev)
    for step in range(9):
        sp8, act8 = rates[rows, step], masks[rows, step] & width
        if step < 8:
            prev = modified_any_fit(sp8, prev, CAPACITY, active=act8).bin_of
    ms = graph_ms(lambda: modified_any_fit(sp8, prev, CAPACITY,
                                           active=act8), 20)
    got = modified_any_fit(sp8, prev, CAPACITY, active=act8)
    want = plain_packer("MBF")(sp8, prev, CAPACITY, active=act8)
    for f in ("bin_of", "names", "n_bins"):
        _exact(getattr(got, f), getattr(want, f),
               f"pack_rows MBF on path F's 960x{F_N} group {f}")
    _require(torch.equal(got.loads.view(torch.int32),
                         want.loads.view(torch.int32)),
             "pack_rows MBF on path F's group: loads differ from the plain "
             "version's bits")
    print(f"  pack_rows (MBF) on the 960x{F_N} group at step 8, "
          f"[{len(rows)}, {F_N}]: ms={ms!r} (the kernel table times it at "
          f"path B's [1024, 32]); equal to the plain packer, loads bit for "
          f"bit")

    # the same call once more: every group hits its warm entry
    runner.reset()
    t0 = time.perf_counter()
    again = runner.simulate(PATH_F, pairs, cfg, device=dev)
    wall2 = time.perf_counter() - t0
    st = runner.stats()
    _require((st["cache_hits"], st["cache_misses"], st["cache_evictions"])
             == (8, 0, 0), f"path F repeat: stats {st}, want 8 hits, 0 "
             f"misses, 0 evictions")
    _require(all(np.array_equal(a, b) for f in ("consumers", "migrations")
                 for a, b in zip(getattr(res, f), getattr(again, f))),
             "path F repeat: integers differ from the first call")
    print(f"path F repeat after reset(): wall_s={wall2!r} hits="
          f"{st['cache_hits']} misses={st['cache_misses']} evictions="
          f"{st['cache_evictions']}")
    del again

    # padded equals direct: in each bucket, 8 groups that share one
    # padded shape, run at that shape (unpadded) through sweep_lag
    t0 = time.perf_counter()
    bit_equal, worst, worst_rel, checked = True, 0.0, 0.0, 0
    for bt in F_T_BUCKETS:
        for bn in F_N_BUCKETS:
            shapes = {}
            for i in np.flatnonzero((tb == bt) & (nb == bn)):
                if (t_i[i], n_i[i]) != (bt, bn):
                    shapes.setdefault((int(t_i[i]), int(n_i[i])),
                                      []).append(int(i))
            (t, n), idx = max(shapes.items(), key=lambda kv: len(kv[1]))
            idx = idx[:8]
            _require(len(idx) == 8, f"path F: only {len(idx)} groups of "
                     f"shape {(t, n)} in bucket {bt}x{bn}")
            solo = sweep_lag(PATH_F, rates[idx, :t, :n], cfg,
                             active=masks[idx, :t, :n], device=dev)
            for j, i in enumerate(idx):
                for f in ("consumers", "migrations", "unreadable"):
                    _require(np.array_equal(
                        getattr(res, f)[i],
                        getattr(solo, f)[:, j].cpu().numpy()),
                        f"path F: {f} of group {i} ({t}x{n} in {bt}x{bn}) "
                        f"differ from its direct run")
                for f in ("lag_total", "lag_max"):
                    want = getattr(solo, f)[:, j].cpu().numpy()
                    got = getattr(res, f)[i]
                    _require(np.allclose(got, want, rtol=TOL, atol=TOL),
                             f"path F: {f} of group {i} differs from its "
                             f"direct run by {np.abs(got - want).max()!r}")
                    err = np.abs(got.astype(np.float64) - want)
                    worst = max(worst, float(err.max()))
                    worst_rel = max(worst_rel, float(
                        (err / np.maximum(np.abs(want), 1.0)).max()))
                    bit_equal &= got.tobytes() == want.tobytes()
            checked += len(idx)
    print(f"path F padded equals direct: {checked} groups (8 a bucket, at "
          f"their own shapes through sweep_lag on the card): integers "
          f"exact, lag within rtol = atol = {TOL} (max abs err {worst!r}, "
          f"max err over max(|lag|, 1) {worst_rel!r}), bit for bit: "
          f"{bit_equal} (direct_s={time.perf_counter() - t0!r})")
    return launches


def run_path_g(dev, seed, rates, act):
    """``api.sweep`` of the 12 packers over path B's traffic (one
    ``pack_rows`` launch an algorithm a step), its first 16 streams x 48
    steps once more on the CPU; ``api.evaluate()`` at the paper's
    defaults and ``api.pack`` of a 256-partition instance for each packer,
    on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build

    b, t, n = rates.shape
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.sweep(rates, CAPACITY, active=act, device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    launches = {"pack_rows": len(PACKERS) * t, "select_slot_grid": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path G: {k} launched {counts[k]} "
                 f"times, want {want}")
    _require(out.bins.shape == (len(PACKERS), b, t)
             and out.algorithms == PACKERS, "path G: malformed sweep")
    print(f"path G: api.sweep of the {len(PACKERS)} packers over B={b} x "
          f"T={t} x N={n} (path B's traffic): wall_s={wall!r} "
          f"algorithm_stream_steps_per_s={len(PACKERS) * b * t / wall!r} "
          f"launches={launches}")
    print("  mean bins " + " ".join(
        f"{a}={float(out.bins[i].mean())!r}" for i, a in enumerate(PACKERS)))
    print("  mean rscore " + " ".join(
        f"{a}={float(out.rscores[i].mean())!r}"
        for i, a in enumerate(PACKERS)))
    small = api.sweep(rates[:16, :48].cpu(), CAPACITY,
                      active=act[:16, :48].cpu(), device="cpu")
    for f in ("bins", "migrations"):
        _require(np.array_equal(getattr(out, f)[:, :16, :48],
                                getattr(small, f)),
                 f"path G: sweep {f} differ from the CPU's")
    err = float(np.abs(out.rscores[:, :16, :48] - small.rscores).max())
    _require(err <= TOL, f"path G: sweep rscores differ from the CPU's by "
             f"{err!r}")
    print(f"path G agreement: 16 streams x 48 steps on the CPU: bins and "
          f"migrations exact, rscores max abs err {err!r}")

    _build.reset_launches()
    t0 = time.perf_counter()
    ev = api.evaluate(device=dev)
    wall_ev = time.perf_counter() - t0
    ev_launches = _build.launch_counts()["pack_rows"]
    _require(ev_launches == len(PACKERS) * 120, f"path G: evaluate "
             f"launched pack_rows {ev_launches} times, want "
             f"{len(PACKERS) * 120}")
    ref = api.evaluate(device="cpu")
    _require((ev.cbs, ev.pareto) == (ref.cbs, ref.pareto),
             "path G: evaluate's CBS or Pareto lists differ from the CPU's")
    err_ev = max(abs(ev.avg_rscore[d][a] - ref.avg_rscore[d][a])
                 for d in ev.deltas for a in ev.algorithms)
    _require(err_ev <= TOL, f"path G: evaluate avg_rscore differs by "
             f"{err_ev!r}")
    print(f"path G: api.evaluate() (deltas {ev.deltas}, 30 partitions, 120 "
          f"measurements) on the card: wall_s={wall_ev!r}, pack_rows "
          f"launches={ev_launches}; CBS and Pareto equal the CPU's, "
          f"avg_rscore max abs err {err_ev!r}; pareto={ev.pareto}")

    rng = np.random.default_rng(seed)
    sp0 = rng.uniform(0.01, 0.25, 256)
    first = api.pack(sp0, CAPACITY, algorithm="BFD", backend="torch",
                     device="cpu")
    prev = np.array([first.assignment[j] for j in range(256)], np.int32)
    prev[::17] = -1
    speeds = np.clip(sp0 + rng.uniform(-0.05, 0.05, 256), 0.001, None)
    _build.reset_launches()
    t0 = time.perf_counter()
    on_card = [api.pack(speeds, CAPACITY, algorithm=a, prev=prev,
                        backend="torch", device=dev) for a in PACKERS]
    wall_pack = time.perf_counter() - t0
    pack_launches = _build.launch_counts()["pack_rows"]
    _require(pack_launches == len(PACKERS), f"path G: api.pack launched "
             f"pack_rows {pack_launches} times, want {len(PACKERS)}")
    for a, got in zip(PACKERS, on_card):
        want = api.pack(speeds, CAPACITY, algorithm=a, prev=prev,
                        backend="torch", device="cpu")
        _require(got == want, f"path G: api.pack {a} differs from the CPU")
    print(f"path G: api.pack of one 256-partition instance for each of the "
          f"{len(PACKERS)} packers equals the CPU (outcomes equal field for "
          f"field): wall_s={wall_pack!r} n_bins=" + " ".join(
              f"{a}:{o.n_bins}" for a, o in zip(PACKERS, on_card)))

    # G4: the pure-Python packers (api.pack's default backend) on the same
    # instance, its speeds quantized to k/1024 so that every load sum is
    # exact in float32 (the reference's cross-backend property), against
    # backend="torch" on the card
    quant = np.round(speeds * 1024) / 1024
    _build.reset_launches()
    torch_q = [api.pack(quant, CAPACITY, algorithm=a, prev=prev,
                        backend="torch", device=dev) for a in PACKERS]
    q_launches = _build.launch_counts()["pack_rows"]
    _require(q_launches == len(PACKERS), f"path G4: api.pack(backend="
             f"'torch') launched pack_rows {q_launches} times")
    mapping = {j: float(w) for j, w in enumerate(quant)}
    prev_map = {j: int(c) for j, c in enumerate(prev) if c >= 0}
    t0 = time.perf_counter()
    py = [api.pack(mapping, CAPACITY, algorithm=a, prev=prev_map)
          for a in PACKERS]
    wall_py = time.perf_counter() - t0
    for a, got, want in zip(PACKERS, py, torch_q):
        _require(got.backend == "py" and got.n_bins == want.n_bins
                 and got.assignment == want.assignment
                 and {c: float(np.float32(v)) for c, v in got.loads.items()}
                 == want.loads,
                 f"path G4: api.pack {a} backend='py' differs from "
                 f"backend='torch'")
    print(f"path G4: api.pack(backend='py') of the same instance (speeds "
          f"quantized to k/1024) for each of the {len(PACKERS)} packers "
          f"equals backend='torch' on the card (assignment, n_bins, loads): "
          f"wall_s={wall_py!r} (the torch backend's 12 calls: "
          f"pack_rows launches={q_launches})")
    return {"pack_rows": launches["pack_rows"] + ev_launches + pack_launches
            + q_launches,
            "select_slot_grid": launches["select_slot_grid"]}


# path I: the adversarial search's own budget (the reference's
# benchmarks/adversarial_bench.py:53), and a search a capacity planner runs
I1_SEARCH = dict(pop_size=8, generations=6, iters=96, n=6,
                 incident_weight=0.05)
I2_SEARCH = dict(pop_size=32, scenarios_per_genome=4, generations=8,
                 iters=960, n=32)
PATH_I_REPLAY = ("MBF", "BFD", "KEDA_LAG")


def _search_launches(tag, counts, family, steps):
    """A search's exact launches: one ``lag_update`` a policy-step, one
    ``pack_rows`` a step for a packer, ``ANNEAL_STEPS`` ``anneal_step``
    launches a step for an annealer, nothing else."""
    from repro_torch.registry import PACKER_FAMILIES
    from repro_torch.registry.builtin import ANNEAL_STEPS

    want = {"lag_update_batch": steps,
            "pack_rows": steps if family in PACKER_FAMILIES else 0,
            "anneal_step": steps * ANNEAL_STEPS if family == "optimizer"
            else 0,
            "select_slot_grid": 0, "move_delta_batch": 0, "loop_fused": 0}
    for k, n in want.items():
        _require(counts[k] == n, f"path {tag}: {k} launched {counts[k]} "
                 f"times, want {n}")
    return {k: want[k] for k in ("lag_update_batch", "pack_rows",
                                 "anneal_step")}


def path_i1_agreement(dev, seed, pol, cfg, sim):
    """One fitness batch of ``pol`` at I1's shape (the oracle's rows of a
    population of ``cfg.pop_size`` genomes) through the loop on the card,
    against the same rows on the CPU (plain versions; an annealer gets
    the draws the card's generator made): integers and incident tables
    exact, lag within ``TOL``."""
    import torch

    from repro_torch.core.scenarios import family_spec
    from repro_torch.lagsim import sweep_lag
    from repro_torch.opt import AnnealNoise
    from repro_torch.registry import builtin, get_spec
    from repro_torch.scenarios import random_population
    from repro_torch.scenarios import search as ts
    from repro_torch.telemetry.alerts import incident_matrix

    spec = family_spec("adversarial")
    draws = ts._Draws(None, seed, dev, len(spec.knobs), cfg)
    rates, act = ts._scenario_oracle(spec, cfg, draws)(
        random_population(spec, seed, cfg.pop_size, device=dev))
    opts = None
    if get_spec(pol).family == "optimizer":
        gen = torch.Generator(device=dev).manual_seed(builtin.ANNEAL_SEED)
        noise = []
        for _ in range(cfg.iters):
            nz = AnnealNoise.draw(builtin.ANNEAL_STEPS, builtin.ANNEAL_CHAINS,
                                  cfg.n, generator=gen)
            noise.append(AnnealNoise(nz.gumbel.cpu(), nz.temps.cpu()))
        opts = {pol: {"noise": noise}}
    t0 = time.perf_counter()
    card = sweep_lag((pol,), rates, sim, active=act, device=dev)
    host = sweep_lag((pol,), rates.cpu(), sim, active=act.cpu(),
                     device="cpu", policy_options=opts)
    rows, steps = rates.shape[:2]
    _agree(_Host(host), _Host(card), rows, steps,
           f"path I1: {pol}'s fitness batch against the CPU run")
    _require(
        (incident_matrix(card.incidents) == incident_matrix(host.incidents))
        .all(), f"path I1: {pol}'s incident table differs from the CPU run's")
    print(f"path I1 agreement: {pol}'s fitness batch ({rows} streams x "
          f"{steps} steps x {cfg.n}) on the CPU (plain versions"
          f"{', the card' + chr(39) + 's draws injected' if opts else ''}): "
          f"integers and incident tables exact, lag within {TOL} "
          f"(s={time.perf_counter() - t0!r})")


def run_path_i1(dev, seed):
    """``api.attack`` of each family's representative at the reference's
    own search budget, alerts on, the baseline on; NF's search twice,
    bit for bit."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig
    from repro_torch.registry import get_spec
    from repro_torch.scenarios import SearchConfig, family_representatives
    from repro_torch.telemetry import (AlertConfig, TelemetryConfig,
                                       default_rules)

    cfg = SearchConfig(**I1_SEARCH)
    sim = LagSimConfig(use_kernel=True, telemetry=TelemetryConfig(
        record_frames=False, alerts=AlertConfig(rules=default_rules())))
    total = {"lag_update_batch": 0, "pack_rows": 0, "anneal_step": 0}
    first = None
    reps = family_representatives()
    for fam, pol in [*reps.items(), ("heuristic", reps["heuristic"])]:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = api.attack(pol, config=cfg, sim=sim, seed=seed, device=dev)
        wall = time.perf_counter() - t0
        gens = out.generations_run + out.baseline.generations_run
        _require(out.baseline.evals == out.evals, f"path I1: {pol}'s "
                 f"baseline spent {out.baseline.evals} evals, want "
                 f"{out.evals}")
        _require(get_spec(pol).family == fam and np.isfinite(
            out.best_fitness) and len(out.history) == out.generations_run,
            f"path I1: {pol}: malformed outcome")
        launches = _search_launches(f"I1 {pol}", _build.launch_counts(),
                                    fam, cfg.iters * gens)
        evals = out.evals + out.baseline.evals
        for k in total:
            total[k] += launches[k]
        print(f"path I1: api.attack({pol!r}) ({fam}; pop {cfg.pop_size}, "
              f"{cfg.generations} generations, {cfg.iters} x {cfg.n}, "
              f"incident_weight {cfg.incident_weight}): best_fitness="
              f"{out.best_fitness!r} baseline_fitness="
              f"{out.baseline_fitness!r} beats_baseline="
              f"{out.beats_baseline} evals={out.evals} generations_run="
              f"{out.generations_run} history={out.history} wall_s={wall!r} "
              f"evals_per_s={evals / wall!r} launches={launches}")
        if pol == reps["heuristic"] and first is not None:
            _require(out.history == first.history
                     and out.witness_genome == first.witness_genome
                     and out.baseline_fitness == first.baseline_fitness,
                     f"path I1: {pol}'s second search differs from its "
                     f"first")
            print(f"path I1: {pol}'s search once more with seed {seed}: "
                  f"history, witness genome and baseline bit for bit")
        else:
            if pol == reps["heuristic"]:
                first = out
            path_i1_agreement(dev, seed, pol, cfg, sim)
    return total


def run_path_i2(dev, seed):
    """``api.attack("MBF")`` at a capacity planner's size through a fresh
    runner: 32 genomes x 4 scenarios of 960 steps (8 h at 30 s) over 32
    partitions a fitness call; then the witness saved, loaded and
    replayed, equal to direct runs."""
    import tempfile

    import torch

    from repro_torch import api
    from repro_torch.core.scenarios import (adversarial_draws,
                                            adversarial_masked, family_spec)
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig
    from repro_torch.scenarios import (SearchConfig, genome_knobs,
                                       load_trace, random_population,
                                       repair_genome, resample_trace,
                                       save_trace)
    from repro_torch.scenarios import search as ts

    cfg = SearchConfig(**I2_SEARCH)
    runner = api.FleetRunner()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.attack("MBF", config=cfg, sim=LagSimConfig(use_kernel=True),
                     seed=seed, fleet=runner, device=dev)
    wall = time.perf_counter() - t0
    g = out.generations_run
    _require(out.baseline.generations_run == g, "path I2: the baseline ran "
             f"{out.baseline.generations_run} generations, want {g}")
    launches = _search_launches("I2", _build.launch_counts(), "sticky",
                                cfg.iters * 2 * g)
    st = runner.stats()
    _require((st["cache_misses"], st["cache_hits"]) == (1, 2 * g - 1),
             f"path I2: fleet cache {st}, want 1 miss and {2 * g - 1} hits")
    rows = cfg.pop_size * cfg.scenarios_per_genome
    print(f"path I2: api.attack('MBF') pop {cfg.pop_size} x "
          f"{cfg.scenarios_per_genome} scenarios x {cfg.iters} steps x "
          f"{cfg.n} partitions ({rows} streams a fitness call): "
          f"best_fitness={out.best_fitness!r} baseline_fitness="
          f"{out.baseline_fitness!r} beats_baseline={out.beats_baseline} "
          f"evals={out.evals} generations_run={g} history={out.history} "
          f"wall_s={wall!r} evals_per_s={2 * out.evals / wall!r} "
          f"policy_stream_steps_per_s="
          f"{2 * g * rows * cfg.iters / wall!r} launches={launches} "
          f"fleet={ {k: st[k] for k in ('cache_hits', 'cache_misses')} }")
    # the oracle's batch at I2's shape, the kept genome first: each
    # genome's rows on the card against the CPU transform of the same
    # draws (the card's generator under the search's scenario seed)
    spec = family_spec("adversarial")
    draws = ts._Draws(None, seed, dev, len(spec.knobs), cfg)
    oracle = ts._scenario_oracle(spec, cfg, draws)
    pop = random_population(spec, seed, cfg.pop_size, device=dev)
    pop[0] = torch.tensor(out.search.best_genome, device=dev)
    t0 = time.perf_counter()
    sp, ac = oracle(pop)
    s = cfg.scenarios_per_genome
    worst = 0.0
    for i, genome in enumerate(repair_genome(spec, pop).cpu().numpy()):
        knobs = genome_knobs(spec, genome)
        gen = torch.Generator(device=dev).manual_seed(draws.scenario_seed)
        raw = adversarial_draws(gen, s, cfg.iters, cfg.n,
                                churn_p=knobs.pop("churn_p"))
        w_sp, w_ac = adversarial_masked({k: v.cpu() for k, v in raw.items()},
                                        capacity=cfg.capacity, **knobs)
        rows_i = slice(s * i, s * i + s)
        _require(torch.equal(ac[rows_i].cpu(), w_ac), f"path I2: genome "
                 f"{i}'s active rows differ from the CPU transform's")
        worst = max(worst, _close(sp[rows_i].cpu(), w_sp,
                                  f"path I2: genome {i}'s oracle rates"))
    print(f"path I2: the oracle's batch {tuple(sp.shape)} (the kept genome "
          f"and {cfg.pop_size - 1} random ones) on the card against the "
          f"CPU transform of the same draws: masks exact, rates "
          f"max_abs_err={worst!r} (s={time.perf_counter() - t0!r})")
    # the search's own layer a generation, timed alone: the oracle's
    # batch (a host copy of the genomes, then 32 generator calls) and one
    # evolution step, against the generation's share of the wall
    fit = torch.rand(cfg.pop_size, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        oracle(pop)
    torch.cuda.synchronize()
    oracle_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    for g_ in range(1, 4):
        ts._evolve(spec, cfg, pop, fit, *draws.evolve(g_))
    torch.cuda.synchronize()
    evolve_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"path I2: a generation's oracle batch ({rows} streams) "
          f"oracle_ms={oracle_ms!r}, one evolution step evolve_ms="
          f"{evolve_ms!r}; a generation's share of the search's wall "
          f"{wall / (2 * g) * 1e3!r} ms")

    # the witness: saved in both formats, loaded, replayed = direct
    tr = out.search.witness_trace(cfg, seed=seed, batch=4, device=dev)
    total = {"lag_update_batch": launches["lag_update_batch"],
             "pack_rows": launches["pack_rows"]}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [save_trace(tr, str(Path(tmp) / f"witness.{ext}"))
                 for ext in ("npz", "json")]
        a, b = (load_trace(p) for p in paths)
        _require(a.rates.tobytes() == b.rates.tobytes() == tr.rates.tobytes()
                 and a.active.tobytes() == b.active.tobytes()
                 and a.meta == b.meta, "path I2: the witness's .npz and "
                 ".json differ")
        for path, iters in ((paths[0], None), (paths[1], None),
                            (paths[0], cfg.iters // 2)):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            rp = api.replay(path, policies=PATH_I_REPLAY, iters=iters,
                            method="linear", use_kernel=True, device=dev)
            wall_rp = time.perf_counter() - t0
            counts = _build.launch_counts()
            want = tr if iters is None else resample_trace(tr, iters,
                                                           "linear")
            direct = api.simulate(want.rates, policies=PATH_I_REPLAY,
                                  active=want.active,
                                  capacity=want.capacity, use_kernel=True,
                                  device=dev)
            steps = want.iters
            _require(counts["lag_update_batch"] == 3 * steps
                     and counts["pack_rows"] == 2 * steps,
                     f"path I2 replay: launches {counts}, want "
                     f"{3 * steps} lag_update and {2 * steps} pack_rows")
            for f in ("lag_total", "consumers", "migrations"):
                _require(getattr(rp.result, f).tobytes()
                         == getattr(direct, f).tobytes(),
                         f"path I2: replay of {Path(path).name} differs "
                         f"from the direct run in {f}")
            total["lag_update_batch"] += counts["lag_update_batch"]
            total["pack_rows"] += counts["pack_rows"]
            print(f"path I2 replay: {Path(path).name} "
                  f"{'as recorded' if iters is None else f'resampled to {iters} steps (linear)'}"
                  f" through {PATH_I_REPLAY}: shape={rp.shape} "
                  f"wall_s={wall_rp!r} violation_frac="
                  f"{rp.metrics['violation_frac'].mean(axis=1).tolist()} "
                  f"equal to a direct api.simulate of the same arrays bit "
                  f"for bit")
    return total


PATH_H_REAL = ("KEDA_LAG_REAL", "CLOUD_RUN_CPU_LAG")
PATH_H_CP = ("MBF", "BFD", "KEDA_LAG")      # 2 of the 3 pack
# KEDA's documented ScaledObject defaults (pollingInterval 30 s,
# cooldownPeriod 300 s) at a 30 s step, a replica cap of half of path B's
# 32 partitions (so that the fold runs), one step of metric delay and of
# rebalance latency, a two-step warm-up storm
H_CP = dict(polling_interval=1, observation_delay=1, actuation_delay=1,
            cooldown_period=10, min_replicas=1, max_replicas=16,
            warmup_steps=2)
PATH_H3 = ("BFD", "MBF", "KEDA_LAG_REAL")
H3_GROUPS = 256


def h_telemetry(frames: bool = True, hist_max=None):
    """Path H's in-loop telemetry: the default sketch (its histogram over
    ``[0, hist_max]``; ``None``: the engine's default for each group's
    N) and the four default alert rules, with per-step frames or
    without."""
    from repro_torch.telemetry import (AlertConfig, SketchConfig,
                                       TelemetryConfig, default_rules)

    return TelemetryConfig(record_frames=frames,
                           sketch=SketchConfig(hist_max=hist_max),
                           alerts=AlertConfig(rules=default_rules()))


def _packers(policies):
    from repro_torch.registry import PACKER_FAMILIES, get_spec

    return sum(get_spec(p).family in PACKER_FAMILIES for p in policies)


def _incident_table(out):
    """Incidents per policy and rule of an ``api.simulate`` outcome."""
    table = {p: {} for p in out.policies}
    for per_stream in out.incidents:
        for inc in per_stream:
            row = table[out.policies[inc.index[0]]]
            row[inc.rule] = row.get(inc.rule, 0) + 1
    return table


def _same_telemetry(got, want, what: str) -> None:
    """Two ``api.simulate`` outcomes' sketches and incidents: counts,
    histograms and incident tables exact, floats within ``TOL``."""
    import numpy as np

    for gs, ws in zip(got.sketches, want.sketches):
        for g, w in zip(gs, ws):
            _require(g.count == w.count and np.array_equal(g.hist, w.hist),
                     f"{what}: sketch counts or histograms differ")
            for f in ("mean", "m2", "vmin", "vmax"):
                a, b = getattr(g, f), getattr(w, f)
                _require(np.allclose(a, b, rtol=TOL, atol=TOL),
                         f"{what}: sketch {f} differs by "
                         f"{np.abs(a - b).max()!r}")
    for gi, wi in zip(got.incidents, want.incidents):
        _require(len(gi) == len(wi), f"{what}: incident counts differ")
        for a, b in zip(gi, wi):
            a, b = a.as_dict(), b.as_dict()
            pa, pb = a.pop("peak"), b.pop("peak")
            _require(a == b and abs(pa - pb) <= TOL * max(1.0, abs(pb)),
                     f"{what}: incident {a} differs from {b}")


def run_path_h1(tag, policies, rates, act, **over):
    """``api.simulate`` of ``policies`` over path B's traffic with the
    drain kernel and path H's telemetry on: exactly one ``lag_update`` a
    policy a step and one ``pack_rows`` a packing policy a step.  Prints
    the SLO metrics, the incidents per policy and rule, and the line count
    of a lint-clean Prometheus exposition of the merged sketch and every
    incident; then the first 16 groups x 48 steps on the card and on the
    CPU (the plain versions) must agree."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.telemetry import (EventStream, merge_summaries,
                                       prometheus_exposition,
                                       validate_exposition)

    p, (b, t, n) = len(policies), rates.shape
    tele = h_telemetry()
    torch.cuda.synchronize()
    api.default_fleet().reset()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.simulate(rates, policies=policies, active=act,
                       device=rates.device, use_kernel=True, telemetry=tele,
                       **over)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    want = {"lag_update_batch": p * t, "pack_rows": _packers(policies) * t,
            "select_slot_grid": 0, "loop_fused": 0}
    for k, v in want.items():
        _require(counts[k] == v, f"path {tag}: {k} launched {counts[k]} "
                 f"times, want {v}")
    _check_outcome(out, (p, b, t))
    _require(len(out.sketches) == b and len(out.incidents) == b
             and len(out.telemetry) == b, f"path {tag}: telemetry missing")
    print(f"path {tag}: {p} policies {policies} x B={b} x T={t} x N={n} "
          f"use_kernel=True, sketch + 4 alert rules + frames on {over}: "
          f"wall_s={wall!r} policy_stream_steps_per_s={p * b * t / wall!r} "
          f"launches={want}")
    _print_metrics(out)
    for name, row in _incident_table(out).items():
        print(f"  {name:>17s} incidents by rule: {row}")
    applied = int((out.consumers[:, :, 1:] != out.consumers[:, :, :-1]
                   ).sum())
    print(f"  consumer-count changes (applied scale decisions) over all "
          f"groups: {applied}; events of group 0 (policy 0's frame): "
          f"{EventStream.from_frame(out.telemetry[0]).counts()}")
    merged = merge_summaries([s for per in out.sketches for s in per])
    text = prometheus_exposition(
        sketch=merged, incidents=[i for per in out.incidents for i in per],
        labels={"path": tag})
    validate_exposition(text)
    print(f"  merged sketch: count={merged.count!r} lag_total p50="
          f"{merged.quantile(0.5)!r} p99={merged.quantile(0.99)!r}; "
          f"Prometheus exposition lint-clean, "
          f"{len(text.splitlines())} lines")
    # agreement: the first 16 groups x 48 steps on the card and on the CPU
    streams, steps = 16, 48
    kw = dict(policies=policies, use_kernel=True, telemetry=tele, **over)
    t0 = time.perf_counter()
    cpu = api.simulate(rates[:streams, :steps].cpu(),
                       active=act[:streams, :steps].cpu(), device="cpu", **kw)
    card = api.simulate(rates[:streams, :steps],
                        active=act[:streams, :steps], device=rates.device,
                        **kw)
    _agree(cpu, out, streams, steps, f"path {tag} against the CPU")
    _agree(cpu, card, streams, steps, f"path {tag} (slice) against the CPU")
    _same_telemetry(card, cpu, f"path {tag} (slice) against the CPU")
    print(f"path {tag} agreement: {streams} groups x {steps} steps on the "
          f"CPU (plain versions): integers, sketch counts and histograms "
          f"and incident tables exact, floats within {TOL} "
          f"(cpu_s={time.perf_counter() - t0!r})")
    return out, {k: counts[k] for k in ("lag_update_batch", "pack_rows")}


def path_h_ops(rates, act):
    """Torch ops a policy-step of path H's policies (an 8-step run's ops
    less a 4-step run's, over 4, as ``path_b_ops`` counts them), with the
    telemetry and the control plane on, each alone, and both off (the
    REAL scalers carry their own control plane in every run)."""
    import dataclasses

    from repro_torch import api
    from repro_torch.lagsim import ControlPlaneConfig

    cp = ControlPlaneConfig(**H_CP)
    tele = h_telemetry()

    def per_step(policy, **kw):
        n = []
        for t in (4, 8):
            with _op_counter() as ops:
                api.simulate(rates[:, :t], policies=(policy,),
                             active=act[:, :t], device=rates.device,
                             use_kernel=True, **kw)
            n.append(ops.n)
        return (n[1] - n[0]) // 4

    rows = {}
    for policy in PATH_H_REAL + PATH_H_CP:
        own = policy in PATH_H_REAL
        rows[policy] = {
            "both": per_step(policy, telemetry=tele,
                             **({} if own else {"control_plane": cp})),
            "telemetry": per_step(policy, telemetry=tele),
            "control_plane": (None if own
                              else per_step(policy, control_plane=cp)),
            "off": per_step(policy)}
    no_frames = per_step("KEDA_LAG", telemetry=dataclasses.replace(
        tele, record_frames=False))
    for policy, row in rows.items():
        print(f"path H torch ops a policy-step, {policy}: {row}")
    print(f"  KEDA_LAG with the sketch and alerts but no frames: "
          f"{no_frames}; the REAL scalers' 'off' and 'telemetry' runs "
          f"carry their registered control plane")
    return rows


def run_path_h2(dev, seed):
    """Path A's heuristics at [1024, 960, 14] under ``fused_steps=8,
    fused_kernel=True`` with a sketch and alerts on: the reference's
    routing sends them to ``_fused_wide`` (``loop_fused`` carries no
    telemetry), so ``loop_fused`` launches 0 times; the trajectories must
    equal the kernel's own output with telemetry off, bit for bit."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels import loop_fused as lf

    rates, act = traffic_mix(1024, 960, 14, seed + 20, dev)
    p, (b, t, n) = len(HEURISTICS), rates.shape
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.simulate(rates, policies=HEURISTICS, active=act, device=dev,
                       fused_steps=8, fused_kernel=True,
                       telemetry=h_telemetry(frames=False))
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    _require(counts["loop_fused"] == 0, f"path H2: loop_fused launched "
             f"{counts['loop_fused']} times with a sketch and alerts on")
    _check_outcome(out, (p, b, t))
    _require(len(out.sketches) == b and out.telemetry is None,
             "path H2: sketches missing or frames recorded")
    kern = lf.loop_fused(rates, active=act, **heuristic_kwargs())
    for i, f in ((0, "lag_total"), (2, "consumers"), (3, "migrations")):
        _require(np.asarray(getattr(out, f)).tobytes()
                 == kern[i].cpu().numpy().tobytes(),
                 f"path H2: {f} differs from loop_fused's output bits")
    print(f"path H2: {p} heuristics x B={b} x T={t} x N={n} fused_steps=8 "
          f"fused_kernel=True, sketch + 4 alert rules on: wall_s={wall!r} "
          f"policy_stream_steps_per_s={p * b * t / wall!r}; loop_fused "
          f"launches=0 (the kernel carries no telemetry: with a sketch or "
          f"alerts on the fused path runs _fused_wide, as the reference "
          f"routes them); lag_total, consumers and migrations equal "
          f"loop_fused's output with telemetry off, bit for bit")
    for name, row in _incident_table(out).items():
        print(f"  {name:>4s} incidents by rule: {row}")
    del out, kern, rates, act
    torch.cuda.empty_cache()


def h3_rows(seed):
    """Path H3's 256 of path F's 4096 groups, and the 16 of them held
    against their direct runs: 8 of each of the two commonest shapes that
    a bucket pads (so that two batched direct runs cover them), then the
    first groups of each family up to 256."""
    import numpy as np

    t_i, n_i = fleet_cuts(seed)
    shapes = {}
    for i, (t, n) in enumerate(zip(t_i.tolist(), n_i.tolist())):
        if (t, n) != (_bucket(t, F_T_BUCKETS), _bucket(n, F_N_BUCKETS)):
            shapes.setdefault((t, n), []).append(i)
    best = sorted(shapes.items(), key=lambda kv: (-len(kv[1]), kv[0]))[:2]
    checked = [i for _, idx in best for i in idx[:8]]
    per = F_GROUPS // len(FAMILIES_F)
    rest = [i for j in range(per) for i in range(j, F_GROUPS, per)
            if i not in checked]
    rows = np.array(sorted(checked + rest[:H3_GROUPS - len(checked)]))
    return rows, [(s, [int(np.flatnonzero(rows == i)[0])
                       for i in idx[:8]]) for s, idx in best]


def run_path_h3(dev, seed):
    """A ragged fleet of 256 of path F's groups (``h3_rows``, path F's
    cuts) with BFD, MBF and KEDA_LAG_REAL through ``FleetRunner.simulate``,
    a sketch and alerts on: exact launch counts; 16 groups (8 of each of
    two shapes) run at their own shapes through ``sweep_lag`` must have
    equal sketches (counts and histograms exact, floats within ``TOL``)
    and incident tables."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.fleet import FleetConfig, FleetRunner
    from repro_torch.kernels import _build
    from repro_torch.lagsim import LagSimConfig, sweep_lag

    rates, masks, t_i, n_i = fleet_traffic(seed, dev)
    rows, best = h3_rows(seed)
    rates, masks = rates[rows], masks[rows]
    t_i, n_i = t_i[rows], n_i[rows]
    pairs = [(rates[i, :t, :n], masks[i, :t, :n])
             for i, (t, n) in enumerate(zip(t_i.tolist(), n_i.tolist()))]
    # fleet-wide replica cap and histogram range: the config resolves at
    # each group's true N and is part of its bucket group's key, so a
    # range that followed N (the default, 8 consumer-steps a partition)
    # would split the 8 buckets into one group an N; one range also lets
    # every group's sketch summary merge with the others'
    cfg = LagSimConfig(use_kernel=True, max_consumers=F_N,
                       telemetry=h_telemetry(frames=False,
                                             hist_max=8.0 * CAPACITY * F_N))
    runner = FleetRunner(FleetConfig(t_buckets=F_T_BUCKETS,
                                     n_buckets=F_N_BUCKETS))
    tb = np.array([_bucket(int(t), F_T_BUCKETS) for t in t_i])
    nb = np.array([_bucket(int(n), F_N_BUCKETS) for n in n_i])
    sum_tb = sum(t for t, _ in set(zip(tb.tolist(), nb.tolist())))
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = runner.simulate(PATH_H3, pairs, cfg, device=dev)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    _require(runner.stats()["cache_misses"] == 8, f"path H3: "
             f"{runner.stats()['cache_misses']} groups, want 8 (one a "
             f"bucket)")
    launches = {"pack_rows": _packers(PATH_H3) * sum_tb,
                "lag_update_batch": len(PATH_H3) * sum_tb,
                "select_slot_grid": 0}
    for k, want in launches.items():
        _require(counts[k] == want, f"path H3: {k} launched {counts[k]} "
                 f"times, want {want}")
    _require(res.sketch is not None and res.incidents is not None
             and res.telemetry is None, "path H3: telemetry missing")
    true_steps = int(t_i.sum())
    print(f"path H3: FleetRunner.simulate {PATH_H3} over {len(pairs)} "
          f"groups of path F ({len(set(zip(tb, nb)))} bucket groups), "
          f"sketch + 4 alert rules: wall_s={wall!r} "
          f"policy_stream_steps_per_s={len(PATH_H3) * true_steps / wall!r} "
          f"launches={launches}")
    totals = {}
    for i in range(len(pairs)):
        for inc in res.scenario_incidents(i):
            totals[inc.rule] = totals.get(inc.rule, 0) + 1
    print(f"  incidents over the fleet by rule: {totals}")
    # padded equals direct: 8 groups of each of the two commonest padded
    # shapes, at their own shape through sweep_lag on the card
    t0 = time.perf_counter()
    checked = 0
    for (t, n), idx in best:
        solo = sweep_lag(PATH_H3, rates[idx, :t, :n], cfg,
                         active=masks[idx, :t, :n], device=dev)
        for j, i in enumerate(idx):
            for f in ("count", "hist"):
                _require(np.array_equal(
                    getattr(res.sketch[i], f),
                    getattr(solo.sketch, f)[:, j].cpu().numpy()),
                    f"path H3: sketch {f} of group {i} differs from its "
                    f"direct run")
            for f in ("mean", "m2", "vmin", "vmax", "ewma", "ewma_w"):
                a = getattr(res.sketch[i], f)
                w = getattr(solo.sketch, f)[:, j].cpu().numpy()
                _require(np.allclose(a, w, rtol=TOL, atol=TOL),
                         f"path H3: sketch {f} of group {i} differs by "
                         f"{np.abs(a - w).max()!r}")
            for f in ("tick", "count", "active", "open_step", "close_step",
                      "consec", "cur_start"):
                _require(np.array_equal(
                    getattr(res.incidents[i], f),
                    getattr(solo.incidents, f)[:, j].cpu().numpy()),
                    f"path H3: alert {f} of group {i} differs from its "
                    f"direct run")
        checked += len(idx)
    print(f"path H3 padded equals direct: {checked} groups of shapes "
          f"{[s for s, _ in best]} at their own shapes: sketch counts and "
          f"histograms and incident tables exact, floats within {TOL} "
          f"(direct_s={time.perf_counter() - t0!r})")
    del res, rates, masks, pairs
    torch.cuda.empty_cache()
    return launches


def run_path(name, policies, rates, act, kernels, exact=None, **over):
    """``api.simulate`` over the path's input; every kernel of ``kernels``
    must launch, each of ``exact`` exactly as many times as it gives."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import _build

    p, (b, t, n) = len(policies), rates.shape
    torch.cuda.synchronize()
    api.default_fleet().reset()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = api.simulate(rates, policies=policies, active=act,
                       device=rates.device, **over)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    for k in kernels:
        _require(counts[k] > 0, f"path {name}: kernel {k} was not launched")
    for k, want in (exact or {}).items():
        _require(counts[k] == want, f"path {name}: {k} launched {counts[k]} "
                 f"times, want {want}")
    _check_outcome(out, (p, b, t))
    launches = {k: counts[k] for k in (*kernels, *(exact or {}))}
    print(f"path {name}: {p} policies x B={b} x T={t} x N={n} {over}: "
          f"wall_s={wall!r} policy_stream_steps_per_s={p * b * t / wall!r} "
          f"launches={launches}")
    print(f"  through api.default_fleet() (the uniform fast path): "
          f"{api.default_fleet().stats()}")
    _print_metrics(out)
    return out, launches


def path_b_ops(rates, act):
    """Torch ops a path-B step dispatches, per policy (an 8-step run's ops
    less a 4-step run's, over 4): with the packing kernel, then with the
    plain packers swapped in on the card (the per-insert walk of torch
    ops that the kernel replaces).  Returns the two totals."""
    from repro_torch import api
    from repro_torch.core import pack as core_pack
    from repro_torch.registry import builtin

    def per_step(policy):
        n = []
        for t in (4, 8):
            with _op_counter() as ops:
                api.simulate(rates[:, :t], policies=(policy,),
                             active=act[:, :t], device=rates.device,
                             use_kernel=True)
            n.append(ops.n)
        return (n[1] - n[0]) // 4

    kern = {p: per_step(p) for p in PATH_B}
    with _swapped([(builtin, "pack", core_pack.pack_plain),
                   (builtin, "modified_any_fit",
                    core_pack.modified_any_fit_plain)]):
        plain = {p: per_step(p) for p in PATH_B}
    print(f"path B torch ops a step, packers on pack_rows: {kern} "
          f"total={sum(kern.values())}")
    print(f"  with the plain packers on the card (the per-insert walk): "
          f"{plain} total={sum(plain.values())}")
    return sum(kern.values()), sum(plain.values())


def path_c1_ops(rates, act):
    """Torch ops an anneal step dispatches at path C1's shape (one
    decision of ANNEAL over path B's first step: an 8-step anneal's ops
    less a 4-step one's, over 4), with the kernel and with the plain
    step.  Returns the two."""
    import torch

    from repro_torch.opt import anneal_chains
    from repro_torch.registry import builtin

    speeds, a = rates[:, 0], act[:, 0]
    prev = torch.full(speeds.shape, -1, dtype=torch.int32, device=rates.device)
    lam = torch.zeros(builtin.ANNEAL_CHAINS, device=rates.device)

    def per_step(**kw):
        n = []
        for steps in (4, 8):
            with _op_counter() as ops:
                anneal_chains(speeds, prev, CAPACITY, lam, steps=steps,
                              active=a, device=rates.device, **kw)
            n.append(ops.n)
        return (n[1] - n[0]) / 4

    kern, plain = per_step(), per_step(use_kernel=False)
    _require(kern < 10, f"path C1: {kern} torch ops an anneal step, want "
                        f"fewer than 10")
    print(f"path C1 torch ops an anneal step ({speeds.shape[0]} rows x "
          f"{builtin.ANNEAL_CHAINS} chains, N={speeds.shape[1]}): "
          f"{kern!r} with anneal_step, {plain!r} with the plain step")
    # an anneal step's device time, the Gumbel draw included (CUDA graph
    # replay, the default generator), with the kernel and the plain step
    from repro_torch.kernels import move_eval as me
    from repro_torch.opt.anneal import _gumbel

    gen = torch.Generator(rates.device).manual_seed(0)
    state, args, act, gumbel, temps = _step_inputs(
        rates.device, gen, speeds.shape[0], builtin.ANNEAL_CHAINS,
        speeds.shape[1], masked=True)
    step = me.anneal_step_launcher(state, *args, temps, gumbel.shape[0],
                                   active=act)
    draw = lambda: _gumbel(gumbel.shape, None, rates.device)  # noqa: E731
    dev_kern = graph_ms(lambda: step(draw(), 0), 50)
    dev_plain = graph_ms(lambda: me.anneal_step_reference(
        state, *args, draw(), temps, 0, active=act), 10)
    print(f"  device ms an anneal step, the draw included (graph replay): "
          f"{dev_kern!r} with anneal_step, {dev_plain!r} with the plain step")
    return kern, plain


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import binpack_select as bs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lag_update as lu
    from repro_torch.kernels import loop_fused as lf
    from repro_torch.kernels import move_eval as me
    from repro_torch.kernels import rwkv6_scan as ws
    from repro_torch.models import attention, rwkv6

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    # full float32 products: the plain versions are the yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    print(f"build_s={time.perf_counter() - t0!r}")
    check_sass(lib)
    check_ptxas()

    gen = torch.Generator(dev).manual_seed(args.seed)
    # path D2's split count: fills 4 * split - 2 and - 1 put the last
    # filled position one short of and at a split boundary
    split = da.decode_splits(D_BATCH, 8, D_PROMPT + D_GEN)
    # path F's bucket groups: rows x N_b for pack_rows and lag_update
    f_groups = fleet_groups(args.seed)
    print(f"path F's bucket groups (T_b, N_b): scenarios {f_groups}")
    # stress shapes, then the shapes paths A, B, C2, F, G and I give each
    # kernel
    errs = {
        "lag_update_batch": max(
            check_lag_update(dev, gen, 4096, 256, 514, names=64),
            check_lag_update(dev, gen, 1024, 32, 66, names=66),
            *(check_lag_update(dev, gen, rows, nb, 2 * nb + 2,     # path F
                               names=2 * nb + 2)
              for (_, nb), rows in f_groups.items()),
            check_lag_update(dev, gen, 8, 6, 14, names=14),      # path I1
            check_lag_update(dev, gen, 128, 32, 66, names=66),   # path I2
            check_lag_update(dev, gen, 4, 32, 66, names=66)),    # replays
        "select_slot_grid": max(
            check_select_slot(dev, gen, 1024, 32, 65),
            check_select_slot(dev, gen, 1024, 1, 65),    # Modified Any Fit
            check_select_slot(dev, gen, 1024, 1, 33)),   # BFD's n + 1 slots
        "pack_rows": max(
            check_pack_rows(dev, gen, 1024, 7),
            check_pack_rows(dev, gen, 1024, 32),         # paths B, G
            check_pack_rows(dev, gen, 16, 256),          # path C2
            check_pack_rows(dev, gen, 3, 30),            # G's evaluate
            check_pack_rows(dev, gen, 1, 256),           # G's pack
            *(check_pack_rows(dev, gen, rows, nb)        # path F
              for (_, nb), rows in f_groups.items()),
            check_pack_rows(dev, gen, 8, 6),             # path I1
            check_pack_rows(dev, gen, 128, 32),          # path I2
            check_pack_rows(dev, gen, 4, 32)),           # I2's replays
        "loop_fused": check_loop_fused(dev, args.seed),
        "move_delta_batch": max(
            check_move_eval(dev, gen, 6144, 32),       # path C1's shape
            check_move_eval(dev, gen, 28, 256),        # path C2's
            check_move_eval(dev, gen, 1024, 301)),     # stress, split chains
        "anneal_step": max(
            check_anneal_step(dev, gen, 1024, 6, 32),  # path C1: warp layout
            check_anneal_step(dev, gen, 1, 28, 256),   # path C2: clusters
            check_anneal_step(dev, gen, 8, 6, 6)),     # path I1: N = 6
        "flash_attention_fwd": max(
            check_flash(dev, gen, D_BATCH, 32, 8, D_PROMPT, D_PROMPT, 128),
            check_flash(dev, gen, 1, 32, 8, 8192, 8192, 128),   # stress
            check_flash(dev, gen, 2, 32, 8, 1000, 1000, 128),   # odd length
            check_flash(dev, gen, 2, 32, 8, 333, 1000, 128, causal=False)),
        "decode_attention_fwd": max(
            check_decode(dev, gen, D_BATCH, 8, 4, D_PROMPT + D_GEN, 128,
                         (0, 7, 4 * split - 2, 4 * split - 1,
                          D_PROMPT + D_GEN - 1)),        # path D2
            check_decode(dev, gen, D_BATCH, 8, 4, 32768, 128, (32767,)),
            check_decode_graph(dev, gen, D_BATCH, 8, 4, D_PROMPT + D_GEN,
                               128, (17, 700, D_PROMPT + D_GEN - 1))),
        "rwkv6_wkv_fwd": _worst(
            check_wkv(dev, gen, D_BATCH, D_PROMPT, 40, 64),       # path E1
            check_wkv(dev, gen, D_BATCH, 1, 40, 64),              # path E2
            check_wkv(dev, gen, 1, 16384, 40, 64, chunk=4096),    # long
            check_wkv(dev, gen, 2, 1000, 40, 64),                 # ragged T
            check_wkv(dev, gen, 1, 16, 2, 16),   # the reference's tests
            check_wkv(dev, gen, 2, 64, 4, 32),
            check_wkv(dev, gen, 1, 13, 5, 64),   # T not a multiple of 8
            check_wkv(dev, gen, 3, 1, 5, 128),   # 4-warp blocks, T = 1
            check_wkv(dev, gen, 2, 77, 4, 128))}

    # path A: the heuristic packers through the loop_fused kernel
    rates_a, act_a = traffic_mix(4096, 2880, 14, args.seed, dev)
    print(f"path A data: rates {tuple(rates_a.shape)} "
          f"{rates_a.numel() * 4 / 1e6!r} MB on the card")
    out_a, launches_a = run_path("A", HEURISTICS, rates_a, act_a,
                                 ("loop_fused",), fused_steps=8,
                                 fused_kernel=True)
    from repro_torch import api
    small = api.simulate(rates_a[:32, :480], policies=HEURISTICS,
                         active=act_a[:32, :480], device="cuda",
                         fused_steps=8)
    _agree(small, out_a, 32, 480, "path A against the wide fused path")
    del small

    # path B: the per-step loop; the drain and every packing call (5 of
    # the 7 policies pack) through kernels, no per-insert selection
    rates_b, act_b = traffic_mix(1024, 480, 32, args.seed + 10, dev)
    steps_b = rates_b.shape[1]
    out_b, launches_b = run_path(
        "B", PATH_B, rates_b, act_b, ("lag_update_batch", "pack_rows"),
        exact={"pack_rows": 5 * steps_b, "select_slot_grid": 0,
               "lag_update_batch": len(PATH_B) * steps_b}, use_kernel=True)
    small = api.simulate(rates_b[:16, :48].cpu(), policies=PATH_B,
                         active=act_b[:16, :48].cpu(), device="cpu",
                         use_kernel=True)
    _agree(small, out_b, 16, 48, "path B against the CPU plain versions")
    del small, out_a, out_b
    ops_b, _ = path_b_ops(rates_b, act_b)
    print(f"path B: lag_update launches={launches_b['lag_update_batch']} "
          f"(one a policy a step, {len(PATH_B)} x {steps_b}); torch ops a "
          f"step, the {len(PATH_B)} policies together: {ops_b}")

    # path C1: the annealer policies, every move evaluation on the kernel
    out_c1, launches_c1 = run_path(
        "C1", PATH_C1, rates_b, act_b, ("anneal_step",),
        exact={"anneal_step": len(PATH_C1) * rates_b.shape[1] * 48,
               "move_delta_batch": 0})
    path_c1_agreement(out_c1, rates_b, act_b)
    del out_c1
    path_c1_ops(rates_b, act_b)

    # path C2: one large topic's frontier through api.optimize
    launches_c2 = run_path_c2(dev, args.seed)

    # path F: a ragged fleet of the 8 families through the fleet layer
    launches_f = run_path_f(dev, args.seed)
    torch.cuda.empty_cache()

    # path G: the packers' sweep and the paper's evaluation
    launches_g = run_path_g(dev, args.seed, rates_b, act_b)

    # path H: the scalers as deployed, observed in the loop
    from repro_torch.lagsim import ControlPlaneConfig
    _, launches_h1a = run_path_h1("H1a", PATH_H_REAL, rates_b, act_b)
    _, launches_h1b = run_path_h1("H1b", PATH_H_CP, rates_b, act_b,
                                  control_plane=ControlPlaneConfig(**H_CP))
    path_h_ops(rates_b, act_b)
    run_path_h2(dev, args.seed)
    launches_h3 = run_path_h3(dev, args.seed)
    launches_h = {k: launches_h1a[k] + launches_h1b[k] + launches_h3[k]
                  for k in ("lag_update_batch", "pack_rows")}
    print(f"path H launches: H1a {launches_h1a}, H1b {launches_h1b}, H3 "
          f"{launches_h3}; in all {launches_h}")

    # path I: adversarial search and trace replay
    t0 = time.perf_counter()
    launches_i1 = run_path_i1(dev, args.seed)
    launches_i2 = run_path_i2(dev, args.seed)
    launches_i = {k: launches_i1[k] + launches_i2.get(k, 0)
                  for k in launches_i1}
    print(f"path I: wall_s={time.perf_counter() - t0!r} launches: I1 "
          f"{launches_i1}, I2 with its replays {launches_i2}; in all "
          f"{launches_i}")

    # path D: qwen3-8b serving, prefill and greedy generation
    launches_d = run_serving_path(dev, args.seed, "D", LLM,
                                  "flash_attention_fwd",
                                  "decode_attention_fwd")
    torch.cuda.empty_cache()
    agreement(dev, args.seed, LLM, [
        (attention, "flash_attention_fwd", fa.flash_attention_plain),
        (attention, "decode_attention_fwd", da.decode_attention_plain)])
    torch.cuda.empty_cache()

    # path E: rwkv6-3b serving, prefill and greedy generation
    launches_e = run_serving_path(dev, args.seed, "E", RWKV,
                                  "rwkv6_wkv_fwd", "rwkv6_wkv_fwd")
    torch.cuda.empty_cache()
    agreement(dev, args.seed, RWKV,
              [(rwkv6, "rwkv6_wkv_fwd", ws.rwkv6_wkv_plain)])
    torch.cuda.empty_cache()

    # per-kernel times at the paths' shapes
    kernels = []
    kw = dict(heuristic_kwargs(), active=act_a)
    b, t, n = rates_a.shape
    p = len(HEURISTICS)
    ms, _ = cuda_ms(lambda: lf.loop_fused(rates_a, **kw), 3)
    # path A's whole input once more, assignments recorded, against the
    # plain version (whose one run is also its time)
    got = lf.loop_fused(rates_a, record_assign=True, **kw)
    plain, want = cuda_ms(
        lambda: lf.loop_fused_reference(rates_a, record_assign=True, **kw),
        1, warmup=0)
    err = compare_loop_fused(got, want, "loop_fused at path A's shape")
    print(f"check loop_fused 8 heuristics B={b} T={t} N={n} masked (path "
          f"A's input), assignments recorded: bit for bit")
    errs["loop_fused"] = max(errs["loop_fused"], err)
    del got, want
    m = n + 1
    per_row_step = {"next": 3 * n, "first": 3 * n * m, "best": 3 * n * m,
                    "worst": 3 * n * m}
    ops = b * t * sum(per_row_step[s]
                      + (2 * n * n if d else 0)
                      + n * (n + 12) + 10 * n
                      for s, d in zip(kw["strategies"], kw["decreasing"]))
    byts = b * t * n * (4 + 4) + p * b * t * 4 * 5
    bnd, by = bound_ms(byts, ops)
    kernels.append(dict(
        name="loop_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/loop_fused.cu",
        replaces="src/repro/kernels/loop_fused.py:220",
        launches=launches_a["loop_fused"], max_abs_err=errs["loop_fused"],
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
        wrapper_ms=ms))
    print(f"loop_fused at path A's shape: ms={ms!r} against its bound "
          f"{bnd!r} ms ({by}); the one-thread-a-row kernel this design "
          f"replaced took 141.3 ms at this shape (PERF.md's kernel table, "
          f"H100 80GB HBM3, 700 W)")

    b, n = 1024, 32
    m = 2 * n + 2
    g = torch.Generator(dev).manual_seed(args.seed)
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    # the drain at path B's shape in the lag twin's own dtypes (f32 lag,
    # produced and cap, int64 assign, bool readable and active, active one
    # step of path B's [B, T, N] mask), so the timed calls convert nothing
    lag = torch.rand((b, n), generator=g, device=dev)
    produced = torch.rand((b, n), generator=g, device=dev)
    assign = torch.randint(-1, n, (b, n), generator=g, device=dev)
    readable = torch.rand((b, n), generator=g, device=dev) > 0.1
    cap = torch.ones((b, m), device=dev)
    act = act_b[:, 0]
    kern = lambda: lu.lag_update_batch(  # noqa: E731
        lag, produced, assign, readable, cap, active=act)
    ref = lambda: lu.lag_update_reference(  # noqa: E731
        lag, produced, assign, readable, cap, m=m, active=act)
    # bytes: lag, produced (f32), assign (int64), readable, active (bool)
    # in and out (f32) a partition, and the cap of each live bin a row
    # reads (the kernel reads cap only there)
    live = readable & act & (assign >= 0)
    live_bins = int(torch.unique(
        (torch.arange(b, device=dev)[:, None] * m + assign)[live]).numel())
    bnd, by = bound_ms(b * n * (4 + 4 + 8 + 1 + 1 + 4) + live_bins * 4,
                       b * n * 8)
    kernels.append(dict(
        name="lag_update", route="cuda",
        source="src/repro_torch/kernels/csrc/lag_update.cu",
        replaces="src/repro/kernels/lag_update.py:125",
        launches=launches_b["lag_update_batch"]
        + launches_f["lag_update_batch"] + launches_h["lag_update_batch"]
        + launches_i["lag_update_batch"],
        launches_by_path={"B": launches_b["lag_update_batch"],
                          "F": launches_f["lag_update_batch"],
                          "H": launches_h["lag_update_batch"],
                          "I": launches_i["lag_update_batch"]},
        max_abs_err=errs["lag_update_batch"], ms=graph_ms(kern, 200),
        plain_ms=graph_ms(ref, 200), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 200)[0],
        # what a wrapper that cast the engine's tensors to int32 added a
        # call: three cast launches (host time, eager)
        casts_ms=cuda_ms(lambda: (assign.to(torch.int32),
                                  readable.to(torch.int32),
                                  act.to(torch.int32)), 200)[0],
        design="a warp a row, 8 rows a block; N <= 32: a lane a partition, "
        "each bin summed over the lanes __match_any_sync finds, in index "
        "order; inputs read in their own dtypes and row strides (no casts)"))

    m = 2 * n + 1                  # Modified Any Fit's slots, [R, 1, M]
    loads = torch.rand((b, 1, m), generator=g, device=dev)
    w = torch.rand((b, 1), generator=g, device=dev)
    k = i32(torch.randint(0, m + 1, (b, 1), generator=g, device=dev))
    capw = torch.ones((b, 1), device=dev)
    kern = lambda: bs.select_slot_grid(  # noqa: E731
        loads, w, k, capw, strategy="best")
    ref = lambda: bs.select_slot_plain(  # noqa: E731
        loads, w, k, capw, strategy="best")
    bnd, by = bound_ms(b * m * 4 + b * 4 * 4, b * m * 3)
    kernels.append(dict(
        name="binpack_select", route="cuda",
        source="src/repro_torch/kernels/csrc/binpack_select.cu",
        replaces="src/repro/kernels/binpack_select.py:76",
        launches=launches_b["select_slot_grid"]
        + launches_f["select_slot_grid"] + launches_g["select_slot_grid"],
        launches_note="no path launches the grid kernel: the packers run "
        "its selection code (select_slot_warp) inside pack_rows",
        max_abs_err=errs["select_slot_grid"], ms=graph_ms(kern, 200),
        plain_ms=graph_ms(ref, 200), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 200)[0]))

    # pack_rows at path B's Modified Any Fit call: MBF on step 8's speeds
    # with the assignment of steps 0-7 as prev
    from repro_torch.core.pack import modified_any_fit

    prev = torch.full((b, n), -1, dtype=torch.long, device=dev)
    for t in range(8):
        prev = modified_any_fit(rates_b[:, t], prev, CAPACITY,
                                active=act_b[:, t]).bin_of
    sp8, act8 = rates_b[:, 8].contiguous(), act_b[:, 8].contiguous()
    kern = lambda: modified_any_fit(  # noqa: E731
        sp8, prev, CAPACITY, active=act8)
    ref = lambda: plain_packer("MBF")(  # noqa: E731
        sp8, prev, CAPACITY, active=act8)
    got, want = kern(), ref()
    torch.cuda.synchronize()
    for f in ("bin_of", "names", "n_bins"):
        _exact(getattr(got, f), getattr(want, f), f"pack_rows MBF at path "
                                                  f"B's step 8: {f}")
    _require(torch.equal(got.loads.view(torch.int32),
                         want.loads.view(torch.int32)),
             "pack_rows MBF at path B's step 8: loads differ")
    # bytes: speeds, prev (int64) and active in; bin_of, loads, names and
    # n_bins out; operations: one fit compare a slot for each active
    # item's insert
    m = 2 * n + 1
    bnd, by = bound_ms(b * n * (4 + 8 + 1 + 8) + b * m * (4 + 8) + b * 8,
                       int(act8.sum()) * m)
    kernels.append(dict(
        name="pack_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/binpack_select.cu",
        replaces="src/repro/kernels/binpack_select.py:76",
        replaces_note="the selection kernel with the reference's scans "
        "around it (src/repro/core/jaxpack.py pack_jax and "
        "modified_any_fit_jax): one launch a packing call",
        launches=launches_b["pack_rows"] + launches_c2["pack_rows"]
        + launches_f["pack_rows"] + launches_g["pack_rows"]
        + launches_h["pack_rows"] + launches_i["pack_rows"],
        launches_by_path={"B": launches_b["pack_rows"],
                          "C2": launches_c2["pack_rows"],
                          "F": launches_f["pack_rows"],
                          "G": launches_g["pack_rows"],
                          "H": launches_h["pack_rows"],
                          "I": launches_i["pack_rows"]},
        max_abs_err=errs["pack_rows"], ms=graph_ms(kern, 50),
        plain_ms=graph_ms(ref, 1), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 50)[0]))
    del prev, got, want

    k, n = 6144, 32                # path C1's chains and partitions
    m = 2 * n + 2
    margs, mact = _anneal_state(dev, g, k, n, masked=True)
    kern = lambda: me.move_delta_batch(*margs, active=mact)  # noqa: E731
    ref = lambda: me.move_delta_reference(*margs, active=mact)  # noqa: E731
    bnd, by = bound_ms(k * n * m * 4 + k * m * 8 + k * n * 16 + k * 8,
                       k * n * m * 4)
    kernels.append(dict(
        name="move_eval", route="cuda",
        source="src/repro_torch/kernels/csrc/move_eval.cu",
        replaces="src/repro/kernels/move_eval.py:135",
        launches=launches_c1["move_delta_batch"]
        + launches_c2["move_delta_batch"],
        launches_note="no path writes the move plane: the annealer runs "
        "anneal_step, which consumes each delta where it is computed",
        max_abs_err=errs["move_delta_batch"], ms=graph_ms(kern, 50),
        plain_ms=graph_ms(ref, 20), bound_ms=bnd, bound_by=by,
        library_ms=None, wrapper_ms=cuda_ms(kern, 50)[0]))
    del margs, mact
    kernels.append(anneal_step_row(dev, g, launches_c1, launches_c2,
                                   launches_i, errs))

    # lag_update_single: the same kernel at batch 1 ([1, 32], 66 bins);
    # no path calls it (the per-step loop drains every stream at once),
    # and it has no counter of its own (its launches count under
    # lag_update_batch), so no run measures its launches: null
    kern = lambda: lu.lag_update_single(  # noqa: E731
        lag[0], produced[0], assign[0], readable[0], cap[0], active=act[0])
    ref = lambda: lu.lag_update_reference(  # noqa: E731
        lag[0], produced[0], assign[0], readable[0], cap[0], m=m,
        active=act[0])
    bnd, by = bound_ms(n * (4 + 4 + 8 + 1 + 1 + 4)
                       + int(torch.unique(assign[0][live[0]]).numel()) * 4,
                       n * 8)
    got, want = kern(), ref()
    kernels.append(dict(
        name="lag_update_single", route="cuda",
        source="src/repro_torch/kernels/csrc/lag_update.cu",
        replaces="src/repro/kernels/lag_update.py:170", launches=None,
        launches_note="no path calls the rank-1 entry; it launches the "
        "lag_update kernel at batch 1, counted under lag_update",
        max_abs_err=_close(got, want, "lag_update_single"),
        ms=graph_ms(kern, 200), plain_ms=graph_ms(ref, 200), bound_ms=bnd,
        bound_by=by, library_ms=None, wrapper_ms=cuda_ms(kern, 200)[0],
        design="the lag_update kernel at batch 1: one warp"))

    kernels += attention_rows(dev, args.seed, launches_d, errs)
    kernels.append(wkv_row(dev, args.seed, launches_e, errs))

    for kern in kernels:
        print(f"kernel {kern['name']}: ms={kern['ms']!r} "
              f"plain_ms={kern['plain_ms']!r} bound_ms={kern['bound_ms']!r} "
              f"({kern['bound_by']}, {kern['bound_ms'] / kern['ms']:.1%} of "
              f"it) library_ms={kern['library_ms']!r} "
              f"wrapper_ms={kern['wrapper_ms']!r} "
              f"launches={kern['launches']}")
        if "design" in kern:
            print(f"kernel {kern['name']} design: {kern['design']}")
        if "casts_ms" in kern:
            print(f"kernel {kern['name']}: the engine's int64 assign and "
                  f"bool masks go in uncast; casting them to int32 would "
                  f"add {kern['casts_ms']!r} ms a call (eager)")
        if "ms_c2" in kern:
            print(f"kernel {kern['name']} at path C2's shape: "
                  f"ms={kern['ms_c2']!r} plain_ms={kern['plain_ms_c2']!r} "
                  f"bound_ms={kern['bound_ms_c2']!r} "
                  f"({kern['bound_by_c2']}) "
                  f"wrapper_ms={kern['wrapper_ms_c2']!r} "
                  f"launches={kern['launches_by_path']}")
        if "ms_f32" in kern:
            print(f"kernel {kern['name']} in float32 at the same shape: "
                  f"ms={kern['ms_f32']!r} plain_ms={kern['plain_ms_f32']!r} "
                  f"bound_ms={kern['bound_ms_f32']!r} "
                  f"({kern['bound_by_f32']}) "
                  f"library_ms={kern['library_ms_f32']!r} "
                  f"wrapper_ms={kern['wrapper_ms_f32']!r}")
        if "ms_decode" in kern:
            print(f"kernel {kern['name']} at one decode step: "
                  f"ms={kern['ms_decode']!r} "
                  f"plain_ms={kern['plain_ms_decode']!r} "
                  f"bound_ms={kern['bound_ms_decode']!r} "
                  f"({kern['bound_by_decode']}, "
                  f"{kern['bound_ms_decode'] / kern['ms_decode']:.1%} of it) "
                  f"wrapper_ms={kern['wrapper_ms_decode']!r} "
                  f"launches={kern['launches_by_path']}; a copy_ of the "
                  f"same state bytes: {kern['state_copy_ms_decode']!r} ms")

    z = torch.zeros(1, device=dev)
    print(f"floor of one replayed graph node (a one-element add_): "
          f"{graph_ms(lambda: z.add_(1), 200)!r} ms")
    print(f"total_s={time.perf_counter() - t_start!r}")
    # the card again, so that it stands in the output's tail beside the
    # numbers (the build's register report above is long)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

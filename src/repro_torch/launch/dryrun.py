"""One-card dry run: for every (architecture x input shape x variant)
cell, run the port's own step (``make_train_step`` with AdamW, remat and
donation; ``make_prefill_step``; ``make_serve_step``) once under fake
tensors on one H100 and record

  * the cost walk (``launch.cost_walk``) -- FLOPs by dtype and HBM bytes
    for the roofline;
  * the live bytes at the step's peak (parameters, optimizer or decode
    state, batch, activations, what autograd and remat keep), each
    allocation rounded as the CUDA caching allocator rounds it -- whether
    the cell fits the card;
  * the batch a card takes (``batch_per_device``): the largest power of
    two, at most the shape's global batch, whose predicted live bytes stay
    within ``FIT`` of the card's memory;

appending one JSON line per cell to the output file (resumable: cells
already present are skipped).  The counterpart of ``repro.launch.dryrun``,
which lowers the same cells on the reference's 16x16 and 2x16x16 TPU
meshes; the port's sharded meshes and their collective bytes come with
its sharding rules, so the variants that only change those rules record
``skipped``.

No tensor is allocated (``FakeTensorMode`` on the CPU device), so the dry
run runs on a host without the card.  The hand-written kernels launch
through ``ctypes`` on real pointers, so while a cell walks,
:func:`stand_ins` puts shape-only stand-ins where the models read them:
each returns empties of its kernel's output shapes, allocates what its
kernel allocates, and charges the walk its kernel's closed-form FLOPs and
bytes (``PERF.md`` §6's bounds).  They are restored on exit.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--rules baseline|wkv_kernel|tail256|...] [--out FILE]
      [--no-skip-existing]

The flags are the reference's, name for name, so that one command line
drives either dry run: ``--mesh`` takes only ``single`` on one card, and
``--skip-existing`` is the default that ``--no-skip-existing`` turns off,
as in the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.launch.cost_walk import CostWalk, WalkStats, current
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, MESH_NAME, N_CHIPS
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, applicable,
                                       input_specs, model_flops)
from repro_torch.serving.capacity import DEFAULT_RESULTS

# named experiment variants: (sharding-rules variant, ArchConfig
# overrides), as the reference names them
VARIANTS = {
    "baseline": ("baseline", {}),
    "no_sp": ("no_sp", {}),
    "moe_local": ("moe_local", {}),
    "ep": ("ep", {}),                                  # expert parallelism
    "wkv_kernel": ("baseline", {"wkv_impl": "kernel_stub"}),
    "tail256": ("baseline", {"decode_tail_window": 256}),
    "ep_tail256": ("ep", {"decode_tail_window": 256}),
}

#: the share of the card's memory a cell's predicted live bytes may take
FIT = 0.9
#: the dry run's device: fake tensors on the CPU device (no allocation;
#: no kernel or host read runs)
DEVICE = "cpu"


# ---------------------------------------------------------------------------
# the kernels' stand-ins
# ---------------------------------------------------------------------------

def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def _charge(name: str, flops: float, dtype, nbytes: float) -> None:
    walk = current()
    if walk is not None:
        walk.add(name, flops, dtype, nbytes)


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a (batch row, head) computes: every pair without
    the mask; with it, query q keeps keys 0..q (``q_pos >= k_pos``)."""
    if not causal:
        return sq * skv
    if sq <= skv:
        return sq * (sq + 1) // 2
    return skv * (skv + 1) // 2 + (sq - skv) * skv


def flash_fwd_stand_in(q, k, v, *, causal: bool = True,
                       return_lse: bool = False):
    """``flash_attention_fwd``'s outputs and allocations; 4 hd FLOPs a
    kept pair and head (two products), q, k, v read and the output (and
    lse) written."""
    b, h, sq, hd = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _charge("flash_attention_fwd",
            4.0 * b * h * hd * causal_pairs(sq, k.shape[2], causal),
            q.dtype, _nbytes(q, k, v, out, lse))
    return (out, lse) if return_lse else out


def flash_bwd_stand_in(q, k, v, o, do, lse, *, causal: bool = True):
    """``flash_attention_bwd``'s outputs and scratch; 10 hd FLOPs a kept
    pair and head (five products), q, k, v, o, do, lse read and dq, dk,
    dv written."""
    from repro_torch.kernels.flash_attention import _WGMMA_BWD, bwd_entry

    b, h, sq, hd = q.shape
    q, k, v, o, do, lse = (x.contiguous() for x in (q, k, v, o, do, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = -(-sq // 64) * 64 if bwd_entry(q.dtype, hd) == _WGMMA_BWD else sq
    scratch = torch.empty(2 * b * h * rows, dtype=torch.float32,
                          device=q.device)
    del scratch
    _charge("flash_attention_bwd",
            10.0 * b * h * hd * causal_pairs(sq, k.shape[2], causal),
            q.dtype, _nbytes(q, k, v, o, do, lse, dq, dk, dv))
    return dq, dk, dv


def _decode_out(q, s: int) -> torch.Tensor:
    """The decode kernel's one allocation: its output, then its f32
    partials (``kernels.decode_attention._alloc``)."""
    from repro_torch.kernels.decode_attention import decode_splits

    b, kvh, g, hd = q.shape
    size = q.element_size()
    ws_at = -(-q.numel() * size // 16) * 16
    ws_bytes = 4 * b * kvh * decode_splits(b, kvh, s) * g * (hd + 2)
    buf = torch.empty(-(-(ws_at + ws_bytes) // size), dtype=q.dtype,
                      device=q.device)
    return buf.as_strided(q.shape, q.stride())


def decode_stand_in(q, k_cache, v_cache, cache_len):
    """``decode_attention_fwd``'s output and partials; one new token
    against the whole cache (as the reference's dry run counts it): 4 hd
    FLOPs a position and query head, q and both caches read, the output
    written."""
    b, kvh, g, hd = q.shape
    s = k_cache.shape[2]
    q = q.contiguous()
    out = _decode_out(q, s)
    _charge("decode_attention_fwd", 4.0 * b * kvh * g * s * hd, q.dtype,
            _nbytes(q, k_cache, v_cache, out))
    return out


def decode_tailed_stand_in(q, k_main, v_main, k_tail, v_tail, cache_len,
                           window: int):
    """``decode_attention_tailed_fwd``: the whole main cache and the whole
    tail, as :func:`decode_stand_in`."""
    b, kvh, g, hd = q.shape
    s = k_main.shape[2] + k_tail.shape[2]
    q = q.contiguous()
    out = _decode_out(q, k_main.shape[2])
    _charge("decode_attention_tailed_fwd", 4.0 * b * kvh * g * s * hd,
            q.dtype, _nbytes(q, k_main, v_main, k_tail, v_tail, out))
    return out


def wkv_fwd_stand_in(r, k, v, w, u, s0, s_last=None,
                     checkpoints: bool = False):
    """``rwkv6_wkv_fwd``: 5 hd^2 + 5 hd FLOPs a step and head (f32), the
    four streams, u and s0 read, the output, the last state (and the
    checkpoints) written."""
    from repro_torch.kernels.rwkv6_scan import ckpt_shape

    b, t, h, hd = r.shape
    if s_last is None:
        s_last = torch.empty_like(s0, memory_format=torch.contiguous_format)
    out = torch.empty_like(r)
    ckpt = (torch.empty(ckpt_shape(b, t, h, hd), dtype=torch.float32,
                        device=r.device) if checkpoints else None)
    _charge("rwkv6_wkv_fwd", float(b * t * h * (5 * hd * hd + 5 * hd)),
            torch.float32, _nbytes(r, k, v, w, u, s0, out, s_last, ckpt))
    return (out, s_last, ckpt) if checkpoints else (out, s_last)


def wkv_bwd_stand_in(r, k, v, w, u, ckpt, do, ds_last):
    """``rwkv6_wkv_bwd``: 14 hd^2 + 16 hd FLOPs a step and head (f32), its
    inputs read and the six gradients written, its du scratch."""
    from repro_torch.kernels.rwkv6_scan import bwd_scratch_floats

    b, t, h, hd = r.shape
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du, ds0 = torch.empty_like(u), torch.empty_like(ds_last)
    scratch = torch.empty(bwd_scratch_floats(b, t, h, hd),
                          dtype=torch.float32, device=r.device)
    del scratch
    _charge("rwkv6_wkv_bwd", float(b * t * h * (14 * hd * hd + 16 * hd)),
            torch.float32, _nbytes(r, k, v, w, u, ckpt, do, ds_last, dr, dk,
                                   dv, dw, du, ds0))
    return dr, dk, dv, dw, du, ds0


#: where the models read each kernel: (module, name) -> stand-in
STAND_INS = {
    ("repro_torch.models.attention", "flash_attention_fwd"):
        flash_fwd_stand_in,
    ("repro_torch.models.attention", "flash_attention_bwd"):
        flash_bwd_stand_in,
    ("repro_torch.models.attention", "decode_attention_fwd"):
        decode_stand_in,
    ("repro_torch.models.attention", "decode_attention_tailed_fwd"):
        decode_tailed_stand_in,
    ("repro_torch.models.rwkv6", "rwkv6_wkv_fwd"): wkv_fwd_stand_in,
    ("repro_torch.models.rwkv6", "rwkv6_wkv_bwd"): wkv_bwd_stand_in,
}


def _clear_caches() -> None:
    from repro_torch.models import layers

    layers._freqs.cache_clear()
    layers._sections.cache_clear()


@contextlib.contextmanager
def stand_ins() -> Iterator[None]:
    """Within the block, the models call the kernels' stand-ins; the
    kernels are put back on exit, and the RoPE tables cached meanwhile
    (fake tensors) are dropped."""
    import importlib

    saved = []
    for (mod, name), fn in STAND_INS.items():
        m = importlib.import_module(mod)
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, fn)
    _clear_caches()
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        _clear_caches()


@contextlib.contextmanager
def fake_mode() -> Iterator[None]:
    """Fake tensors (no storage) with the kernels' stand-ins in place."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True), stand_ins():
        yield


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def cell_config(arch: str, shape: ShapeSpec, variant: str = "baseline"):
    """The cell's config: the variant's overrides, bfloat16 parameters to
    serve and float32 to train, as the reference's dry run sets them."""
    _, over = VARIANTS.get(variant, (variant, {}))
    cfg = configs.get(arch)
    return dataclasses.replace(
        cfg, **over,
        param_dtype="bfloat16" if shape.kind == "decode" else "float32")


def _batch(cfg, shape: ShapeSpec, b: int) -> Dict[str, torch.Tensor]:
    """The step's batch as fake tensors (inside :func:`fake_mode`)."""
    return {k: torch.empty(t.shape, dtype=t.dtype, device=DEVICE)
            for k, t in input_specs(cfg, shape, batch=b).items()}


def _sizes(*trees) -> int:
    from repro_torch._tree import leaves

    return sum(t.numel() * t.element_size() for tree in trees
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def walk_step(cfg, shape: ShapeSpec, b: int) -> Tuple[WalkStats, Dict]:
    """One step of ``cfg`` at ``shape`` and batch ``b`` under fake tensors:
    its walk, and the bytes of its parameters, state and batch (plus the
    tailed state's flush's walk, where the config has a window)."""
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.models.attention import flush_kv_tail
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    with fake_mode():
        params = init_params(cfg, 0, device=DEVICE)
        batch = _batch(cfg, shape, b)
        if shape.kind == "train":
            state = adamw_init(params)
            step = make_train_step(cfg, AdamWConfig(), DEVICE, donate=True)
            run = lambda: step(params, state, batch)  # noqa: E731
        elif shape.kind == "prefill":
            state = {}
            step = make_prefill_step(cfg, DEVICE)
            run = lambda: step(params, batch)  # noqa: E731
        else:
            state = init_decode_state(cfg, b, shape.seq_len, DEVICE)
            step = make_serve_step(cfg, DEVICE)
            run = lambda: step(params, state, batch)  # noqa: E731
        with CostWalk() as walk:
            walk.track(params, state, batch)
            out = run()
            del out
        sizes = {"params_bytes": _sizes(params), "state_bytes": _sizes(state),
                 "batch_bytes": _sizes(batch)}
        flush = None
        if "tail" in state:             # a tailed decode's W-step flush
            with CostWalk() as fw:
                fw.track(state)
                flush_kv_tail(cfg, state)
            flush = fw.stats
    return walk.stats, dict(sizes, flush=flush)


def _pow2_at_most(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def choose_batch(cfg, shape: ShapeSpec, budget: float = None):
    """``(b, walk, extra, fits, fitted)``: the largest power of two ``b <=
    global_batch`` whose live bytes are within ``budget`` (default ``FIT``
    of the card's memory), from live bytes fitted affine in the batch at
    b = 1 and 2 and then walked at ``b`` (halved while the walk exceeds
    the budget).  A cell over the budget at b = 1 returns b = 1 and
    ``fits = False``."""
    budget = FIT * HBM_BYTES if budget is None else budget
    w1, x1 = walk_step(cfg, shape, 1)
    fitted = {"live_at_1": w1.peak_bytes}
    if w1.peak_bytes > budget or shape.global_batch == 1:
        return 1, w1, x1, w1.peak_bytes <= budget, fitted
    w2, x2 = walk_step(cfg, shape, 2)
    slope = max(w2.peak_bytes - w1.peak_bytes, 1)
    fitted.update(live_at_2=w2.peak_bytes, per_row=slope)
    b = _pow2_at_most(min(shape.global_batch,
                          1 + int((budget - w1.peak_bytes) // slope)))
    while b > 2:
        w, x = walk_step(cfg, shape, b)
        if w.peak_bytes <= budget:
            return b, w, x, True, fitted
        b //= 2
    return (2, w2, x2, True, fitted) if b == 2 else (1, w1, x1, True, fitted)


def lower_cell(arch: str, shape_name: str, rules_variant: str = "baseline"
               ) -> Dict:
    """A result dict for one cell on one card (raises on failure)."""
    shape = SHAPES[shape_name]
    cfg = cell_config(arch, shape, rules_variant)
    t0 = time.time()
    b, w, extra, fits, fitted = choose_batch(cfg, shape)
    walk_s = time.time() - t0
    t_compute, t_memory = w.t_compute_s(), w.t_memory_s()
    mf_b = model_flops(cfg, shape, batch=b)
    res = {
        "arch": arch, "shape": shape_name, "mesh": MESH_NAME,
        "rules": rules_variant, "kind": shape.kind, "chips": N_CHIPS,
        "walk_s": round(walk_s, 1),
        "batch_per_device": b, "global_batch": shape.global_batch,
        "flops_per_device": w.flops,
        "flops_by_dtype": dict(w.flops_by_dtype),
        "bytes_per_device": w.hbm_bytes,
        "collective_bytes_per_device": 0.0,
        "cost": w.summary(),
        "model_flops_global": model_flops(cfg, shape),
        "model_flops_per_device": mf_b,
        "useful_flops_ratio": mf_b / w.flops if w.flops > 0 else None,
        "roofline": {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": 0.0,
            "bottleneck": max([("compute", t_compute), ("memory", t_memory),
                               ("collective", 0.0)],
                              key=lambda kv: kv[1])[0],
        },
        "memory": {
            "live_bytes_per_device": int(w.peak_bytes),
            "fits_hbm": bool(fits),
            "hbm_bytes": HBM_BYTES,
            "inputs_bytes": int(w.start_bytes),
            "params_bytes": extra["params_bytes"],
            "state_bytes": extra["state_bytes"],
            "batch_bytes": extra["batch_bytes"],
            **fitted,
        },
    }
    fl = extra["flush"]
    if fl is not None:
        win = cfg.decode_tail_window
        res["flush_amortized"] = {"window": win,
                                  "t_memory_s": fl.hbm_bytes / HBM_BW / win,
                                  "t_collective_s": 0.0}
    return res


def _skip_reason(cfg, shape_name: str, rules: str) -> Optional[str]:
    ok, why = applicable(cfg, shape_name)
    if not ok:
        return why
    if VARIANTS.get(rules, (rules, {}))[0] != "baseline":
        return (f"SKIP(sharding): rules {VARIANTS[rules][0]!r} shard a "
                f"multi-chip mesh; on one card they are the baseline, and "
                f"the port's multi-chip meshes and sharding rules are not "
                f"ported yet")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None,
                    help="single shape (default: all)")
    ap.add_argument("--mesh", default="single", choices=["single"],
                    help="single: one H100 (the reference's multi and both, "
                         "its 2x16x16 mesh, come with the port's sharding)")
    ap.add_argument("--rules", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out", default=DEFAULT_RESULTS)
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--no-skip-existing", dest="skip_existing",
                    action="store_false")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else configs.list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    done = set()
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"], r["rules"]))
                except (json.JSONDecodeError, KeyError):
                    pass

    failures = []
    with open(args.out, "a") as out:
        for arch in archs:
            cfg = configs.get(arch)
            for shape_name in shapes:
                key = (arch, shape_name, MESH_NAME, args.rules)
                if key in done:
                    print(f"[skip-done] {key}", flush=True)
                    continue
                why = _skip_reason(cfg, shape_name, args.rules)
                if why:
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": MESH_NAME, "rules": args.rules,
                           "skipped": why}
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
                    print(f"[skip] {key}: {why}", flush=True)
                    continue
                print(f"[cell] {key} ...", flush=True)
                try:
                    res = lower_cell(arch, shape_name, args.rules)
                    out.write(json.dumps(res) + "\n")
                    out.flush()
                    rl, mem = res["roofline"], res["memory"]
                    print(f"  ok walk={res['walk_s']}s "
                          f"b={res['batch_per_device']} "
                          f"bottleneck={rl['bottleneck']} "
                          f"tc={rl['t_compute_s']:.3e} "
                          f"tm={rl['t_memory_s']:.3e} "
                          f"live={mem['live_bytes_per_device'] / 2**30:.2f}"
                          f"GiB fits={mem['fits_hbm']}", flush=True)
                except Exception as e:  # recorded, as the reference does
                    tb = traceback.format_exc(limit=20)
                    failures.append((key, str(e)))
                    out.write(json.dumps(
                        {"arch": arch, "shape": shape_name,
                         "mesh": MESH_NAME, "rules": args.rules,
                         "error": str(e)[:2000]}) + "\n")
                    out.flush()
                    print(f"  FAIL: {e}\n{tb}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:", flush=True)
        for k, e in failures:
            print(f"  {k}: {e[:200]}", flush=True)
        return 1
    print("\nall cells ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded through ``ctypes``.
The library lands in ``build/repro_torch/<content hash>/`` under the
repository root (listed in ``.gitignore``) on first use; a later process
with the same sources loads it without compiling.  A failed build raises
:class:`KernelBuildError` -- nothing falls back to the plain versions.

No ``--use_fast_math``: the kernels compare against ``inf`` and divide
exactly, and fast math changes both.

Launch counters: each kernel wrapper is registered with
:func:`counted`, carries a plain-integer ``launches`` attribute and adds
one to it exactly where it launches its kernel.  ``reset_launches`` /
``launch_counts`` read and zero all of them at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO = Path(__file__).resolve().parents[3]
BUILD_ROOT = _REPO / "build" / "repro_torch"
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)   # when nvcc is not on PATH
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signature of every entry point: argtypes, all returning cudaError_t
SIGNATURES = {
    # lag, produced, assign, readable, cap, active|NULL, out, B, N, M,
    # assign_i64, readable_i32, active_i32, row strides of lag, produced,
    # assign, readable, cap and active, stream
    "lag_update_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _P),
    # loads, w, k, cap, active|NULL, out, B, N, M, strategy, stream
    "select_slot_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # speeds, prev (i64), active (bool)|NULL, bin_of, loads, names, n_bins,
    # R, N, modified, strategy, decreasing, sticky, cumulative, cap, stream
    "pack_rows_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _F, _P),
    # rates, active (u8)|NULL, lag0|NULL, strat[P], dec[P], tot, mx, cons,
    # migs, unread, asg|NULL, P, B, T, N, rates' and active's row strides,
    # capacity, cap_step, dt, mig, stream
    "loop_fused_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P),
    # loads, counts, assign, speeds, prev, lam, cap, active|NULL, out,
    # K, N, M, stream
    "move_eval_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # assign, loads, counts, cost, best_cost, best_assign (in place),
    # speeds, prev, lam, cap, active|NULL, gumbel, temps, step, R, K, N, M,
    # stream
    "anneal_step_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _P),
    # q, k, v, out, lse (f32 B*H*Sq)|NULL, B, H, KV, Sq, Skv, hd, causal,
    # stream
    "flash_attention_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P),
    "flash_attention_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    # q, k, v, o, do, dq, dk, dv, f32 scratch (lse and D, 2 x B*H*Sq), B,
    # H, KV, Sq, Skv, hd, causal, stream
    "flash_attention_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _P),
    "flash_attention_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _P),
    # q, k, v, o, do, lse, dq, dk, dv, f32 scratch (lse * log2 e and D, 2
    # x B*H*round_up(Sq, 64)), B, H, KV, Sq, Skv, hd, causal, stream
    "flash_attention_bwd_bf16_wgmma": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k_cache, v_cache, cache_len (device int32), out, f32 partials, B,
    # KV, G, S, hd, splits, stream
    "decode_attention_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P),
    "decode_attention_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _P),
    # q, k_cache, v_cache, k_tail, v_tail, cache_len (device int32), out,
    # f32 partials, B, KV, G, S, W, hd, splits, stream
    "decode_attention_tailed_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _P),
    "decode_attention_tailed_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _P),
    # q, k, v (one shard of the cache), fill (device int32), m, l, acc
    # (f32), f32 partials, B, KV, G, S, hd, splits, stream
    "decode_attention_partial_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _P),
    "decode_attention_partial_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _P),
    # r, k, v, w, u, s0, out, s_last (may alias s0), B, T, H, hd, stream
    "rwkv6_wkv_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the same and the checkpoints (B, H, ceil(T / chunk), hd, hd), chunk,
    # B, T, H, hd, stream
    "rwkv6_wkv_ckpt_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P),
    # r, k, v, w, u, ckpt, do, ds_last, dr, dk, dv, dw, du, ds0, f32
    # scratch (du's partials), its length in floats, chunk, rows, B, T, H,
    # hd, stream
    "rwkv6_wkv_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    # hd, out: int clusters the card holds at once, int threads a block,
    # int dynamic shared memory bytes a block
    "rwkv6_wkv_bwd_occupancy": (_I, _P, _P, _P),
}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source; the message carries its
    output."""


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a nonzero ``cudaError_t``."""


_LIB = None
_COUNTED: List[Callable] = []


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), *NVCC_FALLBACKS):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
        "repro_torch CUDA kernels are built from csrc/ on first use")


def _check(procs, echo: bool = False) -> str:
    """Wait for every compiler process; raise on the first failure.
    Returns their standard error, concatenated."""
    report = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        err = err.decode(errors="replace")
        report.append(err)
        if echo:
            print(err, end="")
        if proc.returncode != 0:
            raise KernelBuildError(
                f"{' '.join(cmd)} failed with code {proc.returncode}:\n"
                f"{out.decode(errors='replace')}{err}")
    return "".join(report)


def ptxas_report() -> Path:
    """Where ``build(verbose=True)`` keeps its ``-Xptxas -v`` report."""
    return BUILD_ROOT / _digest(_sources()) / "ptxas.txt"


def build(verbose: bool = False) -> Path:
    """Compile (if not already built) and return the shared library path.
    ``verbose`` rebuilds with ``-Xptxas -v``, prints its report
    (registers, shared memory, stack frame and spills per kernel) and
    keeps it at ``ptxas_report()``."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists() and not verbose:
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        extra = ("-Xptxas", "-v") if verbose else ()
        procs = []
        objs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
            objs.append(str(obj))
        report = _check(procs, echo=verbose)
        if verbose:
            ptxas_report().write_text(report)
        part = Path(tmp) / lib.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(part)]
        _check([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE))])
        os.replace(part, lib)      # atomic: concurrent builds never race
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def entry(name: str) -> Callable:
    """Entry point ``name`` as a callable that raises if the entry point
    returns a CUDA error; a caller that launches many times keeps it."""
    fn = getattr(library(), name)

    def call(*args) -> None:
        code = fn(*args)
        if code != 0:
            raise KernelLaunchError(
                f"{name} returned cudaError_t {code} (launch refused or a "
                f"previous asynchronous fault surfaced)")

    return call


def launch(name: str, *args) -> None:
    """Call entry point ``name``; raise if it returns a CUDA error."""
    entry(name)(*args)


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def counted(fn: Callable) -> Callable:
    """Give a kernel wrapper its ``launches`` counter and register it."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def reset_launches() -> None:
    """Zero every registered wrapper's ``launches`` counter."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """``{wrapper name: launches}`` for every registered kernel wrapper."""
    return {fn.__name__: fn.launches for fn in _COUNTED}

"""Checkpoint store, in the reference's layout (``checkpoint/store.py``).

Layout: ``<dir>/step_<N>/MANIFEST.msgpack`` plus one compressed blob per
leaf (zstd when ``zstandard`` imports, stdlib zlib otherwise; the
manifest records the codec per leaf, and reading a zstd blob without
``zstandard`` raises).  A leaf's key is its path in the tree joined by
``/`` (a list item by its index); its entry names the file, shape,
dtype (numpy's name; bfloat16 tensors, which numpy lacks, are saved as
their raw bytes under ``"bfloat16"``, as the reference's manifest names
them) and the blob's crc32, checked on restore.

* atomic: written to ``step_<N>.tmp`` and renamed, so a crash mid-save
  never corrupts the latest checkpoint;
* the manifest is MessagePack, written and read by ``msgpack_lite`` (the
  card's machine has no ``msgpack`` package);
* trees are nested dicts and lists of tensors; a restore with a target
  gives tensors in the saved dtypes on the target leaves' devices, and
  one without gives the nested dicts of numpy arrays (bfloat16 widened
  to float32, exactly) that ``convert.params_from_numpy`` and
  ``convert.opt_state_from_numpy`` take, which is how a reference
  checkpoint becomes port state.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._tree import items, nest, tree_map, unflatten

from . import msgpack_lite

try:  # optional: zlib when zstandard is absent
    import zstandard as zstd
except ImportError:  # pragma: no cover - depends on the machine
    zstd = None

MANIFEST = "MANIFEST.msgpack"


def _compress(data: bytes, cctx) -> tuple:
    """``(blob, codec)``.  ``cctx``: one ZstdCompressor per checkpoint, or
    None for zlib."""
    if cctx is not None:
        return cctx.compress(data), "zstd"
    return zlib.compress(data, level=6), "zlib"


def _decompress(blob: bytes, codec: str, dctx) -> bytes:
    if codec == "zstd":
        if dctx is None:
            raise ImportError("checkpoint was written with zstd but "
                              "zstandard is not installed")
        return dctx.decompress(blob)
    if codec == "zlib":
        return zlib.decompress(blob)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _raw(leaf) -> tuple:
    """``(bytes, shape, dtype name)`` of a tensor or array leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    "bfloat16")
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.tobytes(order="C"), list(arr.shape), str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Blocking save of ``tree`` (nested dicts and lists of tensors or
    arrays) and ``extra`` (plain data, kept in the manifest); returns the
    step directory."""
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    cctx = zstd.ZstdCompressor(level=3) if zstd is not None else None
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in items(tree):
        data, shape, dtype = _raw(leaf)
        blob, codec = _compress(data, cctx)
        fname = (re.sub(r"[^A-Za-z0-9_.-]", "_", key)
                 + (".zst" if codec == "zstd" else ".zz"))
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(blob)
        manifest["leaves"][key] = {
            "file": fname, "shape": shape, "dtype": dtype,
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF, "codec": codec}
    with open(os.path.join(tmp, MANIFEST), "wb") as f:
        f.write(msgpack_lite.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


def load_manifest(directory: str, step: int) -> dict:
    """The manifest of ``step``: ``{"step", "leaves", "extra"}``."""
    with open(os.path.join(_step_dir(directory, step), MANIFEST), "rb") as f:
        return msgpack_lite.unpackb(f.read())


def _read(base: str, key: str, meta: dict, dctx) -> tuple:
    """``(raw bytes, shape, dtype name)`` of one leaf, its crc checked."""
    with open(os.path.join(base, meta["file"]), "rb") as f:
        blob = f.read()
    if (zlib.crc32(blob) & 0xFFFFFFFF) != meta["crc32"]:
        raise IOError(f"checksum mismatch for {key!r}")
    return (_decompress(blob, meta.get("codec", "zstd"), dctx),
            tuple(meta["shape"]), meta["dtype"])


def _tensor(data: bytes, shape, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(data), dtype=torch.int16).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(
        np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy())


def _array(data: bytes, shape, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":          # exact in float32: numpy has no bf16
        return _tensor(data, shape, dtype).float().numpy()
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()


def restore_checkpoint(directory: str, step: int,
                       target: Any = None) -> Any:
    """The tree saved at ``step``.  With ``target`` (a tree of tensors, or
    of anything with a ``shape``), a tree of its structure whose leaves
    are tensors in the saved dtypes, each on its target leaf's device;
    shapes must match.  Without, nested dicts of numpy arrays keyed by
    the manifest's paths (bfloat16 widened to float32)."""
    base = _step_dir(directory, step)
    manifest = load_manifest(directory, step)
    dctx = zstd.ZstdDecompressor() if zstd is not None else None
    if target is None:
        return nest({key: _array(*_read(base, key, meta, dctx))
                     for key, meta in manifest["leaves"].items()})
    out = {}
    for key, want in items(target):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint {base} missing leaf {key!r}")
        t = _tensor(*_read(base, key, meta, dctx))
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{key!r}: shape {tuple(t.shape)} != "
                             f"{tuple(want.shape)}")
        dev = getattr(want, "device", None)
        out[key] = t if dev is None else t.to(dev)
    return unflatten(target, out)


class CheckpointManager:
    """Keep-last-k rotation and an optional save on a worker thread."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: Optional[dict] = None
             ) -> None:
        # copy to the host first: the caller may change its tensors after
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True)
                             if torch.is_tensor(x) else np.array(x), tree)
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_tree, extra))
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree, extra)

    def _save_and_gc(self, step, tree, extra):
        save_checkpoint(self.directory, step, tree, extra)
        steps = sorted(int(m.group(1)) for n in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", n)))
        for s in steps[: -self.keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, target: Any = None):
        """``(step, tree)`` of the latest checkpoint, or ``(None, None)``."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, target)

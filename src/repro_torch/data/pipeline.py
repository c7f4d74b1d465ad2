"""Token pipeline: deterministic synthetic shards -> bin-packed loader pool
-> fixed-shape (inputs, labels) batches, with resumable state.

The reference's ``data/pipeline.py``.  The token streams are numpy and
counter-based, bit-identical to the reference's; the loader pool packs
with the port's own ``py`` packers (``core.modified.modified_any_fit``
over ``core.assignment.group_view``).  Batches stay numpy on the host:
the train step moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.assignment import group_view
from repro_torch.core.modified import modified_any_fit

#: tokens a counter block: block ``i`` of a shard is drawn from a
#: generator seeded ``(shard seed, i)``, so any offset is seekable
BLOCK = 65536


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    shard_id: int
    seed: int
    rate: float = 1.0          # relative throughput (item size for packing)


class SyntheticShard:
    """Deterministic infinite token stream (stands in for a tokenized
    file).  ``state`` is the number of tokens consumed, so checkpoint and
    restore resume exactly."""

    def __init__(self, spec: ShardSpec, vocab_size: int):
        self.spec = spec
        self.vocab = vocab_size
        self.offset = 0

    def take(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        pos, got = self.offset, 0
        while got < n:
            rng = np.random.default_rng((self.spec.seed, pos // BLOCK))
            blk = rng.integers(0, self.vocab, size=BLOCK, dtype=np.int32)
            lo = pos % BLOCK
            take = min(BLOCK - lo, n - got)
            out[got:got + take] = blk[lo:lo + take]
            got += take
            pos += take
        self.offset = pos
        return out

    def state(self) -> int:
        return self.offset

    def seek(self, offset: int) -> None:
        self.offset = int(offset)


class LoaderPool:
    """Shards assigned to loader workers by Modified Best Fit (sorted by
    the largest shard a loader holds).  ``capacity`` is one loader's
    ingest rate; the packer decides the pool's size, and a re-pack keeps
    shards on their loader where it can (a low R-score: few shards
    reopened)."""

    def __init__(self, shards: Sequence[ShardSpec], capacity: float):
        self.shards = list(shards)
        self.capacity = float(capacity)
        self.assignment: Dict[int, int] = {}
        self.repack()

    def repack(self, rates: Optional[Mapping[int, float]] = None) -> int:
        """Re-pack at ``rates`` (shard id -> rate; a shard not named keeps
        its spec's rate).  Returns the number of loaders."""
        speeds = {s.shard_id: (rates or {}).get(s.shard_id, s.rate)
                  for s in self.shards}
        res = modified_any_fit(speeds, self.capacity,
                               group_view(self.assignment), fit="best",
                               sort_key="max_partition")
        self.assignment = dict(res.pid_to_bin)
        return res.n_bins

    def loader_of(self, shard_id: int) -> int:
        return self.assignment[shard_id]

    def n_loaders(self) -> int:
        return len(set(self.assignment.values()))


class TokenPipeline:
    """Round-robin over shards into fixed (batch, seq + 1) token blocks;
    yields ``{"inputs": (B, S), "labels": (B, S)}`` int32 next-token
    pairs."""

    def __init__(self, batch_size: int, seq_len: int, vocab_size: int,
                 n_shards: int = 16, seed: int = 0,
                 loader_capacity: float = 4.0):
        specs = [ShardSpec(i, seed * 1000 + i, rate=1.0 + (i % 3))
                 for i in range(n_shards)]
        self.pool = LoaderPool(specs, capacity=loader_capacity)
        self.shards = [SyntheticShard(s, vocab_size) for s in specs]
        self.batch_size = batch_size
        self.seq_len = seq_len
        self._next_shard = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rows = []
        for _ in range(self.batch_size):
            sh = self.shards[self._next_shard]
            self._next_shard = (self._next_shard + 1) % len(self.shards)
            rows.append(sh.take(self.seq_len + 1))
        block = np.stack(rows)                     # (B, S + 1)
        return {"inputs": block[:, :-1].astype(np.int32),
                "labels": block[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- resumable state ----------------------------------------------------
    def state(self) -> Dict:
        return {"offsets": [s.state() for s in self.shards],
                "next_shard": self._next_shard}

    def load_state(self, state: Dict) -> None:
        for s, off in zip(self.shards, state["offsets"]):
            s.seek(off)
        self._next_shard = int(state["next_shard"])

"""The store's row order (`store_permutation`), dataset identity
(`dataset_fingerprint`) and per-shard view (`StoredShardSource`).

Port of `repro/data/store/source.py`. The
schedule property that makes out-of-core nested k-means cheap: round
t+1 reuses round t's prefix and only APPENDS, so if consecutive shuffle
positions live in consecutive chunks, the disk frontier advances
monotonically and every chunk is read about once per full-data pass.

A uniform row shuffle destroys that: each doubling's delta scatters
over ALL chunks, costing ~log2(n/b0) full passes. `store_permutation`
therefore shuffles at two levels: chunk ORDER uniformly, then rows
WITHIN each chunk. Every shuffle prefix is a contiguous run of whole
chunks (plus one partial frontier chunk), while each point still lands
in the prefix with chunk-level randomness. The caveat is explicit: the
early batches are a by-chunk (not by-row) sample, so a store whose row
order correlates with content at chunk granularity (e.g. sorted by
label) should be written pre-shuffled.

The bit-parity contract: a store-backed fit replays exactly the row
sequence ``X[store_permutation(...)]``, so ``fit(store, shuffle=True)``
equals ``fit(X[perm], shuffle=False)`` bit for bit, on every backend.
"""
from __future__ import annotations

import zlib
from pathlib import Path
from typing import Dict, Union

import numpy as np

from repro_torch.data.pipeline import ShardLayout, nested_shard_layout
from repro_torch.data.store.reader import ChunkStore


def store_permutation(n: int, chunk_rows: int, seed: int, *,
                      shuffle: bool = True) -> np.ndarray:
    """Chunk-blocked shuffle of ``n`` rows (see module docstring)."""
    if not shuffle:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    n_chunks = -(-n // chunk_rows) if n else 0
    order = rng.permutation(n_chunks)
    parts = []
    for ci in order:
        lo = int(ci) * chunk_rows
        hi = min(n, lo + chunk_rows)
        parts.append(lo + rng.permutation(hi - lo))
    return (np.concatenate(parts) if parts
            else np.arange(0))


def dataset_fingerprint(data) -> Dict[str, object]:
    """Content identity of a fit's dataset, for checkpoint manifests.

    Stores carry their index checksum (covers every chunk's crc32).
    In-memory arrays hash a bounded strided row sample: O(1) in the
    dataset size, computed on the CALLER's array before any shuffle.
    Two same-shape arrays differing only off-sample collide, which the
    fail-loudly-on-the-wrong-dataset use case accepts.
    """
    if isinstance(data, ChunkStore):
        return data.fingerprint()
    X = np.asarray(data)
    n = int(X.shape[0])
    d = int(X.shape[1]) if X.ndim > 1 else 1
    step = max(1, n // 64)
    sample = np.ascontiguousarray(X[::step][:64])
    return {"kind": "array", "n": n, "d": d, "dtype": str(X.dtype),
            "crc": int(zlib.crc32(sample.tobytes()))}


class StoredShardSource:
    """`KMeansShardedSource` semantics, backed by a `ChunkStore`.

    Same surface (`n_valid` / `shard` / `shard_valid` / `global_prefix`)
    so a test can diff the two row for row; plus the streaming primitive
    the mesh engines use: `block(shards, lo, hi)` fetches per-shard
    storage rows [lo, hi) for several shards in ONE pass over the
    covering chunks. On a round-robin layout those shards' rows
    interleave inside the same chunks, so fetching them together reads
    each chunk once instead of once per shard.
    """

    def __init__(self, store: Union[str, Path, ChunkStore], n_shards: int,
                 *, seed: int = 0, shuffle: bool = True,
                 cache_chunks: int = 8, prefetch_depth: int = 0):
        self.store = (store if isinstance(store, ChunkStore)
                      else ChunkStore(store, cache_chunks=cache_chunks,
                                      prefetch_depth=prefetch_depth))
        self._owns_store = not isinstance(store, ChunkStore)
        perm = store_permutation(self.store.n, self.store.chunk_rows,
                                 seed, shuffle=shuffle)
        self.layout: ShardLayout = nested_shard_layout(
            self.store.n, n_shards, seed=seed, perm=perm)
        self.n_shards = n_shards
        self.perm = self.layout.perm

    # -- KMeansShardedSource-parity surface ---------------------------------

    def n_valid(self, s: int) -> int:
        return int(self.layout.n_valid[s])

    def shard(self, s: int) -> np.ndarray:
        """Full storage slice of shard ``s`` (pads = copies of row 0)."""
        return self.block(np.asarray([s]), 0,
                          self.layout.rows_per_shard)[0]

    def shard_valid(self, s: int) -> np.ndarray:
        return self.shard(s)[: self.n_valid(s)]

    def global_prefix(self, b: int) -> np.ndarray:
        if b > self.store.n:
            raise ValueError(
                f"prefix size {b} exceeds the {self.store.n} real rows")
        return self.store.take(self.perm[:b])

    # -- streaming fetch (the engines' placement primitive) -----------------

    def block(self, shards: np.ndarray, lo: int, hi: int) -> np.ndarray:
        """(len(shards), hi-lo, d): storage rows [lo, hi) of each shard.

        Shard ``s`` storage row ``i`` holds shuffle position
        ``i * n_shards + s``; structural pads (positions >= n) map to
        store row 0, mirroring the in-memory engines' pad semantics.
        """
        shards = np.asarray(shards)
        pos = (np.arange(lo, hi)[:, None] * self.n_shards
               + shards[None, :]).ravel()
        orig = self.perm[pos]
        orig = np.where(orig < self.store.n, orig, 0)
        rows = self.store.take(orig)
        return np.ascontiguousarray(
            rows.reshape(hi - lo, len(shards), self.store.d)
            .transpose(1, 0, 2))

    def prefetch_positions(self, plo: int, phi: int) -> int:
        """Hint the store to warm the chunks covering shuffle positions
        [plo, phi), the next prefix extension, in the background."""
        if phi <= plo:
            return 0
        orig = self.perm[plo:min(phi, len(self.perm))]
        orig = orig[orig < self.store.n]
        if not orig.size:
            return 0
        cis = np.unique(orig // self.store.chunk_rows)
        return self.store.prefetch(cis.tolist())

    # -- lifecycle ----------------------------------------------------------

    @property
    def metrics(self):
        return self.store.metrics

    def close(self) -> None:
        if self._owns_store:
            self.store.close()

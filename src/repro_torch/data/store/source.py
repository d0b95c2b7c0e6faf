"""The store's row order (`store_permutation`) and dataset identity
(`dataset_fingerprint`).

Port of the single-process half of `repro/data/store/source.py`. The
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
equals ``fit(X[perm], shuffle=False)`` bit for bit.

`StoredShardSource`, the JAX package's per-shard view of a store, needs
the mesh engines' `data/pipeline.py::nested_shard_layout` and waits for
them (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

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

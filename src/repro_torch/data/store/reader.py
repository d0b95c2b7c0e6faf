"""`ChunkStore`: chunk-at-a-time reader over the chunked on-disk format.

Port of `repro/data/store/reader.py`.

Reads go chunk-at-a-time through a small LRU cache: the nested schedule's
disk access is an append-only frontier (see `source.store_permutation`),
so a handful of cached chunks turns the prefix extensions into about one
load of each chunk per full-data pass. An optional background prefetcher
warms the cache ahead of use.

Every load is counted (`metrics`), so a fit can report the bytes it read
against one pass.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, Union

import numpy as np

from repro_torch.data.store.writer import DATA_NAME, FORMAT, INDEX_NAME


@dataclasses.dataclass
class StoreMetrics:
    """Cumulative read accounting for one `ChunkStore` handle."""
    chunk_loads: int = 0      # chunks decoded off the mapping
    bytes_read: int = 0       # bytes those loads touched
    cache_hits: int = 0       # chunk requests served from the LRU cache
    rows_served: int = 0      # rows returned by rows()/take()
    prefetched: int = 0       # chunk loads issued by the prefetcher

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class ChunkStore:
    """Read handle on a store directory written by `writer.StoreWriter`.

    ``cache_chunks`` bounds host memory at
    ``cache_chunks * chunk_rows * d * itemsize`` plus the (lazily paged)
    mapping. ``verify=True`` checks each chunk's crc32 on load — cheap
    insurance for resumable long fits. ``prefetch_depth > 0`` starts a
    daemon thread that loads requested chunks ahead of use; it only ever
    warms the cache, so results are bit-for-bit identical with it on or
    off.
    """

    def __init__(self, path: Union[str, Path], *, cache_chunks: int = 8,
                 verify: bool = False, prefetch_depth: int = 0):
        self.path = Path(path)
        index_file = self.path / INDEX_NAME
        if not index_file.exists():
            raise FileNotFoundError(
                f"{self.path} is not a chunk store (no {INDEX_NAME}); "
                f"build one with repro_torch.data.store.writer")
        self.index = json.loads(index_file.read_text())
        if self.index.get("format") != FORMAT:
            raise ValueError(
                f"unsupported store format {self.index.get('format')!r} "
                f"at {self.path}; this reader speaks {FORMAT}")
        self.n = int(self.index["n"])
        self.d = int(self.index["d"])
        self.dtype = np.dtype(self.index["dtype"])
        self.chunk_rows = int(self.index["chunk_rows"])
        self.checksum = int(self.index["checksum"])
        self._chunks = self.index["chunks"]
        self.n_chunks = len(self._chunks)
        # pread-based loads (NOT a persistent memmap: mapped file pages
        # count toward the process RSS until the OS reclaims them, so a
        # memmap reader silently re-buffers the whole dataset in host
        # memory over a full pass — exactly what the store exists to
        # avoid; pread leaves the bytes in the kernel page cache)
        self._fd = os.open(self.path / self.index.get("data_file",
                                                      DATA_NAME),
                           os.O_RDONLY) if self.n else None
        self._row_bytes = self.d * self.dtype.itemsize
        self._verify = bool(verify)
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_chunks = max(1, int(cache_chunks))
        self._lock = threading.RLock()
        self.metrics = StoreMetrics()
        self._prefetch_q: "queue.Queue[int] | None" = None
        self._prefetcher = None
        if prefetch_depth > 0:
            self._prefetch_q = queue.Queue(maxsize=int(prefetch_depth))
            self._prefetcher = threading.Thread(
                target=self._prefetch_loop, daemon=True,
                name=f"chunkstore-prefetch:{self.path.name}")
            self._prefetcher.start()

    # -- chunk access -------------------------------------------------------

    def chunk(self, ci: int) -> np.ndarray:
        """Chunk ``ci`` as a host array (LRU-cached; do not mutate)."""
        if not 0 <= ci < self.n_chunks:
            raise IndexError(f"chunk {ci} out of range "
                             f"[0, {self.n_chunks})")
        with self._lock:
            hit = self._cache.get(ci)
            if hit is not None:
                self._cache.move_to_end(ci)
                self.metrics.cache_hits += 1
                return hit
            arr = self._load(ci)
            self._cache[ci] = arr
            while len(self._cache) > self._cache_chunks:
                self._cache.popitem(last=False)
            return arr

    def _load(self, ci: int) -> np.ndarray:
        meta = self._chunks[ci]
        want = meta["rows"] * self._row_bytes
        buf = os.pread(self._fd, want,
                       ci * self.chunk_rows * self._row_bytes)
        if len(buf) != want:
            raise IOError(f"chunk {ci} of {self.path} is corrupt: "
                          f"short read ({len(buf)} of {want} bytes)")
        arr = np.frombuffer(buf, self.dtype).reshape(meta["rows"], self.d)
        if self._verify:
            crc = zlib.crc32(buf)
            if crc != meta["crc"]:
                raise IOError(
                    f"chunk {ci} of {self.path} is corrupt: crc "
                    f"{crc} != recorded {meta['crc']}")
        self.metrics.chunk_loads += 1
        self.metrics.bytes_read += arr.nbytes
        return arr

    # -- row access ---------------------------------------------------------

    def rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) in store order (crosses chunk boundaries)."""
        if not 0 <= lo <= hi <= self.n:
            raise IndexError(f"rows [{lo}, {hi}) out of [0, {self.n}]")
        out = np.empty((hi - lo, self.d), self.dtype)
        at = lo
        while at < hi:
            ci = at // self.chunk_rows
            base = ci * self.chunk_rows
            stop = min(hi, base + self._chunks[ci]["rows"])
            out[at - lo:stop - lo] = self.chunk(ci)[at - base:stop - base]
            at = stop
        self.metrics.rows_served += out.shape[0]
        return out

    def take(self, idx: np.ndarray) -> np.ndarray:
        """Rows at arbitrary store indices, loaded chunk-by-chunk."""
        idx = np.asarray(idx)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(
                f"take indices out of [0, {self.n}): "
                f"[{idx.min()}, {idx.max()}]")
        out = np.empty((idx.size, self.d), self.dtype)
        ci_of = idx // self.chunk_rows
        for ci in np.unique(ci_of):
            m = ci_of == ci
            out[m] = self.chunk(int(ci))[idx[m] - int(ci) * self.chunk_rows]
        self.metrics.rows_served += out.shape[0]
        return out

    # -- prefetch -----------------------------------------------------------

    def prefetch(self, cis: Iterable[int]) -> int:
        """Request background loads; drops requests beyond the queue
        bound (prefetch is a hint, never a dependency). Returns how many
        were enqueued; 0 when no prefetcher is running."""
        if self._prefetch_q is None:
            return 0
        sent = 0
        for ci in cis:
            try:
                self._prefetch_q.put_nowait(int(ci))
                sent += 1
            except queue.Full:
                break
        return sent

    def _prefetch_loop(self) -> None:
        while True:
            ci = self._prefetch_q.get()
            if ci < 0:
                return
            with self._lock:
                cached = ci in self._cache
            if not cached:
                try:
                    self.chunk(ci)
                    with self._lock:
                        self.metrics.prefetched += 1
                except Exception:
                    pass        # the foreground read will raise properly

    # -- lifecycle ----------------------------------------------------------

    def fingerprint(self) -> Dict[str, object]:
        """Content identity for checkpoint manifests (see
        `source.dataset_fingerprint`): shape, dtype and the store-level
        checksum, which covers every chunk's crc32."""
        return {"kind": "store", "n": self.n, "d": self.d,
                "dtype": self.dtype.name, "crc": self.checksum}

    def close(self) -> None:
        if self._prefetch_q is not None:
            self._prefetch_q.put(-1)
            self._prefetcher.join(timeout=5)
            self._prefetch_q = None
        self._cache.clear()
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "ChunkStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"ChunkStore({str(self.path)!r}, n={self.n}, d={self.d}, "
                f"dtype={self.dtype.name}, chunks={self.n_chunks}x"
                f"{self.chunk_rows})")

"""Chunked on-disk dataset writer (+ the `python -m` store-building CLI).

Port of `repro/data/store/writer.py`; the format is the same byte for
byte, so a store written by either package opens in the other:

    python -m repro_torch.data.store.writer OUT --from-npy X.npy
    python -m repro_torch.data.store.writer OUT --synthetic blobs --n N --dim D

Format (one directory):

    data.bin     row-major raw bytes, chunk after chunk
    index.json   {"format", "n", "d", "dtype", "chunk_rows", "checksum",
                  "chunks": [{"offset", "rows", "crc"}, ...]}

All chunks hold exactly ``chunk_rows`` rows except a possibly-ragged
tail. Each chunk carries a crc32; the store-level ``checksum`` covers
the shape header plus every chunk crc, so it fingerprints the full
dataset content without a second pass over the bytes. The index is
written atomically (tmp + rename) at `close`, so a crashed writer never
leaves a readable-but-truncated store behind.

The writer is append-only and buffers at most one chunk: building a
store from a generator streams at O(chunk_rows * d) host memory no
matter how large the dataset.
"""
from __future__ import annotations

import argparse
import json
import os
import zlib
from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np

INDEX_NAME = "index.json"
DATA_NAME = "data.bin"
FORMAT = "repro.chunkstore/1"


def _header_checksum(n: int, d: int, dtype: str, chunk_rows: int,
                     chunk_crcs: Iterable[int]) -> int:
    payload = json.dumps([n, d, dtype, chunk_rows, list(chunk_crcs)])
    return zlib.crc32(payload.encode())


class StoreWriter:
    """Append-only chunked writer; context manager closing the index.

        with StoreWriter(path, d=64, chunk_rows=65536) as w:
            for block in blocks:        # any row counts, any order
                w.append(block)
        store = ChunkStore(path)
    """

    def __init__(self, path: Union[str, Path], *, d: int,
                 dtype: Union[str, np.dtype] = np.float32,
                 chunk_rows: int = 65536):
        if d < 1:
            raise ValueError(f"d must be >= 1, got {d}")
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.d = int(d)
        self.dtype = np.dtype(dtype)
        self.chunk_rows = int(chunk_rows)
        self._f = open(self.path / DATA_NAME, "wb")
        self._buf: list[np.ndarray] = []
        self._buf_rows = 0
        self._chunks: list[dict] = []
        self._offset = 0
        self._n = 0
        self._closed = False

    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=self.dtype)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(
                f"append expects (m, {self.d}) rows, got {rows.shape}")
        self._buf.append(rows)
        self._buf_rows += rows.shape[0]
        while self._buf_rows >= self.chunk_rows:
            block = np.concatenate(self._buf, axis=0)
            self._flush_chunk(block[:self.chunk_rows])
            rest = block[self.chunk_rows:]
            self._buf = [rest] if rest.shape[0] else []
            self._buf_rows = rest.shape[0]

    def _flush_chunk(self, arr: np.ndarray) -> None:
        raw = arr.tobytes()
        self._f.write(raw)
        self._chunks.append({"offset": self._offset, "rows": arr.shape[0],
                             "crc": zlib.crc32(raw)})
        self._offset += len(raw)
        self._n += arr.shape[0]

    def close(self) -> dict:
        """Flush the ragged tail and atomically publish the index."""
        if self._closed:
            return self._index
        if self._buf_rows:
            self._flush_chunk(np.concatenate(self._buf, axis=0))
            self._buf, self._buf_rows = [], 0
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._index = {
            "format": FORMAT,
            "n": self._n, "d": self.d, "dtype": self.dtype.name,
            "chunk_rows": self.chunk_rows, "data_file": DATA_NAME,
            "checksum": _header_checksum(
                self._n, self.d, self.dtype.name, self.chunk_rows,
                (c["crc"] for c in self._chunks)),
            "chunks": self._chunks,
        }
        tmp = self.path / (INDEX_NAME + ".tmp")
        tmp.write_text(json.dumps(self._index))
        os.replace(tmp, self.path / INDEX_NAME)
        self._closed = True
        return self._index

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:                        # crashed mid-write: no index => no store
            self._f.close()


def write_store(path: Union[str, Path], X: np.ndarray, *,
                chunk_rows: int = 65536,
                dtype: Optional[Union[str, np.dtype]] = None) -> Path:
    """One-call store build from an in-memory (or memmapped) array."""
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"write_store expects a 2-D array, got {X.shape}")
    with StoreWriter(path, d=X.shape[1], dtype=dtype or X.dtype,
                     chunk_rows=chunk_rows) as w:
        for lo in range(0, X.shape[0], chunk_rows):
            w.append(X[lo:lo + chunk_rows])
    return Path(path)


# --------------------------------------------------------------------------
# synthetic streaming sources (benchmarks + CLI)
# --------------------------------------------------------------------------

def blob_rows(n: int, *, dim: int, classes: int = 50, seed: int = 0,
              spread: float = 5.0, block: int = 0) -> np.ndarray:
    """One deterministic block of the infinite gaussian-blob stream.

    The mixture centers depend only on ``seed``; the samples of block
    ``i`` depend on ``(seed, i)`` — so a store of any size can be
    generated block-by-block at O(block) memory, and a validation set is
    just blocks from a disjoint index range.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)).astype(np.float32) * spread
    brng = np.random.default_rng((seed, block))
    cls = brng.integers(0, classes, n)
    return (centers[cls]
            + brng.normal(size=(n, dim)).astype(np.float32)
            ).astype(np.float32)


def write_synthetic_store(path: Union[str, Path], *, n: int, dim: int,
                          classes: int = 50, seed: int = 0,
                          spread: float = 5.0,
                          chunk_rows: int = 65536) -> Path:
    """Stream a gaussian-blob dataset of any size straight to disk."""
    with StoreWriter(path, d=dim, chunk_rows=chunk_rows) as w:
        block = 0
        done = 0
        while done < n:
            m = min(chunk_rows, n - done)
            w.append(blob_rows(m, dim=dim, classes=classes, seed=seed,
                               spread=spread, block=block))
            done += m
            block += 1
    return Path(path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Build a chunked dataset store "
                    "(repro.chunkstore/1) on disk")
    ap.add_argument("out", help="store directory to create")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-npy", metavar="FILE",
                     help="convert a .npy array (memory-mapped: the "
                          "array is never loaded whole)")
    src.add_argument("--synthetic", choices=("blobs",),
                     help="stream a synthetic dataset (with --n/--dim)")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="rows for --synthetic")
    ap.add_argument("--dim", type=int, default=64,
                    help="columns for --synthetic")
    ap.add_argument("--classes", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-rows", type=int, default=65536)
    ap.add_argument("--dtype", default=None,
                    help="cast rows to this dtype (default: keep)")
    args = ap.parse_args(argv)

    if args.from_npy:
        X = np.load(args.from_npy, mmap_mode="r")
        out = write_store(args.out, X, chunk_rows=args.chunk_rows,
                          dtype=args.dtype)
    else:
        out = write_synthetic_store(
            args.out, n=args.n, dim=args.dim, classes=args.classes,
            seed=args.seed, chunk_rows=args.chunk_rows)
    idx = json.loads((out / INDEX_NAME).read_text())
    print(f"wrote {idx['n']} x {idx['d']} {idx['dtype']} rows in "
          f"{len(idx['chunks'])} chunks of {idx['chunk_rows']} to {out} "
          f"(checksum {idx['checksum']})")


if __name__ == "__main__":
    main()

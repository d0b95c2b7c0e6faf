"""Data pipelines: nested-prefix k-means sharding + LM token batches.

Port of `repro/data/pipeline.py` (pure numpy, a copy and not an import).

`nested_shard_layout` is THE host-side description of how the mesh
engines place points: shuffle, structural tail padding to a multiple of
the shard count, and the interleave that makes the union of per-shard
prefixes equal the global shuffle prefix.
`repro_torch.api.engines.mesh._MeshRun` and `KMeansShardedSource` both
build on it, so the streaming source and the device placement can never
drift apart.

`LMBatches`: deterministic, seekable token batches (``state == (step,)``),
so a restarted trainer resumes mid-epoch bit-identically.

`KMeansShardedSource`: the nested-batch schedule needs each shard to
hold a contiguous slice whose prefix-union equals the global shuffle
prefix. Points arrive in shuffle order, are dealt round-robin to the
shards, and each shard appends, so shard prefixes always reconstruct the
global prefix exactly. When ``n % n_shards != 0`` the source pads with
structural tail rows exactly like the mesh engine: pads sit at the END
of the shuffle, land on the tail storage row of the high shards, and
each shard's real rows stay prefix-contiguous with a per-shard
``n_valid`` count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data import synthetic


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """How ``n_real`` rows land on ``n_shards`` nested-prefix shards.

    Attributes:
      n_real     caller's dataset size (structural pads excluded).
      n_shards   data shards.
      n_storage  padded total rows; always a multiple of ``n_shards``.
      perm       (n_storage,) global shuffle: shuffle position p holds
                 data row ``perm[p]``; positions >= n_real are the
                 identity tail of structural pads.
      pos        (n_storage,) inverse interleave: storage row
                 ``shard * (n_storage // n_shards) + i`` holds shuffle
                 position ``pos[...] == i * n_shards + shard``.
      n_valid    (n_shards,) real rows on each shard; real rows are the
                 prefix of the shard's storage slice.
    """
    n_real: int
    n_shards: int
    n_storage: int
    perm: np.ndarray
    pos: np.ndarray
    n_valid: np.ndarray

    @property
    def rows_per_shard(self) -> int:
        return self.n_storage // self.n_shards

    def shard_positions(self, s: int) -> np.ndarray:
        """Global-shuffle positions held by shard ``s``, storage order."""
        return np.arange(s, self.n_storage, self.n_shards)

    def orig_index(self) -> np.ndarray:
        """(n_storage,) original data row at each storage row (-1 = pad)."""
        orig = self.perm[self.pos]
        return np.where(orig < self.n_real, orig, -1)

    def shard_orig_rows(self, s: int) -> np.ndarray:
        """(rows_per_shard,) original data row at each storage row OF
        SHARD ``s``, in storage order (-1 = structural pad).

        This is the per-rank placement primitive: a rank materialises
        only its own shard's rows, ``X[shard_orig_rows(s)]`` with pads
        mapped to ``X[0]``, never the padded permutation of the whole
        dataset.
        """
        r = self.rows_per_shard
        return self.orig_index()[s * r:(s + 1) * r]


def nested_shard_layout(n_real: int, n_shards: int, *, seed: int = 0,
                        shuffle: bool = True,
                        perm: Optional[np.ndarray] = None) -> ShardLayout:
    """The mesh engines' data placement, as pure host-side index math.

    Shuffle positions are dealt round-robin: shard ``s`` holds positions
    ``s::n_shards``, so the union of per-shard prefixes of size
    ``b // n_shards`` IS the global shuffle prefix of size ``b``.
    Structural pads occupy positions ``n_real..n_storage-1`` (the end of
    the shuffle), hence the LAST storage row of the high shards; every
    shard's real rows stay prefix-contiguous and are counted by
    ``n_valid``.

    ``perm`` overrides the shuffle with a caller-supplied permutation of
    the ``n_real`` rows (the identity pad tail is appended here). The
    out-of-core `StoredShardSource` uses this to install its
    chunk-blocked shuffle while inheriting all pad/interleave semantics.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    pad = -n_real % n_shards
    n_storage = n_real + pad
    if perm is not None:
        perm = np.asarray(perm)
        if perm.shape != (n_real,):
            raise ValueError(
                f"perm must permute the {n_real} real rows, got shape "
                f"{perm.shape}")
        perm = np.concatenate([perm, np.arange(n_real, n_storage)])
    else:
        rng = np.random.default_rng(seed)
        perm = (np.concatenate([rng.permutation(n_real),
                                np.arange(n_real, n_storage)])
                if shuffle else np.arange(n_storage))
    pos = np.arange(n_storage).reshape(n_storage // n_shards, n_shards) \
        .T.ravel()
    n_valid = np.array([len(range(s, n_real, n_shards))
                        for s in range(n_shards)])
    return ShardLayout(n_real=n_real, n_shards=n_shards,
                       n_storage=n_storage, perm=perm, pos=pos,
                       n_valid=n_valid)


@dataclasses.dataclass
class KMeansShardedSource:
    """Round-robin shard assignment preserving the nested-prefix property.

    ``n % n_shards != 0`` is handled with the mesh engine's structural-
    pad semantics: `shard(s)` returns the full storage slice (pads are
    copies of ``X[0]`` at the tail), and ``n_valid(s)`` says how many
    leading rows are real: the same per-shard mask `_MeshRun` applies
    inside the sharded round.
    """
    X: np.ndarray
    n_shards: int
    seed: int = 0
    perm_override: Optional[np.ndarray] = None

    def __post_init__(self):
        n = self.X.shape[0]
        self.layout = nested_shard_layout(n, self.n_shards, seed=self.seed,
                                          perm=self.perm_override)
        pad = self.layout.n_storage - n
        self._Xp = (np.concatenate([self.X, np.repeat(self.X[:1], pad,
                                                      axis=0)])
                    if pad else self.X)
        self.perm = self.layout.perm

    def n_valid(self, s: int) -> int:
        """Real (non-pad) rows on shard ``s``; always a prefix."""
        return int(self.layout.n_valid[s])

    def shard(self, s: int) -> np.ndarray:
        """Shard s holds global-shuffle positions s::n_shards, in order.

        Rows past ``n_valid(s)`` are structural pads (copies of X[0]).
        """
        return self._Xp[self.perm[s::self.n_shards]]

    def shard_valid(self, s: int) -> np.ndarray:
        """Only the real rows of shard ``s`` (pads stripped)."""
        return self.shard(s)[: self.n_valid(s)]

    def global_prefix(self, b: int) -> np.ndarray:
        if b > self.X.shape[0]:
            raise ValueError(
                f"prefix size {b} exceeds the {self.X.shape[0]} real rows")
        return self.X[self.perm[:b]]


class LMBatches:
    """Seekable synthetic LM batches: (tokens, labels) of (B, S) int32."""

    def __init__(self, *, vocab: int, batch: int, seq: int,
                 n_tokens: int = 2_000_000, seed: int = 0):
        self.tokens = synthetic.lm_tokens(n_tokens, vocab=vocab, seed=seed)
        self.batch, self.seq = batch, seq
        self.per_step = batch * (seq + 1)
        self.n_steps = len(self.tokens) // self.per_step

    def __len__(self) -> int:
        return self.n_steps

    def at(self, step: int) -> Dict[str, np.ndarray]:
        i = (step % self.n_steps) * self.per_step
        chunk = self.tokens[i: i + self.per_step].reshape(
            self.batch, self.seq + 1)
        return {"tokens": chunk[:, :-1].astype(np.int32),
                "labels": chunk[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.at(step)
            step += 1

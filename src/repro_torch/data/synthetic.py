"""Synthetic stand-ins for the paper's datasets.

The port's own copy of `repro/data/synthetic.py` (`infmnist_like`,
`rcv1_like`, `gaussian_blobs`, `lm_tokens`), so the port and
`chip_smoke.py` make data without importing the JAX package. Same seeds,
same numbers.

* ``infmnist_like``  — dense 784-d: k* prototype "digits" (smooth random
  blobs) + per-sample smooth deformation fields + pixel noise, matching
  the generative recipe of Loosli et al.'s infinite-MNIST.
* ``rcv1_like``      — tf-idf-ish documents: Zipfian feature popularity,
  log-normal document lengths, l2-normalised rows, densified (the
  paper's RCV1 at d = 2048, as `configs.kmeans_workloads.KMEANS_RCV1`).
* ``gaussian_blobs`` — a simple mixture for tests.
* ``lm_tokens``      — a Zipf token stream for the LM trainer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _prototypes(rng: np.random.Generator, k: int, side: int = 28
                ) -> np.ndarray:
    """Smooth random 'digit' prototypes on a side x side grid."""
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    protos = np.zeros((k, side, side), np.float32)
    for i in range(k):
        n_strokes = rng.integers(2, 5)
        img = np.zeros((side, side), np.float32)
        for _ in range(n_strokes):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sx, sy = rng.uniform(0.05, 0.25, 2)
            th = rng.uniform(0, np.pi)
            dx, dy = xx - cx, yy - cy
            rx = dx * np.cos(th) + dy * np.sin(th)
            ry = -dx * np.sin(th) + dy * np.cos(th)
            img += np.exp(-(rx ** 2 / (2 * sx ** 2)
                            + ry ** 2 / (2 * sy ** 2)))
        protos[i] = img / max(img.max(), 1e-6)
    return protos


def infmnist_like(n: int, *, n_classes: int = 10, seed: int = 0,
                  side: int = 28, deform: float = 1.5,
                  noise: float = 0.05, chunk: int = 50_000) -> np.ndarray:
    """(n, side*side) f32 deformed-prototype images in [0, 1]."""
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng, n_classes, side)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    out = np.empty((n, side * side), np.float32)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        m = hi - lo
        cls = rng.integers(0, n_classes, m)
        # smooth per-sample deformation: low-freq sin/cos displacement
        ph = rng.uniform(0, 2 * np.pi, (m, 4)).astype(np.float32)
        amp = rng.uniform(0, deform, (m, 2)).astype(np.float32)
        fx = (xx[None] + amp[:, 0, None, None]
              * np.sin(yy[None] / side * 2 * np.pi + ph[:, 0, None, None]))
        fy = (yy[None] + amp[:, 1, None, None]
              * np.sin(xx[None] / side * 2 * np.pi + ph[:, 1, None, None]))
        xi = np.clip(fx, 0, side - 1).astype(np.int32)
        yi = np.clip(fy, 0, side - 1).astype(np.int32)
        img = protos[cls][np.arange(m)[:, None, None], yi, xi]
        img += noise * rng.standard_normal((m, side, side)).astype(
            np.float32)
        out[lo:hi] = np.clip(img, 0, 1).reshape(m, -1)
    return out


def rcv1_like(n: int, *, dim: int = 2048, avg_nnz: int = 60,
              n_topics: int = 50, seed: int = 0,
              chunk: int = 50_000) -> np.ndarray:
    """(n, dim) f32 l2-normalised tf-idf-like rows (densified).

    Each document mixes a topic's Zipfian feature distribution with a
    global background, log-normal lengths — clusterable structure similar
    in spirit to RCV1's. One ``rng.choice`` a row, in Python.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, dim + 1, dtype=np.float64)
    background = 1.0 / ranks ** 1.1
    topic_feats = np.stack([
        rng.permutation(dim)[:dim] for _ in range(n_topics)])
    out = np.empty((n, dim), np.float32)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        m = hi - lo
        topics = rng.integers(0, n_topics, m)
        lengths = np.maximum(
            5, rng.lognormal(np.log(avg_nnz), 0.6, m)).astype(np.int32)
        block = np.zeros((m, dim), np.float32)
        for i in range(m):
            t = topics[i]
            probs = background.copy()
            boost = topic_feats[t][: dim // 10]
            probs[boost] *= 20.0
            probs /= probs.sum()
            idx = rng.choice(dim, size=min(int(lengths[i]), dim),
                             replace=False, p=probs)
            tf = 1.0 + rng.standard_exponential(len(idx))
            block[i, idx] = tf.astype(np.float32)
        norms = np.linalg.norm(block, axis=1, keepdims=True)
        out[lo:hi] = block / np.maximum(norms, 1e-9)
    return out


def gaussian_blobs(n: int, *, k: int = 50, dim: int = 64,
                   spread: float = 5.0, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Simple mixture (data, true_centers) for tests."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)).astype(np.float32) * spread
    X = (centers[rng.integers(0, k, n)]
         + rng.normal(size=(n, dim)).astype(np.float32))
    return X.astype(np.float32), centers


def lm_tokens(n_tokens: int, *, vocab: int, seed: int = 0,
              repeat_p: float = 0.3) -> np.ndarray:
    """Zipf unigram stream with short-range repetition (compressible)."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, n_tokens).astype(np.int64)
    toks = (base % (vocab - 2)) + 1
    rep = rng.random(n_tokens) < repeat_p
    idx = np.maximum(np.arange(n_tokens) - rng.integers(1, 32, n_tokens), 0)
    toks[rep] = toks[idx[rep]]
    return toks.astype(np.int32)

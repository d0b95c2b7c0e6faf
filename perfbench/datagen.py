"""Inputs made on the device from the run's seed.

Torch copies of two recipes, vectorised so that a run's set-up makes its
data in a few large calls on the card:

* ``infmnist_like``: the deformed-prototype recipe of infinite MNIST
  (Loosli et al.) as the port's ``data/synthetic.py`` states it: smooth
  random "digit" prototypes of 2-4 Gaussian strokes on a 28 x 28 grid,
  each sample a prototype under a low-frequency sine displacement field,
  plus pixel noise, clipped to [0, 1]. The validation rows follow the
  training rows from the same prototypes.
* ``blobs``: Gaussian blobs, centres N(0, spread^2), unit noise; the
  centres, then each row's blob, then the noise, to which each row's
  centre is added in place, so the peak stays near the bytes of X.

The draws are torch's, not numpy's: the same seed gives the same rows on
any run of this harness, and other rows than the port's numpy recipe.
A configuration whose ``data`` group gives its own ``seed`` is one fixed
data set, as the paper's infMNIST is: its rows are the same in every run,
and the run's seed changes only what the traffic draws.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

#: rows made per call, which bounds the temporaries
CHUNK_ROWS = 1 << 16


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def prototypes(g: torch.Generator, n_classes: int, side: int,
               device) -> torch.Tensor:
    """(n_classes, side, side) smooth prototypes in [0, 1]: 2 to 4 strokes
    a class, each an oriented Gaussian."""
    max_strokes = 4
    n_strokes = torch.randint(2, max_strokes + 1, (n_classes,), generator=g,
                              device=device)
    shape = (n_classes, max_strokes)
    cx = _uniform(g, shape, 0.2, 0.8, device)
    cy = _uniform(g, shape, 0.2, 0.8, device)
    sx = _uniform(g, shape, 0.05, 0.25, device)
    sy = _uniform(g, shape, 0.05, 0.25, device)
    th = _uniform(g, shape, 0.0, math.pi, device)
    grid = torch.arange(side, dtype=torch.float32, device=device) / side
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    dx = xx[None, None] - cx[..., None, None]
    dy = yy[None, None] - cy[..., None, None]
    cos, sin = torch.cos(th)[..., None, None], torch.sin(th)[..., None, None]
    rx = dx * cos + dy * sin
    ry = -dx * sin + dy * cos
    strokes = torch.exp(-(rx ** 2 / (2 * sx[..., None, None] ** 2)
                          + ry ** 2 / (2 * sy[..., None, None] ** 2)))
    live = (torch.arange(max_strokes, device=device)[None]
            < n_strokes[:, None]).float()
    img = (strokes * live[..., None, None]).sum(1)
    peak = img.flatten(1).max(1).values.clamp_min(1e-6)
    return img / peak[:, None, None]


def deformed_rows(g: torch.Generator, protos: torch.Tensor, n: int, *,
                  deform: float, noise: float, device) -> torch.Tensor:
    """(n, side * side) f32 samples of ``protos``: a class, a sine
    displacement of the sampling grid (phase and amplitude a sample and
    an axis), nearest-pixel lookup, Gaussian pixel noise, clipped."""
    n_classes, side, _ = protos.shape
    flat = protos.reshape(-1)
    grid = torch.arange(side, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    out = torch.empty((n, side * side), dtype=torch.float32, device=device)
    for lo in range(0, n, CHUNK_ROWS):
        m = min(n, lo + CHUNK_ROWS) - lo
        cls = torch.randint(0, n_classes, (m,), generator=g, device=device)
        ph = _uniform(g, (m, 2), 0.0, 2 * math.pi, device)
        amp = _uniform(g, (m, 2), 0.0, deform, device)
        fx = xx[None] + amp[:, 0, None, None] * torch.sin(
            yy[None] / side * 2 * math.pi + ph[:, 0, None, None])
        fy = yy[None] + amp[:, 1, None, None] * torch.sin(
            xx[None] / side * 2 * math.pi + ph[:, 1, None, None])
        xi = fx.clamp(0, side - 1).to(torch.int64)
        yi = fy.clamp(0, side - 1).to(torch.int64)
        idx = cls[:, None, None] * side * side + yi * side + xi
        img = flat[idx]
        img += noise * torch.randn((m, side, side), generator=g,
                                   device=device)
        out[lo:lo + m] = img.clamp_(0.0, 1.0).reshape(m, -1)
    return out


def infmnist_like(g: torch.Generator, config: dict, device, *,
                  n_classes: int, deform: float, noise: float
                  ) -> Dict[str, torch.Tensor]:
    """{"X": (n_points, dim), "X_val": (n_val, dim)} from one set of
    prototypes; ``dim`` is a square number of pixels."""
    n, n_val, dim = config["n_points"], config["n_val"], config["dim"]
    side = math.isqrt(dim)
    if side * side != dim:
        raise ValueError(f"infmnist_like needs a square dim, got {dim}")
    protos = prototypes(g, n_classes, side, device)
    kw = dict(deform=deform, noise=noise, device=device)
    return {"X": deformed_rows(g, protos, n, **kw),
            "X_val": deformed_rows(g, protos, n_val, **kw)}


def blob_rows(g: torch.Generator, centres: torch.Tensor, n: int,
              device) -> torch.Tensor:
    """(n, d) rows, each a uniformly drawn centre plus unit noise."""
    labels = torch.randint(0, centres.shape[0], (n,), generator=g,
                           device=device)
    X = torch.randn((n, centres.shape[1]), generator=g, device=device)
    for lo in range(0, n, CHUNK_ROWS):
        X[lo:lo + CHUNK_ROWS] += centres[labels[lo:lo + CHUNK_ROWS]]
    return X


def blobs(g: torch.Generator, config: dict, device, *, centres: int,
          spread: float, codebook: int) -> Dict[str, torch.Tensor]:
    """{"X": (n_points, dim), "codebook": (codebook, dim)}: rows of
    ``centres`` blobs, and ``codebook`` further rows of the same mixture
    drawn after them (a codebook of sampled points, as a fit starts
    from)."""
    mu = torch.randn((centres, config["dim"]), generator=g,
                     device=device) * spread
    X = blob_rows(g, mu, config["n_points"], device)
    out = {"X": X}
    if codebook:
        out["codebook"] = blob_rows(g, mu, codebook, device)
    return out


#: recipe name in a configuration's ``data`` group -> its maker
RECIPES = {"infmnist_like": infmnist_like, "blobs": blobs}


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The inputs of ``config`` for the run's ``seed``, on ``device``: its
    ``data`` group names the recipe, gives its parameters and may fix the
    data's own seed."""
    params = dict(config["data"])
    recipe = RECIPES[params.pop("recipe")]
    seed = params.pop("seed", seed)
    return recipe(generator(seed, device), config, device, **params)

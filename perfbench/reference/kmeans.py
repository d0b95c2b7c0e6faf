"""Plain k-means reference: what a round, an assignment and a fit's
result must be, in float64, and the same arithmetic in TF32 for the
control.

Plain PyTorch, in row blocks so that it fits beside the inputs on one
card. It imports nothing of the program and takes nothing the program
made: the harness hands it the inputs it handed the program (X, the
first centroids, the codebook) and the program's outputs, which it reads
only to judge them.

Two roles:

* the judge (`judge_labels`, `judge_round`, `judge_fit`): every distance
  in float64, so that its own error (~1e-16 of the scale) is far below
  any the program may make;
* the control (`assign`, `dp_round` at ``precision="tf32"``): the same
  reference put in the program's place at the precision just below the
  configuration's float32: every product's inputs rounded to TF32 (10
  mantissa bits, round to nearest, ties away, as the tensor cores'
  conversion), products accumulated in f32 with TF32 off. The rounding
  is done here, not by the card's TF32 switch, so the control is the
  same on any device.

A number is a share of a scale, so that one limit holds at any width:
a row's distances are judged against ``|x|^2 + max_j |c_j|^2``, the
size of the terms whose difference a squared distance is.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

#: rows a block of the judge or the control holds
BLOCK_ROWS = 1 << 15
PRECISIONS = ("float64", "tf32")


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` with its mantissa rounded to TF32's 10 bits."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return t.double()
    if precision == "tf32":
        return tf32(t)
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def _norms(t: torch.Tensor, precision: str) -> torch.Tensor:
    t = t.double() if precision == "float64" else t.float()
    return (t * t).sum(1)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b.T with both operands at ``precision``; in f32 with the
    card's TF32 switch off, so the rounding is only the operands'."""
    a, b = _operand(a, precision), _operand(b, precision)
    if a.dtype == torch.float64 or a.device.type != "cuda":
        return a @ b.T
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def assign(X: torch.Tensor, C: torch.Tensor, precision: str):
    """(labels int32, d1^2, d2^2): each row's nearest and second-nearest
    centroid by ``|x|^2 - 2 x.c + |c|^2``, the lower index winning a tie."""
    cn = _norms(C, precision)
    n = X.shape[0]
    dt = torch.float64 if precision == "float64" else torch.float32
    a = torch.empty(n, dtype=torch.int32, device=X.device)
    d1 = torch.empty(n, dtype=dt, device=X.device)
    d2 = torch.empty(n, dtype=dt, device=X.device)
    for lo in range(0, n, BLOCK_ROWS):
        x = X[lo:lo + BLOCK_ROWS]
        pd = _mm(x, C, precision).mul_(-2.0).add_(cn).add_(
            _norms(x, precision)[:, None]).clamp_min_(0.0)
        two = torch.topk(pd, min(2, C.shape[0]), dim=1, largest=False)
        first = torch.argmin(pd, dim=1)
        a[lo:lo + x.shape[0]] = first.to(torch.int32)
        d1[lo:lo + x.shape[0]] = two.values[:, 0]
        d2[lo:lo + x.shape[0]] = (two.values[:, 1] if C.shape[0] > 1
                                  else float("inf"))
    return a, d1, d2


def sums(X: torch.Tensor, labels: torch.Tensor, k: int, precision: str):
    """(S (k, d), v (k,)): the rows of each label summed, as one-hot
    products at ``precision``; the counts exact."""
    dt = torch.float64 if precision == "float64" else torch.float32
    S = torch.zeros((k, X.shape[1]), dtype=dt, device=X.device)
    v = torch.zeros(k, dtype=torch.float64, device=X.device)
    for lo in range(0, X.shape[0], BLOCK_ROWS):
        x = X[lo:lo + BLOCK_ROWS]
        lab = labels[lo:lo + BLOCK_ROWS].long()
        hot = torch.zeros((k, x.shape[0]), dtype=torch.float32,
                          device=X.device)
        hot[lab, torch.arange(x.shape[0], device=X.device)] = 1.0
        S += _mm(hot, x.T, precision).to(dt)
        v += torch.bincount(lab, minlength=k).double()
    return S, v


def means(S: torch.Tensor, v: torch.Tensor, C_prev: torch.Tensor):
    """S / v where a cluster has members, else the previous centroid."""
    safe = v.clamp_min(1.0).to(S.dtype)[:, None]
    return torch.where((v > 0)[:, None], S / safe, C_prev.to(S.dtype))


def dp_round(X: torch.Tensor, C: torch.Tensor, precision: str) -> dict:
    """One data-parallel Lloyd round in the program's place: the outputs
    of the program's round that the judge reads (labels, euclidean
    distance, S, v and the next C), computed at ``precision``."""
    a, d1, _ = assign(X, C, precision)
    S, v = sums(X, a, C.shape[0], precision)
    return {"a": a, "d": d1.clamp_min(0).sqrt().float(), "S": S.float(),
            "v": v.float(), "C": means(S, v, C).float()}


# ------------------------------------------------------------------ judge

def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want|_F / |want|_F in float64 (0 where both are 0)."""
    want = want.double()
    num = float(torch.linalg.norm(got.double() - want))
    den = float(torch.linalg.norm(want))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def judge_labels(X: torch.Tensor, C: torch.Tensor, labels: torch.Tensor,
                 d: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """How far each row's label is from its nearest centroid in float64,
    and (with ``d``, the program's euclidean distance to it) how far that
    distance is from the float64 one, both over the row's scale; the
    largest over the rows. A label outside [0, k) reads +inf."""
    k = C.shape[0]
    C64 = C.double()
    cn = (C64 * C64).sum(1)
    cmax = float(cn.max())
    gap = err = 0.0
    for lo in range(0, X.shape[0], BLOCK_ROWS):
        x = X[lo:lo + BLOCK_ROWS].double()
        lab = labels[lo:lo + BLOCK_ROWS].long()
        if bool(((lab < 0) | (lab >= k)).any()):
            return {"label_gap": float("inf"), "dist_err": float("inf")}
        xn = (x * x).sum(1)
        scale = xn + cmax
        own = ((x - C64[lab]) ** 2).sum(1)
        best = torch.addmm(cn, x, C64.T, alpha=-2.0).add_(
            xn[:, None]).min(1).values.clamp_min(0.0)
        gap = max(gap, float(((own - best).clamp_min(0.0) / scale).max()))
        if d is not None:
            got = d[lo:lo + BLOCK_ROWS].double() ** 2
            err = max(err, float(((got - own).abs() / scale).max()))
        del x, own, best
    out = {"label_gap": gap}
    if d is not None:
        out["dist_err"] = err
    return out


def judge_round(X: torch.Tensor, C_in: torch.Tensor, out: dict
                ) -> Dict[str, float]:
    """A data-parallel round's outputs (``out``: a, d, S, v, C) against
    float64: its labels and distances (`judge_labels`), its sums against
    the float64 sums of the rows by its own labels, its next centroids
    against those sums' means."""
    k = C_in.shape[0]
    nums = judge_labels(X, C_in, out["a"], out["d"])
    if nums["label_gap"] == float("inf"):
        return dict(nums, sums_err=float("inf"),
                    centroid_err=float("inf"))
    S, v = sums(X, out["a"], k, "float64")
    nums["sums_err"] = max(_rel(out["S"], S), _rel(out["v"], v))
    nums["centroid_err"] = _rel(out["C"], means(S, v, C_in))
    return nums


def judge_fit(X: torch.Tensor, X_val: torch.Tensor, answer: dict
              ) -> Dict[str, float]:
    """A finished fit (``answer``: C, the fit's labels, its validation
    MSE, predict's labels) against float64. A converged fit is a fixed
    point: its labels are each row's nearest centroid and its centroids
    the means of their rows; its validation MSE is the mean squared
    distance of X_val to them."""
    C = answer["C"]
    k = C.shape[0]
    nums = {"fit_label_gap": judge_labels(X, C, answer["labels"])[
        "label_gap"]}
    nums["predict_label_gap"] = judge_labels(X, C, answer["predicted"])[
        "label_gap"]
    if nums["fit_label_gap"] == float("inf"):
        nums["centroid_err"] = float("inf")
    else:
        S, v = sums(X, answer["labels"], k, "float64")
        live = v > 0
        nums["centroid_err"] = _rel(C.double()[live], (S / v.clamp_min(
            1.0)[:, None])[live])
    _, d1, _ = assign(X_val, C, "float64")
    want = float(d1.mean())
    nums["val_mse_err"] = abs(answer["val_mse"] - want) / want
    return nums

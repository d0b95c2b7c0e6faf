"""The values the CUDA top-2s are held to.

`round_top2_exact` (the one-shot round's) is the top-2 of
`fused_round.fused_round_ref`, with
x.c, |x|^2 and |c|^2 each taken in float64 and rounded once to f32 (the
f32 values nearest the exact ones); the rest is f32. Where |x|^2 and x.c
cancel, as at kmeans_xl's width (x.c ~ 2.6e4, d1 ~ 2e3), an f32 product
leaves d1 ~0.1 off, beyond the rtol 1e-5 the kernel is held to, so the
plain version is no oracle there. `assign_top2_exact` (assign_top2's and
the nested round's) is the top-2 of `ref.assign_top2_ref` taken the same
way. The module imports no JAX: tests/test_torch_gpu.py and
tests/test_torch_kernels.py use it (``chip_smoke.py`` has its own copy,
as it stands alone).
"""
import torch


def round_top2_exact(x: torch.Tensor, c: torch.Tensor):
    """(a int32, d1, d2) for x (n, d) and c (k, d): the nearest and
    second-nearest centroid on ``|c|^2 - 2 x.c`` (the lower index wins a
    tie, a duplicate of the min counts as the 2nd, k == 1 gives +inf),
    then ``max(b + |x|^2, 0)``."""
    x64, c64 = x.double(), c.double()
    xn = (x64 * x64).sum(1).float()
    cn = (c64 * c64).sum(1).float()
    pd = (x64 @ c64.T).float().mul_(-2.0).add_(cn)
    a = torch.argmin(pd, dim=1)
    b1 = torch.gather(pd, 1, a[:, None])[:, 0]
    if c.shape[0] == 1:
        b2 = torch.full_like(b1, float("inf"))
    else:
        b2 = pd.scatter_(1, a[:, None], float("inf")).min(dim=1).values
    return (a.to(torch.int32), torch.clamp_min(b1 + xn, 0.0),
            torch.clamp_min(b2 + xn, 0.0))


#: The tolerance the tensor-core top-2s of assign_top2 and the nested
#: round (the ref expression, EPI_FULL) are held to against
#: `assign_top2_exact`: |got - want| <= FULL_RTOL * `full_scale` +
#: FULL_ATOL for d1 and d2. The scale is the terms' (a distance near 0
#: still carries the rounding of its terms).
#: The card's order, replayed on the CPU (tests/test_torch_kernels.py),
#: meets it; the CPU's f32 product misses it at d=784, k=50. On the card
#: chip_smoke.py phase 3 logs the kernel's gap and cuBLAS's f32 one.
FULL_RTOL = 5e-7
FULL_ATOL = 1e-5


def top2_of(pd: torch.Tensor):
    """(a int32, d1, d2) of an (n, k) distance matrix: the lower index
    wins a tie, a duplicate of the min counts as the 2nd, k == 1 gives
    +inf."""
    a = torch.argmin(pd, dim=1)
    d1 = torch.gather(pd, 1, a[:, None])[:, 0]
    if pd.shape[1] == 1:
        d2 = torch.full_like(d1, float("inf"))
    else:
        d2 = pd.scatter(1, a[:, None], float("inf")).min(dim=1).values
    return a.to(torch.int32), d1, d2


def assign_top2_exact(x: torch.Tensor, c: torch.Tensor):
    """(a int32, d1, d2) for x (n, d) and c (k, d): the top-2 of
    ``max(|x|^2 - 2 x.c + |c|^2, 0)``, with x.c, |x|^2 and |c|^2 each
    taken in float64 and rounded once to f32, the rest in f32."""
    x64, c64 = x.double(), c.double()
    xn = (x64 * x64).sum(1).float()
    cn = (c64 * c64).sum(1).float()
    pd = torch.clamp_min(xn[:, None] - 2.0 * (x64 @ c64.T).float() + cn,
                         0.0)
    return top2_of(pd)


def full_scale(x: torch.Tensor, c: torch.Tensor):
    """|x|^2 + max_j |c_j|^2 per row, in f32: the scale of FULL_RTOL."""
    x64, c64 = x.double(), c.double()
    return ((x64 * x64).sum(1) + (c64 * c64).sum(1).max()).float()


def assert_full_top2(a, d1, d2, x, c, *, euclid=False):
    """A top-2 of the ref expression (a, d1, d2; squared, or euclidean if
    ``euclid``) against `assign_top2_exact`: labels equal but where the
    two centroids' float64 distances tie within the tolerance; d1 and d2
    within FULL_RTOL of `full_scale` plus FULL_ATOL (euclidean ones
    squared back, with the sqrt's own rounding, 2.4e-7 relative, on
    top); +inf where the oracle has it."""
    want = assign_top2_exact(x, c)
    sc = full_scale(x, c).double()
    tol = FULL_RTOL * sc + FULL_ATOL
    diff = torch.nonzero(a != want[0])[:, 0]
    if diff.numel():
        x64, c64 = x[diff].double(), c.double()
        da = ((x64 - c64[a[diff].long()]) ** 2).sum(1)
        dw = ((x64 - c64[want[0][diff].long()]) ** 2).sum(1)
        assert bool(((da - dw).abs() <= tol[diff]).all()), diff
    for g, w in zip((d1, d2), want[1:]):
        g, w = g.double(), w.double()
        if euclid:
            g = g * g
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g), fin)
        err = torch.where(g == w, 0.0, (g - w).abs())[fin]
        slack = (tol + (2.4e-7 * w if euclid else 0.0))[fin]
        assert bool((err <= slack).all()), float((err / sc[fin]).max())

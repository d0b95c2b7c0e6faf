"""The values the one-shot round's CUDA top-2 is held to.

`round_top2_exact` is the top-2 of `fused_round.fused_round_ref`, with
x.c, |x|^2 and |c|^2 each taken in float64 and rounded once to f32 (the
f32 values nearest the exact ones); the rest is f32. Where |x|^2 and x.c
cancel, as at kmeans_xl's width (x.c ~ 2.6e4, d1 ~ 2e3), an f32 product
leaves d1 ~0.1 off, beyond the rtol 1e-5 the kernel is held to, so the
plain version is no oracle there. It imports no JAX: tests/test_torch_gpu.py
and tests/test_torch_kernels.py use it (``chip_smoke.py`` has its own
copy, as it stands alone).
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

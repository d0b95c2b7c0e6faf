"""The port's kernel layer against the JAX package.

On the CPU: the port's plain versions (`repro_torch.kernels.ref`,
`fused_round.fused_nested_round_ref`) against the JAX Pallas kernels in
interpret mode and against the JAX oracles, on the same numpy inputs,
at the tolerances of tests/test_kernels.py (f32 rtol 1e-5, bf16 2e-2;
labels may differ only where two distances tie within tolerance). Plus
the dispatch rules of `plan` and `ops`, and the rule that the port
imports nothing of JAX or of the JAX package.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cluster_sum import cluster_sum_pallas
from repro.kernels.fused_round import (fused_nested_round_pallas,
                                       fused_nested_round_ref as jfused_ref)
from repro.kernels.kmeans_assign import assign_top2_pallas
from repro_torch.kernels import fused_round, ops, plan as tplan
from repro_torch.kernels import ref as tref
from torch_round_oracle import (FULL_RTOL, assert_full_top2,
                                assign_top2_exact, full_scale,
                                round_top2_exact, top2_of)

REPO = pathlib.Path(__file__).resolve().parents[1]

SHAPES = [
    (64, 7, 5),          # tiny, heavy padding
    (256, 32, 50),       # paper k
    (300, 784, 50),      # infMNIST dims, unaligned n
    (512, 128, 128),     # aligned everything
    (1000, 200, 257),    # k crosses one block boundary
    (130, 9, 1),         # k == 1: second distance is +inf
]
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy() if t.is_floating_point() \
            else t.detach().cpu().numpy()
    return np.asarray(t)


def _inputs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = (rng.normal(size=(k, d)) * 2).astype(np.float32)
    return x, c


def _assert_labels(a_got, a_want, d2m, tol):
    """Labels equal, except where the two picks tie within tolerance."""
    a_got, a_want, d2m = _np(a_got), _np(a_want), _np(d2m)
    assert a_got.dtype == np.int32 or a_got.dtype == a_want.dtype
    for i in np.where(a_got != a_want)[0]:
        assert abs(d2m[i, a_got[i]] - d2m[i, a_want[i]]) < tol * 100, i


def _assert_top2(got, want, d2m, tol):
    a_g, d1_g, d2_g = got
    a_w, d1_w, d2_w = want
    np.testing.assert_allclose(_np(d1_g), _np(d1_w), rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(_np(d2_g), _np(d2_w), rtol=tol, atol=tol * 10)
    _assert_labels(a_g, a_w, d2m, tol)


# -- plain versions against JAX ----------------------------------------------

@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_assign_top2_matches_jax(n, d, k, dtype):
    x, c = _inputs(n, d, k, n + d + k)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    xj, cj = jnp.asarray(x, jdt), jnp.asarray(c, jdt)
    xt, ct = torch.from_numpy(x).to(tdt), torch.from_numpy(c).to(tdt)
    got = ops.assign_top2(xt, ct)
    assert got[0].dtype == torch.int32
    assert got[1].dtype == got[2].dtype == torch.float32
    tol = TOL[dtype]
    d2m = jref.pairwise_dist2(xj, cj)
    _assert_top2(got, assign_top2_pallas(xj, cj, bn=128, bk=128,
                                         interpret=True), d2m, tol)
    _assert_top2(got, jref.assign_top2_ref(xj, cj), d2m, tol)
    if k == 1:
        assert np.all(np.isinf(_np(got[2])))


def test_assign_top2_exact_ties():
    """Duplicate centroids: the lower index wins, and the 2nd-min is the
    tied value (a duplicate of the min counts)."""
    x, c = _inputs(200, 16, 6, 11)
    c[4] = c[1]
    c[5] = c[1]
    got = ops.assign_top2(torch.from_numpy(x), torch.from_numpy(c))
    want = jref.assign_top2_ref(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-5,
                               atol=1e-4)
    won_dup = _np(got[0]) == 1
    assert won_dup.any() and not np.isin(_np(got[0]), [4, 5]).any()
    np.testing.assert_array_equal(_np(got[2])[won_dup], _np(got[1])[won_dup])
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_cluster_sum_matches_jax(n, d, k):
    rng = np.random.default_rng(n * 7 + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.integers(0, k, n).astype(np.int32)
    w = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    s_t, v_t = ops.cluster_sum(torch.from_numpy(x), torch.from_numpy(a), k,
                               weights=torch.from_numpy(w))
    xj, aj, wj = jnp.asarray(x), jnp.asarray(a), jnp.asarray(w)
    kp = k + (-k % 128)
    s_p, v_p = cluster_sum_pallas(xj, aj, kp, weights=wj, bn=128, bd=128,
                                  interpret=True)
    s_r, v_r = jref.cluster_sum_ref(xj, aj, k, weights=wj)
    for s_w, v_w in ((s_p[:k], v_p[:k]), (s_r, v_r)):
        np.testing.assert_allclose(_np(s_t), _np(s_w), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(v_t), _np(v_w), rtol=1e-5, atol=1e-5)


def _nested_inputs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    x, c = _inputs(n, d, k, seed + 1)
    a_prev = rng.integers(-1, k, size=n).astype(np.int32)
    settled = (rng.random(n) < 0.3) & (a_prev >= 0)
    d_keep = rng.random(n).astype(np.float32)
    lb_keep = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    return x, c, a_prev, settled, d_keep, lb_keep, valid


@pytest.mark.parametrize("n,d,k", [(64, 7, 5), (300, 784, 50),
                                   (1000, 200, 257), (64, 129, 7),
                                   (100, 16, 1)])
def test_fused_nested_round_matches_jax(n, d, k):
    """Keep-select, -1 on invalid rows, signed delta S/v and sse over
    every valid row, against the Pallas kernel and the JAX oracle."""
    args = _nested_inputs(n, d, k, n * 3 + k)
    got = ops.fused_nested_round(*[torch.from_numpy(a) for a in args])
    jargs = [jnp.asarray(a) for a in args]
    d2m = jref.pairwise_dist2(jargs[0], jargs[1])
    for want in (fused_nested_round_pallas(*jargs, bn=64, interpret=True),
                 jfused_ref(*jargs)):
        _assert_labels(got[0], want[0], d2m, 1e-5)
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
        for g, w in zip(got[1:3], want[1:3]):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(_np(got[4]), _np(want[4]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(got[5]), _np(want[5]), rtol=1e-4,
                                   atol=1e-3)
    invalid = ~args[6]
    assert np.all(_np(got[0])[invalid] == -1)
    keep = args[3] & args[6]
    np.testing.assert_array_equal(_np(got[0])[keep], args[2][keep])
    np.testing.assert_array_equal(_np(got[1])[keep], args[4][keep])


# -- the scatter's order oracle ----------------------------------------------
#
# `ref.ordered_sums` sums in the CUDA scatter's documented order (rows of
# each chunk in row order, then the chunks in order); the kernels are held
# to it bit for bit on the card (tests/test_torch_gpu.py). Here it is held
# to a plain numpy float32 loop bit for bit, and to the plain versions and
# JAX within the existing tolerances.

def _loop_sums(x, k, adds, sse_adds):
    """S, v, sse by a float32 loop: per chunk of `plan.chunk_rows(n)`
    rows, row by row (``adds[r]``: (cluster, weight) pairs, ``sse_adds[r]``
    (cluster, value) pairs), then the chunks in order."""
    n, d = x.shape
    rows = tplan.chunk_rows(max(n, 1))
    S = np.zeros((k, d), np.float32)
    v = np.zeros(k, np.float32)
    e = np.zeros(k, np.float32)
    for lo in range(0, n, rows):
        Sc, vc, ec = np.zeros_like(S), np.zeros_like(v), np.zeros_like(e)
        for r in range(lo, min(n, lo + rows)):
            for j, w in adds[r]:
                Sc[j] += np.float32(w) * x[r]
                vc[j] += np.float32(w)
            for j, s in sse_adds[r]:
                ec[j] += np.float32(s)
        S += Sc
        v += vc
        e += ec
    return S, v, e


def _scatter_case(mode, n, d, k, seed):
    """Inputs of one mode, the oracle's keyword arguments, and the loop's
    (adds, sse_adds)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if mode == "sum":
        a = rng.integers(-2, k + 2, n).astype(np.int32)
        w = rng.normal(size=n).astype(np.float32)
        w[rng.random(n) < 0.4] = 0.0
        kw = dict(a=a, weights=w)
        adds = [[(a[r], w[r])] if w[r] != 0 and 0 <= a[r] < k else []
                for r in range(n)]
        sse = [[] for _ in range(n)]
    elif mode == "nested":
        ap = rng.integers(-1, k, n).astype(np.int32)
        an = np.where(rng.random(n) < 0.7, ap,
                      rng.integers(-1, k, n)).astype(np.int32)
        dn = rng.random(n).astype(np.float32)
        kw = dict(a_prev=ap, a_new=an, d_new=dn)
        adds, sse = [], []
        for r in range(n):
            seen = ap[r] >= 0
            changed = seen and an[r] != ap[r]
            row = [(an[r], 1.0)] if (changed or not seen) and an[r] >= 0 \
                else []
            if changed:
                row.append((min(ap[r], k - 1), -1.0))
            adds.append(row)
            sse.append([(min(max(an[r], 0), k - 1), dn[r] * dn[r])])
    else:
        a = rng.integers(0, k, n).astype(np.int32)
        d1 = (rng.random(n) * 10).astype(np.float32)
        kw = dict(a=a, d1sq=d1)
        adds = [[(a[r], 1.0)] for r in range(n)]
        sse = [[(a[r], d1[r])] for r in range(n)]
    return x, kw, adds, sse


@pytest.mark.parametrize("mode", ["sum", "nested", "round"])
@pytest.mark.parametrize("n,d,k", [(700, 5, 7), (1100, 3, 130), (40, 2, 1)])
def test_ordered_sums_equal_a_float32_loop(mode, n, d, k):
    x, kw, adds, sse = _scatter_case(mode, n, d, k, n + k)
    got = tref.ordered_sums(torch.from_numpy(x), k, **{
        key: torch.from_numpy(val) for key, val in kw.items()})
    want = _loop_sums(x, k, adds, sse)
    assert len(got) == (2 if mode == "sum" else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), w)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_ordered_sums_match_cluster_sum(n, d, k):
    rng = np.random.default_rng(n * 7 + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.integers(0, k, n).astype(np.int32)
    w = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    xt, at, wt = (torch.from_numpy(t) for t in (x, a, w))
    s_o, v_o = tref.ordered_sums(xt, k, at, wt)
    xj, aj, wj = jnp.asarray(x), jnp.asarray(a), jnp.asarray(w)
    kp = k + (-k % 128)
    s_p, v_p = cluster_sum_pallas(xj, aj, kp, weights=wj, bn=128, bd=128,
                                  interpret=True)
    for s_w, v_w in ((s_p[:k], v_p[:k]),
                     tref.cluster_sum_ref(xt, at, k, weights=wt)):
        np.testing.assert_allclose(_np(s_o), _np(s_w), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(v_o), _np(v_w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,d,k", [(64, 7, 5), (300, 784, 50),
                                   (1000, 200, 257), (100, 16, 1)])
def test_ordered_sums_nested_and_round_modes(n, d, k):
    """The nested mode against `fused_round.delta_sums`, the round mode
    against the plain one-shot round's sums, at those tests' tolerances."""
    args = [torch.from_numpy(t) for t in _nested_inputs(n, d, k, n * 3 + k)]
    a_new, d_new = fused_round.fused_nested_round_ref(*args)[:2]
    x, a_prev = args[0], args[2]
    got = tref.ordered_sums(x, k, a_prev=a_prev, a_new=a_new, d_new=d_new)
    for g, w in zip(got, fused_round.delta_sums(x, a_prev, a_new, d_new,
                                                k)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-3)
    a, d1, _, S, v, sse = fused_round.fused_round_ref(x, args[1])
    got = tref.ordered_sums(x, k, a, d1sq=d1)
    for g, w in zip(got, (S, v, sse)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-3)


# -- the tensor-core top-2's arithmetic, emulated ---------------------------
#
# The one-shot round's CUDA top-2 (csrc/tc_top2.cuh) forms x.c in 3xTF32:
# big = tf32(v), small = tf32(v - big), x.c ~ xs.cb + xb.cs + xb.cb. Per
# group of 2 k8 steps (16 features) a fresh tensor-core accumulator takes
# the small terms, then the big ones: six wgmma steps, each adding 8
# products (exact: TF32 times TF32 fits f32) to the accumulator and
# rounding toward zero, as the card's f32 accumulation does. Each group's
# sum is added into an f32 total with Kahan's compensation. `_dot_3xtf32`
# replays that order here, each step modelled as the exact sum truncated
# to f32, before the card runs it.

def _tf32(t):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does, on the int32 view."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rz(t):
    """float64 to f32, rounded toward zero: the low 29 of float64's 52
    mantissa bits cut off, then an exact conversion."""
    return (t.contiguous().view(torch.int64) & ~((1 << 29) - 1)).view(
        torch.float64).float()


def _dot_3xtf32(x, c, group=16):
    """x @ c.T in the card's order (see above), f32."""
    pad = -x.shape[1] % group        # zero features change no sum
    x = torch.nn.functional.pad(x, (0, pad))
    c = torch.nn.functional.pad(c, (0, pad))
    xb, cb = _tf32(x), _tf32(c)
    xs, cs = _tf32(x - xb), _tf32(c - cb)
    xb, cb, xs, cs = (t.double() for t in (xb, cb, xs, cs))
    acc = torch.zeros(x.shape[0], c.shape[0])
    comp = torch.zeros_like(acc)
    for g in range(0, x.shape[1], group):
        steps = [(f, a, b) for f in range(g, g + group, 8)
                 for a, b in ((xs, cb), (xb, cs))]
        steps += [(f, xb, cb) for f in range(g, g + group, 8)]
        part = torch.zeros_like(acc, dtype=torch.float64)
        for f, a, b in steps:
            part = _rz(part + a[:, f:f + 8] @ b[:, f:f + 8].T).double()
        y = part.float() - comp          # Kahan: acc + comp = the sum
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


def _sqnorm_warp(v):
    """|v_r|^2 as the card sums it (``sqnorm_kernel``): lane l of a warp
    adds v[f]^2 for f = l, l + 32, ... with fmaf (one rounding each),
    then the 32 lanes combine by xor shuffles 16, 8, 4, 2, 1."""
    v = torch.nn.functional.pad(v, (0, -v.shape[1] % 32)).double()
    lanes = v.view(v.shape[0], -1, 32)          # feature 32 j + lane
    s = torch.zeros(v.shape[0], 32)
    for j in range(lanes.shape[1]):
        s = (s.double() + lanes[:, j] ** 2).float()
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ off]
    return s[:, 0]


def _top2_3xtf32(x, c):
    """`fused_round_ref`'s top-2, all in f32, with x.c formed by
    `_dot_3xtf32` and |x|^2, |c|^2 by `_sqnorm_warp`, as on the card."""
    pd = _sqnorm_warp(c) - 2.0 * _dot_3xtf32(x, c)
    a = torch.argmin(pd, dim=1)
    b1 = torch.gather(pd, 1, a[:, None])[:, 0]
    b2 = (torch.full_like(b1, float("inf")) if c.shape[0] == 1 else
          pd.scatter(1, a[:, None], float("inf")).min(dim=1).values)
    xn = _sqnorm_warp(x)
    return (a.to(torch.int32), torch.clamp_min(b1 + xn, 0.0),
            torch.clamp_min(b2 + xn, 0.0))


def _xnorm_tiles(x):
    """|x_r|^2 as the tensor-core top-2 sums it from its tiles of x in
    shared memory (EPI_FULL, EPI_NESTED): features in slabs of 32, eight
    threads to a row, thread j holding the float4 at 16-byte position j
    of the row's 128 bytes, which TMA's 128-byte swizzle fills with
    features 4 (j ^ (r % 8)) + 0..3 of the slab. Each thread adds its
    squares with fmaf, slab by slab, x y z w; then the eight combine by
    xor shuffles 1, 2, 4."""
    n = x.shape[0]
    x = torch.nn.functional.pad(x, (0, -x.shape[1] % 32))
    slabs = x.view(n, -1, 8, 4).double()
    lanes = torch.arange(8)
    held = (lanes[None, :] ^ (torch.arange(n) % 8)[:, None])[:, :, None]
    s = torch.zeros(n, 8)
    for sl in range(slabs.shape[1]):
        v = torch.gather(slabs[:, sl], 1, held.expand(n, 8, 4))
        for e in range(4):
            s = (s.double() + v[:, :, e] ** 2).float()
    for off in (1, 2, 4):
        s = s + s[:, lanes ^ off]
    return s[:, 0]


def _full_3xtf32(x, c):
    """assign_top2's top-2 as the card forms it (EPI_FULL): the ref
    expression ``max(|x|^2 - 2 x.c + |c|^2, 0)`` in f32 with x.c by
    `_dot_3xtf32`, |x|^2 by `_xnorm_tiles` and |c|^2 by `_sqnorm_warp`,
    each column clamped before the top-2."""
    pd = torch.clamp_min(_xnorm_tiles(x)[:, None] - 2.0 * _dot_3xtf32(x, c)
                         + _sqnorm_warp(c), 0.0)
    return top2_of(pd)


def _nested_3xtf32(x, c, a_prev, settled, d_keep, lb_keep, valid):
    """The nested round's top-2 and keep-select as the card forms them
    (EPI_NESTED): `_full_3xtf32`, then -1 / 0 / 0 on invalid rows, the
    kept values on settled rows, and the euclidean top-2 on the rest."""
    a, d1, d2 = _full_3xtf32(x, c)
    a_new = torch.where(valid, torch.where(settled, a_prev, a),
                        torch.full_like(a, -1))
    d_new = torch.where(valid, torch.where(settled, d_keep, torch.sqrt(d1)),
                        torch.zeros_like(d1))
    lb_new = torch.where(valid, torch.where(settled, lb_keep,
                                            torch.sqrt(d2)),
                         torch.zeros_like(d2))
    return a_new, d_new, lb_new


def _assert_round_top2(got, want, d2m):
    """`chip_smoke.check_fused_round`'s tolerances: labels equal but for
    near-ties within 1e-3 of the distance, d1 and d2 within rtol 1e-5,
    atol 1e-4."""
    a_g, a_w = _np(got[0]), _np(want[0])
    d2m = _np(d2m)
    for i in np.where(a_g != a_w)[0]:
        want_d = d2m[i, a_w[i]]
        assert abs(d2m[i, a_g[i]] - want_d) < 1e-3 * max(abs(want_d), 1.0), i
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-4)


def test_tf32_rounding():
    """To nearest, ties away from zero, in both signs; the split is exact
    to 2^-22 relative; float64 to f32 toward zero."""
    one_ulp = 2.0 ** -10
    v = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4], dtype=torch.float32)
    torch.testing.assert_close(
        _tf32(v), torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0,
                                1 + one_ulp]), rtol=0, atol=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    big = _tf32(x)
    small = _tf32(x - big)
    assert bool((_tf32(big) == big).all() and (_tf32(small) == small).all())
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    f32_ulp = 2.0 ** -23
    w = torch.tensor([1 + 0.9 * f32_ulp, -(1 + 0.9 * f32_ulp), 1 + f32_ulp,
                      3.0], dtype=torch.float64)
    torch.testing.assert_close(
        _rz(w), torch.tensor([1.0, -1.0, 1 + f32_ulp, 3.0]), rtol=0, atol=0)


@pytest.mark.parametrize("n,d,k", [(4099, 784, 1), (4099, 784, 257),
                                   (777, 33, 50)])
def test_3xtf32_top2_meets_the_kernel_tolerances(n, d, k):
    """At chip_smoke's phase-3 shapes and inputs, the emulated 3xTF32
    top-2 is within the tolerances the card's kernel is held to, of the
    once-rounded float64 top-2 and of the plain version."""
    rng = np.random.default_rng(5 * n + k)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=(k, d)) * 2).astype(np.float32))
    got = _top2_3xtf32(x, c)
    d2m = (torch.cdist(x.double(), c.double()) ** 2).float()
    for want in (round_top2_exact(x, c), fused_round.fused_round_ref(x, c)):
        _assert_round_top2(got, want, d2m)
    if k == 1:
        assert bool(torch.isinf(got[2]).all())


def test_3xtf32_top2_on_blobs_at_full_width():
    """kmeans_xl's width (d=1024, k=4096) on few rows of Gaussian blobs
    (centres N(0, 5^2), unit noise; each centroid a noisy draw of its
    centre), where |x|^2 ~ 2.7e4 cancels down to d1 ~ 2e3. The emulated
    products are within 1e-6 of their L1 mass of float64 (one TF32 pass
    is ~1e-4 off), and the top-2 meets the card's tolerances against the
    once-rounded float64 top-2 (an f32 product does not: its d1 is ~3e-5
    of d1 off here)."""
    n, d, k = 512, 1024, 4096
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(k, d)) * 5.0
    xt = torch.from_numpy((centres[rng.integers(0, k, n)]
                           + rng.normal(size=(n, d))).astype(np.float32))
    ct = torch.from_numpy((centres + rng.normal(size=(k, d)))
                          .astype(np.float32))
    x64, c64 = xt.double(), ct.double()
    mass = x64.abs() @ c64.abs().T
    err = (_dot_3xtf32(xt, ct).double() - x64 @ c64.T).abs() / mass
    assert float(err.max()) < 1e-6
    d2m = ((x64 ** 2).sum(1)[:, None] - 2.0 * x64 @ c64.T
           + (c64 ** 2).sum(1))
    _assert_round_top2(_top2_3xtf32(xt, ct), round_top2_exact(xt, ct), d2m)


@pytest.mark.parametrize("n,d,k", [(2000, 784, 50), (777, 33, 50),
                                   (1000, 200, 257), (130, 9, 1),
                                   (64, 7, 5)])
def test_full_3xtf32_top2_meets_the_float64_oracle(n, d, k):
    """assign_top2's tensor-core top-2 (EPI_FULL), replayed, within the
    oracle tolerance the card's kernel is held to (FULL_RTOL) and within
    the plain version's (f32 rtol 1e-5, atol 1e-4). At infMNIST's width
    the plain version's f32 product on the CPU is outside the oracle
    tolerance: there it tells the two summation orders apart."""
    x, c = (torch.from_numpy(a) for a in _inputs(n, d, k, 5 * n + k))
    got = _full_3xtf32(x, c)
    assert_full_top2(*got, x, c)
    plain = tref.assign_top2_ref(x, c)
    _assert_top2(got, plain, tref.pairwise_dist2(x, c), TOL["f32"])
    if k == 1:
        assert bool(torch.isinf(got[2]).all())
    if d == 784:
        err = (plain[1] - assign_top2_exact(x, c)[1]).abs() / full_scale(x, c)
        assert float(err.max()) > FULL_RTOL


def test_nested_3xtf32_meets_the_float64_oracle():
    """The nested round's epilogue (EPI_NESTED), replayed at d=784, k=50:
    invalid rows -1 / 0 / 0, settled rows pass through bit for bit, the
    rest the oracle's top-2 as euclidean distances (squared back, within
    FULL_RTOL of the scale plus the sqrt's own rounding)."""
    n, d, k = 2000, 784, 50
    x, c, a_prev, settled, d_keep, lb_keep, valid = (
        torch.from_numpy(a) for a in _nested_inputs(n, d, k, 11))
    a_new, d_new, lb_new = _nested_3xtf32(x, c, a_prev, settled, d_keep,
                                          lb_keep, valid)
    assert bool((a_new[~valid] == -1).all())
    assert not bool(d_new[~valid].any()) and not bool(lb_new[~valid].any())
    keep = valid & settled
    assert torch.equal(a_new[keep], a_prev[keep])
    assert torch.equal(d_new[keep], d_keep[keep])
    assert torch.equal(lb_new[keep], lb_keep[keep])
    new = valid & ~settled
    assert bool(new.sum() > n // 2)
    assert_full_top2(a_new[new], d_new[new], lb_new[new], x[new], c,
                     euclid=True)


def test_full_top2_clamp_ties_go_to_the_lower_index():
    """Rows at (nearly) a centroid that has near-duplicates: where the
    ref expression rounds below 0 at several columns, the clamp makes
    them tie at 0, and the lowest of them wins, though a higher one's
    unclamped value is the smaller; the second distance is then 0 too."""
    rng = np.random.default_rng(3)
    d, k = 8, 12
    base = rng.normal(size=(4, d)) * 1000.0
    c = np.repeat(base, 3, axis=0) + rng.normal(size=(k, d)) * 3e-3
    x = c[rng.integers(0, k, 2000)] + rng.normal(size=(2000, d)) * 3e-3
    x, c = (torch.from_numpy(a.astype(np.float32)) for a in (x, c))
    raw = (_xnorm_tiles(x)[:, None] - 2.0 * _dot_3xtf32(x, c)
           + _sqnorm_warp(c))
    a, d1, d2 = _full_3xtf32(x, c)
    clamped = raw <= 0
    tied = clamped.sum(1) >= 2
    assert bool(tied.any())
    lowest = torch.argmax(clamped.int(), dim=1)
    assert torch.equal(a[tied], lowest[tied].to(torch.int32))
    assert not bool(d1[tied].any()) and not bool(d2[tied].any())
    # teeth: some tied row has a higher column with a smaller raw value
    assert bool((raw.argmin(1) != lowest)[tied].any())


@pytest.mark.parametrize("n,d,k", [(3000, 16, 7), (9000, 5, 4096),
                                   (2000, 0, 50), (1, 3, 1)])
def test_onehot_sums_match_index_add_and_repeat(n, d, k):
    """The plain sums' route on CUDA devices (`ref.onehot_sums`), called
    on CPU tensors: within cluster_sum's tolerance (1e-5 of each entry's
    L1 mass, plus 1e-4) of ``index_add_``, and the same bits twice. Rows
    span several one-hot blocks where k = 4096."""
    rng = np.random.default_rng(n + d + k)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32))
    w = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0, 0.5], n).astype(
        np.float32))
    got = tref.onehot_sums(x, a, k, weights=w)
    assert got[0].shape == (k, d) and got[1].shape == (k,)
    want = tref.cluster_sum_ref(x, a, k, weights=w)
    mass = tref.cluster_sum_ref(x.abs(), a, k, weights=w.abs())
    for g, wt, m in zip(got, want, mass):
        assert bool(((g - wt).abs() <= 1e-5 * m + 1e-4).all())
    again = tref.onehot_sums(x, a, k, weights=w)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    ones = tref.onehot_sums(x, a, k)
    torch.testing.assert_close(ones[1], torch.bincount(
        a.long(), minlength=k).float(), rtol=0, atol=0)
    if k == 4096:
        assert tref.ONEHOT_BLOCK // k < n


@pytest.mark.parametrize("d", [0, 7, 33, 784])
def test_tma_operands_zero_padding(d):
    """Rows padded with zeros to a multiple of 4 floats (TMA's 16-byte
    stride) give the top-2 of the unpadded inputs; aligned widths are
    passed through uncopied."""
    x, c = (torch.from_numpy(a) for a in _inputs(300, d, 50, d + 1))
    xp, cp, dp = fused_round.tma_operands(x, c)
    assert dp % 4 == 0 and dp >= max(d, 4) and dp - d < 4 or dp == 4
    assert xp.shape == (300, dp) and cp.shape == (50, dp)
    if dp == d:
        assert xp is x and cp is c
    else:
        assert not bool(xp[:, d:].any()) and not bool(cp[:, d:].any())
    want = fused_round.fused_round_ref(x, c)
    got = fused_round.fused_round_ref(xp, cp)
    _assert_round_top2(got[:3], want[:3], tref.pairwise_dist2(x, c))
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))


# -- dispatch ----------------------------------------------------------------

def test_resolve_plan_rules():
    p = tplan.resolve_plan(None, b=1000, k=13, d=5, device="cpu")
    assert p.backend == "ref" and p.bucket == (1024, 16, 8)
    assert tplan.resolve_plan("ref", b=8, k=2, d=2, device="cpu"
                              ).backend == "ref"
    with pytest.raises(ValueError, match="CUDA device"):
        tplan.resolve_plan("cuda", b=8, k=2, d=2, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel_backend"):
        tplan.resolve_plan("pallas", b=8, k=2, d=2, device="cpu")
    assert p.to_dict() == {"backend": "ref", "bucket": [1024, 16, 8],
                           "family": "unset"}
    assert hash(p) == hash(tplan.KernelPlan("ref", (1024, 16, 8)))
    assert [tplan.chunk_rows(n) for n in (1, 5000, 400_000, 2 ** 20)] == \
        [256, 256, 2048, 4096]


def test_ops_take_plain_versions_on_cpu():
    """A CPU tensor takes the plain version even under a "cuda" plan, and
    no kernel launch is counted."""
    ops.reset_launch_counts()
    x, c = _inputs(50, 6, 3, 0)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    cuda_plan = tplan.KernelPlan("cuda", (64, 4, 8))
    a, _, _ = ops.assign_top2(xt, ct, plan=cuda_plan)
    torch.testing.assert_close(a, tref.assign_top2_ref(xt, ct)[0])
    ops.cluster_sum(xt, a, 3, plan=cuda_plan)
    got = ops.fused_round(xt, ct, plan=cuda_plan)
    for g, w in zip(got, fused_round.fused_round_ref(xt, ct)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.launch_counts() == {"assign_top2": 0, "cluster_sum": 0,
                                   "fused_nested_round": 0,
                                   "fused_round": 0}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "torch_dist_worker.py"]
    assert len(files) > 15
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []

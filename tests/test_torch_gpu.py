"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA
device; the file imports no JAX, so it runs on a machine with a card and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of tests/test_kernels.py (f32 rtol 1e-5, bf16
2e-2); labels may differ only where two distances tie within 100x the
tolerance. Each kernel must also give the same bits twice. The f32
top-2s run on the tensor cores (3xTF32) and are held, beyond that, to
x.c and the norms rounded once from float64 (tests/torch_round_oracle.py)
at a tighter tolerance. A new kernel's tests run first in a pytest
process of their own (``-k``): a device trap poisons the process's CUDA
context for every later test.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_round, ops, ref
from torch_round_oracle import assert_full_top2, round_top2_exact

SHAPES = [(64, 7, 5), (256, 32, 50), (300, 784, 50), (512, 128, 128),
          (1000, 200, 257), (130, 9, 1), (4099, 784, 50)]
TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, d, k, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=(k, d)) * 2).astype(np.float32))
    return x.to(device, dtype), c.to(device, dtype)


def _assert_labels(a_got, a_want, d2m, tol):
    diff = torch.nonzero(a_got != a_want)[:, 0]
    gap = (d2m[diff, a_got[diff].long()] - d2m[diff, a_want[diff].long()])
    assert bool((gap.abs() < tol * 100).all()), diff


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_assign_top2_kernel_matches_plain(cuda, n, d, k, dtype):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, c = _inputs(n, d, k, n + k, cuda, tdt)
    before = ops.launch_counts()["assign_top2"]
    got = ops.assign_top2(x, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["assign_top2"] == before + 1
    want = ref.assign_top2_ref(x, c)
    tol = TOL[dtype]
    assert got[0].dtype == torch.int32
    torch.testing.assert_close(got[1], want[1], rtol=tol, atol=tol * 10)
    torch.testing.assert_close(got[2], want[2], rtol=tol, atol=tol * 10)
    _assert_labels(got[0], want[0], ref.pairwise_dist2(x, c), tol)
    for g, a in zip(got, ops.assign_top2(x, c)):
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_assign_top2_kernel_exact_ties(cuda):
    x, c = _inputs(500, 16, 6, 11, cuda)
    c[4] = c[1]
    c[5] = c[1]
    a, d1, d2 = ops.assign_top2(x, c)
    assert not bool(torch.isin(a, torch.tensor([4, 5], device=cuda)).any())
    won = a == 1
    assert bool(won.any()) and torch.equal(d2[won], d1[won])


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", SHAPES + [(777, 33, 50), (60, 1024, 300),
                                            (4099, 784, 64), (4099, 784, 65)])
def test_assign_top2_kernel_meets_the_float64_oracle(cuda, n, d, k):
    """The f32 kernel (tensor cores, EPI_FULL; BN = 64 where k <= 64)
    against the ref expression with x.c, |x|^2 and |c|^2 rounded once
    from float64: d % 4 != 0 (zero-padded copies), k = 1, ragged k
    tiles, n < 128 and ragged n."""
    x, c = _inputs(n, d, k, 2 * n + k, cuda)
    got = ops.assign_top2(x, c)
    torch.cuda.synchronize()
    assert_full_top2(*got, x, c)
    if k == 1:
        assert bool(torch.isinf(got[2]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [50, 400])
def test_assign_top2_kernel_ties_across_k_tiles(cuda, k):
    """Duplicates of the nearest centroid in its own k tile and, at
    k = 400, in later ones (index 300): the lower index wins and the
    second distance is the tied value."""
    x, c = _inputs(500, 16, k, 19, cuda)
    rng = np.random.default_rng(20)
    c[1] = torch.from_numpy(rng.normal(size=16).astype(np.float32) * 0.3)
    dups = [4, 5] + ([300, k - 1] if k > 300 else [k - 1])
    c[dups] = c[1].clone()
    a, d1, d2 = ops.assign_top2(x, c)
    torch.cuda.synchronize()
    assert not bool(torch.isin(a, torch.tensor(dups, device=cuda)).any())
    won = a == 1
    assert bool(won.any()) and torch.equal(d2[won], d1[won])


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", SHAPES + [(64, 129, 7), (1000, 200, 400)])
def test_fused_nested_round_kernel_meets_the_float64_oracle(cuda, n, d, k):
    """The nested round's top-2 (tensor cores, EPI_NESTED): invalid rows
    -1 / 0 / 0, settled rows passed through bit for bit, the rest the
    float64 oracle's top-2 as euclidean distances (squared back, within
    FULL_RTOL of the scale plus the sqrt's own rounding)."""
    rng = np.random.default_rng(n * 5 + k)
    x, c = _inputs(n, d, k, n + 3 * k, cuda)
    a_prev = rng.integers(-1, k, size=n).astype(np.int32)
    host = (a_prev, (rng.random(n) < 0.3) & (a_prev >= 0),
            rng.random(n).astype(np.float32),
            rng.random(n).astype(np.float32), rng.random(n) < 0.9)
    args = [x, c] + [torch.from_numpy(h).to(cuda) for h in host]
    a_new, d_new, lb_new = ops.fused_nested_round(*args)[:3]
    torch.cuda.synchronize()
    a_prev, settled, d_keep, lb_keep, valid = args[2:]
    assert bool((a_new[~valid] == -1).all())
    assert not bool(d_new[~valid].any()) and not bool(lb_new[~valid].any())
    keep = valid & settled
    assert torch.equal(a_new[keep], a_prev[keep])
    assert torch.equal(d_new[keep], d_keep[keep])
    assert torch.equal(lb_new[keep], lb_keep[keep])
    new = valid & ~settled
    assert_full_top2(a_new[new], d_new[new], lb_new[new], x[new], c,
                     euclid=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", SHAPES + [(3000, 0, 7)])
def test_cluster_sum_kernel_matches_plain(cuda, n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], n).astype(
        np.float32)).to(cuda)
    got = ops.cluster_sum(x, a, k, weights=w)
    want = ref.cluster_sum_ref(x, a, k, weights=w)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    again = ops.cluster_sum(x, a, k, weights=w)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", SHAPES + [(64, 129, 7)])
def test_fused_nested_round_kernel_matches_plain(cuda, n, d, k):
    rng = np.random.default_rng(n * 3 + k)
    x, c = _inputs(n, d, k, n + k, cuda)
    a_prev = rng.integers(-1, k, size=n).astype(np.int32)
    host = (a_prev, (rng.random(n) < 0.3) & (a_prev >= 0),
            rng.random(n).astype(np.float32),
            rng.random(n).astype(np.float32), rng.random(n) < 0.9)
    args = [x, c] + [torch.from_numpy(h).to(cuda) for h in host]
    got = ops.fused_nested_round(*args)
    want = fused_round.fused_nested_round_ref(*args)
    _assert_labels(got[0], want[0], ref.pairwise_dist2(x, c), 1e-5)
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    # the sums against the plain sums over the kernel's own labels (one
    # may differ from the plain label at a tie)
    sums = fused_round.delta_sums(x, args[2], got[0], got[1], k)
    for g, w in zip(got[3:], sums):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    for g, a in zip(got, ops.fused_nested_round(*args)):
        assert torch.equal(g, a)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", [(256, 96, 320), (130, 33, 257),
                                   (64, 7, 5), (300, 1024, 1),
                                   (256, 96, 64), (4099, 784, 50),
                                   (300, 64, 65)])
def test_tc_dot_matches_float64(cuda, n, d, k):
    """The tensor-core top-2's main loop alone (TMA, 3xTF32 split, wgmma)
    against a float64 product, within 1e-5 of each entry's L1 mass
    (sum of |x_f c_f|): f32-level error. One TF32 pass would be off by
    about 1e-3 of a term, well beyond it at these depths."""
    x, c = _inputs(n, d, k, 3 * n + d + k, cuda)
    got = fused_round.tc_dot_cuda(x, c)
    torch.cuda.synchronize()
    exact = x.double() @ c.double().T
    mass = x.double().abs() @ c.double().abs().T
    err = (got.double() - exact).abs()
    assert got.shape == (n, k)
    assert bool((err <= 1e-5 * mass + 1e-6).all()), float((err / mass).max())


def _probe_msg(got, want):
    """Where the product differs, which element of the probe the kernel
    read: value v encodes (tile row v // 32, feature v % 32)."""
    bad = torch.nonzero(got != want)[:12].tolist()
    return f"{int((got != want).sum())} of {got.numel()} differ; " + ", ".join(
        f"({r},{j}): got {got[r, j]:.0f} = ({int(got[r, j]) // 32}, "
        f"{int(got[r, j]) % 32}) want ({int(want[r, j]) // 32}, "
        f"{int(want[r, j]) % 32})" for r, j in bad)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [256, 64, 50])
@pytest.mark.parametrize("side", ["x", "c"])
def test_tc_dot_layout_probe(cuda, side, k):
    """Exact probes of the main loop's layout: one operand holds distinct
    integers below 2^11 (exact in TF32: small parts 0), the other one-hot
    rows, so each product is one element of the first, and a wrong
    swizzle, descriptor or fragment mapping shows which element it read
    instead. k = 256 runs the 128-wide tiles, k = 64 and 50 the 64-wide
    ones (50: a ragged tile)."""
    n, d = 128, 32
    rows = torch.arange(n, device=cuda)[:, None]
    cols = torch.arange(k, device=cuda)[:, None]
    feats = torch.arange(d, device=cuda)[None, :]
    if side == "x":   # x[r, f] = 32 (r % 64) + f; c[j] = e_(j % 32)
        x = ((rows % 64) * 32 + feats).float()
        c = (feats == cols % 32).float()
        want = ((rows % 64) * 32 + cols.T % 32).float()
    else:             # x[r] = e_(r % 32); c[j, f] = 32 (j % 64) + f
        x = (feats == rows % 32).float()
        c = ((cols % 64) * 32 + feats).float()
        want = ((cols.T % 64) * 32 + rows % 32).float()
    got = fused_round.tc_dot_cuda(x, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want), _probe_msg(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", [(4099, 784, 1), (4099, 784, 257),
                                   (777, 33, 50), (100, 7, 50),
                                   (4099, 33, 257), (60, 1024, 300),
                                   (130, 9, 1)])
def test_fused_round_kernel_matches_plain(cuda, n, d, k):
    """Kernel 4 (top-2 on the tensor cores, 3xTF32) against its plain
    version and against the once-rounded float64 top-2
    (`round_top2_exact`): d < 32, d % 4 != 0 (zero-padded copies), k = 1,
    ragged k tiles (k = 257, 300 > 256), n < 128 and ragged n."""
    x, c = _inputs(n, d, k, n + k, cuda)
    before = ops.launch_counts()["fused_round"]
    got = ops.fused_round(x, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_round"] == before + 1
    assert got[0].dtype == torch.int32
    for want in (fused_round.fused_round_ref(x, c)[:3],
                 round_top2_exact(x, c)):
        _assert_labels(got[0], want[0], ref.pairwise_dist2(x, c), 1e-5)
        for g, w in zip(got[1:3], want[1:3]):   # squared, +inf at k=1
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
    # the sums against the plain sums over the kernel's own labels
    S, v = ref.cluster_sum_ref(x, got[0], k)
    _, sse = ref.cluster_sum_ref(x[:, :0], got[0], k, weights=got[1])
    for g, w in zip(got[3:], (S, v, sse)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    for g, a in zip(got, ops.fused_round(x, c)):
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_fused_round_kernel_exact_ties(cuda):
    """Duplicates of the nearest centroid, in its k tile and in the next
    one (index 300): the lower index wins, and the second distance is the
    tied value."""
    x, c = _inputs(500, 16, 400, 17, cuda)
    rng = np.random.default_rng(18)
    c[1] = torch.from_numpy(rng.normal(size=16).astype(np.float32) * 0.3)
    c[4] = c[5] = c[300] = c[1]
    a, d1, d2 = ops.fused_round(x, c)[:3]
    torch.cuda.synchronize()
    assert not bool(torch.isin(a, torch.tensor([4, 5, 300],
                                               device=cuda)).any())
    won = a == 1
    assert bool(won.any()) and torch.equal(d2[won], d1[won])
    for want in (fused_round.fused_round_ref(x, c), round_top2_exact(x, c)):
        torch.testing.assert_close(d1, want[1], rtol=1e-5, atol=1e-4)


# -- the scatter against its order oracle, bit for bit -----------------------
#
# The three kernels sum in the order of `ref.ordered_sums`: with weights in
# {-1, 0, 1} (all the main path uses) they give its bits. Cases: the
# shapes above, k = 4096 (64 cluster tiles) at a few thousand rows, an n
# that is no multiple of its chunk (70001 rows, chunks of 512), every row
# in one cluster, no row adding to S (all weights 0; in the nested round
# no row joins or leaves), and k = 1.

SCATTER_CASES = ([shape + ("random",) for shape in SHAPES]
                 + [(3000, 64, 4096, "random"), (70001, 16, 50, "random"),
                    (5000, 40, 300, "one cluster"),
                    (5000, 40, 50, "weights 0"), (5000, 33, 1, "random")])


def _scatter_inputs(n, d, k, case, device):
    """x, c (c[0] nearest every row under "one cluster"), the labels and
    weights of cluster_sum, and the nested round's a_prev, settled,
    d_keep, lb_keep and valid."""
    rng = np.random.default_rng(n + d + k)
    x, c = _inputs(n, d, k, n * 5 + k, device)
    a = rng.integers(0, k, n).astype(np.int32)
    w = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    a_prev = rng.integers(-1, k, n).astype(np.int32)
    settled = (rng.random(n) < 0.3) & (a_prev >= 0)
    valid = rng.random(n) < 0.9
    if case == "one cluster":
        a[:] = k // 2
        c[1:] = c[0] + 1e3
    elif case == "weights 0":
        w[:] = 0.0
        a_prev = rng.integers(0, k, n).astype(np.int32)
        settled[:] = True
        valid[:] = True
    host = (a, w, a_prev, settled, rng.random(n).astype(np.float32),
            rng.random(n).astype(np.float32), valid)
    return [x, c] + [torch.from_numpy(h).to(device) for h in host]


def _assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w), \
            float((g - w).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,case", SCATTER_CASES + [(3000, 0, 7,
                                                         "random")])
def test_cluster_sum_kernel_equals_the_order_oracle(cuda, n, d, k, case):
    x, _, a, w = _scatter_inputs(n, d, k, case, cuda)[:4]
    got = ops.cluster_sum(x, a, k, weights=w)
    torch.cuda.synchronize()
    _assert_bits(got, ref.ordered_sums(x, k, a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,case", SCATTER_CASES)
def test_fused_nested_round_kernel_equals_the_order_oracle(cuda, n, d, k,
                                                           case):
    x, c, _, _, *nested = _scatter_inputs(n, d, k, case, cuda)
    got = fused_round.fused_nested_round_cuda(x, c, *nested)
    torch.cuda.synchronize()
    if case == "weights 0":
        assert torch.equal(got[0], nested[0])
        assert not bool(got[3].any()) and not bool(got[4].any())
    _assert_bits(got[3:], ref.ordered_sums(x, k, a_prev=nested[0],
                                           a_new=got[0], d_new=got[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,case", SCATTER_CASES)
def test_fused_round_kernel_equals_the_order_oracle(cuda, n, d, k, case):
    x, c = _scatter_inputs(n, d, k, case, cuda)[:2]
    got = fused_round.fused_round_cuda(x, c)
    torch.cuda.synchronize()
    if case == "one cluster":
        assert bool((got[0] == 0).all())
    _assert_bits(got[3:], ref.ordered_sums(x, k, got[0], d1sq=got[1]))


@pytest.mark.gpu
def test_fit_on_card_matches_cpu(cuda):
    """A small fit through the kernels gives the labels and schedule of
    the plain versions on the CPU, and the same bits twice."""
    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(4000, k=8, dim=16, spread=5.0, seed=0)
    cfg = FitConfig(k=8, b0=1000)
    ops.reset_launch_counts()
    gpu = NestedKMeans(cfg, device=cuda).fit(X)
    counts = ops.launch_counts()
    assert all(counts[name] > 0 for name in
               ("assign_top2", "cluster_sum", "fused_nested_round")), counts
    cpu = NestedKMeans(cfg, device="cpu").fit(X)
    np.testing.assert_array_equal(gpu.labels_, cpu.labels_)
    np.testing.assert_array_equal(gpu.predict(X), cpu.predict(X))
    np.testing.assert_allclose(gpu.cluster_centers_, cpu.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    again = NestedKMeans(cfg, device=cuda).fit(X)
    assert np.array_equal(again.cluster_centers_, gpu.cluster_centers_)


# -- the plain path and the round on the card --------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", [(70001, 64, 7), (3000, 32, 4096),
                                   (5000, 0, 50), (300, 784, 50)])
def test_cluster_sum_ref_on_the_card_repeats(cuda, n, d, k):
    """The plain sums on the card (`ref.onehot_sums`) give the same bits
    twice, and agree with ``index_add_`` within cluster_sum's tolerance
    (1e-5 of each entry's L1 mass, plus 1e-4). Many rows to a cluster
    (70001 rows, k = 7) is where ``index_add_``'s atomics reorder."""
    rng = np.random.default_rng(n + d + k)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], n).astype(
        np.float32)).to(cuda)
    got = ref.cluster_sum_ref(x, a, k, weights=w)
    again = ref.cluster_sum_ref(x, a, k, weights=w)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    idx = a.long()
    want = (torch.zeros(k, d, device=cuda).index_add_(0, idx, x * w[:, None]),
            torch.zeros(k, device=cuda).index_add_(0, idx, w))
    mass = (torch.zeros(k, d, device=cuda).index_add_(0, idx,
                                                      (x * w[:, None]).abs()),
            torch.zeros(k, device=cuda).index_add_(0, idx, w.abs()))
    for g, wt, m in zip(got, want, mass):
        assert bool(((g - wt).abs() <= 1e-5 * m + 1e-4).all())


@pytest.mark.gpu
def test_ref_fit_on_card_repeats(cuda):
    """Two fits on the plain versions on the card give the same bits."""
    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(20000, k=8, dim=16, spread=5.0, seed=0)
    cfg = FitConfig(k=8, b0=1000, kernel_backend="ref")
    one = NestedKMeans(cfg, device=cuda).fit(X)
    two = NestedKMeans(cfg, device=cuda).fit(X)
    assert np.array_equal(one.cluster_centers_, two.cluster_centers_)
    assert np.array_equal(one.labels_, two.labels_)


@pytest.mark.gpu
def test_nested_round_makes_no_synchronisation(cuda):
    """One dense round (the fused kernel) and one compacted round
    (assign_top2 on the compacted rows, cluster_sum for the deltas) of
    `nested_round` on the card, under ``set_sync_debug_mode("error")``:
    nothing in a round waits for the device (`api/loop.py` reads the
    round's info once, after it)."""
    from repro_torch.core import rounds, state
    from repro_torch.data.synthetic import gaussian_blobs
    from repro_torch.kernels.plan import KernelPlan
    X, _ = gaussian_blobs(4000, k=8, dim=16, spread=5.0, seed=0)
    X = torch.from_numpy(X).to(cuda)
    plan = KernelPlan("cuda", (4096, 8, 16))
    inf = float("inf")
    # first use: the libraries load, the allocator grows
    st, _ = rounds.nested_round(X, state.init_state(X, 8), b=1000, rho=inf,
                                plan=plan)
    st, _ = rounds.nested_round(X, st, b=2000, rho=inf, capacity=1024,
                                plan=plan)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dense, info_d = rounds.nested_round(X, st, b=2000, rho=inf,
                                            plan=plan)
        compact, info_c = rounds.nested_round(X, dense, b=2000, rho=inf,
                                              capacity=1024, plan=plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(info_d.n_active) == 2000 and int(info_c.n_active) == 2000
    assert int(info_c.n_recomputed) <= 1024
    assert bool((compact.points.a[:2000] >= 0).all())


# -- the other algorithms and bound families on the card ----------------------

#: the rounds of lloyd, mb, mb-f and the elkan and exponion families, each
#: from a state a few rounds into its own fit on the blobs
NEW_ROUNDS = ("lloyd", "mb", "mbf", "elkan", "exponion")


def _new_round(name, X, st, idx, plan):
    from repro_torch.core import rounds
    if name == "lloyd":
        return rounds.lloyd_round(X, st, plan=plan)
    if name in ("mb", "mbf"):
        return rounds.mb_round(X, idx, st, fixed=name == "mbf", plan=plan)
    return rounds.nested_round(X, st, b=2000, rho=float("inf"), bounds=name,
                               plan=plan)


def _new_round_input(name, device):
    """Blobs on ``device``, a state two rounds into a fit of ``name`` on
    the plain versions (some rows seen, some not), and a batch for mb:
    a device slice of a permutation uploaded once, as the engine takes
    its batches."""
    from repro_torch.core import rounds, state
    from repro_torch.data.synthetic import gaussian_blobs
    from repro_torch.kernels.plan import KernelPlan
    X, _ = gaussian_blobs(4000, k=8, dim=16, spread=5.0, seed=0)
    X = torch.from_numpy(X).to(device)
    plan = KernelPlan("ref", (4096, 8, 16))
    bounds = name if name in ("elkan", "exponion") else "none"
    st = state.init_state(X, 8, bounds=bounds)
    for r in range(2):
        if bounds == "none":
            idx = torch.arange(r * 700, (r + 1) * 700, device=device)
            st, _ = rounds.mb_round(X, idx, st, fixed=True, plan=plan)
        else:
            st, _ = rounds.nested_round(X, st, b=1000, rho=float("inf"),
                                        bounds=bounds, plan=plan)
    perm = np.random.default_rng(3).permutation(X.shape[0])
    return X, st, torch.from_numpy(perm).to(device)[:700]


def _round_outputs(st, info):
    out = [st.stats.C, st.stats.S, st.stats.v, st.stats.sse, st.stats.p,
           st.points.a, st.points.d, st.points.lb, info.n_recomputed,
           info.n_changed, info.batch_mse]
    return out + ([st.elkan.l] if st.elkan is not None else [])


@pytest.mark.gpu
@pytest.mark.parametrize("name", NEW_ROUNDS)
def test_new_rounds_make_no_synchronisation(cuda, name):
    """lloyd_round, mb_round and nested_round with elkan or exponion
    bounds, on the kernels, under ``set_sync_debug_mode("error")``."""
    from repro_torch.kernels.plan import KernelPlan
    X, st, idx = _new_round_input(name, cuda)
    plan = KernelPlan("cuda", (4096, 8, 16))
    _new_round(name, X, st, idx, plan)   # first use: libraries, allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, info = _new_round(name, X, st, idx, plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(info.n_recomputed) > 0
    assert bool(torch.isfinite(new.stats.C).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", NEW_ROUNDS)
def test_new_rounds_on_the_kernels_match_the_plain_versions(cuda, name):
    """One round from the same state on the "cuda" and the "ref" plan:
    labels equal but where two distances tie within 100x the f32
    tolerance, the same counts, sums and centroids within the f32
    tolerance."""
    from repro_torch.kernels.plan import KernelPlan
    X, st, idx = _new_round_input(name, cuda)
    got, gi = _new_round(name, X, st, idx, KernelPlan("cuda", (4096, 8, 16)))
    want, wi = _new_round(name, X, st, idx, KernelPlan("ref", (4096, 8, 16)))
    a_got, a_want = got.points.a, want.points.a
    seen = (a_got >= 0) & (a_want >= 0)
    assert torch.equal(a_got >= 0, a_want >= 0)
    d2m = ref.pairwise_dist2(X[seen], st.stats.C)
    _assert_labels(a_got[seen], a_want[seen], d2m, TOL["f32"])
    assert int(gi.n_recomputed) == int(wi.n_recomputed)
    assert int(gi.n_changed) == int(wi.n_changed)
    for f in ("C", "S", "v", "sse"):
        torch.testing.assert_close(getattr(got.stats, f),
                                   getattr(want.stats, f), rtol=1e-5,
                                   atol=1e-3)
    torch.testing.assert_close(got.points.d, want.points.d, rtol=1e-5,
                               atol=1e-4)
    if got.elkan is not None:
        torch.testing.assert_close(got.elkan.l, want.elkan.l, rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NEW_ROUNDS)
def test_new_rounds_repeat_their_bits(cuda, name):
    from repro_torch.kernels.plan import KernelPlan
    X, st, idx = _new_round_input(name, cuda)
    plan = KernelPlan("cuda", (4096, 8, 16))
    one = _round_outputs(*_new_round(name, X, st, idx, plan))
    two = _round_outputs(*_new_round(name, X, st, idx, plan))
    assert all(torch.equal(u, v) for u, v in zip(one, two))


FITS = {"lloyd": {"algorithm": "lloyd"},
        "mb": {"algorithm": "mb", "b0": 700, "max_rounds": 12},
        "mbf": {"algorithm": "mbf", "b0": 700, "max_rounds": 12},
        "sgd": {"algorithm": "sgd", "max_rounds": 12},
        "lloyd_elkan": {"algorithm": "lloyd-elkan", "max_rounds": 12},
        "tb_elkan": {"b0": 1000, "bounds": "elkan"},
        "tb_exponion": {"b0": 1000, "bounds": "exponion"}}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FITS))
def test_new_algorithms_fit_on_card_match_cpu(cuda, name):
    """A small fit of each other algorithm and bound family through the
    kernels launches them and gives the labels, batch sizes and changes
    of the plain versions on the CPU. The pair counts of the elkan and
    exponion families are not compared: their bound tests are decided
    by f32 distances that the card and the CPU sum in different orders,
    and lloyd-elkan's part at a near-tie in round 6 (one pair; ROADMAP
    Queue 3 item 1). `chip_smoke.py` phase 7 holds each family's labels
    to the exhaustive step's instead."""
    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(4000, k=8, dim=16, spread=5.0, seed=0)
    cfg = FitConfig(k=8, **FITS[name])
    ops.reset_launch_counts()
    gpu = NestedKMeans(cfg, device=cuda).fit(X)
    counts = ops.launch_counts()
    assert counts["cluster_sum"] > 0, counts
    if name in ("lloyd", "mb", "mbf", "sgd"):
        assert counts["assign_top2"] > 0, counts
    cpu = NestedKMeans(cfg, device="cpu").fit(X)
    np.testing.assert_array_equal(gpu.labels_, cpu.labels_)
    assert [(r.b, r.n_changed) for r in gpu.telemetry_] == \
        [(r.b, r.n_changed) for r in cpu.telemetry_]
    np.testing.assert_allclose(gpu.cluster_centers_, cpu.cluster_centers_,
                               rtol=1e-5, atol=1e-4)


GPU_KILLS = {"tb_hamerly2": {"b0": 512},
             "tb_elkan": {"b0": 512, "bounds": "elkan"},
             "mb": {"algorithm": "mb", "b0": 700, "max_rounds": 14}}


def _tel_minus_t(records):
    out = []
    for r in records:
        r = r.to_dict()
        r.pop("t")
        out.append(r)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GPU_KILLS))
def test_kill_and_resume_on_card_bit_identical(cuda, tmp_path, name):
    """A fit through the kernels cut at round 7 (last save at round 6)
    and resumed on the card gives the unbroken fit's bits."""
    import dataclasses

    from repro_torch.api import (CheckpointConfig, FitConfig, NestedKMeans,
                                 fit)
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(4000, k=8, dim=16, spread=5.0, seed=0)
    cfg = FitConfig(**dict(dict(k=8, max_rounds=40, seed=0),
                           **GPU_KILLS[name]))
    whole = fit(X, cfg, device=cuda)
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=3)
    fit(X, dataclasses.replace(cfg, max_rounds=7, checkpoint=ck),
        device=cuda)
    ops.reset_launch_counts()
    km = NestedKMeans(dataclasses.replace(cfg, checkpoint=ck), device=cuda)
    km.fit(X, resume=True)
    assert ops.launch_counts()["cluster_sum"] > 0
    np.testing.assert_array_equal(km.cluster_centers_, whole.C)
    np.testing.assert_array_equal(km.labels_, whole.labels)
    assert _tel_minus_t(km.telemetry_) == _tel_minus_t(whole.telemetry)


@pytest.mark.gpu
def test_store_fit_on_card_equals_in_memory_fit(cuda, tmp_path):
    """A store-backed fit on the card (the device buffer filled in place
    as the prefix grows) has the bits of the in-memory fit of the rows
    in `store_permutation`'s order."""
    from repro_torch.api import FitConfig, fit
    from repro_torch.data.store import (ChunkStore, store_permutation,
                                        write_store)
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(5003, k=8, dim=16, spread=5.0, seed=0)
    write_store(tmp_path / "st", X, chunk_rows=512)
    st = ChunkStore(tmp_path / "st")
    ops.reset_launch_counts()
    out_s = fit(st, FitConfig(k=8, b0=256, seed=2), device=cuda)
    counts = ops.launch_counts()
    assert all(counts[n] > 0 for n in ("assign_top2", "cluster_sum",
                                       "fused_nested_round")), counts
    perm = store_permutation(len(X), 512, seed=2)
    out_m = fit(X[perm], FitConfig(k=8, b0=256, seed=2, shuffle=False),
                device=cuda)
    np.testing.assert_array_equal(out_s.C, out_m.C)
    np.testing.assert_array_equal(out_s.labels[perm], out_m.labels)
    assert _tel_minus_t(out_s.telemetry) == _tel_minus_t(out_m.telemetry)
    assert st.metrics.bytes_read <= 1.6 * X.nbytes


@pytest.mark.gpu
def test_card_checkpoint_restores_on_the_cpu(cuda, tmp_path):
    """A checkpoint written from the card's state restores into a CPU
    run of the port with equal leaves and engine meta."""
    from repro_torch.api import FitConfig
    from repro_torch.api.engines.local import LocalEngine
    from repro_torch.api.loop import run_loop
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(4000, k=8, dim=16, spread=5.0, seed=0)
    cfg = FitConfig(k=8, b0=512, bounds="elkan", max_rounds=5,
                    seed=0).resolve(len(X))
    gpu = LocalEngine().begin(X, cfg, device=cuda)
    out = run_loop(gpu, cfg)
    tree, meta = gpu.capture(out.state)
    store = CheckpointStore(tmp_path)
    store.save(5, tree, extra={"engine": meta})
    cpu = LocalEngine().begin(X, cfg, device="cpu")
    got = cpu.restore(store, 5, store.read_extra()["engine"])
    for f in ("C", "S", "v", "sse", "p"):
        assert torch.equal(getattr(got.stats, f),
                           getattr(out.state.stats, f).cpu())
    for f in ("a", "d", "lb"):
        assert torch.equal(getattr(got.points, f),
                           getattr(out.state.points, f).cpu())
    assert torch.equal(got.elkan.l, out.state.elkan.l.cpu())
    assert torch.equal(got.round, out.state.round.cpu())
    assert got.points.a.device.type == "cpu"
    np.testing.assert_array_equal(cpu._mb_perm, gpu._mb_perm)
    assert cpu.capture(got)[1] == meta


# -- the streaming service on the card ---------------------------------------

@pytest.mark.gpu
def test_service_on_card_serves_readers_and_folds_each_row_once(cuda):
    """A small `ClusterService` on the card: 2 reader threads predict
    while 1 producer delivers every row twice under its id. No reader
    sees a torn snapshot or a falling version, labels equal the plain
    assignment on the serving snapshot's C but at near-ties, each row
    lands in the counts once, and the kernels ran: the refresher's
    rounds (fused_nested_round, on the service's own stream) and the
    readers' assign_top2. Every join takes a timeout."""
    import threading
    import time

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.synthetic import gaussian_blobs
    from repro_torch.serve import ClusterService, IngestQueue
    X, _ = gaussian_blobs(6000, k=8, dim=16, spread=5.0, seed=0)
    km = NestedKMeans(FitConfig(k=8, b0=500, seed=0), device=cuda)
    km.fit(X[:2000])
    n0 = float(np.sum(km.counts_, dtype=np.float64))
    before = ops.launch_counts()
    svc = ClusterService(km, queue=IngestQueue(max_rows=1024, dedup=True),
                         micro_batch=128, flush_after_s=0.01).start()
    assert svc.stream is not None
    assert svc.stream != torch.cuda.current_stream(cuda)
    stop = threading.Event()
    errors, checked = [], [0, 0]

    def reader(slot):
        Q = X[slot * 200:(slot + 1) * 200]
        Qd = torch.from_numpy(Q).to(cuda)
        last = 0
        try:
            while not stop.is_set():
                snap = svc.snapshot
                assert snap.verify(), f"torn read at v{snap.version}"
                assert snap.version >= last, (last, snap.version)
                last = snap.version
                labels = svc.predict(Q)
                if svc.snapshot is snap:     # this snapshot served it
                    C = torch.from_numpy(np.array(snap.centroids)).to(cuda)
                    want = ref.assign_top2_ref(Qd, C)[0]
                    _assert_labels(torch.from_numpy(labels).to(cuda), want,
                                   ref.pairwise_dist2(Qd, C), TOL["f32"])
                    checked[slot] += 1
        except Exception as e:               # noqa: BLE001 — asserted below
            errors.append(repr(e))

    def producer():
        for lo in range(2000, 6000, 100):
            for _ in range(2):
                svc.ingest(X[lo:lo + 100], ids=range(lo, lo + 100))

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(2)]
    threads.append(threading.Thread(target=producer, daemon=True))
    for t in threads:
        t.start()
    threads[2].join(60)
    t0 = time.time()
    while svc.queue.depth and time.time() - t0 < 60:
        time.sleep(0.01)
    time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    svc.stop(drain=True)
    assert not errors, errors
    assert all(n > 0 for n in checked)
    m = svc.export_metrics()
    assert m["refresh"]["rows"] == 4000 and m["queue"]["deduped"] == 4000
    assert float(np.sum(km.counts_, dtype=np.float64)) == n0 + 4000
    after = ops.launch_counts()
    for name in ("assign_top2", "fused_nested_round"):
        assert after[name] > before[name], name


@pytest.mark.gpu
def test_launch_counts_are_exact_under_threads(cuda):
    """8 threads launch assign_top2 200 times each with a short switch
    interval: every launch is counted (the counts rise under one lock)."""
    import sys
    import threading
    x, c = _inputs(64, 16, 8, 0, cuda)
    ops.assign_top2(x, c)                # the library loads once, here
    before = ops.launch_counts()["assign_top2"]
    errors = []

    def launch():
        try:
            for _ in range(200):
                ops.assign_top2(x, c)
        except Exception as e:           # noqa: BLE001 — asserted below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, daemon=True)
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert ops.launch_counts()["assign_top2"] == before + 8 * 200

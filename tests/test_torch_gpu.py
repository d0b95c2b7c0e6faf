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
#: kmeans_xl's width: d = 1024 at k = 4096 and at a model rank's 2048
XL_SHAPES = [(8192, 1024, 2048), (8192, 1024, 4096)]


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
                                            (4099, 784, 64), (4099, 784, 65)]
                         + XL_SHAPES)
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
@pytest.mark.parametrize("n,d,k", SHAPES + [(64, 129, 7), (1000, 200, 400)]
                         + XL_SHAPES)
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
@pytest.mark.parametrize("n,d,k", SHAPES + [(3000, 0, 7),
                                            (8192, 1024, 4096)])
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
@pytest.mark.parametrize("n,d,k,case", SCATTER_CASES + [
    (3000, 0, 7, "random"), (8192, 1024, 4096, "random")])
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



@pytest.mark.gpu
def test_engine_shuffles_the_rows_on_the_card(cuda):
    """At infMNIST's width (d = 784, several staging segments) the
    in-memory engine's scatter on the card places X[perm] bit for bit;
    placing holds at most the staging budget and the int64 index beyond
    what the run keeps (the rows, X_val, the state); and a fit is bitwise
    the fit of the host's X[perm] placed unshuffled."""
    from repro_torch import obs
    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.api.engines import local
    from repro_torch.data.synthetic import gaussian_blobs
    N, d = 50000, 784
    X, _ = gaussian_blobs(N, k=50, dim=d, spread=5.0, seed=0)
    X_val = X[:1000].copy()
    seg = local._STAGE_BYTES // (4 * d)
    assert N > 4 * seg
    cfg = FitConfig(k=50, b0=5000, seed=3).resolve(N)
    torch.cuda.synchronize(cuda)
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    run = local.LocalEngine().begin(X, cfg, X_val=X_val, device=cuda)
    torch.cuda.synchronize(cuda)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    held = torch.cuda.memory_allocated(cuda) - base
    perm = np.random.default_rng(3).permutation(N)
    assert np.array_equal(run._Xd.cpu().numpy(), X[perm])
    np.testing.assert_array_equal(run.orig_index, perm)
    assert obs.recent_roots("engine.place")[-1].total(
        "engine.scatter")[1] == -(-N // seg)
    # the allocator rounds each block up to 512 bytes
    assert peak - held <= local._STAGE_BYTES + 8 * N + 2 * 512, (peak, held)
    del run
    small = dict(k=50, b0=5000, seed=3, max_rounds=40)
    shuffled = NestedKMeans(FitConfig(**small), device=cuda).fit(
        X, X_val=X_val)
    placed = NestedKMeans(FitConfig(shuffle=False, **small),
                          device=cuda).fit(X[perm], X_val=X_val)
    assert np.array_equal(shuffled.cluster_centers_,
                          placed.cluster_centers_)
    assert np.array_equal(shuffled.labels_[perm], placed.labels_)
    assert [r.n_recomputed for r in shuffled.telemetry_] == \
        [r.n_recomputed for r in placed.telemetry_]


@pytest.mark.gpu
def test_spans_lie_on_the_host_side_of_a_profiled_fit(cuda):
    """Under `torch.profiler` the program's spans are ranges of the host's
    timeline only: no device event carries a span's name (a user
    annotation would be mirrored onto the device and read as busy)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(20000, k=16, dim=64, spread=5.0, seed=0)
    km = NestedKMeans(FitConfig(k=16, b0=2000), device=cuda)
    km.fit(X)                                     # builds and warms up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        km.fit(X)
        km.predict(X)
    spans = ("estimator.", "engine.", "loop.", "round.", "predict.",
             "eval_mse")
    events = prof.events()
    dev = [e.name for e in events if str(e.device_type).endswith("CUDA")]
    host = {e.name for e in events
            if not str(e.device_type).endswith("CUDA")}
    assert dev and not [n for n in dev if n.startswith(spans)]
    assert {"estimator.fit", "engine.upload", "loop.issue", "loop.fetch",
            "round.assign", "estimator.predict",
            "predict.labels"} <= host


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


# -- the host-sync auditor on the card ----------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("path", ["tb_traced", "mb", "lloyd", "elkan",
                                  "store"])
def test_hostsync_audit_on_the_card_is_clean(cuda, tmp_path, path):
    """Small fits under `hostsync`'s two layers on the card
    (``set_sync_debug_mode`` in the round scope, the interceptor on
    `torch.Tensor`): no synchronisation outside the sanctioned crossings,
    with tracing on; the store fit's segment uploads and mb's
    permutation upload run in the engine's sanctioned "upload" scope."""
    from repro_torch.analysis import hostsync
    from repro_torch.api.config import FitConfig
    from repro_torch.api.engines import make_engine
    from repro_torch.api.loop import run_loop
    from repro_torch.data.store import ChunkStore, write_store
    from repro_torch.obs import read_events, summarize
    if path == "tb_traced":
        assert hostsync.audit_backend("local", device=cuda,
                                      trace_dir=str(tmp_path)) == []
        assert summarize(read_events(tmp_path))["rounds"] > 0
        return
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4096, 16)).astype(np.float32)
    if path == "store":
        write_store(tmp_path / "st", X, chunk_rows=512)
        config = FitConfig(k=8, b0=256, capacity_floor=32,
                           max_rounds=30).resolve(4096)
        data = [ChunkStore(tmp_path / "st") for _ in range(2)]
    else:
        kw = {"mb": dict(algorithm="mb", b0=512, max_rounds=20),
              "lloyd": dict(algorithm="lloyd", max_rounds=10),
              "elkan": dict(bounds="elkan", b0=256, max_rounds=30)}[path]
        config = FitConfig(k=8, eval_every=4, **kw).resolve(4096)
        data = [X, X]
    run_loop(make_engine(config).begin(data[0], config, X_val=X[:256],
                                       device=cuda), config)   # warm-up
    audit = hostsync.HostSyncAudit(device=cuda)
    with audit.installed():
        run_loop(make_engine(config).begin(data[1], config, X_val=X[:256],
                                           device=cuda), config, audit=audit)
    assert audit.violations == [], [str(v) for v in audit.violations]
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.gpu
def test_hostsync_sync_debug_layer_catches_the_planted_leak(cuda):
    """Layer (a) alone (sync-debug mode, no interceptor) flags an
    ``.item()`` in the round scope at its caller's line and leaves the
    mode as it found it; the selftest's planted per-round ``float()`` of
    a device scalar is caught by it at the planted line."""
    from repro_torch.analysis import _selftest as fx
    from repro_torch.analysis import hostsync
    audit = hostsync.HostSyncAudit(device=cuda)
    x = torch.ones((), device=cuda)
    with audit.round_scope():
        assert torch.cuda.get_sync_debug_mode() == 1
        with audit.sanctioned_scope("round_info"):
            assert x.item() == 1.0                # sanctioned: silent
        assert x.item() == 1.0                    # flagged
    assert torch.cuda.get_sync_debug_mode() == 0
    assert [(v.kind, v.file) for v in audit.violations] == \
        [("cuda-sync", "tests/test_torch_gpu.py")]
    found = hostsync.selftest(device=cuda)
    line = fx.leaky_line("if float(torch.max(state.stats.p)) > 1e9:")
    assert {v.kind for v in found} >= {"cuda-sync", "d2h-float"}
    assert all(v.line == line for v in found)


@pytest.mark.gpu
def test_inplace_check_on_the_card_counts_only_the_growth(cuda):
    """The in-place check's memory bound on the card: a small store fit
    is clean beside other tensors the process holds (many times its
    buffer), and the planted copying segment write is flagged as a
    second buffer, a moved pointer and a copying write."""
    from repro_torch.analysis import donation
    held = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    assert donation.run(device=cuda) == []
    found = donation.selftest(device=cuda)
    assert {v.kind for v in found} == {"copying-write", "buffer-moved",
                                       "second-buffer"}
    del held


# -- the mesh engines on the card ---------------------------------------------

def _blobs(n=4000):
    from repro_torch.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(n, k=8, dim=16, spread=5.0, seed=0)
    Xv, _ = gaussian_blobs(512, k=8, dim=16, spread=5.0, seed=1)
    return X[:n - 1], Xv


@pytest.mark.gpu
def test_one_rank_nccl_mesh_fit_equals_local_on_card(cuda):
    """A mesh fit over a one-rank NCCL group is bit-equal to the local fit
    on the card (C, labels, telemetry but t) and launches the kernels."""
    import socket

    import torch.distributed as dist

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.launch.mesh import make_host_mesh
    X, Xv = _blobs()
    cfg = FitConfig(k=8, b0=1000)
    local = NestedKMeans(cfg, device="cuda").fit(X, X_val=Xv)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        before = ops.launch_counts()
        km = NestedKMeans(FitConfig(k=8, b0=1000, backend="mesh"),
                          mesh=make_host_mesh((1,), ("data",)),
                          device="cuda").fit(X, X_val=Xv)
        torch.cuda.synchronize()
        after = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(km.cluster_centers_,
                                  local.cluster_centers_)
    np.testing.assert_array_equal(km.labels_, local.labels_)
    assert [r.to_dict() | {"t": 0} for r in km.telemetry_] == \
        [r.to_dict() | {"t": 0} for r in local.telemetry_]
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        assert after[name] > before[name], name


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_launch_the_kernels(cuda, tmp_path):
    """Two spawned ranks of a gloo group both compute on the card: the
    kernels launch on every rank, and the ranks hold the same bits."""
    import torch_dist_worker as worker
    X, Xv = _blobs()
    ranks = worker.spawn(tmp_path, "mesh", (2,), ("data",), parts=["card"],
                         dir=str(tmp_path), X=X, Xv=Xv, timeout_s=300)
    for r in ranks:
        assert str(r["card_device"]).startswith("cuda")
        assert (r["launches"] > 0).all(), r["launches"]
        for key in ("C_card", "labels_card", "tel_card"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
    assert ranks[0]["labels_card"].min() >= 0
    assert ranks[0]["sched_card"][-1, 0] == len(X)


# -- the XL engine on the card ------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", XL_SHAPES)
def test_top2_kernels_at_kmeans_xl_width_match_the_plain_labels(cuda, n, d,
                                                                k):
    """Kernels 1 and 3 at kmeans_xl's width take the plain versions'
    labels but at ties (the float64 oracle holds their distances: the
    plain f32 product is no oracle at this width)."""
    x, c = _inputs(n, d, k, n + k, cuda)
    d2m = ref.pairwise_dist2(x, c)
    want = ref.assign_top2_ref(x, c)[0]
    _assert_labels(ops.assign_top2(x, c)[0], want, d2m, TOL["f32"])
    ones = torch.ones(n, dtype=torch.bool, device=cuda)
    minus = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    zeros = torch.zeros(n, device=cuda)
    got = ops.fused_nested_round(x, c, minus, ~ones, zeros, zeros, ones)
    _assert_labels(got[0], want, d2m, TOL["f32"])
    torch.cuda.synchronize()


def _one_rank_nccl():
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return make_host_mesh((1, 1), ("data", "model"))


@pytest.mark.gpu
def test_new_collectives_on_a_one_rank_nccl_group(cuda):
    """The reduce-scatter, MAX and MIN all-reduces and the ring permute
    over a one-rank NCCL (data, model) mesh give their inputs back, as
    over a one-device JAX mesh, on the card."""
    import torch.distributed as dist

    from repro_torch.core import collectives
    t = torch.randn(64, 9, device=cuda)
    mesh = _one_rank_nccl()
    try:
        got = [collectives.psum_scatter(t, mesh, "model"),
               collectives.pmax(t, mesh, "model"),
               collectives.pmin(t[0], mesh, "data"),
               collectives.ppermute_ring(t, mesh, "model")]
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, (t, t, t[0], t)):
        assert g.device == t.device and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("bounds,capacity", [
    ("none", None), ("hamerly2", None), ("hamerly2", 512),
    ("elkan", None), ("exponion", None)])
def test_xl_round_at_one_model_rank_equals_nested_round_on_card(
        cuda, bounds, capacity):
    """`xl_nested_round` over a one-rank NCCL (1, 1) mesh, on the "cuda"
    plan, from a state two rounds into a fit: every leaf of the state and
    every field of the info bit-equal to `rounds.nested_round`'s (the
    dense hamerly2 round through the fused kernel, the compacted one
    through kernels 1 and 2)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.core import rounds, state
    from repro_torch.core.distributed_xl import xl_nested_round
    from repro_torch.kernels.plan import KernelPlan
    X = torch.from_numpy(_blobs()[0]).to(cuda)
    plan = KernelPlan("cuda", (4096, 8, 16))
    st = state.init_state(X, 8, bounds=bounds)
    for b in (1000, 1000):
        st, _ = rounds.nested_round(X, st, b=b, rho=float("inf"),
                                    bounds=bounds, plan=plan)
    kw = dict(b=2000, rho=float("inf"), bounds=bounds, capacity=capacity,
              plan=plan)
    want = rounds.nested_round(X, st, **kw)
    mesh = _one_rank_nccl()
    try:
        got = xl_nested_round(X, st, mesh=mesh, data_axes=("data",),
                              model_axis="model", **kw)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for g, w in ((got[0].stats, want[0].stats), (got[0].points,
                                                 want[0].points),
                 (got[1], want[1])):
        for f in dataclasses.fields(w):
            assert torch.equal(getattr(g, f.name), getattr(w, f.name)), \
                f.name
    if bounds == "elkan":
        assert torch.equal(got[0].elkan.l, want[0].elkan.l)


@pytest.mark.gpu
def test_two_gloo_model_ranks_on_one_card(cuda, tmp_path):
    """Two spawned ranks of a gloo (1, 2) group on the card: the new
    collectives carry CUDA tensors, and an XL fit launches kernels 1 and
    2 on every rank, the ranks holding the same bits."""
    import torch_dist_worker as worker
    X, Xv = _blobs()
    ranks = worker.spawn(tmp_path, "xl_engine", (1, 2), worker.XL_AXES,
                         parts=["card:1x2"], dir=str(tmp_path), X=X, Xv=Xv,
                         timeout_s=300)
    for r in ranks:
        assert r["1x2_card_ok"].all(), r["1x2_card_ok"]
        assert str(r["1x2_card_device"]).startswith("cuda")
        assert (r["1x2_card_launches"] > 0).all(), r["1x2_card_launches"]
        for key in ("C_1x2_card", "labels_1x2_card", "tel_1x2_card"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
    assert ranks[0]["labels_1x2_card"].min() >= 0


# -- the dense model and the serve entry point on the card --------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_dense_model_on_card_matches_cpu(cuda):
    """The reduced tinyllama's weights made on the CPU and copied to the
    card: prefill and decode logits within 6e-2 of the CPU's (bf16
    activations); the attention in f32 within 1e-5, TF32 off."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train import step as tstep
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced("tinyllama-1.1b")
    params = M.init_params(1, cfg, "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 17)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda))):
        t = toks.to(dev)
        lp, cache = tstep.make_prefill_step(cfg, cache_len=21)(
            p, {"tokens": t[:, :-1]})
        ld, _ = tstep.make_decode_step(cfg)(p, t[:, -1:], cache)
        out[dev] = (lp.cpu(), ld.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=6e-2, atol=6e-2)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, h, 16))
                                .astype(np.float32))
               for s, h in ((48, 4), (64, 2), (64, 2)))
    kw = dict(causal=True, q_chunk=16, kv_chunk=16, q_offset=16)
    want = L.flash_attention(q, k, v, **kw)
    got = L.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_build_codebook_on_card_runs_the_kernels(cuda):
    """The codebook over the reduced tinyllama's embedding table on the
    card: kernels 1 and 3 launched (never their plain versions), the
    same bits twice, its MSE within 1e-3 of the CPU fit's, and its
    service folding each id in once."""
    from repro_torch import configs
    from repro_torch.launch.serve import build_codebook
    from repro_torch.models import model as M
    from repro_torch.serve import ClusterService, IngestQueue
    E = M.init_params(1, configs.get_reduced("tinyllama-1.1b"), "cpu")[
        "embed"].float().numpy()
    ops.reset_launch_counts()
    km = build_codebook(E, 16, 0, device=cuda)
    km.predict(E)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["assign_top2"] > 0 and counts["fused_nested_round"] > 0
    assert km.outcome_.kernel_plan["backend"] == "cuda"
    again = build_codebook(E, 16, 0, device=cuda)
    np.testing.assert_array_equal(again.cluster_centers_,
                                  km.cluster_centers_)
    cpu = build_codebook(E, 16, 0, device="cpu")

    def mse(C):
        d = ((E[:, None, :] - C[None]) ** 2).sum(-1)
        return float(d.min(1).mean())

    assert abs(mse(km.cluster_centers_) - mse(cpu.cluster_centers_)) <= \
        1e-3 * mse(cpu.cluster_centers_)
    n0 = float(km.counts_.sum())
    svc = ClusterService(km, micro_batch=32, flush_after_s=0.01,
                         queue=IngestQueue(max_rows=1024, dedup=True))
    svc.start()
    try:
        ids = np.arange(64)
        svc.ingest(E[ids], ids=ids.tolist())
        svc.ingest(E[ids], ids=ids.tolist())
    finally:
        svc.stop()
    assert float(km.counts_.sum()) == n0 + 64
    assert svc.snapshot.verify()


@pytest.mark.gpu
def test_serve_cli_on_card(cuda):
    """``python -m repro_torch.launch.serve --codebook 16`` on the card
    (its default device), reduced: rc 0 and its service line."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "tinyllama-1.1b", "--codebook", "16"], capture_output=True,
        text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert p.returncode == 0, p.stderr
    assert "on cuda" in p.stdout and "codebook service:" in p.stdout


# -- the moe, ssm and hybrid families on the card ----------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "jamba-v0.1-52b"])
def test_moe_ssm_hybrid_models_on_card_match_cpu(cuda, arch):
    """The reduced granite-moe (moe), mamba2 (ssm) and jamba (hybrid):
    weights made on the CPU and copied to the card, prefill and decode
    logits within 6e-2 of the CPU's (bf16 activations), the decode's
    SSM state written in place."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.train import step as tstep
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_reduced(arch)
    params = M.init_params(1, cfg, "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 21)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda))):
        t = toks.to(dev)
        lp, cache = tstep.make_prefill_step(cfg, cache_len=24)(
            p, {"tokens": t[:, :-1]})
        ld, new = tstep.make_decode_step(cfg)(p, t[:, -1:], cache)
        out[dev] = (lp.cpu(), ld.cpu())
        assert all(new["blocks"][t_] is cache["blocks"][t_]
                   for t_ in cache["blocks"])
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=6e-2, atol=6e-2)


def _train_steps_on(cfg, device, steps, seed=0):
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    params = M.init_params(seed, cfg, device)
    opt = adamw.init(params)
    step = tstep.make_train_step(cfg, n_micro=2, opt_cfg=adamw.AdamWConfig(
        lr=3e-3, warmup_steps=2, decay_steps=20))
    data = LMBatches(vocab=cfg.vocab, batch=4, seq=steps[1],
                     n_tokens=40_000, seed=0)
    metrics = []
    for s in range(steps[0]):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.at(s).items()}
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics


@pytest.mark.gpu
def test_moe_train_step_on_card_repeats_its_bits(cuda):
    """3 train steps of the reduced granite-moe on the card, twice: every
    param, moment and the count bit-equal (the dispatch writes unique
    slots, the combine's backward adds one term a slot), the loss
    finite."""
    from repro_torch import configs
    from repro_torch.util.tree import tree_leaves
    cfg = configs.get_reduced("granite-moe-1b-a400m")
    runs = [_train_steps_on(cfg, cuda, (3, 16)) for _ in range(2)]
    (p1, o1, m1), (p2, o2, m2) = runs
    assert m1 == m2 and all(np.isfinite(m["loss"]) for m in m1)
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu)
                    + [o1.count],
                    tree_leaves(p2) + tree_leaves(o2.mu) + tree_leaves(o2.nu)
                    + [o2.count]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_ssm_train_step_at_chunk_128_has_finite_gradients(cuda):
    """mamba2 reduced with ``chunk=128`` at S = 128 (one chunk of 128,
    where the reference's SSD gradient is NaN, ROADMAP Queue 3 item 9):
    2 steps on the card, each grad_norm and loss finite."""
    import dataclasses

    from repro_torch import configs
    cfg = configs.get_reduced("mamba2-2.7b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=128))
    _, _, metrics = _train_steps_on(cfg, cuda, (2, 128))
    for m in metrics:
        assert np.isfinite(m["grad_norm"]) and np.isfinite(m["loss"]), m


# -- the encdec and vlm families and the RCV1 fit on the card -----------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_encdec_and_vlm_models_on_card_match_cpu(cuda, arch):
    """The reduced whisper-tiny (encdec) and internvl2-76b (vlm): weights
    made on the CPU and copied to the card, normal bf16 frames or patches
    from a numpy seed, the cache sized as the serve CLI sizes it;
    prefill and decode logits and whisper's cached ``enc_out`` within
    6e-2 of the CPU's (bf16 activations)."""
    from repro_torch import configs
    from repro_torch.launch.serve import cache_len
    from repro_torch.models import model as M
    from repro_torch.train import step as tstep
    cfg = configs.get_reduced(arch)
    params = M.init_params(1, cfg, "cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13)))
    e = cfg.encoder
    shape = ((2, e.n_ctx, e.d_frontend) if cfg.family == "encdec"
             else (2, e.n_ctx, cfg.d_model))
    name = "frames" if cfg.family == "encdec" else "patches"
    extra = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    out = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda))):
        t = toks.to(dev)
        lp, cache = tstep.make_prefill_step(cfg, cache_len=cache_len(
            cfg, 12, 4))(p, {"tokens": t[:, :-1], name: extra.to(dev)})
        enc = cache["enc_out"].cpu() if "enc_out" in cache else None
        ld, _ = tstep.make_decode_step(cfg)(p, t[:, -1:], cache)
        out[dev] = (lp.cpu(), ld.cpu()) + ((enc,) if enc is not None
                                           else ())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=6e-2, atol=6e-2)


@pytest.mark.gpu
def test_rcv1_fit_on_card_runs_the_kernels(cuda):
    """The paper's RCV1 algorithm (tb, hamerly2, rho = inf) at k = 8 on
    3,000 `rcv1_like` rows at d = 256 on the card: kernels 1-3 launched,
    the same bits twice, the final validation MSE within 1e-3 of the CPU
    fit's (the plain versions)."""
    import math

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.synthetic import rcv1_like
    X = rcv1_like(3300, dim=256, seed=0)
    X, Xv = X[:3000], X[3000:]
    cfg = FitConfig(k=8, b0=256, algorithm="tb", rho=math.inf,
                    bounds="hamerly2", seed=0)
    ops.reset_launch_counts()
    km = NestedKMeans(cfg, device=cuda).fit(X, X_val=Xv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        assert counts[name] > 0, counts
    again = NestedKMeans(cfg, device=cuda).fit(X, X_val=Xv)
    np.testing.assert_array_equal(again.cluster_centers_,
                                  km.cluster_centers_)
    np.testing.assert_array_equal(again.labels_, km.labels_)
    cpu = NestedKMeans(cfg, device="cpu").fit(X, X_val=Xv)
    assert abs(km.final_mse_ - cpu.final_mse_) <= 1e-3 * cpu.final_mse_


def _sharded_steps_on(cfg, device, steps, mesh=None):
    """``steps`` train steps (n_micro 2, batch 4 x 16 from numpy seed 0)
    from `init_params(1)`: the local step, or the sharded step on
    ``mesh``; returns every param, moment, the count and the losses."""
    from repro_torch.launch.input_specs import abstract_params
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.util.tree import tree_leaves
    params = M.init_params(1, cfg, device)
    specs = None
    if mesh is not None:
        specs = S.param_specs(cfg, mesh, abstract_params(cfg))
        params = S.shard_tree(params, specs, mesh)
    opt = adamw.init(params)
    step = tstep.make_train_step(cfg, n_micro=2, mesh=mesh, device=device)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    batch = {k: v.to(device) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])
    return (tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
            + [opt.count] + losses)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"])
def test_one_rank_nccl_sharded_step_equals_the_local_step(cuda, arch):
    """3 steps of the sharded train step on a one-rank NCCL (1, 1) mesh:
    every param, moment, the count and the losses bit-equal to the local
    step's at --reduced size."""
    import torch.distributed as dist

    from repro_torch import configs
    cfg = configs.get_reduced(arch)
    local = _sharded_steps_on(cfg, cuda, 3)
    mesh = _one_rank_nccl()
    try:
        got = _sharded_steps_on(cfg, cuda, 3, mesh)
    finally:
        dist.destroy_process_group()
    assert len(got) == len(local)
    assert all(torch.equal(a, b) for a, b in zip(got, local))


@pytest.mark.gpu
def test_ep_dispatch_on_one_rank_equals_the_dense_dispatch(cuda):
    """granite's MoE layer (reduced, capacity factor 100: nothing
    dropped) under a one-rank NCCL (1, 1) mesh runs the expert-parallel
    dispatch; its output and aux loss equal the dense dispatch's on the
    same tokens bit for bit (one rank holds every expert), and so do
    their gradients."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = configs.get_reduced("granite-moe-1b-a400m")
    moe = dataclasses.replace(cfg.moe, capacity_factor=100.0)
    p = {k: v[0] for k, v in
         M.init_params(1, cfg, cuda)["blocks"]["0"]["moe"].items()}
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator(
        cuda).manual_seed(0), device=cuda).bfloat16()
    T, K = 4 * 16, moe.top_k
    assert bool(L.moe_route(p, x.reshape(T, -1), moe)[3].all())

    def run():
        xs = x.clone().requires_grad_()
        out, aux = L.moe_fwd(p, xs, moe)
        (gx,) = torch.autograd.grad(out.float().sum() + aux, xs)
        return out, aux, gx

    dense = run()
    calls = []
    orig = L._moe_fwd_ep
    mesh = _one_rank_nccl()
    try:
        L._moe_fwd_ep = lambda *a: calls.append(1) or orig(*a)
        with L.use_mesh(mesh):
            ep = run()
    finally:
        L._moe_fwd_ep = orig
        dist.destroy_process_group()
    assert calls == [1]
    for a, b in zip(ep, dense):
        assert torch.equal(a, b)

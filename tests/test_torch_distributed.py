"""The port's one-shot round kernel and its distributed rounds against the
JAX package, and the port's multi-rank rounds against its one-rank ones.

On the CPU, with the same numpy inputs (or the same JAX state carried
over with `repro_torch.convert.state_from_numpy`) in both packages:

* `fused_round_ref`, the plain version of the one-shot round kernel,
  against JAX's `fused_round_pallas` in interpret mode and against JAX's
  `fused_round_ref`;
* `dp_round_body` (fused and not), `xl_round_body` and
  `make_sharded_round` against JAX's on a one-device mesh, the port's
  single-device form (``mesh=None``);
* rounds over 2 and 2x2 ranks of a gloo process group, spawned by
  `torch.multiprocessing` (tests/torch_dist_worker.py, which imports no
  JAX), against the port's one-rank rounds. Each spawn has a join
  timeout and each rank a process-group timeout, so a stuck rank fails
  its test and does not hang the run.

Labels must be equal. Floats are compared at rtol 1e-5 unless a test
says why not: the two packages' matrix products and sums add in
different orders.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from repro.core import distributed as jdist
from repro.core import rounds as jrounds
from repro.core import state as jstate
from repro.kernels.fused_round import (fused_round_pallas,
                                       fused_round_ref as jfused_ref)
from repro.kernels.plan import resolve_plan as jresolve
from repro_torch.convert import state_from_numpy
from repro_torch.core import distributed as tdist
from repro_torch.kernels import fused_round
from repro_torch.kernels.plan import KernelPlan
from repro_torch.launch.mesh import make_host_mesh

INF = math.inf
SHAPES = [(100, 16, 5), (256, 64, 32), (300, 48, 7)]
JOIN_TIMEOUT_S = 120


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _inputs(n, d, k):
    rng = np.random.default_rng(n + k)
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(k, d)) * 2).astype(np.float32))


# -- the one-shot round kernel's plain version -------------------------------

@pytest.mark.parametrize("n,d,k", SHAPES)
def test_fused_round_plain_matches_pallas(n, d, k):
    """Against the TPU kernel in interpret mode: labels equal, the rest at
    rtol 1e-4 / atol 1e-3. The kernel's wrapper pads n to its row tile
    and subtracts the pads' |c_a|^2 from sse again, a cancellation that
    leaves its sse ~1e-4 relative off at these n; the port has no pad
    rows, so its sse is held to a float64 sum at rtol 1e-5 as well."""
    x, c = _inputs(n, d, k)
    got = fused_round.fused_round_ref(torch.from_numpy(x),
                                      torch.from_numpy(c))
    want = fused_round_pallas(jnp.asarray(x), jnp.asarray(c), bn=128,
                              interpret=True)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, rtol=1e-4, atol=1e-3)
    a = _np(got[0])
    d1_exact = ((x.astype(np.float64) - c[a]) ** 2).sum(1)
    sse_exact = np.bincount(a, weights=d1_exact, minlength=k)
    _close(got[5], sse_exact, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_fused_round_plain_matches_jax_ref(n, d, k):
    """Against JAX's oracle, at tests/test_kernels.py's tolerances for the
    TPU kernel against it. The oracle takes the top-2 on the ref
    expression and the port on the partial distance: they agree but for
    ties and the last bits of d1 and d2."""
    x, c = _inputs(n, d, k)
    a, d1, d2, S, v, sse = fused_round.fused_round_ref(
        torch.from_numpy(x), torch.from_numpy(c))
    a_r, d1_r, d2_r, S_r, v_r, sse_r = jfused_ref(jnp.asarray(x),
                                                  jnp.asarray(c))
    np.testing.assert_array_equal(_np(a), np.asarray(a_r))
    _close(d1, d1_r, rtol=1e-4, atol=1e-4)
    _close(d2, d2_r, rtol=1e-4, atol=1e-4)
    _close(S, S_r, rtol=1e-4, atol=1e-3)
    _close(v, v_r, rtol=1e-6, atol=1e-6)
    _close(sse, sse_r, rtol=1e-4, atol=1e-3)


# -- the rounds of core/distributed.py, single device --------------------------

def _assert_round(got, want, names, sse_rtol=1e-5):
    for name, g, w in zip(names, got, want):
        if name in ("a", "grow"):
            np.testing.assert_array_equal(_np(g), np.asarray(w), name)
        elif name == "sse":
            _close(g, w, rtol=sse_rtol, atol=1e-3)
        else:
            # sums over ~500 rows of magnitude ~10 in another order
            _close(g, w, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def blobs_c0(blobs):
    X, _ = blobs
    X = X[np.random.default_rng(0).permutation(len(X))]
    return X, X[:8].copy()


@pytest.mark.parametrize("fused", [True, False])
def test_dp_round_matches_jax(blobs_c0, fused):
    """``fused``: JAX runs the TPU kernel in interpret mode, the port the
    kernel's plain version (the tensors lie on the CPU)."""
    X, C = blobs_c0
    want = jdist.make_dp_round(jax.make_mesh((1,), ("data",)),
                               use_pallas=fused)(jnp.asarray(X),
                                                 jnp.asarray(C))
    got = tdist.make_dp_round(None, fused=fused)(torch.from_numpy(X),
                                                 torch.from_numpy(C))
    _assert_round(got, want, worker.DP_OUT)
    assert got[3].dtype == torch.int32


@pytest.mark.parametrize("rho", [INF, 0.5])
def test_xl_round_matches_jax(blobs_c0, rho):
    X, C = blobs_c0
    S0, v0 = np.zeros_like(C), np.zeros(len(C), np.float32)
    want = jdist.make_xl_round(jax.make_mesh((1, 1), ("data", "model")),
                               k=len(C), rho=rho)(
        *map(jnp.asarray, (X, C, S0, v0)))
    got = tdist.make_xl_round(None, k=len(C), rho=rho)(
        *map(torch.from_numpy, (X, C, S0, v0)))
    _assert_round(got, want, ("C_new", "S", "v", "a", "d", "d2", "grow",
                              "r_med", "mse"))


@pytest.fixture(scope="module")
def mid_fit(blobs):
    """Shuffled blobs and a JAX state two rounds into a b=1000 fit, as
    numpy leaves: the state tests/test_torch_rounds.py starts from, whose
    next rounds have no Hamerly near-tie (ROADMAP Queue 3 item 1)."""
    X, _ = blobs
    Xd = X[np.random.default_rng(0).permutation(len(X))]
    Xj = jnp.asarray(Xd)
    state = jstate.init_state(Xj, 8)
    plan = jresolve("ref", b=len(X), k=8, d=X.shape[1])
    for _ in range(2):
        state, _ = jrounds.nested_round(Xj, state, b=1000, rho=INF,
                                        plan=plan)
    return Xd, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("b,capacity,n_real,bounds", [
    (2000, None, None, "hamerly2"), (2000, None, 1501, "hamerly2"),
    (1000, 512, None, "hamerly2"), (2000, None, 1777, "none")])
def test_sharded_round_matches_jax(mid_fit, b, capacity, n_real, bounds):
    Xd, jtree = mid_fit
    jplan = jresolve("ref", b=len(Xd), k=8, d=Xd.shape[1])
    jst, jinfo = jdist.make_sharded_round(
        jax.make_mesh((1,), ("data",)), ("data",), b_local=b, rho=INF,
        bounds=bounds, capacity=capacity, n_real=n_real, plan=jplan)(
        jnp.asarray(Xd), jax.tree.map(jnp.asarray, jtree))
    tst, tinfo = tdist.make_sharded_round(
        None, ("data",), b_local=b, rho=INF, bounds=bounds,
        capacity=capacity, n_real=n_real,
        plan=KernelPlan("ref", jplan.bucket))(
        torch.from_numpy(Xd), state_from_numpy(jtree, device="cpu"))
    np.testing.assert_array_equal(_np(tst.points.a), np.asarray(jst.points.a))
    for f in ("n_changed", "n_recomputed", "n_active", "overflow", "grow"):
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    assert tinfo.n_active.dtype == torch.int32
    for f in ("batch_mse", "r_median", "p_max"):
        _close(getattr(tinfo, f), getattr(jinfo, f))
    for f in ("C", "S", "v", "p"):
        _close(getattr(tst.stats, f), getattr(jst.stats, f))
    _close(tst.stats.sse, jst.stats.sse, rtol=1e-5, atol=1e-3)


class _Coords:
    """A stand-in for a DeviceMesh: its named dims and this rank's
    coordinates."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self._coord = shape, names, coord

    def get_local_rank(self, axis):
        return self._coord[self.mesh_dim_names.index(axis)]


def test_per_shard_n_valid_rule():
    """Row-major over the data dims, the tail rows on the low shards,
    as JAX's `per_shard_n_valid` lays them out."""
    assert tdist.per_shard_n_valid(None, ("data",), None) is None
    assert tdist.per_shard_n_valid(None, ("data",), 7) == 7
    got = [tdist.per_shard_n_valid(
        _Coords((2, 3, 2), ("pod", "data", "model"), (p, q, m)),
        ("pod", "data"), 20) for p in range(2) for q in range(3)
        for m in range(2)]
    # 20 rows over 6 shards: 4, 4, 3, 3, 3, 3, replicated over "model"
    assert got == [4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3]


def test_fold_top2_matches_jax():
    """Ties on the minimum go to the lower global index on both sides."""
    rng = np.random.default_rng(5)
    d1 = rng.integers(0, 3, size=(2, 64)).astype(np.float32)
    d2 = d1 + rng.integers(0, 3, size=(2, 64)).astype(np.float32)
    ia = rng.integers(0, 100, size=(2, 64)).astype(np.int32)
    want = jdist._fold_top2(*(jnp.asarray(t) for t in
                              (d1[0], d2[0], ia[0], d1[1], d2[1], ia[1])))
    got = tdist._fold_top2(*(torch.from_numpy(t) for t in
                             (d1[0], d2[0], ia[0], d1[1], d2[1], ia[1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh((1,), ("data",))


# -- multi-rank rounds on spawned gloo ranks ---------------------------------

def _spawn(tmp_path, case, shape, axes, **inputs):
    """Run ``case`` on prod(shape) spawned ranks; their outputs by rank."""
    return worker.spawn(tmp_path, case, shape, axes,
                        timeout_s=JOIN_TIMEOUT_S, **inputs)


def test_dp_round_two_ranks_equal_one(tmp_path, blobs_c0):
    """Labels exact; C, S, v at rtol 1e-5 (the ranks' sums add in another
    order than one rank's); both ranks the same bits."""
    X, C = blobs_c0
    ranks = _spawn(tmp_path, "dp", (2,), ("data",), X=X, C=C)
    for fused in (1, 0):
        one = tdist.make_dp_round(None, fused=bool(fused))(
            torch.from_numpy(X), torch.from_numpy(C))
        for name, want in zip(worker.DP_OUT, one):
            got = [r[f"{name}_{fused}"] for r in ranks]
            if name in ("a", "d"):      # row-sharded: the ranks' slices
                got = np.concatenate(got)
            else:                       # replicated: equal on every rank
                np.testing.assert_array_equal(got[0], got[1])
                got = got[0]
            if name in ("a", "grow"):
                np.testing.assert_array_equal(got, _np(want))
            else:
                _close(got, want, rtol=1e-5, atol=1e-5)


def test_xl_round_2x2_equals_1x1_with_a_cross_shard_tie(tmp_path, blobs_c0):
    """k=8 over 2 model ranks, with centroid 6 (on model rank 1) an exact
    copy of centroid 1 (on rank 0): the lower global index, 1, wins its
    rows on both meshes, and their second distance equals the first."""
    X, C = blobs_c0
    C = C.copy()
    C[6] = C[1]
    ranks = _spawn(tmp_path, "xl", (2, 2), ("data", "model"), X=X, C=C)
    one = tdist.make_xl_round(None, k=8)(
        *map(torch.from_numpy, (X, C, np.zeros_like(C),
                                np.zeros(8, np.float32))))
    by_rank = {(dq, m): ranks[2 * dq + m] for dq in range(2)
               for m in range(2)}
    for r in ranks:
        np.testing.assert_array_equal(r["model_order"], [0, 1])
    a = np.concatenate([by_rank[(dq, 0)]["a"] for dq in range(2)])
    np.testing.assert_array_equal(a, _np(one[3]))
    won = a == 1
    assert won.any() and not (a == 6).any()
    d = np.concatenate([by_rank[(dq, 0)]["d"] for dq in range(2)])
    d2 = np.concatenate([by_rank[(dq, 0)]["d2"] for dq in range(2)])
    np.testing.assert_array_equal(d2[won], d[won])
    _close(d, one[4])
    _close(d2, one[5])
    for dq in range(2):           # replicated over "model" within a row
        np.testing.assert_array_equal(by_rank[(dq, 0)]["a"],
                                      by_rank[(dq, 1)]["a"])
    for m in range(2):            # the model rank's k-slice of C
        got = by_rank[(0, m)]["C"]
        np.testing.assert_array_equal(got, by_rank[(1, m)]["C"])
        _close(got, one[0][4 * m:4 * m + 4])
    for i, name in ((6, "grow"), (7, "r_med"), (8, "mse")):
        for r in ranks:
            _close(r[name], one[i])


def test_sharded_round_two_ranks_odd_n_real(tmp_path, blobs_c0):
    """Two rounds, b_local 300 then 600, over 2 x 600 rows with n_real =
    1199: rank 0 holds 600 real rows and rank 1 599 and a pad. The one-rank
    rounds run over the union of the two ranks' prefixes, laid out so
    that the first round's 600 rows are a prefix of the second's 1199."""
    X, C = blobs_c0
    X = X[:1200]
    ranks = _spawn(tmp_path, "sharded", (2,), ("data",), X=X, C=C,
                   n_real=1199)
    x0, x1 = X[:600], X[600:]
    parts = [x0[:300], x1[:300], x0[300:], x1[300:599]]
    union = np.concatenate(parts)
    Xt = torch.from_numpy(union)
    st = worker.fresh_state(Xt, torch.from_numpy(C))
    for r, b in enumerate((600, 1199)):
        st, info = tdist.make_sharded_round(
            None, ("data",), b_local=b, rho=INF)(Xt, st)
        a = _np(st.points.a)
        got = np.concatenate([ranks[0][f"a_{r}"][:300],
                              ranks[1][f"a_{r}"][:300],
                              ranks[0][f"a_{r}"][300:],
                              ranks[1][f"a_{r}"][300:599]])
        np.testing.assert_array_equal(got, a)
        assert ranks[1][f"a_{r}"][599] == -1
        for f in ("n_changed", "n_recomputed", "n_active", "grow"):
            assert ranks[0][f"{f}_{r}"] == ranks[1][f"{f}_{r}"] \
                == int(getattr(info, f)), f
        np.testing.assert_array_equal(ranks[0][f"C_{r}"], ranks[1][f"C_{r}"])
        _close(ranks[0][f"C_{r}"], st.stats.C)
        _close(ranks[0][f"batch_mse_{r}"], info.batch_mse)
    assert int(info.n_active) == 1199

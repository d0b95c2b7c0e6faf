"""The port's state, controller and nested round against the JAX package.

The same numpy inputs, or the same JAX state carried over with
`repro_torch.convert.state_from_numpy`, go through both packages on the
CPU. Labels and the integer `RoundInfo` fields must be equal; floats are
compared at rtol 1e-5 (the two packages' matrix products sum in different
orders, so their floats need not match bit for bit), with the absolute
slack that the |x|^2 - 2 x.c + |c|^2 expansion leaves in distances.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctl
from repro.core import rounds as jrounds
from repro.core import state as jstate
from repro.kernels.plan import resolve_plan as jresolve
from repro_torch.convert import codebook_from_numpy, state_from_numpy
from repro_torch.core import controller as tctl
from repro_torch.core import rounds as trounds
from repro_torch.core import state as tstate
from repro_torch.kernels.plan import KernelPlan

INF = math.inf


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# -- state and controller ----------------------------------------------------

def test_centroid_update_matches_jax():
    rng = np.random.default_rng(0)
    C = rng.normal(size=(6, 5)).astype(np.float32)
    S = rng.normal(size=(6, 5)).astype(np.float32) * 10
    v = np.array([3, 0, 1, 7, 0, 2], np.float32)      # two empty clusters
    z = np.zeros(6, np.float32)
    j = jstate.centroid_update(jstate.ClusterStats(
        C=jnp.asarray(C), S=jnp.asarray(S), v=jnp.asarray(v),
        sse=jnp.asarray(z), p=jnp.asarray(z)))
    t = tstate.centroid_update(tstate.ClusterStats(
        C=torch.from_numpy(C), S=torch.from_numpy(S), v=torch.from_numpy(v),
        sse=torch.from_numpy(z), p=torch.from_numpy(z)))
    _close(t.C, j.C)
    _close(t.p, j.p)
    np.testing.assert_array_equal(_np(t.C)[[1, 4]], C[[1, 4]])
    assert np.all(_np(t.p)[[1, 4]] == 0)


@pytest.mark.parametrize("n,chunk,jax_rtol", [
    (300, 64, 1e-5), (256, 64, 1e-5),
    # JAX pads 50 rows to 65,536 and subtracts the pads' distances again:
    # that cancellation costs it ~3e-5 relative, while the port slices
    # the ragged chunk and stays at the float64 value
    (50, 65536, 1e-4)])
def test_full_mse_matches_jax(n, chunk, jax_rtol):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 12)).astype(np.float32)
    C = rng.normal(size=(5, 12)).astype(np.float32)
    j = jstate.full_mse(jnp.asarray(X), jnp.asarray(C), chunk=chunk)
    t = tstate.full_mse(torch.from_numpy(X), torch.from_numpy(C),
                        chunk=chunk)
    exact = ((X[:, None].astype(np.float64) - C[None]) ** 2).sum(-1) \
        .min(1).mean()
    _close(t, exact, rtol=1e-6, atol=0)
    _close(t, j, rtol=jax_rtol, atol=0)


def test_sigma_c_and_ratios_match_jax():
    sse = np.array([4.0, 2.0, 9.0, 1.0, 0.0, 3.0], np.float32)
    v = np.array([0.0, 1.0, 1.5, 1.9, 5.0, 2.0], np.float32)  # (1, 2) too
    p = np.array([1.0, 0.0, 0.5, 2.0, 1.0, 0.0], np.float32)
    _close(tctl.sigma_c(torch.from_numpy(sse), torch.from_numpy(v)),
           jctl.sigma_c(jnp.asarray(sse), jnp.asarray(v)))
    _close(tctl.growth_ratios(*map(torch.from_numpy, (sse, v, p))),
           jctl.growth_ratios(*map(jnp.asarray, (sse, v, p))))


@pytest.mark.parametrize("n_inf,rho", [(2, INF), (3, INF), (4, INF),
                                       (0, 0.5), (0, 50.0)])
def test_should_grow_matches_jax(n_inf, rho):
    """k=6 with 3 ratios infinite is exactly half: the lower median is
    finite and rho=inf does NOT grow; 4 of 6 does."""
    rng = np.random.default_rng(n_inf)
    sse = rng.random(6).astype(np.float32) * 10
    v = np.full(6, 5.0, np.float32)
    p = rng.random(6).astype(np.float32) + 0.1
    p[:n_inf] = 0.0
    gj, rj = jctl.should_grow(*map(jnp.asarray, (sse, v, p)), rho)
    gt, rt = tctl.should_grow(*map(torch.from_numpy, (sse, v, p)), rho)
    assert bool(gt) == bool(gj)
    _close(rt, rj)
    if rho == INF:
        assert bool(gt) == (n_inf > 3)


def test_codebook_from_numpy():
    C = np.arange(6, dtype=np.float32).reshape(3, 2)
    st = codebook_from_numpy(C, [2, 0, 1], device="cpu")
    np.testing.assert_array_equal(_np(tstate.centroid_update(st).C), C)


@pytest.mark.parametrize("fn", [state_from_numpy, codebook_from_numpy])
def test_convert_defaults_to_the_card(fn):
    """Both carry state onto the card unless asked, as the estimator does,
    and a bare call raises where there is none."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a bare call would succeed")
    args = ((np.zeros((2, 2), np.float32), [1, 1])
            if fn is codebook_from_numpy else (None,))
    with pytest.raises(RuntimeError, match="is_available"):
        fn(*args)


# -- one nested round from the same state --------------------------------------

@pytest.fixture(scope="module")
def mid_fit(blobs):
    """Shuffled blobs and a JAX state two rounds into a b=1000 fit, as
    numpy leaves."""
    X, _ = blobs
    Xd = X[np.random.default_rng(0).permutation(len(X))]
    Xj = jnp.asarray(Xd)
    state = jstate.init_state(Xj, 8)
    plan = jresolve("ref", b=len(X), k=8, d=X.shape[1])
    for _ in range(2):
        state, _ = jrounds.nested_round(Xj, state, b=1000, rho=INF,
                                        plan=plan)
    return Xd, jax.tree.map(np.asarray, state)


CASES = {
    # name: (b, capacity, n_valid, expect overflow)
    "dense_with_new_rows": (2000, None, None, False),
    "dense_masked": (2000, None, 1500, False),
    "compacted": (1000, 512, None, False),
    "overflow": (1000, 8, None, True),
}


@pytest.mark.parametrize("case,bounds", [
    (case, bounds) for case in sorted(CASES) for bounds in ("hamerly2", "none")
    if bounds == "hamerly2" or CASES[case][1] is None])   # none: no capacity
@pytest.mark.parametrize("kernels", ["ref", "fused"])
def test_nested_round_matches_jax(mid_fit, case, bounds, kernels):
    """"fused" runs JAX's Pallas plan (interpret mode) against the port's
    "cuda" plan, whose dense rounds take the fused path (here its plain
    version, since the tensors lie on the CPU)."""
    b, capacity, n_valid, overflow = CASES[case]
    Xd, jtree = mid_fit
    jplan = jresolve("ref" if kernels == "ref" else "pallas", b=len(Xd),
                     k=8, d=Xd.shape[1])
    tplan = KernelPlan("ref" if kernels == "ref" else "cuda",
                       jplan.bucket)
    jst, jinfo = jrounds.nested_round(
        jnp.asarray(Xd), jax.tree.map(jnp.asarray, jtree), b=b, rho=INF,
        bounds=bounds, capacity=capacity, plan=jplan,
        n_valid=None if n_valid is None else jnp.int32(n_valid))
    tst, tinfo = trounds.nested_round(
        torch.from_numpy(Xd), state_from_numpy(jtree, device="cpu"), b=b,
        rho=INF, bounds=bounds, capacity=capacity, plan=tplan,
        n_valid=n_valid)

    np.testing.assert_array_equal(_np(tst.points.a), _np(jst.points.a))
    for f in ("n_changed", "n_recomputed", "n_active", "overflow", "grow"):
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    assert bool(tinfo.overflow) == overflow
    assert tinfo.n_recomputed.dtype == torch.int32
    for f in ("batch_mse", "r_median", "p_max"):
        _close(getattr(tinfo, f), getattr(jinfo, f))
    for f in ("C", "S", "v", "p"):
        _close(getattr(tst.stats, f), getattr(jst.stats, f))
    _close(tst.stats.sse, jst.stats.sse, rtol=1e-5, atol=1e-3)
    _close(tst.points.d, jst.points.d, atol=1e-4)
    _close(tst.points.lb, jst.points.lb, atol=1e-4)
    assert int(tst.round) == int(jst.round)
    if n_valid is not None:
        assert np.all(_np(tst.points.a)[n_valid:b] == -1)


def test_round_scalars_are_filled_on_the_device():
    """`rounds._scalar` and `distributed._count` fill their 0-d tensors on
    x's device (no host copy) and give the values and dtypes of the
    ``torch.tensor`` calls they replace."""
    from repro_torch.core import distributed as tdist
    x = torch.zeros(37, 3)
    for v, dt in ((37, torch.int32), (0, torch.int32), (False, torch.bool),
                  (True, torch.bool)):
        got = trounds._scalar(v, x, dt)
        want = torch.tensor(v, dtype=dt)
        assert got.shape == () and got.dtype == dt and got.device == x.device
        assert torch.equal(got, want)
    assert trounds._scalar(5, x).dtype == torch.int32
    count = tdist._count(x)
    assert count.shape == () and count.dtype == torch.int64
    assert torch.equal(count, torch.tensor(37, dtype=torch.int64))

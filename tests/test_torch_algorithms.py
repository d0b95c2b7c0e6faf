"""The port's lloyd, mb, mbf and sgd against the JAX package's, on the CPU.

The same numpy inputs, or the same JAX state carried over with
`repro_torch.convert.state_from_numpy`, go through both packages: one
round from the same state (the JAX side on its ref plan, and on its
Pallas plan in interpret mode against the port's "cuda" plan, whose ops
take their plain versions on CPU tensors), and whole fits through both
estimators. Labels and the integer `RoundInfo` fields must be equal;
floats are compared at rtol 1e-5, as in tests/test_torch_rounds.py. Then
the JAX package's exactness properties of mb and mb-f, held inside the
port, and the legacy `core.driver` shim.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import FitConfig as JConfig
from repro.api import NestedKMeans as JKMeans
from repro.core import rounds as jrounds
from repro.core import state as jstate
from repro.kernels.plan import resolve_plan as jresolve
from repro_torch import api
from repro_torch.api import config as tconfig
from repro_torch.convert import state_from_numpy
from repro_torch.core import driver
from repro_torch.core import rounds as trounds
from repro_torch.core import state as tstate
from repro_torch.kernels.plan import KernelPlan

INF = math.inf


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _plans(kernels, n, d):
    """The JAX plan and the port's plan for one case: "ref" on both
    sides, or JAX's Pallas plan (interpret mode) against the port's
    "cuda" plan."""
    jplan = jresolve("ref" if kernels == "ref" else "pallas", b=n, k=8, d=d)
    return jplan, KernelPlan("ref" if kernels == "ref" else "cuda",
                             jplan.bucket)


def _assert_same_round(tst, tinfo, jst, jinfo):
    np.testing.assert_array_equal(_np(tst.points.a), _np(jst.points.a))
    for f in ("n_changed", "n_recomputed", "n_active", "overflow", "grow"):
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    assert tinfo.n_recomputed.dtype == torch.int32
    for f in ("batch_mse", "r_median", "p_max"):
        _close(getattr(tinfo, f), getattr(jinfo, f))
    for f in ("C", "S", "v", "p"):
        _close(getattr(tst.stats, f), getattr(jst.stats, f))
    _close(tst.stats.sse, jst.stats.sse, rtol=1e-5, atol=1e-3)
    _close(tst.points.d, jst.points.d, atol=1e-4)
    _close(tst.points.lb, jst.points.lb, atol=1e-4)
    assert int(tst.round) == int(jst.round)


@pytest.fixture(scope="module")
def mid_mb(blobs):
    """Shuffled blobs and a JAX state three mb-f rounds of 500 rows in,
    as numpy leaves: some rows seen, most not."""
    X, _ = blobs
    Xd = X[np.random.default_rng(0).permutation(len(X))]
    Xj = jnp.asarray(Xd)
    state = jstate.init_state(Xj, 8, bounds="none")
    order = np.random.default_rng(1).permutation(len(X))
    for r in range(3):
        state, _ = jrounds.mb_round(
            Xj, jnp.asarray(order[r * 500:(r + 1) * 500]), state, fixed=True)
    return Xd, jax.tree.map(np.asarray, state)


# -- one round from the same state ---------------------------------------------

@pytest.mark.parametrize("kernels", ["ref", "pallas"])
def test_lloyd_round_matches_jax(mid_mb, kernels):
    Xd, jtree = mid_mb
    jplan, tplan = _plans(kernels, *Xd.shape)
    jst, jinfo = jrounds.lloyd_round(
        jnp.asarray(Xd), jax.tree.map(jnp.asarray, jtree), plan=jplan)
    tst, tinfo = trounds.lloyd_round(
        torch.from_numpy(Xd), state_from_numpy(jtree, device="cpu"),
        plan=tplan)
    _assert_same_round(tst, tinfo, jst, jinfo)
    assert int(tinfo.n_recomputed) == len(Xd) and not bool(tinfo.grow)
    assert math.isinf(float(tinfo.r_median))


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("kernels", ["ref", "pallas"])
def test_mb_round_matches_jax(mid_mb, fixed, kernels):
    """A batch that mixes rows seen in earlier rounds with new ones."""
    Xd, jtree = mid_mb
    jplan, tplan = _plans(kernels, *Xd.shape)
    idx = np.random.default_rng(2).permutation(len(Xd))[:700]
    jst, jinfo = jrounds.mb_round(
        jnp.asarray(Xd), jnp.asarray(idx), jax.tree.map(jnp.asarray, jtree),
        fixed=fixed, plan=jplan)
    tstate_in = state_from_numpy(jtree, device="cpu")
    a_before = tstate_in.points.a.clone()
    tst, tinfo = trounds.mb_round(
        torch.from_numpy(Xd), torch.from_numpy(idx), tstate_in,
        fixed=fixed, plan=tplan)
    _assert_same_round(tst, tinfo, jst, jinfo)
    assert int(tinfo.n_recomputed) == 700
    # functional: the caller's state is not written
    assert torch.equal(tstate_in.points.a, a_before)


# -- whole fits ------------------------------------------------------------------

FITS = {
    # mb/mbf at b0=700 over N=4000: five batches a pass, so twelve rounds
    # cross two reshuffles of the resampling stream
    "lloyd": {"algorithm": "lloyd", "max_rounds": 12},
    "lloyd_to_convergence": {"algorithm": "lloyd"},
    "mb": {"algorithm": "mb", "b0": 700, "max_rounds": 12},
    "mbf": {"algorithm": "mbf", "b0": 700, "max_rounds": 12},
    # the stream is drawn after the (skipped) shuffle all the same
    "mbf_no_shuffle": {"algorithm": "mbf", "b0": 700, "max_rounds": 12,
                       "shuffle": False},
    "sgd": {"algorithm": "sgd", "max_rounds": 12},
}


def _schedule(km):
    return [(r.b, r.n_recomputed, r.n_changed, r.grow)
            for r in km.telemetry_]


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_matches_jax(blobs, blobs_val, name):
    X, _ = blobs
    kw = FITS[name]
    j = JKMeans(JConfig(k=8, kernel_backend="ref", **kw)).fit(
        X, X_val=blobs_val)
    t = api.NestedKMeans(api.FitConfig(k=8, **kw), device="cpu").fit(
        X, X_val=blobs_val)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    assert _schedule(t) == _schedule(j)
    assert t.converged_ == j.converged_
    assert t.converged_ == (name == "lloyd_to_convergence")
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.final_mse_, j.final_mse_, rtol=1e-5)


# -- the JAX package's exactness properties, inside the port -------------------

def _serial_mb_round(X, idx, C, v):
    """Sculley's Algorithm 1, straight from the paper, in numpy."""
    C = C.copy()
    v = v.copy()
    a = {}
    for i in idx:                       # assignment step (C frozen)
        a[i] = int(np.argmin(((X[i] - C) ** 2).sum(1)))
    for i in idx:                       # update step (running mean)
        j = a[i]
        v[j] += 1
        eta = 1.0 / v[j]
        C[j] = (1 - eta) * C[j] + eta * X[i]
    return C, v


def test_mb_matches_serial_oracle(blobs):
    """mb's S/v form equals the serial running-mean form."""
    X, _ = blobs
    X = X[:600]
    k, b = 8, 100
    rng = np.random.default_rng(0)
    Xs = X[rng.permutation(len(X))]
    Xd = torch.from_numpy(Xs)
    state = tstate.init_state(Xd, k, bounds="none")
    C_np = _np(state.stats.C).copy()
    v_np = np.zeros(k)
    order = rng.permutation(len(X))
    for r in range(4):
        idx = order[r * b:(r + 1) * b]
        state, _ = trounds.mb_round(Xd, torch.from_numpy(idx), state,
                                    fixed=False)
        C_np, v_np = _serial_mb_round(Xs, idx, C_np, v_np)
        np.testing.assert_allclose(_np(state.stats.C), C_np, rtol=1e-4,
                                   atol=1e-4, err_msg=f"round {r}")


def test_mbf_centroids_are_exact_current_means(blobs):
    """After any number of mb-f rounds, C(j) is the mean of the rows
    whose latest assignment is j."""
    X, _ = blobs
    X = X[:1000]
    k, b = 8, 200
    Xd = torch.from_numpy(X)
    state = tstate.init_state(Xd, k, bounds="none")
    rng = np.random.default_rng(1)
    for _ in range(8):
        idx = rng.permutation(len(X))[:b]
        state, _ = trounds.mbf_round(Xd, torch.from_numpy(idx), state)
    a = _np(state.points.a)
    C = _np(state.stats.C)
    for j in range(k):
        members = X[a == j]
        if len(members):
            np.testing.assert_allclose(C[j], members.mean(0), rtol=1e-4,
                                       atol=1e-4)


def test_nested_full_batch_equals_lloyd(blobs):
    """gb-inf with b0 = N converges to Lloyd's centroids."""
    X, _ = blobs
    r1 = driver.fit(X, 8, algorithm="lloyd", seed=3, max_rounds=40,
                    device="cpu")
    r2 = driver.fit(X, 8, algorithm="gb", b0=len(X), rho=INF, seed=3,
                    max_rounds=40, device="cpu")
    Xt = torch.from_numpy(X)
    m1 = float(tstate.full_mse(Xt, torch.from_numpy(r1.C)))
    m2 = float(tstate.full_mse(Xt, torch.from_numpy(r2.C)))
    assert r1.converged and r2.converged
    assert abs(m1 - m2) / m1 < 1e-5


# -- the legacy shim -------------------------------------------------------------

def test_driver_algorithms_match_the_config():
    assert driver.ALGORITHMS == tconfig.ALGORITHMS


def test_driver_fit_is_the_estimators(blobs, blobs_val):
    """The shim returns the estimator's fit as a `FitResult` with dict
    telemetry, and runs on the card unless asked."""
    X, _ = blobs
    res = driver.fit(X, 8, algorithm="mbf", b0=700, max_rounds=6,
                     X_val=blobs_val, device="cpu")
    km = api.NestedKMeans(api.FitConfig(k=8, algorithm="mbf", b0=700,
                                        max_rounds=6),
                          device="cpu").fit(X, X_val=blobs_val)
    np.testing.assert_array_equal(res.C, km.cluster_centers_)
    untimed = [{f: v for f, v in r.to_dict().items() if f != "t"}
               for r in km.telemetry_]
    assert [{f: v for f, v in r.items() if f != "t"}
            for r in res.telemetry] == untimed
    assert res.algorithm == "mbf" and res.final_mse == km.final_mse_
    assert isinstance(res.state, tstate.KMeansState)
    for fn in (driver.fit, api.fit):
        assert inspect.signature(fn).parameters["device"].default == "cuda"

"""The port's elkan and exponion bound families against the JAX package's,
on the CPU.

One nested round from the same JAX state carried over with
`repro_torch.convert.state_from_numpy` (the JAX side on its ref plan, and
on its Pallas plan in interpret mode against the port's "cuda" plan, whose
ops take their plain versions on CPU tensors), the exponion geometry, and
whole fits through both estimators. Labels and the integer `RoundInfo`
fields must be equal; floats are compared at rtol 1e-5, bounds at 1e-4, as
in tests/test_torch_rounds.py. Then the JAX package's exactness
properties, held inside the port: a bound family never changes an
assignment.
"""
import dataclasses
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
from repro_torch.convert import state_from_numpy
from repro_torch.core import rounds as trounds
from repro_torch.core import state as tstate
from repro_torch.kernels.plan import KernelPlan

INF = math.inf
FAMILIES = ("elkan", "exponion")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def mid_fits(blobs):
    """Shuffled blobs and, for each family, a JAX state two rounds into a
    b=1000 fit with that family's bounds, as numpy leaves."""
    X, _ = blobs
    Xd = X[np.random.default_rng(0).permutation(len(X))]
    Xj = jnp.asarray(Xd)
    plan = jresolve("ref", b=len(X), k=8, d=X.shape[1])
    trees = {}
    for bounds in FAMILIES:
        state = jstate.init_state(Xj, 8, bounds=bounds)
        for _ in range(2):
            state, _ = jrounds.nested_round(Xj, state, b=1000, rho=INF,
                                            bounds=bounds, plan=plan)
        trees[bounds] = jax.tree.map(np.asarray, state)
    return Xd, trees


CASES = {
    # name: (b, n_valid)
    "dense_with_new_rows": (2000, None),
    "dense_masked": (2000, 1500),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bounds", FAMILIES)
@pytest.mark.parametrize("kernels", ["ref", "pallas"])
def test_nested_round_matches_jax(mid_fits, case, bounds, kernels):
    b, n_valid = CASES[case]
    Xd, trees = mid_fits
    jtree = trees[bounds]
    jplan = jresolve("ref" if kernels == "ref" else "pallas", b=len(Xd),
                     k=8, d=Xd.shape[1])
    tplan = KernelPlan("ref" if kernels == "ref" else "cuda", jplan.bucket)
    jst, jinfo = jrounds.nested_round(
        jnp.asarray(Xd), jax.tree.map(jnp.asarray, jtree), b=b, rho=INF,
        bounds=bounds, plan=jplan,
        n_valid=None if n_valid is None else jnp.int32(n_valid))
    tin = state_from_numpy(jtree, device="cpu")
    lb_before = tin.points.lb.clone()
    tst, tinfo = trounds.nested_round(
        torch.from_numpy(Xd), tin, b=b, rho=INF, bounds=bounds, plan=tplan,
        n_valid=n_valid)

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
    if bounds == "elkan":
        _close(tst.elkan.l, jst.elkan.l, atol=1e-4)
        # elkan keeps no second-nearest bound: lb is left as it was
        assert torch.equal(tst.points.lb, lb_before)
    else:
        assert tst.elkan is None
    if n_valid is not None:
        assert np.all(_np(tst.points.a)[n_valid:b] == -1)
        if bounds == "elkan":
            assert not np.any(_np(tst.elkan.l)[n_valid:b])


def test_init_state_allocates_elkan_bounds_only_for_elkan():
    X = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    for bounds in ("none", "hamerly2", "elkan", "exponion"):
        j = jstate.init_state(jnp.asarray(X), 4, bounds=bounds)
        t = tstate.init_state(torch.from_numpy(X), 4, bounds=bounds)
        assert (t.elkan is None) == (j.elkan is None) == (bounds != "elkan")
    t = tstate.init_state(torch.from_numpy(X), 4, bounds="elkan")
    assert t.elkan.l.shape == (50, 4) and t.elkan.l.dtype == torch.float32
    assert not bool(t.elkan.l.any())


def test_state_from_numpy_carries_elkan_bounds(mid_fits):
    _, trees = mid_fits
    jtree = trees["elkan"]
    st = state_from_numpy(jtree, device="cpu")
    np.testing.assert_array_equal(_np(st.elkan.l), jtree.elkan.l)
    assert st.elkan.l.dtype == torch.float32
    assert state_from_numpy(trees["exponion"], device="cpu").elkan is None


# -- the exponion geometry -------------------------------------------------------

GEOMETRIES = {
    "blobs": None,
    # duplicate centroids: ties at distance 0 (and between the copies'
    # neighbours) are broken by index, as JAX's stable sort breaks them
    "duplicates": np.array([[0, 0], [3, 4], [0, 0], [3, 4], [6, 8], [0, 0]],
                           np.float32),
    "k1": np.array([[1.5, -2.0]], np.float32),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_exponion_geom_matches_jax(blobs, name):
    C = GEOMETRIES[name]
    if C is None:
        C = blobs[0][:8]
    j = jstate.build_exponion_geom(jnp.asarray(C))
    t = tstate.build_exponion_geom(torch.from_numpy(C))
    for f in ("order", "rank"):
        got, want = _np(getattr(t, f)), _np(getattr(j, f))
        assert getattr(t, f).dtype == torch.int32
        np.testing.assert_array_equal(got, want, err_msg=f)
    _close(t.dist, j.dist)
    _close(t.s, j.s)
    if name == "k1":
        assert _np(t.s).tolist() == [0.0]
    if name == "duplicates":
        # row 2 is a copy of row 0: 0 sorts first around it
        assert _np(t.order)[2, :3].tolist() == [0, 2, 5]


def test_exponion_annulus_boundary_tie():
    """A centroid exactly on the annulus boundary (d(c_a, c_j) == R) is
    scanned: the assignment stays and lb is the exact second-nearest.

    Anchor c0=(0,0), x=(1,0) so u=1; s(0)=d(c0,c1)=3 via c1=(0,3);
    R = 2u+s = 5 = d(c0,c2) = d(c0,c3) for c2=(5,0), c3=(-5,0). lb is
    deflated so the point fails its Hamerly test and scans its annulus.
    """
    C = torch.tensor([[0.0, 0.0], [0.0, 3.0], [5.0, 0.0], [-5.0, 0.0]])
    x = torch.tensor([[1.0, 0.0]])
    state = tstate.init_state(x, 4, bounds="exponion")
    state = dataclasses.replace(
        state,
        stats=dataclasses.replace(state.stats, C=C, p=torch.zeros(4)),
        points=dataclasses.replace(
            state.points, a=torch.tensor([0], dtype=torch.int32),
            d=torch.tensor([1.0]), lb=torch.tensor([0.5])))
    assert float(tstate.build_exponion_geom(C).s[0]) == 3.0
    a, d, lb, n_rec, overflow, _ = trounds._assign_exponion(
        x, state, state.points.a, None, use_shalf=False)
    assert int(a[0]) == 0
    assert float(d[0]) == pytest.approx(1.0)
    assert float(lb[0]) == pytest.approx(np.sqrt(10.0), rel=1e-6)
    # all 4 centroids scanned (the boundary pair too) + 1 d_a refresh
    assert int(n_rec) == 5
    assert not bool(overflow)


# -- whole fits ------------------------------------------------------------------

FITS = {
    "lloyd_elkan": {"algorithm": "lloyd-elkan", "max_rounds": 12},
    "tb_elkan": {"b0": 1000, "bounds": "elkan"},
    "tb_exponion": {"b0": 1000, "bounds": "exponion"},
    "tb_exponion_no_shalf": {"b0": 256, "bounds": "exponion",
                             "use_shalf": False},
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
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.final_mse_, j.final_mse_, rtol=1e-5)


def test_lloyd_elkan_to_convergence_matches_jax(blobs):
    """lloyd-elkan run to convergence: the labels, the centroids, the
    rounds and every round's b, changes and vote are JAX's. Each round's
    pair count is JAX's from the same state (the round tests above), but
    at round 23 of this fit one Elkan test l - p < d_a is a 2e-6 relative
    near-tie that the two packages' matrix products decide differently
    (one pair more or fewer; ROADMAP Queue 3 item 1), so the counts are
    compared over the first 20 rounds only."""
    X, _ = blobs
    kw = {"k": 8, "algorithm": "lloyd-elkan"}
    j = JKMeans(JConfig(kernel_backend="ref", **kw)).fit(X)
    t = api.NestedKMeans(api.FitConfig(**kw), device="cpu").fit(X)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    assert t.converged_ and j.converged_
    assert [(r.b, r.n_changed, r.grow) for r in t.telemetry_] == \
        [(r.b, r.n_changed, r.grow) for r in j.telemetry_]
    assert _schedule(t)[:20] == _schedule(j)[:20]
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)


# -- the JAX package's exactness properties, inside the port -------------------

@pytest.mark.parametrize("bounds", ["hamerly2", "elkan", "exponion"])
def test_bounds_never_change_assignments(blobs, bounds):
    """tb with any bound family gives gb's labels round for round."""
    X, _ = blobs
    k, b = 8, 512
    Xd = torch.from_numpy(X)
    s_ref = tstate.init_state(Xd, k, bounds="none")
    s_tb = tstate.init_state(Xd, k, bounds=bounds)
    for r in range(12):
        s_ref, _ = trounds.nested_round(Xd, s_ref, b=b, rho=INF,
                                        bounds="none")
        s_tb, _ = trounds.nested_round(Xd, s_tb, b=b, rho=INF,
                                       bounds=bounds)
        np.testing.assert_array_equal(_np(s_ref.points.a[:b]),
                                      _np(s_tb.points.a[:b]),
                                      err_msg=f"round {r}")
        _close(s_ref.stats.C, s_tb.stats.C)


def test_bound_families_parity_on_local(blobs):
    """Every bound family's labels AND centroids are bit-equal to
    ``bounds="none"``'s on the same init and schedule, with an N that is
    not a power of two."""
    X, _ = blobs
    X = X[:1003]
    base = None
    for fam in ["none", "hamerly2", "elkan", "exponion"]:
        cfg = api.FitConfig(k=8, algorithm="tb", b0=256, rho=INF,
                            bounds=fam, max_rounds=25, seed=0)
        out = api.fit(X, cfg, device="cpu")
        if base is None:
            base = out
        else:
            np.testing.assert_array_equal(out.labels, base.labels,
                                          err_msg=fam)
            np.testing.assert_array_equal(out.C, base.C, err_msg=fam)

"""The port's `rcv1_like`, the stand-in for the paper's second dataset,
against the JAX package's, on the CPU.

`repro_torch.data.synthetic.rcv1_like` is a numpy copy of
`repro.data.synthetic.rcv1_like`: the rows are held bit-equal at the
same arguments, including a case whose rows span several chunks (each
chunk draws its topics and lengths anew). The reference's own check of
the rows (tests/test_optim_data.py) runs on the port's rows, and the
paper's algorithm (tb, hamerly2, rho = inf) fits a small set of them in
both packages with the same schedule and labels.

The rows are l2-normalised and sparse, so a row's distances to its
nearest centroids lie close together (at k = 8, d = 256 often within
1e-3). The two packages sum |x|^2 - 2 x.c + |c|^2 in other orders, and
at such a near-tie they may decide a row differently: on 4,000 rows
with b0 = 500 their fits part at round 86 (one row's label, n_changed
33 against 34) and converge to other centroids, and with b0 = 256 and
the data's seed 1 at round 77 (one recomputation, as ROADMAP Queue 3
item 1 records on the blobs). The fit case below (3,000 rows, b0 = 256,
seed 0) meets no such tie; centroids are held at rtol=atol=1e-5, as
tests/test_torch_fit.py holds them.
"""
import math

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

from repro.api import FitConfig as JConfig
from repro.api import NestedKMeans as JKMeans
from repro.data import synthetic as jsyn
from repro_torch.api import FitConfig, NestedKMeans
from repro_torch.data import synthetic as tsyn

#: (n, dim, avg_nnz, seed, chunk); the second spans three chunks
RCV1_ARGS = [(200, 512, 30, 0, 50_000), (300, 256, 60, 3, 128),
             (64, 2048, 60, 1, 50_000), (50, 64, 10, 2, 50_000)]


@pytest.mark.parametrize("n,dim,avg_nnz,seed,chunk", RCV1_ARGS)
def test_rcv1_like_is_jax_bits(n, dim, avg_nnz, seed, chunk):
    kw = dict(dim=dim, avg_nnz=avg_nnz, seed=seed, chunk=chunk)
    got = tsyn.rcv1_like(n, **kw)
    want = jsyn.rcv1_like(n, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (n, dim)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rcv1_like_rows_are_normalised_sparseish():
    """tests/test_optim_data.py's check of the reference's rows, on the
    port's."""
    X = tsyn.rcv1_like(100, dim=512, avg_nnz=30, seed=0)
    norms = np.linalg.norm(X, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    nnz = (X != 0).sum(1)
    assert nnz.mean() < 120          # sparse-ish


def test_rcv1_fit_matches_jax():
    """The paper's RCV1 algorithm (`KMEANS_RCV1`'s tb, hamerly2, rho =
    inf) at k = 8 on 3,000 rows at d = 256 (+300 validation rows), JAX
    on its plain kernels: labels, the schedule (b, n_recomputed,
    n_changed, grow), convergence and `predict` equal; centroids and the
    final validation MSE at 1e-5."""
    X = tsyn.rcv1_like(3300, dim=256, seed=0)
    X, Xv = X[:3000], X[3000:]
    kw = dict(k=8, b0=256, algorithm="tb", rho=math.inf, bounds="hamerly2",
              seed=0)
    j = JKMeans(JConfig(kernel_backend="ref", **kw)).fit(X, X_val=Xv)
    t = NestedKMeans(FitConfig(**kw), device="cpu").fit(X, X_val=Xv)

    def schedule(km):
        return [(r.b, r.n_recomputed, r.n_changed, r.grow)
                for r in km.telemetry_]

    assert schedule(t) == schedule(j)
    assert len(schedule(t)) > 50 and t.converged_ == j.converged_
    np.testing.assert_array_equal(t.labels_, j.labels_)
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.final_mse_, j.final_mse_, rtol=1e-5)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))

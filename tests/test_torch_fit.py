"""The port's estimator against the JAX package's, end to end on the CPU.

The same data through `repro.api.NestedKMeans` (kernel_backend="ref") and
`repro_torch.api.NestedKMeans` (device="cpu"): labels, the telemetry
schedule (b, n_recomputed, n_changed, grow) and convergence must be
equal, centroids allclose, and `predict` equal. Plus the port's own
rules: device="cuda" is the default and never falls back to the CPU, and
what is not ported yet (the xl backend) is refused by name.
Checkpoints and chunk stores are held to JAX in
tests/test_torch_{checkpoint,resume,store}.py; traced fits in
tests/test_torch_obs.py.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.api import FitConfig as JConfig
from repro.api import NestedKMeans as JKMeans
from repro_torch.api import FitConfig, NestedKMeans, NotFittedError

# Configurations on the blobs fixture. b0=500 is left out on purpose:
# there a point's Hamerly test d_a <= lb - p_max is a 2e-6 near-tie at
# round 6, which the two packages' float sums decide differently, so
# n_recomputed differs by one while every label agrees (ROADMAP Queue 3).
CONFIGS = {
    "default_b0": {},
    "b0_1000": {"b0": 1000},
    "b0_256": {"b0": 256},
    "compacted": {"b0": 300, "capacity_floor": 64},
    "gb_bounds_none": {"b0": 1000, "bounds": "none"},
    "seed1": {"b0": 512, "seed": 1},
}


def _schedule(km):
    return [(r.b, r.n_recomputed, r.n_changed, r.grow)
            for r in km.telemetry_]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fit_matches_jax(blobs, blobs_val, name):
    X, _ = blobs
    kw = CONFIGS[name]
    j = JKMeans(JConfig(k=8, kernel_backend="ref", **kw)).fit(
        X, X_val=blobs_val)
    t = NestedKMeans(FitConfig(k=8, **kw), device="cpu").fit(
        X, X_val=blobs_val)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    assert _schedule(t) == _schedule(j)
    assert t.converged_ == j.converged_
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.final_mse_, j.final_mse_, rtol=1e-5)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    assert t.outcome_.kernel_plan["backend"] == "ref"


def test_inference_and_partial_fit_match_jax(blobs):
    X, _ = blobs
    cfg = {"k": 8, "b0": 1000}
    j = JKMeans(JConfig(kernel_backend="ref", **cfg))
    t = NestedKMeans(FitConfig(**cfg), device="cpu")
    for lo in (0, 1000, 2000):          # three streaming batches
        j.partial_fit(X[lo:lo + 1000])
        t.partial_fit(X[lo:lo + 1000])
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.counts_, j.counts_)
    assert [r.n_changed for r in t.telemetry_] == \
        [r.n_changed for r in j.telemetry_]
    Xq = X[3000:3300]
    np.testing.assert_array_equal(t.predict(Xq), j.predict(Xq))
    np.testing.assert_allclose(t.transform(Xq), j.transform(Xq),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t.score(Xq), j.score(Xq), rtol=1e-5)
    assert t.predict(Xq).dtype == np.int32
    with pytest.raises(NotFittedError):
        t.labels_


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NestedKMeans(FitConfig(k=4))
    km = NestedKMeans(FitConfig(k=4), device="cpu")
    assert km.device == torch.device("cpu")
    with pytest.raises(NotFittedError):
        km.predict(np.zeros((2, 3), np.float32))


def test_config_matches_jax_shape():
    assert FitConfig(k=3).to_dict().keys() == JConfig(k=3).to_dict().keys()
    assert FitConfig(k=3, kernel_backend="cuda").kernel_backend == "cuda"
    with pytest.raises(ValueError, match="kernel_backend"):
        FitConfig(k=3, kernel_backend="pallas")
    cfg = FitConfig(k=3, rho=2.5, b0=7)
    assert FitConfig.from_dict(cfg.to_dict()) == cfg


def test_unported_backend_and_resume_are_refused(tmp_path, blobs):
    """No backend is refused any more: xl, like mesh, needs a
    `DeviceMesh` (tests/test_torch_mesh.py, tests/test_torch_xl.py);
    resume and chunk stores are ported, and refuse what the JAX package
    refuses: a resume with no checkpoint config, a store fit of a
    non-nested algorithm."""
    from repro_torch.data.store import write_store
    X, _ = blobs
    with pytest.raises(ValueError, match="backend='xl' needs"):
        NestedKMeans(FitConfig(k=4, backend="xl"), device="cpu")
    with pytest.raises(ValueError, match="requires config.checkpoint"):
        NestedKMeans(FitConfig(k=4), device="cpu").fit(X, resume=True)
    write_store(tmp_path / "st", X[:500], chunk_rows=128)
    with pytest.raises(ValueError, match="out-of-core"):
        NestedKMeans(FitConfig(k=4, algorithm="lloyd"),
                     device="cpu").fit(str(tmp_path / "st"))


# (N, dtype, order, shuffle) at 64 rows a staging segment
PLACEMENTS = {
    "f32_c": (650, np.float32, "C", True),
    "f64": (650, np.float64, "C", True),
    "fortran": (650, np.float32, "F", True),
    "exact_multiple": (640, np.float32, "C", True),
    "below_one_segment": (50, np.float32, "C", True),
    "no_shuffle": (650, np.float32, "C", False),
}


@pytest.mark.parametrize("name", sorted(PLACEMENTS))
def test_engine_places_the_shuffled_rows_bit_for_bit(monkeypatch, name):
    """The in-memory engine uploads the caller's rows a staging segment
    at a time and scatters them on the device: storage row i holds
    float32(X[perm[i]]) bit for bit, as the host's X[perm] and the JAX
    engine give it, and the permutations are the seed's draws in the
    JAX engine's order. One ``engine.scatter`` a segment, none
    unshuffled."""
    from repro.api.engines.local import LocalEngine as JEngine
    from repro_torch import obs
    from repro_torch.api.engines import local
    N, dtype, order, shuffle = PLACEMENTS[name]
    d, seg = 8, 64
    monkeypatch.setattr(local, "_STAGE_BYTES", seg * 4 * d)
    rng = np.random.default_rng(N)
    X = np.asarray(rng.normal(size=(N, d)) * 1e3, dtype=dtype, order=order)
    X_val = X[:20].copy()
    cfg = FitConfig(k=4, b0=32, seed=7, shuffle=shuffle).resolve(N)
    run = local.LocalEngine().begin(X, cfg, X_val=X_val, device="cpu")
    draws = np.random.default_rng(7)
    perm = draws.permutation(N) if shuffle else np.arange(N)
    assert np.array_equal(run._Xd.numpy(),
                          np.ascontiguousarray(X[perm], np.float32))
    np.testing.assert_array_equal(run.orig_index, perm)
    np.testing.assert_array_equal(run._mb_perm, draws.permutation(N))
    assert np.array_equal(run._Xv.numpy(), X_val.astype(np.float32))
    place = obs.recent_roots("engine.place")[-1]
    assert place.total("engine.scatter")[1] == (
        -(-N // seg) if shuffle else 0)
    assert place.total("engine.upload")[1] == 2
    jrun = JEngine().begin(X, JConfig(k=4, b0=32, seed=7,
                                      shuffle=shuffle).resolve(N))
    np.testing.assert_array_equal(jrun.orig_index, run.orig_index)
    assert np.array_equal(np.asarray(jrun._Xd), run._Xd.numpy())

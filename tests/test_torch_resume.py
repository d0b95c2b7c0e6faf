"""In-loop checkpoints and kill-and-resume in the port, and across the
two packages, on the CPU.

The local cases of tests/test_resume.py against `repro_torch.api`: a fit
checkpointed at round R and resumed gives BIT-IDENTICAL centroids,
labels and telemetry (but the wall clock ``t``) to an unbroken fit, for
tb-hamerly2, tb-elkan, tb-exponion, lloyd-elkan, lloyd, mb and mb-f
(their resampling stream rides in the checkpoint). Then across packages:
a JAX fit cut at round 7 is resumed by the port, and a port fit cut at
round 7 by JAX; each is held to the other package's unbroken fit with
labels and schedule equal and C within the f32 tolerance of
tests/test_torch_fit.py (rtol 1e-5, atol 1e-5).
"""
import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

from repro import api as japi
from repro_torch.api import (CheckpointConfig, FitConfig, NestedKMeans,
                             fit)
from repro_torch.checkpoint import CheckpointStore


def _tel(records):
    out = []
    for r in records:
        r = r.to_dict()
        r.pop("t")
        out.append(r)
    return out


def _schedule(records):
    return [(r.b, r.n_recomputed, r.n_changed, r.grow) for r in records]


BASE = dict(k=8, b0=512, max_rounds=40, eval_every=5, seed=0)
KILLS = {
    "tb_hamerly2": {},
    "tb_elkan": {"bounds": "elkan"},
    "tb_exponion": {"bounds": "exponion"},
    "lloyd_elkan": {"algorithm": "lloyd-elkan", "max_rounds": 25},
    "lloyd": {"algorithm": "lloyd", "max_rounds": 25},
    "mb": {"algorithm": "mb", "b0": 700, "max_rounds": 14, "seed": 2},
    "mbf": {"algorithm": "mbf", "b0": 700, "max_rounds": 14, "seed": 2},
}


@pytest.mark.parametrize("name", sorted(KILLS))
def test_kill_and_resume_bit_identical(tmp_path, blobs, blobs_val, name):
    """Cut at round 7 (the last save at round 6), resumed: the unbroken
    fit's bits. mb's 14 rounds of 700 rows cross a reshuffle of the
    4000 rows after the cut."""
    X, _ = blobs
    cfg = FitConfig(**dict(BASE, **KILLS[name]))
    whole = fit(X, cfg, X_val=blobs_val, device="cpu")
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=3)
    fit(X, dataclasses.replace(cfg, max_rounds=7, checkpoint=ck),
        X_val=blobs_val, device="cpu")
    km = NestedKMeans(dataclasses.replace(cfg, checkpoint=ck), device="cpu")
    km.fit(X, X_val=blobs_val, resume=True)
    np.testing.assert_array_equal(km.cluster_centers_, whole.C)
    np.testing.assert_array_equal(km.labels_, whole.labels)
    assert _tel(km.telemetry_) == _tel(whole.telemetry)
    assert km.converged_ == whole.converged
    assert len(whole.telemetry) > 7


def test_kill_by_raising_mid_loop(tmp_path, blobs):
    """A fit killed by an exception in ``on_round`` (the last save five
    rounds earlier) resumes to the unbroken fit's bits."""
    X, _ = blobs
    cfg = FitConfig(k=8, b0=256, max_rounds=60, seed=1)
    whole = fit(X, cfg, device="cpu")
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=5)

    def kill(rec):
        if rec.round == 12:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        NestedKMeans(dataclasses.replace(cfg, checkpoint=ck), device="cpu",
                     on_round=kill).fit(X)
    assert CheckpointStore(tmp_path).latest_step() == 10
    km = NestedKMeans(dataclasses.replace(cfg, checkpoint=ck),
                      device="cpu").fit(X, resume=True)
    np.testing.assert_array_equal(km.cluster_centers_, whole.C)
    assert _tel(km.telemetry_) == _tel(whole.telemetry)


def test_resume_of_finished_fit_is_noop(tmp_path, blobs):
    X, _ = blobs
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=5)
    cfg = FitConfig(k=8, b0=512, max_rounds=60, seed=0, checkpoint=ck)
    out_a = fit(X, cfg, device="cpu")
    assert out_a.converged
    calls = []
    km = NestedKMeans(cfg, device="cpu", on_round=calls.append)
    km.fit(X, resume=True)
    assert km.converged_ and calls == []
    np.testing.assert_array_equal(out_a.C, km.cluster_centers_)
    assert _tel(out_a.telemetry) == _tel(km.telemetry_)


def test_resume_without_checkpoint_config_raises(blobs):
    X, _ = blobs
    with pytest.raises(ValueError, match="checkpoint"):
        NestedKMeans(FitConfig(k=8), device="cpu").fit(X, resume=True)


def test_resume_with_empty_dir_starts_fresh(tmp_path, blobs):
    X, _ = blobs
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=50)
    km = NestedKMeans(FitConfig(k=8, b0=512, max_rounds=10, checkpoint=ck),
                      device="cpu")
    km.fit(X, resume=True)
    assert km.n_rounds_ == 10


def test_fresh_fit_supersedes_stale_checkpoints(tmp_path, blobs):
    X, _ = blobs
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=2)
    cfg = FitConfig(k=8, b0=512, max_rounds=60, seed=0, checkpoint=ck)
    fit(X, cfg, device="cpu")                # long run, high step numbers
    store = CheckpointStore(tmp_path)
    old_latest = store.latest_step()
    out = fit(X, dataclasses.replace(cfg, max_rounds=4), device="cpu")
    assert store.latest_step() == 4 != old_latest
    km = NestedKMeans(dataclasses.replace(cfg, max_rounds=4), device="cpu")
    km.fit(X, resume=True)                   # the NEW run, not the stale
    np.testing.assert_array_equal(out.C, km.cluster_centers_)


@pytest.mark.parametrize("change,field", [({"seed": 1}, "seed"),
                                          ({"bounds": "exponion"},
                                           "bounds")])
def test_resume_rejects_foreign_manifest(tmp_path, blobs, change, field):
    X, _ = blobs
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=2)
    cfg = FitConfig(k=8, b0=512, max_rounds=4, seed=0, checkpoint=ck)
    fit(X, cfg, device="cpu")
    km = NestedKMeans(dataclasses.replace(cfg, max_rounds=10, **change),
                      device="cpu")
    with pytest.raises(ValueError, match=field):
        km.fit(X, resume=True)


def test_checkpoint_manifest_carries_fitconfig(tmp_path, blobs):
    X, _ = blobs
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=2)
    cfg = FitConfig(k=8, algorithm="gb", b0=512, max_rounds=6,
                    checkpoint=ck)
    fit(X, cfg, device="cpu")
    store = CheckpointStore(tmp_path)
    extra = store.read_extra()
    assert FitConfig.from_dict(extra["config"]) == cfg.resolve(len(X))
    assert extra["loop"]["rounds_done"] == store.latest_step() == 6
    assert extra["engine"]["engine"] == "local"
    assert extra["data"]["kind"] == "array"


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

CROSS = {"tb_hamerly2": {}, "tb_elkan": {"bounds": "elkan"},
         "mbf": {"algorithm": "mbf", "b0": 700, "max_rounds": 14,
                 "seed": 2}}


def _jcfg(kw, ck=None):
    return japi.FitConfig(kernel_backend="ref", checkpoint=ck,
                          **dict(BASE, **kw))


@pytest.mark.parametrize("name", sorted(CROSS))
def test_port_resumes_a_jax_fit(tmp_path, blobs, blobs_val, name):
    X, _ = blobs
    kw = CROSS[name]
    whole = japi.fit(X, _jcfg(kw), X_val=blobs_val)
    jck = japi.CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=3)
    japi.fit(X, dataclasses.replace(_jcfg(kw, jck), max_rounds=7),
             X_val=blobs_val)
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=3)
    km = NestedKMeans(FitConfig(checkpoint=ck, **dict(BASE, **kw)),
                      device="cpu")
    km.fit(X, X_val=blobs_val, resume=True)
    np.testing.assert_array_equal(km.labels_, whole.labels)
    assert _schedule(km.telemetry_) == _schedule(whole.telemetry)
    np.testing.assert_allclose(km.cluster_centers_, whole.C, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(CROSS))
def test_jax_resumes_a_port_fit(tmp_path, blobs, blobs_val, name):
    X, _ = blobs
    kw = CROSS[name]
    cfg = FitConfig(**dict(BASE, **kw))
    whole = fit(X, cfg, X_val=blobs_val, device="cpu")
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=3)
    fit(X, dataclasses.replace(cfg, max_rounds=7, checkpoint=ck),
        X_val=blobs_val, device="cpu")
    jck = japi.CheckpointConfig(checkpoint_dir=str(tmp_path), save_every=3)
    km = japi.NestedKMeans(_jcfg(kw, jck))
    km.fit(X, X_val=blobs_val, resume=True)
    np.testing.assert_array_equal(km.labels_, whole.labels)
    assert _schedule(km.telemetry_) == _schedule(whole.telemetry)
    np.testing.assert_allclose(km.cluster_centers_, whole.C, rtol=1e-5,
                               atol=1e-5)

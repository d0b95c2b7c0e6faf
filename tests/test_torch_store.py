"""The port's chunk store and store-backed fits against the JAX package's.

The writer and reader cases of tests/test_store.py against
`repro_torch.data.store` (round trip, dtypes, odd appends, abort,
corruption, LRU and metrics, prefetch, the CLI); `store_permutation` and
`dataset_fingerprint` equal to JAX's; stores written by either package
equal file for file and open in the other. Then the fits: the port's
stored fit equals its in-memory fit of ``X[store_permutation(...)]``
with ``shuffle=False`` bit for bit, and JAX's stored fit with labels and
schedule equal and C within the f32 tolerance of tests/test_torch_fit.py
(rtol 1e-5, atol 1e-5); kill-and-resume from one store is bit-identical;
a different store is refused at resume; non-nested algorithms are
refused.
"""
import dataclasses
import os
import time

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

from repro import api as japi
from repro.data import store as jstore
from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans, fit
from repro_torch.data.store import (ChunkStore, StoreWriter,
                                    dataset_fingerprint, store_permutation,
                                    write_store)


def _rows(n, d=6, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(dtype)


def _tel(records):
    out = []
    for r in records:
        r = r.to_dict()
        r.pop("t")                   # wall-clock differs by definition
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# format round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,chunk_rows", [(0, 8), (5, 8), (8, 8),
                                          (17, 8), (1000, 64), (257, 256)])
def test_roundtrip(tmp_path, n, chunk_rows):
    X = _rows(n)
    write_store(tmp_path / "st", X, chunk_rows=chunk_rows)
    with ChunkStore(tmp_path / "st", verify=True) as st:
        assert (st.n, st.d) == X.shape
        assert st.n_chunks == -(-n // chunk_rows)
        np.testing.assert_array_equal(st.rows(0, n), X)
        if n:
            idx = np.random.default_rng(1).integers(0, n, 3 * n)
            np.testing.assert_array_equal(st.take(idx), X[idx])
            np.testing.assert_array_equal(st.rows(n // 3, 2 * n // 3),
                                          X[n // 3:2 * n // 3])


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16"])
def test_roundtrip_dtypes(tmp_path, dtype):
    X = _rows(100, dtype=np.dtype(dtype))
    write_store(tmp_path / "st", X, chunk_rows=32)
    with ChunkStore(tmp_path / "st") as st:
        assert st.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(st.rows(0, 100), X)


def test_writer_odd_appends_match_write_store(tmp_path):
    X = _rows(531)
    write_store(tmp_path / "a", X, chunk_rows=100)
    with StoreWriter(tmp_path / "b", d=X.shape[1], chunk_rows=100) as w:
        at = 0
        for size in (1, 7, 99, 100, 101, 223):
            w.append(X[at:at + size])
            at += size
        w.append(X[at:])
    a, b = ChunkStore(tmp_path / "a"), ChunkStore(tmp_path / "b")
    assert a.checksum == b.checksum
    np.testing.assert_array_equal(a.rows(0, 531), b.rows(0, 531))


def test_writer_abort_leaves_no_index(tmp_path):
    with pytest.raises(RuntimeError):
        with StoreWriter(tmp_path / "st", d=4, chunk_rows=8) as w:
            w.append(_rows(20, d=4))
            raise RuntimeError("interrupted")
    with pytest.raises(FileNotFoundError, match="not a chunk store"):
        ChunkStore(tmp_path / "st")


def test_corruption_detected(tmp_path):
    X = _rows(64)
    write_store(tmp_path / "st", X, chunk_rows=16)
    with open(tmp_path / "st" / "data.bin", "r+b") as f:
        f.seek(16 * X.shape[1] * 4 + 5)      # a byte inside chunk 1
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    st = ChunkStore(tmp_path / "st", verify=True)
    st.chunk(0)
    with pytest.raises(IOError, match="corrupt"):
        st.chunk(1)
    ChunkStore(tmp_path / "st").chunk(1)     # no verify: unnoticed


def test_lru_and_metrics(tmp_path):
    X = _rows(160)
    write_store(tmp_path / "st", X, chunk_rows=16)    # 10 chunks
    st = ChunkStore(tmp_path / "st", cache_chunks=4)
    st.rows(0, 160)
    m = st.metrics
    assert m.chunk_loads == 10 and m.cache_hits == 0
    assert m.bytes_read == X.nbytes and m.rows_served == 160
    st.take(np.arange(160 - 16 * 4, 160))    # the 4 cached tail chunks
    assert st.metrics.chunk_loads == 10 and st.metrics.cache_hits == 4
    st.chunk(0)                              # evicted: a reload
    assert st.metrics.chunk_loads == 11


def test_prefetch_warms_cache(tmp_path):
    write_store(tmp_path / "st", _rows(128), chunk_rows=16)
    with ChunkStore(tmp_path / "st", prefetch_depth=4) as st:
        assert st.prefetch([0, 1]) == 2
        deadline = time.monotonic() + 5
        while st.metrics.prefetched < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert st.metrics.prefetched == 2
        st.chunk(0), st.chunk(1)
        assert st.metrics.cache_hits == 2
    assert ChunkStore(tmp_path / "st").prefetch([0]) == 0   # no thread


def test_writer_cli_synthetic(tmp_path):
    from repro_torch.data.store import writer
    out = str(tmp_path / "st")
    writer.main([out, "--synthetic", "blobs", "--n", "500", "--dim", "8",
                 "--classes", "4", "--chunk-rows", "128"])
    with ChunkStore(out, verify=True) as st:
        assert (st.n, st.d) == (500, 8)
        assert st.rows(0, 500).std() > 0


def test_writer_cli_from_npy_matches_jax(tmp_path):
    from repro_torch.data.store import writer
    X = _rows(300, d=5, dtype=np.float64)
    np.save(tmp_path / "x.npy", X)
    writer.main([str(tmp_path / "t"), "--from-npy", str(tmp_path / "x.npy"),
                 "--chunk-rows", "64", "--dtype", "float32"])
    jstore.writer.main([str(tmp_path / "j"), "--from-npy",
                        str(tmp_path / "x.npy"), "--chunk-rows", "64",
                        "--dtype", "float32"])
    _assert_same_files(tmp_path / "t", tmp_path / "j")


# ---------------------------------------------------------------------------
# the two packages on the same stores
# ---------------------------------------------------------------------------

def _assert_same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == \
        ["data.bin", "index.json"]
    for name in ("data.bin", "index.json"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("n,chunk_rows,seed", [(0, 8, 0), (1, 8, 3),
                                               (1000, 64, 3), (1003, 128, 2),
                                               (4001, 256, 1)])
def test_store_permutation_matches_jax(n, chunk_rows, seed):
    for shuffle in (True, False):
        np.testing.assert_array_equal(
            store_permutation(n, chunk_rows, seed, shuffle=shuffle),
            jstore.store_permutation(n, chunk_rows, seed, shuffle=shuffle))


def test_store_permutation_chunk_frontier():
    n, chunk_rows = 1000, 64
    perm = store_permutation(n, chunk_rows, seed=3)
    assert sorted(perm) == list(range(n))
    for b in (1, 64, 100, 500, 999):
        assert len(np.unique(perm[:b] // chunk_rows)) <= \
            -(-b // chunk_rows) + 1


@pytest.mark.parametrize("n,d,chunk_rows,dtype", [
    (0, 3, 8, "float32"), (5, 1, 8, "float32"), (531, 6, 100, "float32"),
    (300, 8, 64, "float64"), (257, 4, 256, "float16")])
def test_stores_are_byte_identical_and_open_in_both(tmp_path, n, d,
                                                    chunk_rows, dtype):
    X = _rows(n, d=d, seed=n, dtype=np.dtype(dtype))
    write_store(tmp_path / "t", X, chunk_rows=chunk_rows)
    jstore.write_store(tmp_path / "j", X, chunk_rows=chunk_rows)
    _assert_same_files(tmp_path / "t", tmp_path / "j")
    with ChunkStore(tmp_path / "j", verify=True) as t, \
            jstore.ChunkStore(tmp_path / "t", verify=True) as j:
        np.testing.assert_array_equal(t.rows(0, n), X)
        np.testing.assert_array_equal(j.rows(0, n), X)
        assert t.fingerprint() == j.fingerprint()
        assert dataset_fingerprint(t) == jstore.dataset_fingerprint(j)


def test_synthetic_stores_match_jax(tmp_path):
    from repro_torch.data.store import writer
    kw = dict(n=700, dim=5, classes=3, seed=4, chunk_rows=128)
    writer.write_synthetic_store(tmp_path / "t", **kw)
    jstore.writer.write_synthetic_store(tmp_path / "j", **kw)
    _assert_same_files(tmp_path / "t", tmp_path / "j")


@pytest.mark.parametrize("shape,dtype", [((300, 6), "float32"),
                                         ((7, 2), "float64"),
                                         ((129,), "float32")])
def test_array_fingerprint_matches_jax(shape, dtype):
    X = _rows(int(np.prod(shape)), d=1, dtype=np.dtype(dtype)).reshape(shape)
    fp = dataset_fingerprint(X)
    assert fp == jstore.dataset_fingerprint(X)
    assert fp["kind"] == "array" and fp == dataset_fingerprint(X.copy())
    assert fp != dataset_fingerprint(X + 1)


# ---------------------------------------------------------------------------
# store-backed fits
# ---------------------------------------------------------------------------

N, CHUNK = 1003, 128


def _cfg(**kw):
    kw.setdefault("k", 4)
    kw.setdefault("b0", 128)
    kw.setdefault("max_rounds", 40)
    kw.setdefault("seed", 2)
    return FitConfig(**kw)


@pytest.fixture
def stored(tmp_path):
    X = _rows(N, d=8, seed=4)
    write_store(tmp_path / "st", X, chunk_rows=CHUNK)
    return X, tmp_path / "st"


@pytest.mark.parametrize("bounds", ["hamerly2", "none", "exponion"])
def test_stored_fit_equals_in_memory_fit_of_the_permuted_rows(stored,
                                                              bounds):
    X, path = stored
    st = ChunkStore(path)
    out_s = fit(st, _cfg(bounds=bounds), device="cpu")
    perm = store_permutation(N, CHUNK, seed=2)
    out_m = fit(X[perm], _cfg(bounds=bounds, shuffle=False), device="cpu")
    np.testing.assert_array_equal(out_s.C, out_m.C)
    np.testing.assert_array_equal(out_s.labels[perm], out_m.labels)
    assert _tel(out_s.telemetry) == _tel(out_m.telemetry)
    # the frontier property: the fit read the store about once
    assert st.metrics.bytes_read <= 1.6 * X.nbytes


@pytest.mark.parametrize("bounds", ["hamerly2", "none"])
def test_stored_fit_matches_jax_stored_fit(stored, bounds):
    X, path = stored
    t = fit(str(path), _cfg(bounds=bounds), device="cpu")
    j = japi.fit(str(path), japi.FitConfig(
        k=4, b0=128, max_rounds=40, seed=2, bounds=bounds,
        kernel_backend="ref"))
    np.testing.assert_array_equal(t.labels, j.labels)
    assert [(r.b, r.n_recomputed, r.n_changed, r.grow)
            for r in t.telemetry] == [(r.b, r.n_recomputed, r.n_changed,
                                       r.grow) for r in j.telemetry]
    np.testing.assert_allclose(t.C, j.C, rtol=1e-5, atol=1e-5)


def test_fit_from_path_and_data_source(stored):
    _, path = stored
    out_a = fit(str(path), _cfg(), device="cpu")
    km = NestedKMeans(_cfg(data_source=str(path)), device="cpu")
    km.fit()                         # no X: the config names the store
    np.testing.assert_array_equal(out_a.C, km.cluster_centers_)
    assert km.outcome_.labels.shape == (N,)
    with pytest.raises(ValueError, match="needs data"):
        NestedKMeans(_cfg(), device="cpu").fit()


def test_store_metrics_hook(stored):
    """A store-backed run reports its store's read metrics (the first
    k rows' chunk is read at begin); an in-memory run reports None."""
    from repro_torch.api.engines.local import LocalEngine
    X, path = stored
    cfg = _cfg().resolve(N)
    run = LocalEngine().begin(ChunkStore(path), cfg, device="cpu")
    m = run.store_metrics()
    assert m["chunk_loads"] == 1 and m["rows_served"] == cfg.k
    assert m["bytes_read"] == CHUNK * X.shape[1] * 4
    run.nested_step(run.state, 300, None)      # the prefix grows to 300
    assert run.store_metrics()["rows_served"] == 300
    assert LocalEngine().begin(X, cfg, device="cpu").store_metrics() is None


def test_store_rejects_non_nested_algorithms(stored):
    _, path = stored
    with pytest.raises(ValueError, match="data_source"):
        _cfg(algorithm="mb", data_source=str(path))
    with pytest.raises(ValueError, match="out-of-core"):
        fit(str(path), _cfg(algorithm="lloyd"), device="cpu")


def test_stored_kill_and_resume_bit_identical(tmp_path, stored):
    _, path = stored
    cfg = _cfg(eval_every=3)
    whole = fit(ChunkStore(path), cfg, device="cpu")
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path / "ck"), save_every=2)
    fit(ChunkStore(path), dataclasses.replace(cfg, max_rounds=7,
                                              checkpoint=ck), device="cpu")
    km = NestedKMeans(dataclasses.replace(cfg, checkpoint=ck), device="cpu")
    km.fit(ChunkStore(path), resume=True)
    np.testing.assert_array_equal(km.cluster_centers_, whole.C)
    np.testing.assert_array_equal(km.labels_, whole.labels)
    assert _tel(km.telemetry_) == _tel(whole.telemetry)


def test_resume_fingerprint_gate(tmp_path, stored):
    X, path = stored
    write_store(tmp_path / "other", _rows(N, d=8, seed=5), chunk_rows=CHUNK)
    ck = CheckpointConfig(checkpoint_dir=str(tmp_path / "ck"), save_every=2)
    cfg = _cfg(checkpoint=ck)
    fit(ChunkStore(path), dataclasses.replace(cfg, max_rounds=5),
        device="cpu")
    with pytest.raises(ValueError, match="different dataset"):
        NestedKMeans(cfg, device="cpu").fit(ChunkStore(tmp_path / "other"),
                                            resume=True)
    NestedKMeans(cfg, device="cpu").fit(ChunkStore(path), resume=True)
    ck2 = CheckpointConfig(checkpoint_dir=str(tmp_path / "ck2"),
                           save_every=2)
    cfg2 = _cfg(checkpoint=ck2)
    fit(X, dataclasses.replace(cfg2, max_rounds=5), device="cpu")
    with pytest.raises(ValueError, match="different dataset"):
        NestedKMeans(cfg2, device="cpu").fit(_rows(N, d=8, seed=5),
                                             resume=True)

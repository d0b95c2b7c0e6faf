import pytest

# NOTE: no XLA_FLAGS here on purpose — unit/smoke tests must see the real
# (single) device; only launch/dryrun.py forces 512 placeholder devices.


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test, excluded from the scripts/ci_tier1.sh "
        "fast subset")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips where there is none")


@pytest.fixture(scope="session")
def blobs():
    from repro.data.synthetic import gaussian_blobs
    X, centers = gaussian_blobs(4000, k=8, dim=16, spread=5.0, seed=0)
    return X, centers


@pytest.fixture(scope="session")
def blobs_val():
    from repro.data.synthetic import gaussian_blobs
    X, _ = gaussian_blobs(512, k=8, dim=16, spread=5.0, seed=1)
    return X

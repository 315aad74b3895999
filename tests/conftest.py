"""Test configuration: force CPU backend with 8 virtual devices.

Set BEFORE importing jax so the distributed tests can build an 8-device
`jax.sharding.Mesh` without GPUs (testing multi-device code without a
cluster — SURVEY §4).  The Triton kernel runs in Pallas interpret mode on
the CPU (tests/test_spmm_csr.py); what only a GPU can run is marked
``gpu`` and skips here (the `gpu` fixture decides, at run time), and
`chip_smoke.py` covers it on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_backend_optimization_level" not in flags:
    # The suite is compile-time-bound (many small distinct programs);
    # dialing the CPU backend's optimization level down speeds compiles
    # with no effect on what the tests assert.  GPU runs never see it.
    flags = (flags + " --xla_backend_optimization_level=1").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", False)
# Exact fp32 matmuls so dense test oracles are bit-trustworthy.
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402


def random_csr(m, n, density=0.05, seed=0, binary=False, dtype=np.float32):
    """Random sparse matrix as (our CSR container, scipy CSR oracle)."""
    from gespmm_tpu.sparse.formats import csr_from_scipy

    rng = np.random.default_rng(seed)
    mat = sp.random(
        m, n, density=density, format="csr", random_state=rng, dtype=np.float64
    )
    mat.data = rng.standard_normal(mat.nnz)
    mat = mat.astype(dtype)
    mat.sort_indices()
    ours = csr_from_scipy(mat)
    if binary:
        mat.data[:] = 1
        ours = ours.with_data(None)
    return ours, mat


def powerlaw_csr(m, n, avg_deg=8, seed=0, dtype=np.float32):
    """Skewed-degree random graph (power-law-ish rows) for load-balance tests."""
    from gespmm_tpu.sparse.formats import csr_from_scipy

    rng = np.random.default_rng(seed)
    # Zipf-distributed out-degrees, clipped.
    deg = np.minimum(rng.zipf(1.6, size=m), n - 1)
    deg = np.maximum((deg * avg_deg / max(deg.mean(), 1)).astype(int), 0)
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, n, size=rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    mat = mat.astype(dtype)
    return csr_from_scipy(mat), mat


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first JAX device if it is a GPU; otherwise skip (tests marked
    ``gpu`` run on the card only).  Decided when the test runs, never at
    import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is {dev.platform})")
    return dev


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (heavy interpret-mode/end-to-end)",
    )


def pytest_collection_modifyitems(config, items):
    """Skip `slow`-marked tests by default so the everyday CPU suite stays
    under ~5 minutes (VERDICT r2 #10).  Every slow test either has a fast
    sibling covering the same op at smaller shapes, or is an extended
    property sweep.  Opt in with --runslow or GESPMM_SLOW=1 (run_bench.sh
    and CI-style full runs set it)."""
    if config.getoption("--runslow") or os.environ.get("GESPMM_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow or GESPMM_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)

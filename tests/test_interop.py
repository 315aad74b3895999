"""BCOO interop + scatter-formulation baseline tier."""

import jax.numpy as jnp
import numpy as np
import pytest

from gespmm_tpu.ops import reference as ref
from gespmm_tpu.ops.interop import (
    bcoo_spmm_baseline, csr_from_bcoo, csr_to_bcoo, csr_to_bcsr,
    cusparse_lowering, cusparse_spmm,
)
from gespmm_tpu.sparse.formats import expand_indptr
from tests.conftest import random_csr

TOL = dict(rtol=1e-5, atol=1e-5)


def test_bcoo_roundtrip():
    csr, mat = random_csr(23, 31, density=0.15, seed=0)
    bcoo = csr_to_bcoo(csr)
    back = csr_from_bcoo(bcoo)
    np.testing.assert_array_equal(np.asarray(back.indptr), mat.indptr)
    np.testing.assert_array_equal(np.asarray(back.indices), mat.indices)
    np.testing.assert_allclose(np.asarray(back.data), mat.data, rtol=1e-6)


def test_bcoo_baseline_matches_scipy():
    csr, mat = random_csr(30, 28, density=0.12, seed=1)
    B = np.random.default_rng(1).standard_normal((28, 8)).astype(np.float32)
    out = bcoo_spmm_baseline(csr, jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(out), mat @ B, rtol=1e-4, atol=1e-4)


def test_scatter_formulation_matches_gather():
    csr, mat = random_csr(40, 35, density=0.1, seed=2)
    B = np.random.default_rng(2).standard_normal((35, 12)).astype(np.float32)
    rows = expand_indptr(csr.indptr, csr.nnz)
    scatter = ref.spmm_scatter_xla(rows, csr.indices, csr.data, jnp.asarray(B), 40)
    gather = ref.spmm_xla(csr.indptr, csr.indices, csr.data, jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(scatter), np.asarray(gather), **TOL)
    np.testing.assert_allclose(np.asarray(gather), mat @ B, **TOL)


@pytest.mark.slow
def test_adjacency_matrix_quacks_like_bcoo():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gespmm_tpu.ops.interop import AdjacencyMatrix, csr_to_bcoo
    from tests.conftest import random_csr

    csr, mat = random_csr(48, 40, density=0.12, seed=61)
    A = AdjacencyMatrix.from_csr(csr, plan=True, col_tile=16,
                                 rows_per_block=8, chunk_nnz=8, part_rows=24)
    assert A.shape == (48, 40) and A.ndim == 2 and A.nse == csr.nnz
    rng = np.random.default_rng(61)
    x = jnp.asarray(rng.standard_normal((40, 8)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((40,)).astype(np.float32))
    y2 = jnp.asarray(rng.standard_normal((48, 8)).astype(np.float32))

    np.testing.assert_allclose(np.asarray(A @ x), mat @ np.asarray(x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(A @ v), mat @ np.asarray(v),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(A.T @ y2), mat.T @ np.asarray(y2),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(y2.T @ A), np.asarray(y2).T @ mat,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(A.todense()), mat.toarray(),
                               rtol=1e-5, atol=1e-6)
    assert A.T.T.shape == A.shape

    # a stock call site: function written for BCOO works unchanged
    def stock_fn(M, x):
        return jnp.sum(jnp.tanh(M @ x))

    bcoo = csr_to_bcoo(csr)
    ours, stock = stock_fn(A, x), stock_fn(bcoo, x)
    np.testing.assert_allclose(float(ours), float(stock), rtol=1e-4)

    # grads flow through @ and through jit
    g = jax.jit(jax.grad(stock_fn, argnums=1))(A, x)
    gd = jax.grad(lambda xx: jnp.sum(jnp.tanh(jnp.asarray(mat.toarray()) @ xx)))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gd), rtol=1e-4,
                               atol=1e-4)

    # round-trip through BCOO
    A2 = AdjacencyMatrix.from_bcoo(bcoo, plan=False)
    np.testing.assert_allclose(np.asarray(A2 @ x), mat @ np.asarray(x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("binary", [False, True])
def test_csr_to_bcsr_matches_scipy(binary):
    csr, mat = random_csr(26, 19, density=0.2, seed=5, binary=binary)
    M = csr_to_bcsr(csr)
    assert M.data.dtype == jnp.float32 and M.indices.dtype == jnp.int32
    np.testing.assert_allclose(np.asarray(M.todense()), mat.toarray(),
                               rtol=1e-6)


@pytest.mark.parametrize("start", [False, True])
def test_cusparse_lowering_restores_flag(start):
    import jax

    jax.config.update("jax_bcoo_cusparse_lowering", start)
    try:
        with pytest.raises(ZeroDivisionError):
            with cusparse_lowering():
                assert jax.config.jax_bcoo_cusparse_lowering is True
                1 / 0
        assert jax.config.jax_bcoo_cusparse_lowering is start
    finally:
        jax.config.update("jax_bcoo_cusparse_lowering", False)


def test_cusparse_spmm_refuses_a_program_without_cusparse():
    # On the CPU BCSR @ dense lowers to the CPU library, not cuSPARSE: a
    # time labelled cuSPARSE must never come from it.
    csr, _ = random_csr(16, 16, density=0.2, seed=6)
    with pytest.raises(RuntimeError, match="cuSPARSE"):
        cusparse_spmm(csr_to_bcsr(csr), jnp.ones((16, 4), jnp.float32))

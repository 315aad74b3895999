"""Row-aligned (scan-free) max/min SpMM layout — round 5 (VERDICT r4 #4).

Parity vs dense oracles and vs the scan kernel, including the cases the
layout introduces: degree classes, mega rows recursing through extra
levels, hierarchical tie-count combination, and the VJP riding the
forward-emitted ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gespmm_tpu.kernels.spmm_stream import spmm_minmax_aligned, spmm_tiled
from gespmm_tpu.ops.spmm import Adjacency, spmm
from gespmm_tpu.sparse.partition import (
    build_aligned_minmax_plan,
    build_tiled_plan,
)
from tests.conftest import powerlaw_csr, random_csr


def _dense_minmax(mat, B, op):
    m = mat.shape[0]
    K = B.shape[1]
    out = np.zeros((m, K), np.float32)
    for r in range(m):
        cols = mat.indices[mat.indptr[r] : mat.indptr[r + 1]]
        vals = mat.data[mat.indptr[r] : mat.indptr[r + 1]]
        if len(cols) == 0:
            continue
        contrib = vals[:, None] * B[cols]
        out[r] = contrib.max(0) if op == "max" else contrib.min(0)
    return out


def _dense_ties(mat, B, op):
    m = mat.shape[0]
    K = B.shape[1]
    out = _dense_minmax(mat, B, op)
    ties = np.zeros((m, K), np.float32)
    for r in range(m):
        cols = mat.indices[mat.indptr[r] : mat.indptr[r + 1]]
        vals = mat.data[mat.indptr[r] : mat.indptr[r + 1]]
        if len(cols) == 0:
            continue
        contrib = vals[:, None] * B[cols]
        ties[r] = (contrib == out[r][None, :]).sum(0)
    return out, ties


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
def test_aligned_matches_dense(op, binary):
    csr, mat = random_csr(120, 90, density=0.08, seed=31, binary=binary)
    plan = build_aligned_minmax_plan(csr)
    assert plan is not None
    B = np.random.default_rng(31).standard_normal((90, 12)).astype(np.float32)
    out = spmm_minmax_aligned(
        plan, csr.data, jnp.asarray(B), 120, reduce=op
    )
    if binary:
        mat = mat.copy()
        mat.data[:] = 1.0
    np.testing.assert_allclose(
        np.asarray(out), _dense_minmax(mat, B, op), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("op", ["max", "min"])
def test_aligned_mega_row_segments(op):
    # A hub row whose degree exceeds the largest class width: multiple
    # segments per row, adjacent candidates of the same row (max_run>1),
    # chunk-boundary straddling forced by a tiny cand_chunk.
    rng = np.random.default_rng(32)
    import scipy.sparse as sp
    from gespmm_tpu.sparse.formats import csr_from_scipy

    m, n = 64, 200
    mat = sp.random(m, n, density=0.04, random_state=rng, format="lil",
                    dtype=np.float32)
    mat[3, :150] = rng.standard_normal(150).astype(np.float32)  # hub deg 150
    mat[3, mat[3].toarray()[0] == 0] = 0.5
    mat = mat.tocsr()
    mat.eliminate_zeros()
    csr = csr_from_scipy(mat)
    plan = build_aligned_minmax_plan(csr, seg_widths=(4, 16))
    assert len(plan.levels) > 1  # hub deg 150 > W_max 16 -> recursion
    B = rng.standard_normal((n, 8)).astype(np.float32)
    out = spmm_minmax_aligned(
        plan, csr.data, jnp.asarray(B), m, reduce=op
    )
    np.testing.assert_allclose(
        np.asarray(out), _dense_minmax(mat, B, op), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("op", ["max", "min"])
def test_aligned_ties_exact(op):
    # Quantized values force real ties; counts must match the dense
    # oracle EXACTLY (they seed the even-split VJP).
    rng = np.random.default_rng(33)
    csr, mat = random_csr(80, 60, density=0.15, seed=33)
    qdata = np.round(np.asarray(csr.data) * 2) / 2
    qdata[qdata == 0] = 1.0
    csr = csr.with_data(jnp.asarray(qdata.astype(np.float32)))
    mat.data[:] = qdata
    plan = build_aligned_minmax_plan(csr, seg_widths=(4, 8))
    B = (np.round(rng.standard_normal((60, 8)) * 2) / 2).astype(np.float32)
    out, ties = spmm_minmax_aligned(
        plan, csr.data, jnp.asarray(B), 80, reduce=op, want_ties=True,
    )
    dout, dties = _dense_ties(mat, B, op)
    np.testing.assert_allclose(np.asarray(out), dout, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ties), dties)


def test_tiled_plan_routes_minmax_to_aligned():
    csr, mat = random_csr(64, 48, density=0.1, seed=34)
    plan = build_tiled_plan(csr)
    assert plan.minmax is not None
    B = np.random.default_rng(34).standard_normal((48, 8)).astype(np.float32)
    out = spmm_tiled(plan, csr.data, jnp.asarray(B), 64, reduce="max")
    np.testing.assert_allclose(
        np.asarray(out), _dense_minmax(mat, B, "max"), rtol=1e-6, atol=1e-6
    )
    # Scan path still reachable when the aligned layout is disabled.
    plan_scan = build_tiled_plan(csr, minmax_aligned=False)
    assert plan_scan.minmax is None
    out2 = spmm_tiled(plan_scan, csr.data, jnp.asarray(B), 64, reduce="max")
    np.testing.assert_allclose(np.asarray(out), np.asarray(out2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("op", ["max", "min"])
def test_aligned_grads_match_xla(op):
    # End-to-end through spmm(): forward emits ties from the aligned
    # kernel (cnt0 path), backward rides spmm_minmax_vjp_tiled with the
    # saved counts — must match the XLA even-tie-splitting VJP.
    rng = np.random.default_rng(35)
    csr, mat = random_csr(72, 60, density=0.12, seed=35)
    qdata = np.round(np.asarray(csr.data) * 2) / 2
    qdata[qdata == 0] = 1.0
    csr = csr.with_data(jnp.asarray(qdata.astype(np.float32)))
    adj = Adjacency.from_csr(csr, plan=True)
    assert adj.plan.minmax is not None
    adj_plain = Adjacency.from_csr(csr)
    Bq = jnp.asarray(
        (np.round(rng.standard_normal((60, 12)) * 2) / 2).astype(np.float32)
    )

    def loss(b, a, meth):
        return jnp.sum(jnp.sin(spmm(a, b, reduce=op, method=meth)))

    g_t = jax.grad(lambda b: loss(b, adj, "tiled"))(Bq)
    g_x = jax.grad(lambda b: loss(b, adj_plain, "xla"))(Bq)
    np.testing.assert_allclose(np.asarray(g_t), np.asarray(g_x),
                               rtol=1e-4, atol=1e-4)
    ge_t = jax.grad(lambda v: loss(Bq, adj.with_data(v), "tiled"))(csr.data)
    ge_x = jax.grad(
        lambda v: loss(Bq, adj_plain.with_data(v), "xla"))(csr.data)
    np.testing.assert_allclose(np.asarray(ge_t), np.asarray(ge_x),
                               rtol=1e-4, atol=1e-4)


def test_aligned_empty_rows_zero():
    csr, mat = random_csr(64, 32, density=0.02, seed=36)
    assert (np.diff(mat.indptr) == 0).any()
    plan = build_aligned_minmax_plan(csr)
    B = np.random.default_rng(36).standard_normal((32, 8)).astype(np.float32)
    for op in ("max", "min"):
        out = np.asarray(spmm_minmax_aligned(
            plan, csr.data, jnp.asarray(B), 64, reduce=op
        ))
        assert np.all(out[np.diff(mat.indptr) == 0] == 0)


@pytest.mark.parametrize("widths", [(1,), (0, 4), ()])
def test_aligned_rejects_bad_seg_widths(widths):
    # A widest class of 1 never shrinks a row's candidate count, so its
    # rows would be left unresolved; non-positive widths are meaningless.
    csr, _ = random_csr(64, 64, density=0.1, seed=37)
    with pytest.raises(ValueError, match="seg_widths"):
        build_aligned_minmax_plan(csr, seg_widths=widths)

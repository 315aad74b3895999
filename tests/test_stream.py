"""Tiled SpMM (per-tile XLA gather + XLA segment reduce over the slot
layout) vs scipy / dense goldens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gespmm_tpu.kernels.spmm_stream import spmm_tiled
from gespmm_tpu.ops.spmm import Adjacency, spmm
from gespmm_tpu.sparse.partition import TiledSpmmPlan, build_tiled_plan
from tests.conftest import powerlaw_csr, random_csr

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 sums in another order than scipy


@pytest.mark.parametrize(
    "shape,density,ct,rp,E,pr",
    [
        pytest.param((60, 50), 0.15, 16, 8, 8, 24,
                     marks=pytest.mark.slow),  # many tiles, many parts
        ((100, 90), 0.05, 32, 16, 16, 1 << 20),  # single part
        ((64, 64), 0.1, 1 << 20, 16, 16, 1 << 20),  # single tile
    ],
)
def test_spmm_tiled_interpret(shape, density, ct, rp, E, pr):
    csr, mat = random_csr(*shape, density=density, seed=1)
    plan = build_tiled_plan(
        csr, col_tile=ct, rows_per_block=rp, chunk_nnz=E, part_rows=pr
    )
    B = np.random.default_rng(1).standard_normal((shape[1], 32)).astype(np.float32)
    out = spmm_tiled(plan, csr.data, jnp.asarray(B), shape[0])
    np.testing.assert_allclose(np.asarray(out), mat @ B, **TOL)


def test_spmm_tiled_binary_and_modes():
    # Binary adjacency (implicit 1.0 edges) through the segment reduce.
    csr, mat = random_csr(48, 40, density=0.12, seed=2, binary=True)
    plan = build_tiled_plan(csr, col_tile=16, rows_per_block=8, chunk_nnz=8,
                            part_rows=16)
    B = np.random.default_rng(2).standard_normal((40, 16)).astype(np.float32)
    out = spmm_tiled(plan, None, jnp.asarray(B), 48)
    np.testing.assert_allclose(np.asarray(out), mat @ B, rtol=1e-5, atol=1e-5)


def test_spmm_tiled_powerlaw():
    csr, mat = powerlaw_csr(96, 80, avg_deg=10, seed=3)
    plan = build_tiled_plan(csr, col_tile=32, rows_per_block=16, chunk_nnz=16,
                            part_rows=40)
    B = np.random.default_rng(3).standard_normal((80, 8)).astype(np.float32)
    out = spmm_tiled(plan, csr.data, jnp.asarray(B), 96)
    np.testing.assert_allclose(np.asarray(out), mat @ B, **TOL)


def test_spmm_tiled_k_padding():
    # K not a multiple of 128 exercises the pad/strip path.
    csr, mat = random_csr(30, 25, density=0.2, seed=4)
    plan = build_tiled_plan(csr, col_tile=8, rows_per_block=8, chunk_nnz=8,
                            part_rows=16)
    B = np.random.default_rng(4).standard_normal((25, 33)).astype(np.float32)
    out = spmm_tiled(plan, csr.data, jnp.asarray(B), 30)
    np.testing.assert_allclose(np.asarray(out), mat @ B, **TOL)


def test_spmm_tiled_empty_rows_and_empty_part():
    # Rows (and a whole trailing part) with no nonzeros stay exactly zero.
    csr, mat = random_csr(40, 30, density=0.1, seed=5)
    import scipy.sparse as sp
    from gespmm_tpu.sparse.formats import csr_from_scipy

    smat = sp.vstack([mat, sp.csr_matrix((24, 30), dtype=np.float32)]).tocsr()
    ours = csr_from_scipy(smat)
    plan = build_tiled_plan(ours, col_tile=16, rows_per_block=8, chunk_nnz=8,
                            part_rows=32)
    B = np.random.default_rng(5).standard_normal((30, 8)).astype(np.float32)
    out = spmm_tiled(plan, ours.data, jnp.asarray(B), 64)
    np.testing.assert_allclose(np.asarray(out), smat @ B, **TOL)
    assert np.all(np.asarray(out)[40:] == 0)


def test_adjacency_auto_plan_is_tiled_and_dispatches():
    csr, mat = random_csr(64, 64, density=0.08, seed=6)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=32, rows_per_block=16,
                             chunk_nnz=16, part_rows=32)
    assert isinstance(adj.plan, TiledSpmmPlan)
    assert isinstance(adj.plan_t, TiledSpmmPlan)
    B = np.random.default_rng(6).standard_normal((64, 16)).astype(np.float32)
    out = spmm(adj, jnp.asarray(B), method="tiled")
    np.testing.assert_allclose(np.asarray(out), mat @ B, **TOL)
    # auto resolves to tiled when the plan is tiled
    out2 = spmm(adj, jnp.asarray(B), method="auto")
    np.testing.assert_allclose(np.asarray(out2), np.asarray(out), rtol=0, atol=0)


def test_spmm_tiled_grad_matches_dense():
    csr, mat = random_csr(40, 36, density=0.1, seed=7)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    B = jnp.asarray(
        np.random.default_rng(7).standard_normal((36, 8)).astype(np.float32)
    )
    dense = jnp.asarray(mat.toarray())

    def loss_sparse(b):
        return jnp.sum(jnp.sin(spmm(adj, b, method="tiled")))

    def loss_dense(b):
        return jnp.sum(jnp.sin(dense @ b))

    g1 = jax.grad(loss_sparse)(B)
    g2 = jax.grad(loss_dense)(B)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-3,
                               atol=1e-4)


def test_spmm_tiled_jit_stability():
    csr, _ = random_csr(32, 32, density=0.1, seed=8)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=16)
    B = jnp.asarray(
        np.random.default_rng(8).standard_normal((32, 8)).astype(np.float32)
    )
    f = jax.jit(lambda b: spmm(adj, b, method="tiled"))
    o1, o2 = f(B), f(B)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))


def test_sddmm_tiled_matches_dense_and_grads():
    csr, mat = random_csr(60, 50, density=0.12, seed=9)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    rng = np.random.default_rng(9)
    D1 = jnp.asarray(rng.standard_normal((60, 16)).astype(np.float32))
    D2 = jnp.asarray(rng.standard_normal((50, 16)).astype(np.float32))

    from gespmm_tpu.ops.sddmm import sddmm

    out = sddmm(adj, D1, D2)
    coo = mat.tocoo()
    golden = np.einsum(
        "ek,ek->e", np.asarray(D1)[coo.row], np.asarray(D2)[coo.col]
    )
    # golden follows scipy's coo order == CSR order (sorted indices)
    np.testing.assert_allclose(np.asarray(out), golden, rtol=1e-4, atol=1e-4)

    # grads vs the dense masked formulation
    mask = jnp.asarray((mat.toarray() != 0).astype(np.float32))

    def loss_sparse(d1, d2):
        return jnp.sum(jnp.sin(sddmm(adj, d1, d2)))

    def loss_dense(d1, d2):
        prod = (d1 @ d2.T) * mask
        vals = prod[coo.row, coo.col]
        return jnp.sum(jnp.sin(vals))

    g1 = jax.grad(loss_sparse, argnums=(0, 1))(D1, D2)
    g2 = jax.grad(loss_dense, argnums=(0, 1))(D1, D2)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )


def test_spmm_tiled_bf16_binary_exact_fast_path():
    # bf16 features + implicit-1.0 edges: gathered in bf16, summed in
    # f32, returned in bf16.
    csr, mat = random_csr(64, 64, density=0.1, seed=13, binary=True)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=32, rows_per_block=16,
                             chunk_nnz=16, part_rows=32)
    B = np.random.default_rng(13).standard_normal((64, 16)).astype(np.float32)
    B16 = jnp.asarray(B).astype(jnp.bfloat16)
    out = spmm(adj, B16, method="tiled")
    assert out.dtype == jnp.bfloat16
    golden = mat @ np.asarray(B16.astype(jnp.float32))
    np.testing.assert_allclose(
        np.asarray(out.astype(jnp.float32)), golden, rtol=2e-2, atol=2e-2
    )


def _dense_minmax(mat, B, op):
    """Dense oracle: out[r,k] = op over nonzero c of A[r,c]*B[c,k]; empty
    rows -> 0 (the op-layer semantics)."""
    A = mat.toarray()
    mask = A != 0
    ident = -np.inf if op == "max" else np.inf
    contrib = np.where(
        mask[:, :, None], A[:, :, None] * B[None, :, :], ident
    )
    red = contrib.max(axis=1) if op == "max" else contrib.min(axis=1)
    return np.where(np.isfinite(red), red, 0.0)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize(
    "shape,density,ct,rp,E,pr,binary",
    [
        pytest.param((60, 50), 0.15, 16, 8, 8, 24, False,
                     marks=pytest.mark.slow),  # many tiles, many parts
        pytest.param((64, 64), 0.1, 1 << 20, 16, 16, 1 << 20, False,
                     marks=pytest.mark.slow),  # single tile
        ((48, 40), 0.12, 16, 8, 8, 16, True),    # binary adjacency
    ],
)
def test_spmm_tiled_minmax_interpret(op, shape, density, ct, rp, E, pr, binary):
    csr, mat = random_csr(*shape, density=density, seed=21, binary=binary)
    # minmax_aligned=False: this test pins the SCAN kernel (the aligned
    # layout has its own suite in tests/test_aligned_minmax.py).
    plan = build_tiled_plan(
        csr, col_tile=ct, rows_per_block=rp, chunk_nnz=E, part_rows=pr,
        minmax_aligned=False,
    )
    B = np.random.default_rng(21).standard_normal(
        (shape[1], 16)
    ).astype(np.float32)
    out = spmm_tiled(
        plan, csr.data, jnp.asarray(B), shape[0], reduce=op
    )
    if binary:
        mat = mat.copy()
        mat.data[:] = 1.0
    golden = _dense_minmax(mat, B, op)
    # max/min are exact selections — tight tolerance.
    np.testing.assert_allclose(np.asarray(out), golden, rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_spmm_tiled_minmax_powerlaw_long_runs():
    # Hub rows span many chunks; the per-chunk scan + cross-chunk fold
    # must still produce the exact row max.
    csr, mat = powerlaw_csr(96, 80, avg_deg=10, seed=22)
    plan = build_tiled_plan(csr, col_tile=32, rows_per_block=16, chunk_nnz=16,
                            part_rows=40, minmax_aligned=False)
    B = np.random.default_rng(22).standard_normal((80, 8)).astype(np.float32)
    out = spmm_tiled(plan, csr.data, jnp.asarray(B), 96,
                     reduce="max")
    np.testing.assert_allclose(
        np.asarray(out), _dense_minmax(mat, B, "max"), rtol=1e-6, atol=1e-6
    )


def test_spmm_max_dispatches_tiled_and_matches_xla():
    csr, mat = random_csr(64, 64, density=0.08, seed=23)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=32, rows_per_block=16,
                             chunk_nnz=16, part_rows=32)
    B = jnp.asarray(
        np.random.default_rng(23).standard_normal((64, 16)).astype(np.float32)
    )
    out_tiled = spmm(adj, B, reduce="max", method="tiled")
    out_xla = spmm(adj, B, reduce="max", method="xla")
    np.testing.assert_allclose(
        np.asarray(out_tiled), np.asarray(out_xla), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out_tiled), _dense_minmax(mat, np.asarray(B), "max"),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.slow
def test_spmm_tiled_minmax_grad_matches_dense(op):
    csr, mat = random_csr(40, 36, density=0.1, seed=24)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    B = jnp.asarray(
        np.random.default_rng(24).standard_normal((36, 8)).astype(np.float32)
    )
    A = jnp.asarray(mat.toarray())
    mask = jnp.asarray(mat.toarray() != 0)
    ident = -jnp.inf if op == "max" else jnp.inf
    red = jnp.max if op == "max" else jnp.min

    def loss_sparse(b):
        return jnp.sum(jnp.sin(spmm(adj, b, reduce=op, method="tiled")))

    def loss_dense(b):
        contrib = jnp.where(mask[:, :, None], A[:, :, None] * b[None], ident)
        out = red(contrib, axis=1)
        out = jnp.where(jnp.isfinite(out), out, 0.0)
        return jnp.sum(jnp.sin(out))

    g1 = jax.grad(loss_sparse)(B)
    g2 = jax.grad(loss_dense)(B)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.slow
def test_spmm_tiled_max_edge_value_grad():
    # d(loss)/d(edge values) through the tiled max backward vs the XLA
    # reference backward (same tie-splitting semantics).
    csr, mat = random_csr(32, 30, density=0.12, seed=25)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=16)
    B = jnp.asarray(
        np.random.default_rng(25).standard_normal((30, 8)).astype(np.float32)
    )

    def loss(vals, method):
        a = adj.with_data(vals)
        return jnp.sum(jnp.sin(spmm(a, B, reduce="max", method=method)))

    g_tiled = jax.grad(lambda v: loss(v, "tiled"))(adj.csr.data)
    g_xla = jax.grad(lambda v: loss(v, "xla"))(adj.csr.data)
    np.testing.assert_allclose(
        np.asarray(g_tiled), np.asarray(g_xla), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("op", ["max", "min"])
def test_spmm_tiled_want_ties_counts_and_grads(op):
    # Quantized B forces REAL ties (several edges achieving the row
    # max/min exactly); the in-kernel pair-monoid count must equal a
    # dense recount, and the grad (which consumes the emitted ties via
    # the even-split rule) must match the dense oracle.
    csr, mat = random_csr(48, 40, density=0.15, seed=27, binary=True)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    rng = np.random.default_rng(27)
    B = jnp.asarray(
        np.round(rng.standard_normal((40, 8)) * 2).astype(np.float32) / 2
    )
    out, ties = spmm_tiled(
        adj.plan, None, B, 48, reduce=op, want_ties=True
    )
    dense = np.asarray(mat.toarray() != 0)
    contrib = np.where(dense[:, :, None], np.asarray(B)[None], np.nan)
    red = np.nanmax if op == "max" else np.nanmin
    with np.errstate(all="ignore"):
        golden = red(contrib, axis=1)
    golden_ties = np.nansum(
        (contrib == golden[:, None, :]).astype(np.float32), axis=1
    )
    golden_out = np.where(np.isnan(golden), 0.0, golden)
    np.testing.assert_allclose(np.asarray(out), golden_out, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ties), golden_ties)
    assert (np.asarray(ties).max(initial=0)) > 1, "test graph has no ties"

    ident = -jnp.inf if op == "max" else jnp.inf
    redj = jnp.max if op == "max" else jnp.min
    A = jnp.asarray(dense.astype(np.float32))
    mask = jnp.asarray(dense)

    def loss_sparse(b):
        return jnp.sum(jnp.sin(spmm(adj, b, reduce=op, method="tiled")))

    def loss_dense(b):
        c = jnp.where(mask[:, :, None], A[:, :, None] * b[None], ident)
        o = redj(c, axis=1)
        return jnp.sum(jnp.sin(jnp.where(jnp.isfinite(o), o, 0.0)))

    g1 = jax.grad(loss_sparse)(B)
    g2 = jax.grad(loss_dense)(B)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("op", ["max", "min"])
def test_spmm_tiled_want_ties_multi_ktile_slab_bf16(op, monkeypatch):
    # The K-slab recursion and bf16 inputs with want_ties: a tiny stream
    # budget forces two 128-column slabs at K=256.
    import gespmm_tpu.kernels.spmm_stream as ss

    csr, mat = random_csr(24, 20, density=0.2, seed=31, binary=True)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    rng = np.random.default_rng(31)
    K = 256
    B = jnp.asarray(
        np.round(rng.standard_normal((20, K)) * 2).astype(np.float32) / 2
    )
    dense = np.asarray(mat.toarray() != 0)
    contrib = np.where(dense[:, :, None], np.asarray(B)[None], np.nan)
    red = np.nanmax if op == "max" else np.nanmin
    with np.errstate(all="ignore"):
        golden = red(contrib, axis=1)
    golden_ties = np.nansum(
        (contrib == golden[:, None, :]).astype(np.float32), axis=1
    )
    golden_out = np.where(np.isnan(golden), 0.0, golden)

    slots_max = max(p.num_slots for p in adj.plan.parts)
    # Budget small enough that a 256-wide f32 stream must slab (the slab
    # floor is 128 columns, so this forces exactly two slabs).
    monkeypatch.setattr(ss, "_stream_budget", lambda: slots_max * 4 * 128)
    assert ss._k_slab(slots_max, K) == 128
    out, ties = spmm_tiled(
        adj.plan, None, B, 24, reduce=op,
        want_ties=True,
    )
    np.testing.assert_allclose(np.asarray(out), golden_out, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ties), golden_ties)
    assert (np.asarray(ties).max(initial=0)) > 1, "test graph has no ties"

    # bf16 B + implicit edges with ties.
    Bb = B.astype(jnp.bfloat16)
    out_b, ties_b = spmm_tiled(
        adj.plan, None, Bb, 24, reduce=op,
        want_ties=True,
    )
    # B's values are multiples of 0.5 well within bf16 range, so the
    # bf16 cast is exact and the golden still applies.
    np.testing.assert_allclose(
        np.asarray(out_b.astype(jnp.float32)), golden_out, rtol=1e-6,
        atol=1e-6,
    )
    np.testing.assert_array_equal(np.asarray(ties_b), golden_ties)


def test_explicit_method_strictness():
    csr, _ = random_csr(32, 32, density=0.1, seed=26)
    adj_plain = Adjacency.from_csr(csr)
    adj_tiled = Adjacency.from_csr(csr, plan=True, col_tile=16,
                                   rows_per_block=8, chunk_nnz=8, part_rows=16)
    B = jnp.asarray(
        np.random.default_rng(26).standard_normal((32, 8)).astype(np.float32)
    )
    # tiled without a tiled plan must raise, not silently fall back.
    with pytest.raises(ValueError, match="tiled"):
        spmm(adj_plain, B, method="tiled")
    # pallas is the Triton kernel: off the GPU it must raise, not run
    # interpreted or fall back.
    with pytest.raises(ValueError, match="Triton"):
        spmm(adj_tiled, B, method="pallas")
    # explicit kernel method with an unsupported reduce must raise.
    with pytest.raises(ValueError, match="reduce"):
        spmm(adj_tiled, B, method="scatter", reduce="max")
    with pytest.raises(ValueError, match="unknown method"):
        spmm(adj_tiled, B, method="warp")
    # auto may fall back silently for any reduce.
    spmm(adj_plain, B, method="auto", reduce="max")


@pytest.mark.slow
def test_spmm_tiled_nonmultiple_k_tile_terminates():
    # A wide K that is not a multiple of 128.
    csr, mat = random_csr(24, 20, density=0.2, seed=27)
    plan = build_tiled_plan(csr, col_tile=8, rows_per_block=8, chunk_nnz=8,
                            part_rows=16)
    B = np.random.default_rng(27).standard_normal((20, 300)).astype(np.float32)
    out = spmm_tiled(plan, csr.data, jnp.asarray(B), 24)
    np.testing.assert_allclose(np.asarray(out), mat @ B, **TOL)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("layout", [
    dict(col_tile=8, rows_per_block=8, chunk_nnz=8, part_rows=40),
    dict(col_tile=8, rows_per_block=8, chunk_nnz=8, part_rows=16),
    dict(col_tile=1 << 20, chunk_nnz=8),
])
def test_reduce_part_matches_dense(op, layout):
    # The XLA segment reduce over the slot layout: chunk boundaries, tile
    # boundaries (col_tile=8), part boundaries (part_rows=16), pad slots,
    # and exact tie counts for max/min.
    from gespmm_tpu.kernels.spmm_stream import _gather_part, _reduce_part

    csr, mat = random_csr(40, 32, density=0.25, seed=33, binary=True)
    plan = build_tiled_plan(csr, minmax_aligned=False, **layout)
    rng = np.random.default_rng(33)
    B = jnp.asarray(
        np.round(rng.standard_normal((32, 8)) * 2).astype(np.float32) / 2
    )
    dense = np.asarray(mat.toarray() != 0)
    c = np.where(dense[:, :, None], np.asarray(B)[None], np.nan)
    outs, ties = [], []
    for part in plan.parts:
        contrib = _gather_part(part, None, B)
        res = _reduce_part(
            contrib, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op=op, want_ties=op != "sum",
        )
        out, t = res if op != "sum" else (res, None)
        assert out.shape == (part.m_pad, 8)
        outs.append(np.asarray(out)[: part.m_part])
        if t is not None:
            ties.append(np.asarray(t)[: part.m_part])
    got = np.concatenate(outs)
    with np.errstate(all="ignore"):
        if op == "sum":
            np.testing.assert_allclose(got, np.nansum(c, axis=1),
                                       rtol=1e-6, atol=1e-6)
            return
        golden = (np.nanmax if op == "max" else np.nanmin)(c, axis=1)
    empty = ~dense.any(axis=1)
    ident = -np.inf if op == "max" else np.inf
    assert np.all(got[empty] == ident)
    np.testing.assert_array_equal(got[~empty], golden[~empty])
    golden_ties = np.nansum((c == golden[:, None, :]).astype(np.float32), 1)
    np.testing.assert_array_equal(np.concatenate(ties), golden_ties)


def test_adjacency_forward_only_plan():
    # plan_transpose=False (forward-only use: inference / the sweep):
    # tiled forward still runs; backward falls back to the XLA tier and
    # stays correct; max/min grads also route through the no-ties path.
    csr, mat = random_csr(40, 36, density=0.12, seed=51)
    adj = Adjacency.from_csr(csr, plan=True, plan_transpose=False,
                             col_tile=16, rows_per_block=8, chunk_nnz=8,
                             part_rows=40)
    assert adj.plan is not None and adj.plan_t is None
    B = jnp.asarray(
        np.random.default_rng(51).standard_normal((36, 8)).astype(np.float32)
    )
    out = spmm(adj, B, method="tiled")
    np.testing.assert_allclose(np.asarray(out), mat @ np.asarray(B), **TOL)
    dense = jnp.asarray(mat.toarray())
    for reduce in ("sum", "max"):
        def loss_sparse(b, _r=reduce):
            return jnp.sum(jnp.sin(spmm(adj, b, reduce=_r, method="tiled")))

        def loss_dense(b, _r=reduce):
            if _r == "sum":
                return jnp.sum(jnp.sin(dense @ b))
            c = jnp.where(jnp.asarray(mat.toarray() != 0)[:, :, None],
                          dense[:, :, None] * b[None], -jnp.inf)
            o = jnp.max(c, axis=1)
            return jnp.sum(jnp.sin(jnp.where(jnp.isfinite(o), o, 0.0)))

        g1 = jax.grad(loss_sparse)(B)
        g2 = jax.grad(loss_dense)(B)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   rtol=1e-3, atol=1e-4, err_msg=reduce)


@pytest.mark.parametrize("layout", ["hub", "shuffled", "padded"])
def test_reduce_part_sum_is_float32_accurate(layout):
    # A row spread over many chunks (a hub) sums its per-chunk runs first,
    # so its error stays near one float32 rounding of the row; rows that
    # repeat non-adjacently inside a chunk must still sum exactly once.
    from gespmm_tpu.kernels.spmm_stream import _reduce_part

    C, E, K, R = 512, 256, 8, 6
    rng = np.random.default_rng(11)
    if layout == "hub":
        lr = np.zeros((C, E), np.int32)
        lr[:, -3:] = 1
    else:
        lr = rng.integers(0, R, size=(C, E)).astype(np.int32)
        if layout == "padded":
            lr = np.sort(lr, axis=1)
            lr[:, E - 40:] = R  # pad sentinel: dropped
    rs = rng.integers(0, 3, size=C).astype(np.int32)
    c = (rng.standard_normal((C * E, K)) + 3).astype(np.float32)
    m_pad = R + 3
    out = _reduce_part(jnp.asarray(c), jnp.asarray(lr), jnp.asarray(rs),
                       m_pad=m_pad, rows_per_block=R)
    seg = np.where(lr < R, rs[:, None] + lr, m_pad).reshape(-1)
    ref = np.zeros((m_pad + 1, K))
    np.add.at(ref, seg, c.astype(np.float64))
    err = np.abs(np.asarray(out) - ref[:m_pad]).max() / np.abs(ref).max()
    assert err <= (1e-6 if layout == "hub" else 1e-5)

"""SpMM / SDDMM numerics vs scipy golden at 1e-5 (SURVEY §4 target —
tighter than the reference's 1e-2 tolerance at `spmm_test.cu:676`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gespmm_tpu.ops.spmm import Adjacency, spmm
from gespmm_tpu.ops.sddmm import sddmm, sddmm_coo
from gespmm_tpu.ops import graph as gops
from tests.conftest import powerlaw_csr, random_csr

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 7, 32, 130])
@pytest.mark.parametrize("binary", [False, True])
def test_spmm_sum_matches_scipy(k, binary):
    csr, mat = random_csr(57, 43, density=0.12, seed=k, binary=binary)
    rng = np.random.default_rng(k)
    B = rng.standard_normal((43, k)).astype(np.float32)
    out = spmm(csr, jnp.asarray(B))
    oracle = mat @ B
    np.testing.assert_allclose(np.asarray(out), oracle, **TOL)


def test_spmm_jit_and_adjacency():
    csr, mat = random_csr(40, 40, density=0.1, seed=2)
    adj = Adjacency.from_csr(csr)
    B = np.random.default_rng(0).standard_normal((40, 16)).astype(np.float32)
    f = jax.jit(lambda a, b: spmm(a, b))
    out = f(adj, jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(out), mat @ B, **TOL)


def test_spmm_empty_rows():
    csr, mat = random_csr(64, 32, density=0.02, seed=5)
    assert (np.diff(mat.indptr) == 0).any(), "fixture should have empty rows"
    B = np.random.default_rng(1).standard_normal((32, 8)).astype(np.float32)
    for reduce in ("sum", "mean", "max", "min"):
        out = np.asarray(spmm(csr, jnp.asarray(B), reduce=reduce))
        empty = np.diff(mat.indptr) == 0
        assert np.all(out[empty] == 0), f"{reduce}: empty rows must be 0"


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_spmm_maxmin_matches_dense(reduce):
    csr, mat = random_csr(30, 25, density=0.15, seed=8)
    B = np.random.default_rng(3).standard_normal((25, 12)).astype(np.float32)
    out = np.asarray(spmm(csr, jnp.asarray(B), reduce=reduce))
    # Dense oracle: per row, reduce over contributing edges.
    dense = mat.toarray()
    expect = np.zeros((30, 12), np.float32)
    for r in range(30):
        cols = mat.indices[mat.indptr[r] : mat.indptr[r + 1]]
        vals = mat.data[mat.indptr[r] : mat.indptr[r + 1]]
        if len(cols) == 0:
            continue
        contrib = vals[:, None] * B[cols]
        expect[r] = contrib.max(0) if reduce == "max" else contrib.min(0)
    np.testing.assert_allclose(out, expect, **TOL)


def test_spmm_mean_matches_scipy():
    csr, mat = random_csr(45, 33, density=0.1, seed=4)
    B = np.random.default_rng(4).standard_normal((33, 9)).astype(np.float32)
    out = np.asarray(spmm(csr, jnp.asarray(B), reduce="mean"))
    deg = np.maximum(np.diff(mat.indptr), 1)
    np.testing.assert_allclose(out, (mat @ B) / deg[:, None], **TOL)


def test_spmm_powerlaw_structure():
    csr, mat = powerlaw_csr(200, 150, avg_deg=6, seed=7)
    B = np.random.default_rng(5).standard_normal((150, 33)).astype(np.float32)
    out = np.asarray(spmm(csr, jnp.asarray(B)))
    np.testing.assert_allclose(out, mat @ B, rtol=1e-4, atol=1e-4)


def test_spmm_transpose_pairing():
    csr, mat = random_csr(20, 35, density=0.12, seed=6)
    adj = Adjacency.from_csr(csr)
    t = adj.transpose()
    B = np.random.default_rng(6).standard_normal((20, 10)).astype(np.float32)
    out = np.asarray(spmm(t, jnp.asarray(B)))
    np.testing.assert_allclose(out, mat.T @ B, **TOL)


@pytest.mark.parametrize("k", [4, 32, 100])
def test_sddmm_matches_scipy(k):
    csr, mat = random_csr(48, 37, density=0.15, seed=k, binary=True)
    rng = np.random.default_rng(k)
    D1 = rng.standard_normal((48, k)).astype(np.float32)
    D2 = rng.standard_normal((37, k)).astype(np.float32)
    out = np.asarray(sddmm(csr, jnp.asarray(D1), jnp.asarray(D2)))
    # Oracle: dense product sampled at the pattern.
    full = D1 @ D2.T
    rows = np.repeat(np.arange(48), np.diff(mat.indptr))
    np.testing.assert_allclose(out, full[rows, mat.indices], rtol=1e-4, atol=1e-4)


def test_sddmm_coo_matches_csr_order():
    csr, mat = random_csr(25, 25, density=0.1, seed=12, binary=True)
    rng = np.random.default_rng(12)
    D1 = jnp.asarray(rng.standard_normal((25, 8)).astype(np.float32))
    D2 = jnp.asarray(rng.standard_normal((25, 8)).astype(np.float32))
    rows = np.repeat(np.arange(25), np.diff(mat.indptr)).astype(np.int32)
    a = sddmm_coo(jnp.asarray(rows), csr.indices, D1, D2, shape=(25, 25))
    b = sddmm(csr, D1, D2)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_gcn_aggregate_matches_manual():
    csr, mat = random_csr(30, 30, density=0.15, seed=9)
    adj = Adjacency.from_csr(csr)
    x = np.random.default_rng(9).standard_normal((30, 11)).astype(np.float32)
    out = np.asarray(gops.gcn_aggregate(adj, jnp.asarray(x)))
    dout = np.maximum(np.diff(mat.indptr), 1).astype(np.float64)
    din = np.maximum(np.asarray((mat != 0).sum(0)).ravel(), 1).astype(np.float64)
    expect = (dout**-0.5)[:, None] * (mat @ ((din**-0.5)[:, None] * x))
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_edge_softmax_rows_sum_to_one():
    csr, mat = random_csr(22, 22, density=0.2, seed=10, binary=True)
    adj = Adjacency.from_csr(csr)
    logits = jnp.asarray(
        np.random.default_rng(10).standard_normal(csr.nnz).astype(np.float32)
    )
    w = np.asarray(gops.edge_softmax(adj, logits))
    rows = np.repeat(np.arange(22), np.diff(mat.indptr))
    sums = np.zeros(22)
    np.add.at(sums, rows, w)
    nonempty = np.diff(mat.indptr) > 0
    np.testing.assert_allclose(sums[nonempty], 1.0, rtol=1e-5)


def test_add_self_loops():
    csr, mat = random_csr(18, 18, density=0.1, seed=11)
    out = gops.add_self_loops(csr, weight=2.5)
    dense = np.asarray(out.todense())
    expect = mat.toarray().copy()
    np.fill_diagonal(expect, 2.5)
    np.testing.assert_allclose(dense, expect, **TOL)


def test_spmm_scatter_method_matches_xla():
    import jax.numpy as jnp
    import numpy as np

    from gespmm_tpu.ops.spmm import Adjacency, spmm
    from tests.conftest import random_csr

    csr, mat = random_csr(50, 44, density=0.1, seed=31)
    adj = Adjacency.from_csr(csr)
    B = np.random.default_rng(31).standard_normal((44, 8)).astype(np.float32)
    out = spmm(adj, jnp.asarray(B), method="scatter")
    np.testing.assert_allclose(np.asarray(out), mat @ B, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_sddmm_tiled_tier_and_strictness():
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from gespmm_tpu.ops.sddmm import sddmm
    from gespmm_tpu.ops.spmm import Adjacency
    from tests.conftest import random_csr

    csr, mat = random_csr(48, 40, density=0.12, seed=31)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    rng = np.random.default_rng(31)
    D1 = jnp.asarray(rng.standard_normal((48, 16)).astype(np.float32))
    D2 = jnp.asarray(rng.standard_normal((40, 16)).astype(np.float32))
    out_tiled = sddmm(adj, D1, D2, method="tiled")
    out_xla = sddmm(adj, D1, D2, method="xla")
    np.testing.assert_allclose(
        np.asarray(out_tiled), np.asarray(out_xla), rtol=1e-5, atol=1e-5
    )
    # gradient flows through the tiled tier too
    import jax

    g = jax.grad(lambda d: jnp.sum(sddmm(adj, d, D2, method="tiled") ** 2))(D1)
    g2 = jax.grad(lambda d: jnp.sum(sddmm(adj, d, D2, method="xla") ** 2))(D1)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g2), rtol=1e-4,
                               atol=1e-5)
    # explicit tiled without a plan raises
    plain = Adjacency.from_csr(csr)
    with pytest.raises(ValueError, match="tiled"):
        sddmm(plain, D1, D2, method="tiled")
    with pytest.raises(ValueError, match="tiled"):
        sddmm(csr, D1, D2, method="tiled")


@pytest.mark.slow
def test_edge_softmax_stream_path_matches_xla_and_grads():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gespmm_tpu.ops.graph import edge_softmax
    from gespmm_tpu.ops.spmm import Adjacency
    from tests.conftest import random_csr

    csr, mat = random_csr(60, 60, density=0.1, seed=51)
    adj_plan = Adjacency.from_csr(csr, plan=True, col_tile=16,
                                  rows_per_block=8, chunk_nnz=8, part_rows=32)
    adj_plain = Adjacency.from_csr(csr)
    rng = np.random.default_rng(51)
    for shape in ((csr.nnz,), (csr.nnz, 4)):
        logits = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        a1 = edge_softmax(adj_plan, logits)
        a2 = edge_softmax(adj_plain, logits)
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                                   rtol=1e-5, atol=1e-6)
        # rows sum to 1 (per head)
        rows = np.asarray(adj_plan.rows)
        sums = np.zeros((60,) + shape[1:])
        np.add.at(sums, rows, np.asarray(a1))
        deg = np.bincount(rows, minlength=60)
        np.testing.assert_allclose(sums[deg > 0],
                                   np.ones_like(sums[deg > 0]), rtol=1e-5)
        # grads match between paths and vs a dense softmax oracle
        g1 = jax.grad(lambda l: jnp.sum(jnp.sin(edge_softmax(adj_plan, l))))(logits)
        g2 = jax.grad(lambda l: jnp.sum(jnp.sin(edge_softmax(adj_plain, l))))(logits)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   rtol=1e-4, atol=1e-6)

    # dense oracle for the scalar case
    logits = jnp.asarray(rng.standard_normal((csr.nnz,)).astype(np.float32))
    rows = np.asarray(adj_plan.rows)

    def dense_loss(l):
        # segment softmax via dense (m, nnz) one-hot
        oh = jnp.asarray((rows[None, :] == np.arange(60)[:, None]
                          ).astype(np.float32))
        mx = jnp.max(jnp.where(oh > 0, l[None, :], -jnp.inf), axis=1)
        mx = jnp.where(jnp.isfinite(mx), mx, 0.0)
        ex = jnp.exp(l - mx[rows])
        den = oh @ ex
        return jnp.sum(jnp.sin(ex / jnp.maximum(den, 1e-38)[rows]))

    g1 = jax.grad(lambda l: jnp.sum(jnp.sin(edge_softmax(adj_plan, l))))(logits)
    gd = jax.grad(dense_loss)(logits)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(gd), rtol=1e-4,
                               atol=1e-6)


def test_additive_attention_logits_and_grads():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gespmm_tpu.ops.graph import additive_attention_logits
    from gespmm_tpu.ops.spmm import Adjacency
    from tests.conftest import random_csr

    csr, mat = random_csr(50, 44, density=0.12, seed=71)
    coo = mat.tocoo()
    rng = np.random.default_rng(71)
    src = jnp.asarray(rng.standard_normal((50,)).astype(np.float32))
    dst = jnp.asarray(rng.standard_normal((44,)).astype(np.float32))
    for adj in (Adjacency.from_csr(csr, plan=True, col_tile=16,
                                   rows_per_block=8, chunk_nnz=8,
                                   part_rows=24),
                Adjacency.from_csr(csr)):
        out = additive_attention_logits(adj, src, dst)
        golden = np.asarray(src)[coo.row] + np.asarray(dst)[coo.col]
        np.testing.assert_allclose(np.asarray(out), golden, rtol=1e-6,
                                   atol=1e-6)

        def loss(s, d):
            return jnp.sum(jnp.sin(additive_attention_logits(adj, s, d)))

        g1 = jax.grad(loss, argnums=(0, 1))(src, dst)
        # dense oracle
        A = jnp.asarray((mat.toarray() != 0).astype(np.float32))

        def dense_loss(s, d):
            lg = s[:, None] + d[None, :]
            return jnp.sum(jnp.where(A > 0, jnp.sin(lg), 0.0))

        g2 = jax.grad(dense_loss, argnums=(0, 1))(src, dst)
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


def test_spmm_dense_method_matches_scipy():
    # The densify-and-matmul crossover baseline (≙ the merge-spmm third-
    # baseline role, reference run_test.sh:12-16): numerics must match.
    csr, mat = random_csr(57, 43, density=0.12, seed=11)
    B = np.random.default_rng(4).standard_normal((43, 16)).astype(np.float32)
    out = spmm(csr, jnp.asarray(B), method="dense")
    np.testing.assert_allclose(np.asarray(out), mat @ B, rtol=1e-4, atol=1e-4)
    out_m = spmm(csr, jnp.asarray(B), reduce="mean", method="dense")
    deg = np.maximum(np.diff(mat.indptr), 1)[:, None]
    np.testing.assert_allclose(
        np.asarray(out_m), (mat @ B) / deg, rtol=1e-4, atol=1e-4
    )


def test_spmm_dense_size_guard():
    # The dense tier must refuse (not OOM) when densified A is too large.
    from gespmm_tpu.ops import reference as ref

    rows = jnp.zeros((4,), jnp.int32)
    cols = jnp.zeros((4,), jnp.int32)
    B = jnp.zeros((1 << 18, 8), jnp.float32)
    with pytest.raises(ValueError, match="dense A would be"):
        ref.spmm_dense_xla(rows, cols, None, B, 1 << 18)

"""Fused slot-space GAT attention vs the composed single-device chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gespmm_tpu.kernels.gat_fused import gat_attention_aggregate
from gespmm_tpu.ops.graph import additive_attention_logits, edge_softmax
from gespmm_tpu.ops.spmm import Adjacency, spmm
from tests.conftest import powerlaw_csr, random_csr

TOL = dict(rtol=1e-4, atol=1e-4)


def _composed(adj, src, dst, B, slope=0.2):
    logits = additive_attention_logits(adj, src, dst)
    alpha = edge_softmax(adj, jax.nn.leaky_relu(logits, slope))
    return spmm(adj.with_data(alpha), B, method="xla")


def _mk(m, n, K, density=0.12, seed=0, **plan_kw):
    csr, mat = random_csr(m, n, density=density, seed=seed)
    adj = Adjacency.from_csr(csr, plan=True, **plan_kw)
    rng = np.random.default_rng(seed)
    src = jnp.asarray(rng.standard_normal((m,)).astype(np.float32))
    dst = jnp.asarray(rng.standard_normal((n,)).astype(np.float32))
    B = jnp.asarray(rng.standard_normal((n, K)).astype(np.float32))
    return adj, src, dst, B


@pytest.mark.parametrize(
    "shape,K,kw",
    [
        ((60, 50), 16, dict(col_tile=16, rows_per_block=8, chunk_nnz=8,
                            part_rows=24)),   # many tiles, many parts
        pytest.param((64, 64), 32, dict(col_tile=1 << 20,
                                        rows_per_block=16, chunk_nnz=16),
                     marks=pytest.mark.slow),  # single tile
    ],
)
def test_fused_matches_composed_chain(shape, K, kw):
    adj, src, dst, B = _mk(*shape, K, seed=shape[0], **kw)
    out = gat_attention_aggregate(adj, src, dst, B)
    expect = _composed(adj, src, dst, B)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect), **TOL)


def test_fused_powerlaw_hub_rows():
    csr, _ = powerlaw_csr(96, 96, avg_deg=8, seed=3)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=32, rows_per_block=8,
                             chunk_nnz=8, part_rows=40)
    rng = np.random.default_rng(3)
    src = jnp.asarray(rng.standard_normal((96,)).astype(np.float32))
    dst = jnp.asarray(rng.standard_normal((96,)).astype(np.float32))
    B = jnp.asarray(rng.standard_normal((96, 8)).astype(np.float32))
    out = gat_attention_aggregate(adj, src, dst, B)
    expect = _composed(adj, src, dst, B)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect), **TOL)
    # Rows with no edges aggregate to zero.
    deg = np.diff(np.asarray(csr.indptr))
    assert np.all(np.abs(np.asarray(out)[deg == 0]) < 1e-6)


def test_fused_grads_match_composed():
    # 52 % part_rows != 0: the last part is row-padded, exercising the
    # padded-denominator clamp in the backward (a zero-padded den once
    # produced inf/NaN through invalid slots).
    adj, src, dst, B = _mk(52, 52, 8, seed=9, col_tile=16,
                           rows_per_block=8, chunk_nnz=8, part_rows=24)
    w = jnp.asarray(
        np.random.default_rng(9).standard_normal((52, 8)).astype(np.float32)
    )

    def loss_fused(src, dst, B):
        return jnp.sum(gat_attention_aggregate(adj, src, dst, B) * w)

    def loss_comp(src, dst, B):
        return jnp.sum(_composed(adj, src, dst, B) * w)

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(src, dst, B)
    gc = jax.grad(loss_comp, argnums=(0, 1, 2))(src, dst, B)
    for a, b, name in zip(gf, gc, ["src", "dst", "B"]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-4,
            err_msg=f"grad_{name}",
        )


@pytest.mark.slow
def test_fused_jit_and_dtype():
    adj, src, dst, B = _mk(40, 40, 8, seed=5, col_tile=1 << 20,
                           rows_per_block=8, chunk_nnz=8)
    f = jax.jit(lambda s, d, b: gat_attention_aggregate(adj, s, d, b))
    o1 = f(src, dst, B)
    o2 = f(src, dst, B)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
    ob = gat_attention_aggregate(adj, src, dst, B.astype(jnp.bfloat16))
    assert ob.dtype == jnp.bfloat16
    assert bool(jnp.isfinite(ob.astype(jnp.float32)).all())


def test_fused_validates_inputs():
    adj, src, dst, B = _mk(40, 40, 8, seed=5, col_tile=1 << 20,
                           rows_per_block=8, chunk_nnz=8)
    with pytest.raises(ValueError, match="single head"):
        gat_attention_aggregate(adj, src[:10], dst, B)
    with pytest.raises(ValueError, match="must be"):
        gat_attention_aggregate(adj, src, dst, B[:10])
    from gespmm_tpu.ops.spmm import Adjacency as A

    adj_np = A.from_csr(adj.csr)  # no plan
    with pytest.raises(ValueError, match="plan"):
        gat_attention_aggregate(adj_np, src, dst, B)


def test_dot_attention_matches_composed():
    csr, _ = random_csr(56, 48, density=0.12, seed=17)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    rng = np.random.default_rng(17)
    D1 = jnp.asarray(rng.standard_normal((56, 6)).astype(np.float32))
    D2 = jnp.asarray(rng.standard_normal((48, 6)).astype(np.float32))
    B = jnp.asarray(rng.standard_normal((48, 8)).astype(np.float32))
    from gespmm_tpu.kernels.gat_fused import dot_attention_aggregate
    from gespmm_tpu.ops.sddmm import sddmm

    out = dot_attention_aggregate(adj, D1, D2, B)
    scores = sddmm(adj, D1, D2, method="xla")
    alpha = edge_softmax(adj, scores)
    expect = spmm(adj.with_data(alpha), B, method="xla")
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect), **TOL)


def test_dot_attention_grads_match_composed():
    csr, _ = random_csr(44, 44, density=0.14, seed=21)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    rng = np.random.default_rng(21)
    D1 = jnp.asarray(rng.standard_normal((44, 5)).astype(np.float32))
    D2 = jnp.asarray(rng.standard_normal((44, 5)).astype(np.float32))
    B = jnp.asarray(rng.standard_normal((44, 8)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((44, 8)).astype(np.float32))
    from gespmm_tpu.kernels.gat_fused import dot_attention_aggregate
    from gespmm_tpu.ops.sddmm import sddmm

    def loss_fused(D1, D2, B):
        out = dot_attention_aggregate(adj, D1, D2, B, negative_slope=0.2)
        return jnp.sum(out * w)

    def loss_comp(D1, D2, B):
        scores = sddmm(adj, D1, D2, method="xla")
        alpha = edge_softmax(adj, jax.nn.leaky_relu(scores, 0.2))
        return jnp.sum(spmm(adj.with_data(alpha), B, method="xla") * w)

    gf = jax.grad(loss_fused, argnums=(0, 1, 2))(D1, D2, B)
    gc = jax.grad(loss_comp, argnums=(0, 1, 2))(D1, D2, B)
    for a, b, name in zip(gf, gc, ["D1", "D2", "B"]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=3e-4, atol=3e-4,
            err_msg=f"grad_{name}",
        )


def test_attention_aggregate_api_both_paths():
    from gespmm_tpu.ops.graph import attention_aggregate

    csr, _ = random_csr(40, 40, density=0.15, seed=29)
    adj_plan = Adjacency.from_csr(csr, plan=True, col_tile=1 << 20,
                                  rows_per_block=8, chunk_nnz=8)
    adj_xla = Adjacency.from_csr(csr)
    rng = np.random.default_rng(29)
    q = jnp.asarray(rng.standard_normal((40, 4)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((40, 4)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((40, 8)).astype(np.float32))
    out_fused = attention_aggregate(adj_plan, q, k, v)
    out_xla = attention_aggregate(adj_xla, q, k, v, method="xla")
    np.testing.assert_allclose(
        np.asarray(out_fused), np.asarray(out_xla), **TOL
    )


def test_fused_bound_max_mode_matches_exact():
    adj, src, dst, B = _mk(48, 48, 8, seed=33, col_tile=16,
                           rows_per_block=8, chunk_nnz=8, part_rows=24)
    out_e = gat_attention_aggregate(adj, src, dst, B, max_mode="exact")
    out_b = gat_attention_aggregate(adj, src, dst, B, max_mode="bound")
    np.testing.assert_allclose(np.asarray(out_b), np.asarray(out_e),
                               rtol=1e-5, atol=1e-5)
    # Gradients agree too (the shift only changes the residual mx).
    w = jnp.asarray(
        np.random.default_rng(33).standard_normal((48, 8)).astype(np.float32)
    )
    ge = jax.grad(lambda s: jnp.sum(
        gat_attention_aggregate(adj, s, dst, B, max_mode="exact") * w))(src)
    gb = jax.grad(lambda s: jnp.sum(
        gat_attention_aggregate(adj, s, dst, B, max_mode="bound") * w))(src)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(ge),
                               rtol=1e-4, atol=1e-4)


def test_fused_head_batched_matches_per_head():
    """heads=H batched call == H independent single-head calls on the
    head slices (forward and gradients)."""
    csr, _ = random_csr(44, 44, density=0.14, seed=37)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=24)
    rng = np.random.default_rng(37)
    H, dh = 3, 4
    src = jnp.asarray(rng.standard_normal((44, H)).astype(np.float32))
    dst = jnp.asarray(rng.standard_normal((44, H)).astype(np.float32))
    B = jnp.asarray(rng.standard_normal((44, H * dh)).astype(np.float32))
    out = gat_attention_aggregate(adj, src, dst, B, heads=H)
    for hd in range(H):
        ref = gat_attention_aggregate(
            adj, src[:, hd], dst[:, hd], B[:, hd * dh : (hd + 1) * dh]
        )
        np.testing.assert_allclose(
            np.asarray(out)[:, hd * dh : (hd + 1) * dh], np.asarray(ref),
            rtol=1e-5, atol=1e-5, err_msg=f"head {hd}",
        )
    # Gradient parity: sum-loss grads match the per-head composition.
    w = jnp.asarray(
        rng.standard_normal((44, H * dh)).astype(np.float32)
    )

    def loss_batched(src, dst, B):
        return jnp.sum(gat_attention_aggregate(adj, src, dst, B, heads=H) * w)

    def loss_per_head(src, dst, B):
        tot = 0.0
        for hd in range(H):
            o = gat_attention_aggregate(
                adj, src[:, hd], dst[:, hd], B[:, hd * dh : (hd + 1) * dh]
            )
            tot = tot + jnp.sum(o * w[:, hd * dh : (hd + 1) * dh])
        return tot

    gb = jax.grad(loss_batched, argnums=(0, 1, 2))(src, dst, B)
    gp = jax.grad(loss_per_head, argnums=(0, 1, 2))(src, dst, B)
    for a, b, name in zip(gb, gp, ["src", "dst", "B"]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-4,
            err_msg=f"grad_{name}",
        )


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("method", ["auto", "tiled", "xla"])
@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_fused_attention_rule(backend, method, planned, monkeypatch):
    from gespmm_tpu.ops.spmm import fused_attention

    csr, _ = random_csr(30, 30, density=0.15, seed=31)
    adj = Adjacency.from_csr(csr, plan=planned)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    # "tiled" asks for the fused chain; "auto" takes it off the GPU only
    # (on the GPU the unfused composition measured faster).
    want = planned and (method == "tiled"
                        or (method == "auto" and backend != "gpu"))
    assert fused_attention(method, adj) == want
    assert fused_attention(method, adj.without_plans()) is False


@pytest.mark.parametrize("heads", [1, 2])
def test_gat_auto_on_gpu_runs_unfused_without_plans(heads, monkeypatch):
    import gespmm_tpu.kernels.gat_fused as gf
    from gespmm_tpu.models.gat import gat_layer_apply, gat_layer_init

    csr, _ = random_csr(36, 36, density=0.15, seed=37)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=1 << 20,
                             rows_per_block=8, chunk_nnz=8)
    x = jnp.asarray(np.random.default_rng(37).standard_normal((36, 6)),
                    jnp.float32)
    p = gat_layer_init(jax.random.PRNGKey(0), 6, 4, heads=heads)
    want = gat_layer_apply(p, adj.without_plans(), x, method="xla")

    def no_fused(*a, **k):
        raise AssertionError("auto took the fused chain on the GPU")

    def no_slot_reduce(*a, **k):
        raise AssertionError("the unfused chain used the tiled plan")

    monkeypatch.setattr(gf, "gat_attention_aggregate", no_fused)
    import gespmm_tpu.kernels.spmm_stream as ss

    monkeypatch.setattr(ss, "edge_segment_reduce", no_slot_reduce)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = gat_layer_apply(p, adj, x, method="auto")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)

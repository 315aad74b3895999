"""Distributed SpMM on the 8-device virtual CPU mesh.

Multi-device tests without a cluster (SURVEY §4):
row-partitioned CSR under shard_map must match the single-device op
bit-for-bit in structure and to fp tolerance in values, and gradients must
flow through the collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gespmm_tpu.parallel.mesh import make_mesh
from gespmm_tpu.parallel.dist_spmm import (
    dist_spmm,
    partition_adjacency,
)
from jax.sharding import NamedSharding, PartitionSpec as P
from tests.conftest import powerlaw_csr, random_csr

TOL = dict(rtol=1e-5, atol=1e-5)


def _sharded_B(mesh, n, k, seed=0, model=True):
    B = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    spec = P("data", "model" if model else None)
    return jnp.asarray(B), jax.device_put(
        jnp.asarray(B), NamedSharding(mesh, spec)
    )


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_dist_spmm_matches_scipy(parts):
    mesh = make_mesh(data=parts, model=1, devices=jax.devices()[:parts])
    # n divisible by parts*1 for clean sharding; pad-free case first.
    csr, mat = random_csr(64, 64, density=0.1, seed=parts)
    padj = partition_adjacency(csr, parts)
    B_host, B = _sharded_B(mesh, 64, 16, seed=parts, model=False)
    out = dist_spmm(padj, B, mesh, model_axis=None)
    out = np.asarray(out)[:64]
    np.testing.assert_allclose(out, mat @ np.asarray(B_host), **TOL)


def test_dist_spmm_2d_mesh():
    mesh = make_mesh(data=4, model=2)
    csr, mat = random_csr(64, 64, density=0.12, seed=3)
    padj = partition_adjacency(csr, 4)
    B_host, B = _sharded_B(mesh, 64, 32, seed=3)
    out = np.asarray(dist_spmm(padj, B, mesh))[:64]
    np.testing.assert_allclose(out, mat @ np.asarray(B_host), **TOL)


def test_dist_spmm_uneven_rows_and_powerlaw():
    # m not divisible by parts; skewed degrees.
    mesh = make_mesh(data=4, model=1, devices=jax.devices()[:4])
    csr, mat = powerlaw_csr(100, 64, avg_deg=7, seed=5)
    padj = partition_adjacency(csr, 4)
    B_host, B = _sharded_B(mesh, 64, 8, seed=5, model=False)
    out = np.asarray(dist_spmm(padj, B, mesh, model_axis=None))
    # Output padded to parts*rows_per_part rows.
    np.testing.assert_allclose(out[:100], mat @ np.asarray(B_host), rtol=1e-4, atol=1e-4)
    assert np.all(out[100:] == 0)


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_dist_spmm_other_monoids(reduce):
    from gespmm_tpu.ops.spmm import Adjacency, spmm

    mesh = make_mesh(data=4, model=1, devices=jax.devices()[:4])
    csr, mat = random_csr(48, 40, density=0.15, seed=9)
    padj = partition_adjacency(csr, 4)
    B_host, B = _sharded_B(mesh, 40, 8, seed=9, model=False)
    out = np.asarray(dist_spmm(padj, B, mesh, reduce=reduce, model_axis=None))[:48]
    expect = np.asarray(spmm(Adjacency.from_csr(csr), jnp.asarray(B_host), reduce=reduce))
    np.testing.assert_allclose(out, expect, **TOL)


def test_dist_spmm_grad_flows_through_collectives():
    mesh = make_mesh(data=4, model=2)
    csr, mat = random_csr(64, 64, density=0.12, seed=11)
    padj = partition_adjacency(csr, 4)
    B_host, B = _sharded_B(mesh, 64, 32, seed=11)
    g = np.random.default_rng(1).standard_normal((padj.num_parts * padj.rows_per_part, 32)).astype(np.float32)

    def loss(b):
        return jnp.vdot(dist_spmm(padj, b, mesh), jnp.asarray(g))

    grad = np.asarray(jax.jit(jax.grad(loss))(B))
    expect = mat.T @ g[:64]
    np.testing.assert_allclose(grad, expect, rtol=1e-4, atol=1e-4)


def test_dist_spmm_jit_and_edge_values():
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    csr, mat = random_csr(32, 32, density=0.2, seed=13)  # has data
    padj = partition_adjacency(csr, 2)
    B_host, B = _sharded_B(mesh, 32, 8, seed=13, model=False)
    f = jax.jit(lambda p, b: dist_spmm(p, b, mesh, model_axis=None))
    out = np.asarray(f(padj, B))[:32]
    np.testing.assert_allclose(out, mat @ np.asarray(B_host), **TOL)


@pytest.mark.slow
def test_sharded_gcn_train_step_loss_decreases():
    from gespmm_tpu.ops.graph import add_self_loops
    from gespmm_tpu.parallel.train_step import build_sharded_gcn
    from gespmm_tpu.utils.datasets import sbm_graph

    mesh = make_mesh(data=4, model=2)
    ds = sbm_graph(n_per_class=32 * 4, num_classes=4, feat_dim=32, seed=0)
    csr = add_self_loops(ds.csr)
    step, (params, opt_state), prepare, _ = build_sharded_gcn(
        csr, 32, 16, 4, mesh
    )
    x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state, x, labels, mask)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_halo_spmm_matches_dense_both_tiers():
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    csr, mat = random_csr(96, 96, density=0.08, seed=11)
    nd = 4
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True, chunk_nnz=16,
                              rows_per_block=16)
    B = np.random.default_rng(11).standard_normal((96, 16)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    for method in ("xla", "tiled", "auto"):
        out = jax.jit(lambda b, m=method: halo_spmm(
            hp, b, mesh, method=m, model_axis=None))(Bd)
        np.testing.assert_allclose(
            np.asarray(out)[:96], mat @ B, rtol=1e-4, atol=1e-4,
            err_msg=method,
        )


def test_halo_spmm_binary_uneven_rows():
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    # m=90 over 4 parts: rpp=23, last slab short + binary values.
    csr, mat = random_csr(90, 90, density=0.1, seed=12, binary=True)
    nd = 4
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True, chunk_nnz=16,
                              rows_per_block=16)
    B = np.random.default_rng(12).standard_normal((90, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    out = jax.jit(lambda b: halo_spmm(hp, b, mesh, method="tiled",
                                      model_axis=None))(Bd)
    np.testing.assert_allclose(np.asarray(out)[:90], mat @ B, rtol=1e-4,
                               atol=1e-4)


def test_halo_spmm_with_model_axis():
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    csr, mat = random_csr(64, 64, density=0.1, seed=13)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    hp = build_halo_partition(csr, 2, tiled=True, chunk_nnz=16,
                              rows_per_block=16)
    B = np.random.default_rng(13).standard_normal((64, 16)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", "model")))
    out = jax.jit(lambda b: halo_spmm(hp, b, mesh, method="tiled"))(Bd)
    np.testing.assert_allclose(np.asarray(out)[:64], mat @ B, rtol=1e-4,
                               atol=1e-4)


def test_halo_spmm_grads_both_tiers_vs_dense():
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    csr, mat = random_csr(96, 96, density=0.08, seed=21)
    nd = 4
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True, chunk_nnz=16,
                              rows_per_block=16)
    B = np.random.default_rng(21).standard_normal((96, 16)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    A = jnp.asarray(mat.toarray())
    gd = jax.grad(lambda b: jnp.sum(jnp.sin(A @ b[:96])))(
        pad_for_halo(hp, jnp.asarray(B))
    )
    for method in ("xla", "tiled"):
        g = jax.jit(jax.grad(
            lambda b, m=method: jnp.sum(jnp.sin(halo_spmm(
                hp, b, mesh, method=m, model_axis=None)[:96]))
        ))(Bd)
        np.testing.assert_allclose(np.asarray(g), np.asarray(gd),
                                   rtol=1e-4, atol=1e-4, err_msg=method)


@pytest.mark.parametrize("reduce", ["mean", "max", "min"])
def test_halo_spmm_monoids(reduce):
    from gespmm_tpu.ops.spmm import Adjacency, spmm
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    csr, mat = random_csr(48, 48, density=0.15, seed=9)
    nd = 4
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True,
                              chunk_nnz=16, rows_per_block=16)
    B = np.random.default_rng(9).standard_normal((48, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    expect = np.asarray(spmm(Adjacency.from_csr(csr), jnp.asarray(B),
                             reduce=reduce))
    for method in ("xla", "tiled"):
        out = jax.jit(lambda b, m=method: halo_spmm(
            hp, b, mesh, reduce=reduce, method=m, model_axis=None))(Bd)
        np.testing.assert_allclose(np.asarray(out)[:48], expect,
                                   err_msg=method, **TOL)


@pytest.mark.parametrize("op", ["max", "min"])
def test_halo_tiled_minmax_grads_with_ties(op):
    # Tiled-tier sharded max/min gradients vs the dense oracle, with
    # QUANTIZED B so several edges tie for the extremum — the joint
    # diag+halo even-split semantics (VERDICT r3 #7) is exactly what a
    # per-block split would get wrong here.
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    csr, mat = random_csr(48, 48, density=0.15, seed=13, binary=True)
    nd = 4
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True, chunk_nnz=16,
                              rows_per_block=16)
    rng = np.random.default_rng(13)
    B = np.round(rng.standard_normal((48, 8)) * 2).astype(np.float32) / 2
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))

    dense = jnp.asarray((mat.toarray() != 0))
    ident = -jnp.inf if op == "max" else jnp.inf
    redj = jnp.max if op == "max" else jnp.min

    def loss_dense(b):
        c = jnp.where(dense[:, :, None], b[None], ident)
        o = redj(c, axis=1)
        return jnp.sum(jnp.sin(jnp.where(jnp.isfinite(o), o, 0.0)))

    def loss_sharded(b):
        return jnp.sum(jnp.sin(halo_spmm(
            hp, b, mesh, reduce=op, method="tiled", model_axis=None
        )[:48]))

    g_dense = jax.grad(loss_dense)(jnp.asarray(B))
    g_shard = jax.jit(jax.grad(loss_sharded))(Bd)
    np.testing.assert_allclose(np.asarray(g_shard)[:48],
                               np.asarray(g_dense), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", ["max", "min"])
def test_halo_tiled_minmax_edge_value_grads(op):
    # Runtime edge values through the sharded tiled minmax: forward and
    # d/d(vals) must match the single-device tiled op.
    from gespmm_tpu.ops.spmm import Adjacency, spmm
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo, split_edge_values,
    )

    csr, mat = random_csr(40, 40, density=0.15, seed=17)
    nd = 4
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True, chunk_nnz=16,
                              rows_per_block=16)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=40)
    B = np.random.default_rng(17).standard_normal((40, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    vals = jnp.asarray(np.asarray(csr.data))

    def loss_sharded(v):
        dv, hv = split_edge_values(hp, v)
        return jnp.sum(jnp.sin(halo_spmm(
            hp, Bd, mesh, reduce=op, method="tiled", model_axis=None,
            diag_vals=dv, halo_vals=hv,
        )[:40]))

    def loss_single(v):
        return jnp.sum(jnp.sin(spmm(
            adj.with_data(v), jnp.asarray(B), reduce=op, method="tiled"
        )))

    np.testing.assert_allclose(
        float(jax.jit(loss_sharded)(vals)), float(loss_single(vals)),
        rtol=1e-5, atol=1e-5,
    )
    g_shard = jax.jit(jax.grad(loss_sharded))(vals)
    g_single = jax.grad(loss_single)(vals)
    np.testing.assert_allclose(np.asarray(g_shard), np.asarray(g_single),
                               rtol=1e-4, atol=1e-4)


def test_halo_footprint_small_on_banded_graph():
    # A banded (locality-friendly) graph needs only boundary rows: the
    # per-shard dense footprint must be far below n (the whole point of
    # halo exchange vs all-gather).
    import scipy.sparse as sp
    from gespmm_tpu.sparse.formats import csr_from_scipy
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    n, bw = 256, 3
    mat = sp.diags(
        [np.ones(n - abs(o)) for o in range(-bw, bw + 1)],
        offsets=list(range(-bw, bw + 1)), format="csr",
    ).astype(np.float32)
    mat.sort_indices()
    csr = csr_from_scipy(mat)
    nd = 8
    hp = build_halo_partition(csr, nd, tiled=False)
    # Each shard needs at most bw rows from each neighbor => H <= 8
    # (8-aligned) and footprint ~ 1/P + P*H/n << 1.
    assert hp.H <= 8
    assert hp.footprint_fraction < 0.4, hp.footprint_fraction
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    B = np.random.default_rng(3).standard_normal((n, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    out = jax.jit(lambda b: halo_spmm(hp, b, mesh, model_axis=None))(Bd)
    np.testing.assert_allclose(np.asarray(out)[:n], mat @ B, rtol=1e-5,
                               atol=1e-5)


def test_halo_strictness_and_errors():
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    csr, _ = random_csr(45, 45, density=0.1, seed=31)
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    hp = build_halo_partition(csr, 2, tiled=False)
    assert hp.num_parts * hp.cpp == 46  # padding IS required here
    B = jnp.zeros((hp.num_parts * hp.cpp, 8), jnp.float32)
    with pytest.raises(ValueError, match="tiled"):
        halo_spmm(hp, B, mesh, method="tiled", model_axis=None)
    with pytest.raises(ValueError, match="pad"):
        halo_spmm(hp, jnp.zeros((45, 8), jnp.float32), mesh,
                  model_axis=None)
@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_halo_multipart_shard(reduce):
    # A shard larger than the window budget splits into multiple
    # output windows.
    # part_budget_rows=16 forces rpp=32 > budget → 2 windows per shard;
    # values AND gradients must match the dense oracle.
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    csr, mat = random_csr(64, 64, density=0.12, seed=41)
    nd = 2
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True, chunk_nnz=8,
                              rows_per_block=8, part_budget_rows=16)
    assert all(len(cs) > 1 for cs in hp.tiled_cfgs), (
        "budget override must force multiple windows"
    )
    B = np.random.default_rng(41).standard_normal((64, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    dense = jnp.asarray(mat.toarray())
    mask = jnp.asarray(mat.toarray() != 0)
    ident = -jnp.inf
    out = jax.jit(lambda b: halo_spmm(hp, b, mesh, reduce=reduce,
                                      method="tiled", model_axis=None))(Bd)
    if reduce == "sum":
        expect = mat @ B
    else:
        c = np.where(np.asarray(mask)[:, :, None],
                     np.asarray(dense)[:, :, None] * B[None], np.nan)
        with np.errstate(all="ignore"):
            expect = np.nanmax(c, axis=1)
        expect = np.where(np.isnan(expect), 0.0, expect)
    np.testing.assert_allclose(np.asarray(out)[:64], expect, rtol=1e-4,
                               atol=1e-4)

    def loss_sharded(b):
        return jnp.sum(jnp.sin(halo_spmm(
            hp, b, mesh, reduce=reduce, method="tiled", model_axis=None
        )[:64]))

    def loss_dense(b):
        if reduce == "sum":
            return jnp.sum(jnp.sin(dense @ b))
        c = jnp.where(mask[:, :, None], dense[:, :, None] * b[None], ident)
        o = jnp.max(c, axis=1)
        return jnp.sum(jnp.sin(jnp.where(jnp.isfinite(o), o, 0.0)))

    g_shard = jax.jit(jax.grad(loss_sharded))(Bd)
    g_dense = jax.grad(loss_dense)(jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(g_shard)[:64],
                               np.asarray(g_dense), rtol=1e-4, atol=1e-4)


def test_halo_ragged_rounds_cut_comm_on_skewed_graph():
    # One hub-heavy pair must inflate only its own round, not all P^2
    # pairs: halo_rows (= sum of per-round sizes) must sit well below
    # P * H (the round-2 padded-exchange footprint).
    import scipy.sparse as sp
    from gespmm_tpu.sparse.formats import csr_from_scipy
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    n, nd = 512, 8
    rng = np.random.default_rng(11)
    # banded base: every pair needs ~bw rows
    mat = sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                   offsets=[-1, 0, 1], format="lil")
    # one hub pair: shard 0's rows reference MANY columns of shard 7
    hub_cols = rng.choice(np.arange(448, 512), size=60, replace=False)
    for i, c in enumerate(hub_cols):
        mat[i % 64, c] = 1.0
    csr = csr_from_scipy(mat.tocsr().astype(np.float32))
    hp = build_halo_partition(csr, nd, tiled=False)
    assert hp.halo_rows < nd * hp.H / 2, (hp.halo_rows, nd * hp.H)
    # and the op still matches dense
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    B = rng.standard_normal((n, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    out = jax.jit(lambda b: halo_spmm(hp, b, mesh, model_axis=None))(Bd)
    dense = mat.tocsr().astype(np.float32).toarray()
    np.testing.assert_allclose(np.asarray(out)[:n], dense @ B, rtol=1e-5,
                               atol=1e-5)


def test_halo_tiled_runtime_edge_value_grads_vs_dense():
    # Sharded training of an edge-weighted model on the STREAM tier:
    # gradients w.r.t. B and w.r.t. the per-edge values must match the
    # dense formulation (VERDICT r2 #6 — edge values were baked into the
    # plan and had no gradient).
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo, split_edge_values,
    )

    nd = 4
    csr, mat = random_csr(64, 64, density=0.12, seed=13)
    hp = build_halo_partition(csr, nd, tiled=True)
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    rng = np.random.default_rng(13)
    B = rng.standard_normal((64, 16)).astype(np.float32)
    vals = rng.standard_normal(csr.nnz).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))

    def loss(v, b):
        dv, hv = split_edge_values(hp, v)
        out = halo_spmm(hp, b, mesh, method="tiled", model_axis=None,
                        diag_vals=dv, halo_vals=hv)
        return jnp.sum(jnp.sin(out[:64]))

    gv, gb = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(vals), Bd)

    # dense reference
    indptr = np.asarray(csr.indptr); indices = np.asarray(csr.indices)
    rows = np.repeat(np.arange(64), np.diff(indptr))
    def dense_loss(v, b):
        A = jnp.zeros((64, 64)).at[rows, indices].set(v)
        return jnp.sum(jnp.sin(A @ b))
    gv_ref, gb_ref = jax.grad(dense_loss, argnums=(0, 1))(
        jnp.asarray(vals), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(gv), np.asarray(gv_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gb)[:64], np.asarray(gb_ref),
                               rtol=1e-4, atol=1e-4)
    # values must also change the forward (not just grads)
    dv, hv = split_edge_values(hp, jnp.asarray(vals))
    outv = jax.jit(lambda b: halo_spmm(hp, b, mesh, method="tiled",
                                       model_axis=None, diag_vals=dv,
                                       halo_vals=hv))(Bd)
    A = np.zeros((64, 64), np.float32); A[rows, indices] = vals
    np.testing.assert_allclose(np.asarray(outv)[:64], A @ B, rtol=1e-4,
                               atol=1e-4)


def test_halo_baked_edge_values_still_work_tiled():
    # Values present at partition time flow through the runtime-fetch
    # path (no baking) and still match the weighted dense product.
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo,
    )

    nd = 4
    csr, mat = random_csr(48, 48, density=0.15, seed=17)
    vals = np.random.default_rng(17).standard_normal(csr.nnz).astype(
        np.float32)
    wcsr = csr.with_data(jnp.asarray(vals))
    hp = build_halo_partition(wcsr, nd, tiled=True)
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    B = np.random.default_rng(18).standard_normal((48, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    out = jax.jit(lambda b: halo_spmm(hp, b, mesh, method="tiled",
                                      model_axis=None))(Bd)
    indptr = np.asarray(csr.indptr); indices = np.asarray(csr.indices)
    rows = np.repeat(np.arange(48), np.diff(indptr))
    A = np.zeros((48, 48), np.float32); A[rows, indices] = vals
    np.testing.assert_allclose(np.asarray(out)[:48], A @ B, rtol=1e-4,
                               atol=1e-4)


def test_halo_diag_compute_independent_of_collectives():
    """The overlap *precondition*, asserted on the compiled HLO: the
    diagonal SpMM's compute (its scatter-adds) must not transitively
    depend on any collective-permute.  Runtime overlap itself is a GPU
    latency-hiding-scheduler behavior and unobservable on the virtual
    CPU mesh (synchronous collective-permute); what we CAN pin down is
    the data-dependency structure that makes it possible — and that a
    regression (diag path accidentally consuming the halo table) breaks.
    """
    import re

    from gespmm_tpu.parallel.halo import build_halo_partition, halo_spmm

    mesh = make_mesh(data=4, model=1, devices=jax.devices()[:4])
    csr, _ = powerlaw_csr(96, 96, avg_deg=6, seed=1)
    hp = build_halo_partition(csr, 4, tiled=False)
    B = jnp.asarray(
        np.random.default_rng(0).standard_normal(
            (4 * hp.cpp, 16)
        ).astype(np.float32)
    )
    B = jax.device_put(B, NamedSharding(mesh, P("data", None)))
    f = jax.jit(lambda b: halo_spmm(hp, b, mesh, model_axis=None))
    txt = f.lower(B).compile().as_text()

    # Parse the entry computation's dataflow (fusion operands are listed
    # at entry level, so the graph is complete for our purpose).
    entry = txt[txt.index("ENTRY "):]
    deps, kinds = {}, {}
    for line in entry.splitlines():
        m_op = re.match(r"\s*(?:ROOT )?%([\w.-]+) = \S+ ([\w-]+)\(", line)
        if not m_op:
            continue
        name, kind = m_op.groups()
        body = line[m_op.end():]
        deps[name] = set(re.findall(r"%([\w.-]+)", body))
        kinds[name] = kind

    ppermutes = {n for n, k in kinds.items() if k == "collective-permute"}
    assert ppermutes, "expected collective-permute ops in the halo HLO"

    from functools import lru_cache

    @lru_cache(maxsize=None)
    def touches_collective(name):
        if name in ppermutes:
            return True
        return any(
            touches_collective(d) for d in deps.get(name, ()) if d in kinds
        )

    # Scatter-adds reach the entry computation as wrapped_scatter
    # fusions on XLA:CPU — match by name or kind.
    independent_scatters = [
        n for n, k in kinds.items()
        if ("scatter" in k or "scatter" in n) and not touches_collective(n)
    ]
    assert independent_scatters, (
        "no scatter-add free of collective dependencies — the diagonal "
        "SpMM appears to consume exchanged data"
    )


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_halo_multipart_runtime_edge_value_grads(reduce):
    # Multi-part windows + RUNTIME edge values: the per-window src maps
    # (sliced with the window's edge offset — new in round 4) must route
    # value gradients to the right edges.
    from gespmm_tpu.ops.spmm import Adjacency, spmm
    from gespmm_tpu.parallel.halo import (
        build_halo_partition, halo_spmm, pad_for_halo, split_edge_values,
    )

    csr, mat = random_csr(64, 64, density=0.12, seed=47)
    nd = 2
    mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
    hp = build_halo_partition(csr, nd, tiled=True, chunk_nnz=8,
                              rows_per_block=8, part_budget_rows=16)
    assert all(len(cs) > 1 for cs in hp.tiled_cfgs)
    adj = Adjacency.from_csr(csr, plan=True, col_tile=16, rows_per_block=8,
                             chunk_nnz=8, part_rows=64)
    B = np.random.default_rng(47).standard_normal((64, 8)).astype(np.float32)
    Bd = jax.device_put(pad_for_halo(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    vals = jnp.asarray(np.asarray(csr.data))

    def loss_sharded(v):
        dv, hv = split_edge_values(hp, v)
        return jnp.sum(jnp.sin(halo_spmm(
            hp, Bd, mesh, reduce=reduce, method="tiled", model_axis=None,
            diag_vals=dv, halo_vals=hv,
        )[:64]))

    def loss_single(v):
        return jnp.sum(jnp.sin(spmm(
            adj.with_data(v), jnp.asarray(B), reduce=reduce, method="tiled"
        )))

    np.testing.assert_allclose(
        float(jax.jit(loss_sharded)(vals)), float(loss_single(vals)),
        rtol=1e-5, atol=1e-5,
    )
    g_shard = jax.jit(jax.grad(loss_sharded))(vals)
    g_single = jax.grad(loss_single)(vals)
    np.testing.assert_allclose(np.asarray(g_shard), np.asarray(g_single),
                               rtol=1e-4, atol=1e-4)

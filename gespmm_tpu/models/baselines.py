"""Stock-library model baselines for A/B benchmarking.

Capability parity with the reference's baseline scripts (`gcn_pyg.py` vs
`gcn_custom.py` — same model on the stock framework vs the custom kernels,
SURVEY §4.4): here the "stock framework" is `jax.experimental.sparse`
(BCOO), so `gcn_bench --impl bcoo` trains the identical GCN with the
vendor sparse matmul in place of our SpMM op.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from gespmm_tpu.models.common import dense_apply, dense_init, dropout

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class GCNBcoo:
    """GCN identical to models.gcn.GCN but aggregating via BCOO @ dense."""

    dims: Sequence[int]
    dropout_rate: float = 0.5
    bias: bool = True

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def init(self, key) -> dict:
        keys = jax.random.split(key, self.n_layers)
        return {
            f"layer_{i}": dense_init(
                keys[i], self.dims[i], self.dims[i + 1], bias=self.bias
            )
            for i in range(self.n_layers)
        }

    def apply(self, params, adj, x, *, norms=None, training=False, rng=None):
        """`adj` here is (bcoo, out_norm, in_norm) — see from_adjacency."""
        bcoo, out_norm, in_norm = adj
        h = x
        for i in range(self.n_layers):
            h = h @ params[f"layer_{i}"]["w"]
            h = h * in_norm[:, None].astype(h.dtype)
            h = bcoo @ h
            h = h * out_norm[:, None].astype(h.dtype)
            if "b" in params[f"layer_{i}"]:
                h = h + params[f"layer_{i}"]["b"]
            if i < self.n_layers - 1:
                h = jax.nn.relu(h)
                if training and rng is not None:
                    rng, sub = jax.random.split(rng)
                    h = dropout(sub, h, self.dropout_rate, training)
        return h

    def log_probs(self, params, adj, x, **kw):
        return jax.nn.log_softmax(self.apply(params, adj, x, **kw), axis=-1)

    @staticmethod
    def from_adjacency(adj):
        """Convert our Adjacency into the (bcoo, norms) tuple this model
        consumes."""
        from gespmm_tpu.ops.graph import degree_norm
        from gespmm_tpu.ops.interop import csr_to_bcoo

        out_norm, in_norm = degree_norm(adj)
        return (csr_to_bcoo(adj.csr), out_norm, in_norm)


@dataclasses.dataclass(frozen=True)
class GATStock:
    """GAT identical to models.gat.GAT (single-head) built ONLY from
    stock JAX ops: gathers + `jax.ops.segment_*` for the edge softmax
    and a `jax.experimental.sparse` BCOO matmul for the alpha-weighted
    aggregate — what a user writes without this framework (the
    gcn_pyg.py-style A/B, extended to attention).  Same parameter
    structure as GAT(heads=1), so same-seed runs are directly
    comparable."""

    dims: Sequence[int]
    dropout_rate: float = 0.5
    negative_slope: float = 0.2

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def init(self, key) -> dict:
        from gespmm_tpu.models.gat import gat_layer_init

        keys = jax.random.split(key, self.n_layers)
        return {
            f"layer_{i}": gat_layer_init(
                keys[i], self.dims[i], self.dims[i + 1]
            )
            for i in range(self.n_layers)
        }

    def apply(self, params, adj, x, *, training=False, rng=None):
        """`adj` is (rows, cols, shape) — see from_adjacency."""
        from jax.experimental import sparse as jsparse

        rows, cols, shape = adj
        m = shape[0]
        h = x
        for i in range(self.n_layers):
            p = params[f"layer_{i}"]
            if training and rng is not None:
                rng, sub = jax.random.split(rng)
                h = dropout(sub, h, self.dropout_rate, training)
            h = h @ p["w"]
            logits = (
                jnp.take(h @ p["a_src"], rows)
                + jnp.take(h @ p["a_dst"], cols)
            )
            logits = jax.nn.leaky_relu(logits, self.negative_slope)
            mx = jax.ops.segment_max(logits, rows, num_segments=m)
            mx = jnp.where(jnp.isfinite(mx), mx, 0.0)
            ex = jnp.exp(logits - jnp.take(mx, rows))
            den = jax.ops.segment_sum(ex, rows, num_segments=m)
            alpha = ex / jnp.maximum(jnp.take(den, rows), 1e-20)
            A = jsparse.BCOO(
                (alpha, jnp.stack([rows, cols], axis=1)), shape=shape
            )
            h = A @ h + p["b"]
            if i < self.n_layers - 1:
                h = jax.nn.elu(h)
        return h

    def log_probs(self, params, adj, x, **kw):
        return jax.nn.log_softmax(self.apply(params, adj, x, **kw), axis=-1)

    @staticmethod
    def from_adjacency(adj):
        from gespmm_tpu.sparse.formats import expand_indptr

        csr = adj.csr
        rows = (
            adj.rows if adj.rows is not None
            else expand_indptr(csr.indptr, csr.nnz)
        )
        return rows, csr.indices, csr.shape


@dataclasses.dataclass(frozen=True)
class SAGEStock:
    """GraphSAGE (mean / pool / sum) on stock JAX ops: mean/sum via a
    BCOO matmul with pre-normalized values, pool via
    `jax.ops.segment_max` — the vendor-path A/B for sage_bench.  Same
    parameter structure as models.sage.GraphSAGE for same-seed runs."""

    dims: Sequence[int]
    aggregator: str = "mean"
    dropout_rate: float = 0.5

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def init(self, key) -> dict:
        from gespmm_tpu.models.sage import sage_conv_init

        keys = jax.random.split(key, self.n_layers)
        return {
            f"layer_{i}": sage_conv_init(
                keys[i], self.dims[i], self.dims[i + 1], self.aggregator
            )
            for i in range(self.n_layers)
        }

    def apply(self, params, adj, x, *, training=False, rng=None):
        """`adj` is (bcoo_mean, rows, cols, m) — see from_adjacency."""
        bcoo_mean, rows, cols, m = adj
        h = x
        for i in range(self.n_layers):
            p = params[f"layer_{i}"]
            if training and rng is not None:
                rng, sub = jax.random.split(rng)
                h = dropout(sub, h, self.dropout_rate, training)
            if self.aggregator == "pool":
                pre = jax.nn.relu(dense_apply(p["pool"], h))
                agg = jax.ops.segment_max(
                    jnp.take(pre, cols, axis=0),
                    rows, num_segments=m,
                )
                agg = jnp.where(jnp.isfinite(agg), agg, 0.0)
            else:  # mean / sum ride the stock sparse matmul
                agg = bcoo_mean @ h
            h = dense_apply(p["self"], h) + dense_apply(p["neigh"], agg)
            if i < self.n_layers - 1:
                h = jax.nn.relu(h)
        return h

    def log_probs(self, params, adj, x, **kw):
        return jax.nn.log_softmax(self.apply(params, adj, x, **kw), axis=-1)

    @staticmethod
    def from_adjacency(adj, aggregator="mean"):
        from gespmm_tpu.ops.interop import csr_to_bcoo
        from gespmm_tpu.sparse.formats import expand_indptr

        csr = adj.csr
        m = csr.shape[0]
        rows = (
            adj.rows if adj.rows is not None
            else expand_indptr(csr.indptr, csr.nnz)
        )
        data = (
            jnp.ones((csr.nnz,), jnp.float32)
            if csr.data is None else csr.data
        )
        if aggregator == "mean":
            deg = jnp.maximum(
                (csr.indptr[1:] - csr.indptr[:-1]).astype(jnp.float32), 1.0
            )
            data = data / jnp.take(deg, rows)
        bcoo = csr_to_bcoo(csr.with_data(data))
        return bcoo, rows, csr.indices, m

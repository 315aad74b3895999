"""LSTM neighborhood aggregator for GraphSAGE.

Completes the `--aggregator-type` surface of the reference's SAGE benchmark
(`dgl-custom/benchmark/sage/sage_dgl.py:181-182` exposes mean/gcn/pool/
lstm via stock DGL SAGEConv).  Unlike the SpMM-reducible aggregators, LSTM
aggregation is order-sensitive and per-node recurrent; the formulation
here is:

  * a padded neighbor table (n, D_pad) built once per graph (host-side) —
    static shapes, mask for real neighbors;
  * one `lax.scan` over the neighbor axis running a batched LSTM cell for
    ALL nodes at once (an n-row batch per matmul), with masked
    state updates so shorter neighborhoods freeze at their final state.

Degree capping (`max_neighbors`) bounds D_pad on power-law graphs —
neighbors beyond the cap are dropped (sampling, as GraphSAGE prescribes).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gespmm_tpu.models.common import glorot
from gespmm_tpu.sparse.formats import CSR

Array = jax.Array


def build_neighbor_table(
    csr: CSR, max_neighbors: int = 32, seed: int = 0
) -> Tuple[Array, Array]:
    """(neighbors (n, D) int32, mask (n, D) bool) — host-side, per graph.

    Rows with more than `max_neighbors` edges keep a uniform sample
    (deterministic per seed), matching GraphSAGE's neighbor sampling.
    """
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    m = csr.shape[0]
    D = max_neighbors
    rng = np.random.default_rng(seed)
    nbrs = np.zeros((m, D), np.int32)
    mask = np.zeros((m, D), bool)
    for r in range(m):
        row = indices[indptr[r] : indptr[r + 1]]
        if row.shape[0] > D:
            row = rng.choice(row, size=D, replace=False)
        nbrs[r, : row.shape[0]] = row
        mask[r, : row.shape[0]] = True
    return jnp.asarray(nbrs), jnp.asarray(mask)


def lstm_cell_init(key, in_dim: int, hidden: int) -> dict:
    k1, k2 = jax.random.split(key)
    return {
        "wi": glorot(k1, (in_dim, 4 * hidden)),
        "wh": glorot(k2, (hidden, 4 * hidden)),
        "b": jnp.zeros((4 * hidden,), jnp.float32),
    }


def _lstm_step(p, h, c, x):
    gates = x @ p["wi"] + h @ p["wh"] + p["b"]
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    c2 = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    h2 = jax.nn.sigmoid(o) * jnp.tanh(c2)
    return h2, c2


def lstm_aggregate(
    params: dict,
    x: Array,
    neighbors: Array,
    mask: Array,
) -> Array:
    """h_agg[v] = final LSTM state over v's (sampled) neighbor features."""
    n, D = neighbors.shape
    hidden = params["wh"].shape[0]
    h0 = jnp.zeros((n, hidden), x.dtype)
    c0 = jnp.zeros((n, hidden), x.dtype)

    def step(carry, t):
        h, c = carry
        feats = jnp.take(x, neighbors[:, t], axis=0)
        h2, c2 = _lstm_step(params, h, c, feats)
        m = mask[:, t][:, None].astype(x.dtype)
        return (h2 * m + h * (1 - m), c2 * m + c * (1 - m)), None

    (h, _), _ = jax.lax.scan(step, (h0, c0), jnp.arange(D))
    return h

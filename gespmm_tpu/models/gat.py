"""GAT — graph attention network composed from our SDDMM/SpMM primitives.

Beyond the reference's model zoo (it has GCN + SAGE), but the natural
consumer of its SDDMM op (which the reference exposes but never uses in a
model, SURVEY §3.5): attention logits are an SDDMM over the edge pattern,
normalization is edge-softmax, and aggregation is a value-weighted SpMM —
every hot op routes through the framework's kernels and their VJPs
(including the edge-value gradients the reference cannot take).

Single-head GAT layer (GATv1-style additive attention):
  e_ij  = LeakyReLU(a_src · (W h_i) + a_dst · (W h_j))
  α_ij  = softmax_j over i's in-edges
  h'_i  = Σ_j α_ij (W h_j)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from gespmm_tpu.models.common import dense_init, dropout, glorot
from gespmm_tpu.ops.graph import edge_softmax
from gespmm_tpu.ops.spmm import Adjacency, fused_attention, spmm

Array = jax.Array


def gat_layer_init(key, in_dim: int, out_dim: int, heads: int = 1) -> dict:
    """Per-layer params.  heads > 1 follows DGL's GATConv: one shared
    projection W (in, heads*out), per-head attention vectors (heads,
    out); the merge (concat for hidden layers, mean for the output
    layer) happens in apply."""
    k1, k2, k3 = jax.random.split(key, 3)
    if heads == 1:
        return {
            "w": glorot(k1, (in_dim, out_dim)),
            "a_src": glorot(k2, (out_dim, 1))[:, 0],
            "a_dst": glorot(k3, (out_dim, 1))[:, 0],
            "b": jnp.zeros((out_dim,), jnp.float32),
        }
    return {
        "w": glorot(k1, (in_dim, heads * out_dim)),
        "a_src": glorot(k2, (heads, out_dim)),
        "a_dst": glorot(k3, (heads, out_dim)),
        "b": jnp.zeros((heads * out_dim,), jnp.float32),
    }


def gat_layer_apply(
    p: dict,
    adj: Adjacency,
    x: Array,
    *,
    negative_slope: float = 0.2,
    method: str = "auto",
    merge: str = "concat",
) -> Array:
    if p["a_src"].ndim == 2:  # multi-head layer
        return _gat_layer_multihead(
            p, adj, x, negative_slope=negative_slope, method=method,
            merge=merge,
        )
    h = x @ p["w"]  # (n, out)
    # Additive attention decomposes into per-node terms; the edge logits
    # are src_score[row] + dst_score[col] — expressed directly (two
    # gathers + per-node segment-sum gradients) rather than as the
    # equivalent rank-2 SDDMM, whose generic VJP runs two K=2 SpMMs.
    src_score = h @ p["a_src"]  # (n,)
    dst_score = h @ p["a_dst"]
    if fused_attention(method, adj):
        # Fused slot-space chain (kernels/gat_fused): 2 stream passes
        # forward, 2 backward, zero nnz-order permutes in place of the
        # separate logits/softmax/weighted-SpMM ops.
        from gespmm_tpu.kernels.gat_fused import gat_attention_aggregate

        out = gat_attention_aggregate(
            adj, src_score, dst_score, h, negative_slope=negative_slope
        )
        return out + p["b"]
    from gespmm_tpu.ops.graph import additive_attention_logits

    adj = adj.without_plans()
    logits = additive_attention_logits(adj, src_score, dst_score)
    logits = jax.nn.leaky_relu(logits, negative_slope)
    alpha = edge_softmax(adj, logits)
    out = spmm(adj.with_data(alpha), h, reduce="sum", method=method)
    return out + p["b"]


def _gat_layer_multihead(
    p: dict,
    adj: Adjacency,
    x: Array,
    *,
    negative_slope: float,
    method: str,
    merge: str,
) -> Array:
    """Multi-head layer: per-head fused attention over the head's slice
    of the shared projection; heads merge by concat (hidden layers) or
    mean (output layer), DGL GATConv semantics."""
    heads, dh = p["a_src"].shape
    h = x @ p["w"]  # (n, heads*dh)
    use_fused = fused_attention(method, adj)
    n = h.shape[0]
    # Per-head scores, all heads at once: (n, H).
    src = jnp.einsum("nhd,hd->nh", h.reshape(n, heads, dh), p["a_src"])
    dst = jnp.einsum("nhd,hd->nh", h.reshape(n, heads, dh), p["a_dst"])
    if use_fused:
        # ONE fused call batches every head: K=H max pass + (H*dh+H)
        # aggregate — the per-head loop's narrow passes fused away.
        from gespmm_tpu.kernels.gat_fused import gat_attention_aggregate

        out = gat_attention_aggregate(
            adj, src, dst, h, negative_slope=negative_slope, heads=heads
        )
    else:
        from gespmm_tpu.ops.graph import additive_attention_logits

        adj = adj.without_plans()
        outs = []
        for hd in range(heads):
            hh = h[:, hd * dh : (hd + 1) * dh]
            logits = additive_attention_logits(adj, src[:, hd], dst[:, hd])
            alpha = edge_softmax(
                adj, jax.nn.leaky_relu(logits, negative_slope)
            )
            outs.append(
                spmm(adj.with_data(alpha), hh, reduce="sum", method=method)
            )
        out = jnp.concatenate(outs, axis=1)
    if merge == "mean":
        m_out = out.shape[0]
        return out.reshape(m_out, heads, dh).mean(axis=1) + p["b"][:dh]
    return out + p["b"]


@dataclasses.dataclass(frozen=True)
class GAT:
    """n-layer GAT. `dims = [in, hidden..., out]`.

    ``heads`` > 1 follows the DGL GAT benchmark architecture: hidden
    layers run `heads` attention heads merged by concatenation (so their
    effective width is hidden*heads), the output layer averages its
    heads."""

    dims: Sequence[int]
    dropout_rate: float = 0.5
    negative_slope: float = 0.2
    method: str = "auto"
    heads: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def init(self, key) -> dict:
        keys = jax.random.split(key, self.n_layers)
        params = {}
        for i in range(self.n_layers):
            in_dim = self.dims[i] * (self.heads if i > 0 else 1)
            params[f"layer_{i}"] = gat_layer_init(
                keys[i], in_dim, self.dims[i + 1], heads=self.heads
            )
        return params

    def apply(
        self,
        params: dict,
        adj: Adjacency,
        x: Array,
        *,
        training: bool = False,
        rng: Optional[Array] = None,
    ) -> Array:
        h = x
        for i in range(self.n_layers):
            if training and rng is not None:
                rng, sub = jax.random.split(rng)
                h = dropout(sub, h, self.dropout_rate, training)
            last = i == self.n_layers - 1
            h = gat_layer_apply(
                params[f"layer_{i}"], adj, h,
                negative_slope=self.negative_slope, method=self.method,
                merge="mean" if last else "concat",
            )
            if not last:
                h = jax.nn.elu(h)
        return h

    def log_probs(self, params, adj, x, **kw) -> Array:
        return jax.nn.log_softmax(self.apply(params, adj, x, **kw), axis=-1)

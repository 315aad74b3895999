"""Graph-level aggregation ops layered on the SpMM/SDDMM primitives.

The capability surface of the reference's model layer:
  * GCN symmetric-normalized aggregation — ≙ `GCNConv.forward`
    (`pytorch-custom/op.py:111-148`): scale by 1/√deg_out, SpMM-aggregate,
    scale by 1/√deg_in.
  * GraphSAGE aggregators mean / gcn / pool — ≙ the `--aggregator-type`
    surface of `dgl-custom/benchmark/sage/sage_dgl.py:181-182`.
  * degree utilities and self-loop handling — ≙ `gcn_custom.py:29-49` and
    the DGL benchmark's `--self-loop` flag (`gcn_dgl.py:214-216`).

Everything is jittable and differentiable through the custom-VJP primitives.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gespmm_tpu.ops.spmm import Adjacency, spmm
from gespmm_tpu.ops.sddmm import sddmm
from gespmm_tpu.sparse.formats import CSR, in_degrees, out_degrees

Array = jax.Array


def degree_norm(adj: Adjacency, power: float = -0.5, eps: float = 0.0):
    """(out_norm, in_norm): per-node degree**power with 0-degree clamped to 1.

    ≙ the cached `out_deg_sqrt` / `in_deg_sqrt` vectors of
    `op.py:107-109,122-137`.
    """
    csr = adj.csr if isinstance(adj, Adjacency) else adj
    dout = jnp.maximum(out_degrees(csr).astype(jnp.float32), 1.0) + eps
    din = jnp.maximum(in_degrees(csr).astype(jnp.float32), 1.0) + eps
    return dout**power, din**power


def gcn_aggregate(
    adj: Adjacency,
    x: Array,
    *,
    out_norm: Optional[Array] = None,
    in_norm: Optional[Array] = None,
    method: str = "auto",
) -> Array:
    """Symmetric-normalized GCN aggregation: D_out^-1/2 · A · D_in^-1/2 · x.

    Follows the exact scaling order of `GCNConv.forward` (`op.py:141-145`):
    pre-scale x by the source-side norm, SpMM, post-scale by the
    destination-side norm.  Pass precomputed norms to amortize (the
    reference caches them per graph, `op.py:122-137`).
    """
    if out_norm is None or in_norm is None:
        o, i = degree_norm(adj)
        out_norm = o if out_norm is None else out_norm
        in_norm = i if in_norm is None else in_norm
    x = x * in_norm[:, None].astype(x.dtype)
    agg = spmm(adj, x, reduce="sum", method=method)
    return agg * out_norm[:, None].astype(agg.dtype)


def sage_aggregate(
    adj: Adjacency,
    x: Array,
    *,
    aggregator: str = "mean",
    method: str = "auto",
) -> Array:
    """Neighborhood aggregation for GraphSAGE.

    aggregator:
      "mean": mean of neighbor features (SpMM mean-reduce).
      "gcn":  symmetric-norm aggregation including self (caller adds loops).
      "pool": elementwise max of neighbor features (SpMM max-reduce) — the
              caller applies the pre-pool MLP, per SAGEConv semantics.
      "sum":  plain sum.
    """
    if aggregator == "mean":
        return spmm(adj, x, reduce="mean", method=method)
    if aggregator == "sum":
        return spmm(adj, x, reduce="sum", method=method)
    if aggregator == "pool":
        return spmm(adj, x, reduce="max", method=method)
    if aggregator == "gcn":
        return gcn_aggregate(adj, x, method=method)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def _edge_softmax_xla(rows, logits2d, m):
    mx = jax.ops.segment_max(logits2d, rows, num_segments=m)
    mx = jnp.where(jnp.isfinite(mx), mx, 0.0)
    ex = jnp.exp(logits2d - jnp.take(mx, rows, axis=0))
    denom = jax.ops.segment_sum(ex, rows, num_segments=m)
    return ex / jnp.maximum(jnp.take(denom, rows, axis=0), 1e-20)


@jax.custom_vjp
def _edge_softmax_core(adj: Adjacency, logits2d: Array) -> Array:
    """Row-wise softmax of (nnz, K) edge values.

    When the adjacency carries a tiled plan, the row-max and the
    normalizer each run as one slot-order reduction
    (`kernels/spmm_stream.edge_segment_reduce`); otherwise as XLA segment
    ops keyed by the per-nonzero row ids.
    """
    from gespmm_tpu.sparse.partition import TiledSpmmPlan
    from gespmm_tpu.sparse.formats import expand_indptr

    rows = (
        adj.rows if adj.rows is not None
        else expand_indptr(adj.csr.indptr, adj.csr.nnz)
    )
    m = adj.shape[0]
    if isinstance(adj.plan, TiledSpmmPlan):
        from gespmm_tpu.kernels.spmm_stream import edge_segment_reduce

        mx = edge_segment_reduce(adj.plan, logits2d, "max")
        ex = jnp.exp(logits2d - jnp.take(mx, rows, axis=0))
        denom = edge_segment_reduce(adj.plan, ex, "sum")
        return ex / jnp.maximum(jnp.take(denom, rows, axis=0), 1e-20)
    return _edge_softmax_xla(rows, logits2d, m)


def _edge_softmax_fwd(adj, logits2d):
    alpha = _edge_softmax_core(adj, logits2d)
    return alpha, (adj, alpha)


def _edge_softmax_bwd(res, g):
    # Softmax Jacobian: dl = alpha ⊙ (g - rowsum(alpha ⊙ g)[row]) — the
    # rank-1 correction needs exactly one more per-row reduction, which
    # again runs in slot order when a plan is present.
    from gespmm_tpu.sparse.partition import TiledSpmmPlan

    from gespmm_tpu.sparse.formats import expand_indptr

    adj, alpha = res
    rows = (
        adj.rows if adj.rows is not None
        else expand_indptr(adj.csr.indptr, adj.csr.nnz)
    )
    t = alpha * g
    if isinstance(adj.plan, TiledSpmmPlan):
        from gespmm_tpu.kernels.spmm_stream import edge_segment_reduce

        s = edge_segment_reduce(adj.plan, t, "sum")
    else:
        s = jax.ops.segment_sum(t, rows, num_segments=adj.shape[0])
    dl = t - alpha * jnp.take(s, rows, axis=0)
    return (None, dl)


_edge_softmax_core.defvjp(_edge_softmax_fwd, _edge_softmax_bwd)


def edge_softmax(adj: Adjacency, logits: Array) -> Array:
    """Per-destination-row softmax over edge logits (attention precursor).

    Not in the reference's op set, but the canonical consumer of SDDMM
    (an edge-softmax/attention precursor); provided so attention-style
    models compose from our
    primitives.  logits: (nnz,) or (nnz, heads) in CSR order; softmax
    within each destination row, per head.  Differentiable (custom VJP:
    one stream-reduce per direction instead of chained segment ops).
    """
    if not isinstance(adj, Adjacency):
        adj = Adjacency.from_csr(adj)
    squeeze = logits.ndim == 1
    logits2d = logits[:, None] if squeeze else logits
    out = _edge_softmax_core(adj, logits2d)
    return out[:, 0] if squeeze else out


def gat_attention(
    adj: Adjacency, q: Array, k: Array, *, method: str = "auto"
) -> Array:
    """Edge attention scores softmax(SDDMM(q, k)) — composes the two
    primitives the way graph-attention layers do."""
    scores = sddmm(adj, q, k, method=method)
    return edge_softmax(adj, scores)


def attention_aggregate(
    adj: Adjacency,
    q: Array,
    k: Array,
    v: Array,
    *,
    negative_slope: Optional[float] = None,
    method: str = "auto",
) -> Array:
    """out[r] = Σ_c softmax_c(act(q[r]·k[c])) · v[c] over the edge
    pattern — the full dot-product attention layer (SDDMM scores +
    edge softmax + weighted aggregate) in one call.

    Where `ops/spmm.fused_attention` chooses it, this runs the fused
    slot-space chain (`kernels/gat_fused.dot_attention_aggregate`): 2
    stream passes per direction, softmax denominator folded into the
    aggregate, no edge-order permutes.  Otherwise it composes the three
    ops on the XLA formulations.  ``act`` is identity unless
    ``negative_slope`` is given (leaky-relu, GAT-style).
    """
    from gespmm_tpu.ops.spmm import fused_attention

    if fused_attention(method, adj):
        from gespmm_tpu.kernels.gat_fused import dot_attention_aggregate

        return dot_attention_aggregate(
            adj, q, k, v, negative_slope=negative_slope
        )
    adj = adj.without_plans()
    scores = sddmm(adj, q, k, method=method)
    if negative_slope is not None:
        scores = jax.nn.leaky_relu(scores, negative_slope)
    alpha = edge_softmax(adj, scores)
    from gespmm_tpu.ops.spmm import spmm as _spmm

    return _spmm(adj.with_data(alpha), v, reduce="sum", method=method)


@jax.custom_vjp
def _additive_logits_core(adj: Adjacency, src_score: Array,
                          dst_score: Array) -> Array:
    rows = (
        adj.rows if adj.rows is not None
        else adj.csr.row_ids()
    )
    return (
        jnp.take(src_score, rows, axis=0)
        + jnp.take(dst_score, adj.csr.indices, axis=0)
    )


def _additive_logits_fwd(adj, src_score, dst_score):
    return _additive_logits_core(adj, src_score, dst_score), adj


def _additive_logits_bwd(adj, g):
    # grad_src[r] = Σ_{e: row=r} g_e ; grad_dst[c] = Σ_{e: col=c} g_e —
    # per-node segment sums, in slot order on plan / plan_t when present.
    from gespmm_tpu.sparse.partition import TiledSpmmPlan

    g2 = g[:, None] if g.ndim == 1 else g
    if isinstance(adj.plan, TiledSpmmPlan) and isinstance(
        adj.plan_t, TiledSpmmPlan
    ):
        from gespmm_tpu.kernels.spmm_stream import edge_segment_reduce

        gs = edge_segment_reduce(adj.plan, g2, "sum")
        # plan_t's slot order indexes CSC edges: permute the cotangent.
        gd = edge_segment_reduce(adj.plan_t, g2[adj.perm], "sum")
    else:
        rows = adj.rows if adj.rows is not None else adj.csr.row_ids()
        gs = jax.ops.segment_sum(g2, rows, num_segments=adj.shape[0])
        gd = jax.ops.segment_sum(g2, adj.csr.indices,
                                 num_segments=adj.shape[1])
    if g.ndim == 1:
        gs, gd = gs[:, 0], gd[:, 0]
    return (None, gs, gd)


_additive_logits_core.defvjp(_additive_logits_fwd, _additive_logits_bwd)


def additive_attention_logits(
    adj: Adjacency, src_score: Array, dst_score: Array
) -> Array:
    """Per-edge additive-attention logits: e = src[row_e] + dst[col_e].

    The GATv1 decomposition — a rank-2 SDDMM in disguise, but expressed
    directly it is two gathers forward and two per-node segment sums
    backward (slot-order reductions when plans exist), instead of a
    generic SDDMM whose VJP runs two K=2 SpMMs.
    ``src_score``/``dst_score``: (m,) / (n,) or (m, H) / (n, H).
    """
    if isinstance(adj, CSR):
        from gespmm_tpu.ops.spmm import Adjacency as _A

        adj = _A.from_csr(adj)
    return _additive_logits_core(adj, src_score, dst_score)


def add_self_loops(csr: CSR, weight: float = 1.0) -> CSR:
    """Host-side: A + weight·I (dedup: existing diagonal entries replaced).

    ≙ the DGL benchmark's `--self-loop` graph preprocessing
    (`gcn_dgl.py:214-216`, `sage_dgl.py` equivalents).  Not jittable (nnz
    changes); call during graph construction.
    """
    import numpy as np

    m, n = csr.shape
    if m != n:
        raise ValueError("self-loops need a square matrix")
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    data = (
        np.ones(indices.shape[0], np.float32)
        if csr.data is None
        else np.asarray(csr.data)
    )
    rows = np.repeat(np.arange(m), np.diff(indptr))
    keep = rows != indices
    rows = np.concatenate([rows[keep], np.arange(m)])
    cols = np.concatenate([indices[keep], np.arange(m)])
    vals = np.concatenate([data[keep], np.full(m, weight, data.dtype)])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=m)
    new_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    out = CSR(
        indptr=jnp.asarray(new_indptr),
        indices=jnp.asarray(cols.astype(np.int32)),
        data=jnp.asarray(vals),
        shape=(m, n),
    )
    return out if csr.data is not None else out.with_data(out.data)

"""XLA-native reference implementations of SpMM and SDDMM.

These are the "fallback dispatch" tier — the role cuSPARSE plays in the
reference (`dgl-custom/binary_reduce_sum.cu:83-143`): always-correct,
compiler-scheduled implementations that (a) serve as the correctness oracle
for the Pallas kernel, (b) handle dtypes/backends the hand kernel doesn't,
and (c) run on CPU for the virtual-mesh distributed tests.

Formulation: gather rows of the dense operand with `take`, scale by edge
values, reduce with `jax.ops.segment_*` keyed by the expanded row ids.
XLA fuses gather+scale+segment-reduce into a tight scatter pipeline; all
shapes are static (nnz is baked per graph, exactly as the reference
specializes kernels per matrix).

All functions here operate on raw arrays (not containers) so they can be
called from inside `shard_map` bodies and kernel fallbacks alike.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

Array = jax.Array

# Reduction monoids supported — mirrors the reference's sum
# (`binary_reduce_sum.cu`) and max (`binary_reduce_max.cu`) kernel families,
# plus mean/min which DGL exposes at the same layer.
REDUCTIONS = ("sum", "max", "min", "mean")

def _gather_scale(
    indices: Array, data: Optional[Array], B: Array
) -> Array:
    """B[indices] * data — the per-nonzero contribution matrix [nnz, K]."""
    gathered = jnp.take(B, indices, axis=0, indices_are_sorted=False)
    if data is not None:
        gathered = gathered * data[:, None].astype(gathered.dtype)
    return gathered


def spmm_rows_xla(
    rows: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
    m: int,
    reduce: str = "sum",
    rows_sorted: bool = True,
) -> Array:
    """SpMM given per-nonzero row ids (COO-like). C[r] = reduce_e val_e*B[col_e].

    Empty rows produce 0 for every monoid (we mask the -inf/+inf identities
    of max/min back to 0, the same observable behavior as the reference's
    zero-initialized output buffers for sum and its max_init=-10000 clamp at
    `binary_reduce_max.cu:22-24` — but cleaner: exact zeros).
    """
    if reduce not in REDUCTIONS:
        raise ValueError(f"reduce must be one of {REDUCTIONS}, got {reduce!r}")
    contrib = _gather_scale(indices, data, B)
    acc_dtype = jnp.promote_types(contrib.dtype, jnp.float32)
    contrib32 = contrib.astype(acc_dtype)
    if reduce in ("sum", "mean"):
        out = jax.ops.segment_sum(
            contrib32, rows, num_segments=m, indices_are_sorted=rows_sorted
        )
        if reduce == "mean":
            deg = jax.ops.segment_sum(
                jnp.ones((rows.shape[0],), acc_dtype),
                rows,
                num_segments=m,
                indices_are_sorted=rows_sorted,
            )
            out = out / jnp.maximum(deg, 1.0)[:, None]
    elif reduce == "max":
        out = jax.ops.segment_max(
            contrib32, rows, num_segments=m, indices_are_sorted=rows_sorted
        )
        out = jnp.where(jnp.isfinite(out), out, 0.0)
    else:  # min
        out = jax.ops.segment_min(
            contrib32, rows, num_segments=m, indices_are_sorted=rows_sorted
        )
        out = jnp.where(jnp.isfinite(out), out, 0.0)
    return out.astype(B.dtype)


def spmm_xla(
    indptr: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
    reduce: str = "sum",
) -> Array:
    """CSR SpMM: C = A @ B (or reduce-variant), C shape (m, K)."""
    from gespmm_tpu.sparse.formats import expand_indptr

    m = indptr.shape[0] - 1
    rows = expand_indptr(indptr, indices.shape[0])
    return spmm_rows_xla(rows, indices, data, B, m, reduce=reduce)


def sddmm_xla(
    rows: Array,
    cols: Array,
    D1: Array,
    D2: Array,
) -> Array:
    """SDDMM: out[e] = D1[rows[e]] · D2[cols[e]] (dot over feature dim).

    The XLA formulation of `sddmmCOO*Scale` (`pytorch-custom/sddmm.cu`):
    two row gathers and a lane reduction, accumulated in fp32.
    """
    a = jnp.take(D1, rows, axis=0)
    b = jnp.take(D2, cols, axis=0)
    acc = jnp.promote_types(a.dtype, jnp.float32)
    return jnp.sum(a.astype(acc) * b.astype(acc), axis=-1).astype(D1.dtype)


def spmm_max_arg_xla(
    indptr: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
) -> Array:
    """Forward max-SpMM returning the reduced output (see spmm_xla).

    Kept separate so callers that need residuals for the max-VJP can reuse
    the contribution construction.
    """
    return spmm_xla(indptr, indices, data, B, reduce="max")


# ---------------------------------------------------------------------------
# Backward helpers (shared by the custom-VJP layer in ops/spmm.py)
# ---------------------------------------------------------------------------


def spmm_max_vjp_edges(
    rows: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
    out: Array,
    g: Array,
    m: int,
):
    """Cotangents for max-reduce SpMM with even tie-splitting.

    For each output element C[r, k] = max_e val_e * B[col_e, k], the gradient
    flows to every achieving edge, split evenly among ties — matching
    `jnp.max`'s VJP so dense-autodiff grad checks pass exactly.

    Returns (grad_edge_contrib [nnz, K]) — per-(edge, lane) cotangent of the
    *contribution* val_e*B[col_e]; callers turn it into grad_B (scatter by
    col) and grad_data (dot with B rows).
    """
    contrib = _gather_scale(indices, data, B)  # [nnz, K]
    acc = jnp.promote_types(contrib.dtype, jnp.float32)
    contrib = contrib.astype(acc)
    out_rows = jnp.take(out, rows, axis=0).astype(acc)  # [nnz, K]
    is_max = (contrib == out_rows).astype(acc)
    # Count ties per (row, k) to split gradient evenly.
    ties = jax.ops.segment_sum(is_max, rows, num_segments=m)
    ties_rows = jnp.take(ties, rows, axis=0)
    weight = is_max / jnp.maximum(ties_rows, 1.0)
    g_rows = jnp.take(g, rows, axis=0).astype(acc)
    return g_rows * weight


def spmm_best_xla(
    indptr: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
    reduce: str = "sum",
    rows: Optional[Array] = None,
) -> Array:
    """The plain XLA SpMM: gather the rows of B, then a sorted segment
    reduction over the (precomputed, when given) per-nonzero row ids."""
    m = indptr.shape[0] - 1
    if rows is not None:
        return spmm_rows_xla(rows, indices, data, B, m, reduce=reduce)
    return spmm_xla(indptr, indices, data, B, reduce=reduce)


def spmm_scatter_xla(
    rows: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
    m: int,
) -> Array:
    """Scatter/push-formulation SpMM: out[row_e] += val_e * B[col_e].

    The XLA expression of the Gunrock baseline's per-edge atomicAdd
    (`gunrock-test/app/spmm/spmm_enactor.cuh:92-105`) — kept as a benchmark
    tier for the gather-vs-scatter comparison the GE-SpMM paper makes
    (scatter lowers to XLA scatter-add instead of segment-sum's sorted
    reduction).
    """
    contrib = _gather_scale(indices, data, B)
    acc = jnp.promote_types(contrib.dtype, jnp.float32)
    out = jnp.zeros((m, B.shape[1]), acc)
    return out.at[rows].add(contrib.astype(acc)).astype(B.dtype)


# ---------------------------------------------------------------------------
# Dense crossover baseline (the merge-spmm "third baseline" role)
# ---------------------------------------------------------------------------

# Densifying A costs m*n*4 bytes; cap it so a careless call cannot exhaust
# device memory (4 GB leaves room for B, C, and the caller).
DENSE_BYTES_LIMIT = 4 << 30


def spmm_dense_xla(
    rows: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
    m: int,
    reduce: str = "sum",
) -> Array:
    """Densify-and-matmul SpMM: A_dense @ B as one dense matrix product.

    The third-baseline role of the reference's merge-spmm build
    (`compile.sh:5-13`, `run_test.sh:12-16`): a fundamentally different
    formulation that quantifies where the sparse kernels stop paying.
    Scatter-builds the dense A (one nnz-sized scatter, paid once per
    call), then one matmul.

    Guards: m*n*4 bytes must be under DENSE_BYTES_LIMIT (raise, don't
    OOM) — the bench records the cell as guarded, the same observable as
    merge-spmm's max_ncols ladder skipping a width.
    """
    if reduce != "sum":
        raise ValueError("spmm_dense_xla supports reduce='sum' only")
    n = B.shape[0]
    dense_bytes = m * n * 4
    if dense_bytes > DENSE_BYTES_LIMIT:
        raise ValueError(
            f"dense A would be {dense_bytes/2**30:.1f} GiB "
            f"(> {DENSE_BYTES_LIMIT / 2**30:.0f} GiB guard): the dense "
            "tier is a small-graph crossover baseline, not a large-graph "
            "path; use method='auto'"
        )
    vals = (
        jnp.ones(indices.shape, jnp.float32)
        if data is None else data.astype(jnp.float32)
    )
    A = jnp.zeros((m, n), jnp.float32).at[rows, indices].add(vals)
    # HIGHEST keeps the product in float32 (no TF32 on the GPU), so the
    # crossover is compared with the sparse paths at their precision.
    out = jnp.dot(A, B.astype(jnp.float32),
                  preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return out.astype(B.dtype)

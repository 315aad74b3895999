"""Sparse matrix containers as JAX pytrees.

Design notes
------------
The reference framework (hgyhungry/ge-spmm) stores CSR as three raw device
pointers handed to CUDA kernels (`spmm_test.cu:557-581`,
`pytorch-custom/spmm.cpp:24-43`).  Here the containers are registered JAX
pytrees so they flow through `jit` / `grad` / `shard_map` unchanged:

  * ``indptr``/``indices`` are ``int32`` (the reference likewise asserts
    int32 at `spmm.cpp:33-38`).
  * ``data`` may be ``None`` — the "topology only / implicit 1.0" variant the
    reference implements as dedicated ``no_edge_value`` kernels
    (`pytorch-custom/spmm_kernel.cu:31-173`).  Keeping it ``None`` (static
    pytree-wise) lets XLA skip the multiply entirely.
  * ``shape`` is static aux data, so each distinct sparsity *shape* gets its
    own compiled executable — the same per-matrix specialization the CUDA
    reference gets from runtime kernel dispatch.

All transforms here are pure `jnp` and therefore jittable; `sparse/io.py`
holds the host-side (NumPy / native C++) ingest path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def _as_i32(x) -> Array:
    x = jnp.asarray(x)
    if x.dtype != jnp.int32:
        x = x.astype(jnp.int32)
    return x


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix (row, col[, data]) with static shape.

    Entries are expected sorted row-major (row, then col) and deduplicated,
    matching the post-ingest invariant of the reference reader
    (`util/util.hpp:75-102` customSort + `:218-284` makeSymmetric).
    """

    row: Array
    col: Array
    data: Optional[Array]
    shape: Tuple[int, int]

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        if self.data is None:
            return (self.row, self.col), (self.shape, False)
        return (self.row, self.col, self.data), (self.shape, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, has_data = aux
        if has_data:
            row, col, data = children
        else:
            (row, col), data = children, None
        return cls(row=row, col=col, data=data, shape=shape)

    # -- properties ----------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def dtype(self):
        return jnp.float32 if self.data is None else self.data.dtype

    def with_data(self, data: Optional[Array]) -> "COO":
        return COO(row=self.row, col=self.col, data=data, shape=self.shape)

    def todense(self) -> Array:
        m, n = self.shape
        vals = (
            jnp.ones(self.nnz, jnp.float32) if self.data is None else self.data
        )
        out = jnp.zeros((m, n), vals.dtype)
        return out.at[self.row, self.col].add(vals)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix.

    ``indptr``: (m+1,) int32 — row segment offsets into ``indices``/``data``.
    ``indices``: (nnz,) int32 — column ids, sorted within each row.
    ``data``: (nnz,) values or ``None`` for implicit 1.0 (adjacency).
    """

    indptr: Array
    indices: Array
    data: Optional[Array]
    shape: Tuple[int, int]

    def tree_flatten(self):
        if self.data is None:
            return (self.indptr, self.indices), (self.shape, False)
        return (self.indptr, self.indices, self.data), (self.shape, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, has_data = aux
        if has_data:
            indptr, indices, data = children
        else:
            (indptr, indices), data = children, None
        return cls(indptr=indptr, indices=indices, data=data, shape=shape)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return jnp.float32 if self.data is None else self.data.dtype

    def with_data(self, data: Optional[Array]) -> "CSR":
        return CSR(
            indptr=self.indptr, indices=self.indices, data=data, shape=self.shape
        )

    def row_ids(self) -> Array:
        """Expand indptr to a per-nonzero row-id vector (the COO row array).

        Jittable; used by the segment-reduce reference path and by SDDMM's
        CSR entry point — the stand-in for the reference's
        per-warp binary search ``findRow`` (`computeUtil.h:11-28`).
        """
        return expand_indptr(self.indptr, self.nnz)

    def row_lengths(self) -> Array:
        return self.indptr[1:] - self.indptr[:-1]

    def to_coo(self) -> COO:
        return COO(
            row=self.row_ids(), col=self.indices, data=self.data, shape=self.shape
        )

    def todense(self) -> Array:
        return self.to_coo().todense()


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column matrix — structurally CSR of the transpose.

    Carried alongside a CSR so the backward of SpMM can run on Aᵀ without a
    runtime transpose, mirroring the reference's precomputed CSC pairing
    (`pytorch-custom/op.py:8-36`, `spmm_kernel.cu:381-423` csr2csc).
    """

    indptr: Array  # (n+1,) column offsets
    indices: Array  # (nnz,) row ids
    data: Optional[Array]
    shape: Tuple[int, int]  # shape of the ORIGINAL matrix (m, n)

    def tree_flatten(self):
        if self.data is None:
            return (self.indptr, self.indices), (self.shape, False)
        return (self.indptr, self.indices, self.data), (self.shape, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, has_data = aux
        if has_data:
            indptr, indices, data = children
        else:
            (indptr, indices), data = children, None
        return cls(indptr=indptr, indices=indices, data=data, shape=shape)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def with_data(self, data: Optional[Array]) -> "CSC":
        return CSC(
            indptr=self.indptr, indices=self.indices, data=data, shape=self.shape
        )

    def as_csr_of_transpose(self) -> CSR:
        """View this CSC as the CSR of Aᵀ (shape swapped)."""
        m, n = self.shape
        return CSR(
            indptr=self.indptr, indices=self.indices, data=self.data, shape=(n, m)
        )


# ---------------------------------------------------------------------------
# Transforms (all jittable)
# ---------------------------------------------------------------------------


def expand_indptr(indptr: Array, nnz: int) -> Array:
    """indptr (m+1,) -> per-nonzero row ids (nnz,). Jittable, O(nnz log m)-free.

    Implemented as a scatter-add of 1 at each row start followed by an
    inclusive cumsum — the classic dense-friendly expansion (no dynamic
    shapes, no binary search).
    """
    m = indptr.shape[0] - 1
    if nnz == 0:
        return jnp.zeros((0,), jnp.int32)
    starts = jnp.zeros((nnz,), jnp.int32)
    # Mark row boundaries: for each row r>0, add 1 at position indptr[r].
    # Empty rows produce multiple marks at the same position; `add` handles it.
    bounds = jnp.clip(indptr[1:m], 0, nnz - 1)
    # Guard: marks at position >= nnz mean trailing empty rows — drop them by
    # scattering 0 instead.
    valid = (indptr[1:m] < nnz).astype(jnp.int32)
    starts = starts.at[bounds].add(valid)
    return jnp.cumsum(starts).astype(jnp.int32)


def indptr_from_rows(row: Array, m: int) -> Array:
    """Sorted per-nonzero row ids -> CSR indptr (m+1,). Jittable."""
    counts = jnp.zeros((m,), jnp.int32).at[row].add(1)
    return jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts).astype(jnp.int32)]
    )


def csr_from_coo(coo: COO) -> CSR:
    """COO (sorted row-major, deduped) -> CSR. Jittable.

    Equivalent of the reference's host conversion loop
    (`spmm_test.cu:557-581`), expressed as a cumsum over row counts.
    """
    m, _ = coo.shape
    return CSR(
        indptr=indptr_from_rows(_as_i32(coo.row), m),
        indices=_as_i32(coo.col),
        data=coo.data,
        shape=coo.shape,
    )


def csr_to_csc(csr: CSR, return_permutation: bool = False):
    """CSR -> CSC via stable sort on column ids. Jittable.

    Replacement for the reference's cuSPARSE-backed transform
    (`csr2cscKernel`, `spmm_kernel.cu:381-423`).  The returned permutation
    maps CSC edge order -> CSR edge order (``csc.data = csr.data[perm]``),
    which callers use to re-order edge gradients back to CSR order.
    """
    m, n = csr.shape
    rows = csr.row_ids()
    # Stable sort by column; stability preserves row order within a column,
    # giving sorted row indices per column (canonical CSC).
    perm = jnp.argsort(csr.indices, stable=True).astype(jnp.int32)
    csc_rows = rows[perm]
    csc_cols_sorted = csr.indices[perm]
    data = None if csr.data is None else csr.data[perm]
    csc = CSC(
        indptr=indptr_from_rows(csc_cols_sorted, n),
        indices=csc_rows,
        data=data,
        shape=(m, n),
    )
    if return_permutation:
        return csc, perm
    return csc


def transpose(csr: CSR) -> CSR:
    """CSR of Aᵀ (materialized)."""
    return csr_to_csc(csr).as_csr_of_transpose()


def coo_from_dense(dense: Array) -> COO:
    """Dense -> COO (host-side helper for tests; not jittable)."""
    d = np.asarray(dense)
    row, col = np.nonzero(d)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    return COO(
        row=jnp.asarray(row, jnp.int32),
        col=jnp.asarray(col, jnp.int32),
        data=jnp.asarray(d[row, col]),
        shape=d.shape,
    )


def csr_from_scipy(sp) -> CSR:
    """scipy.sparse matrix -> CSR container (host-side helper)."""
    sp = sp.tocsr()
    sp.sort_indices()
    return CSR(
        indptr=jnp.asarray(sp.indptr, jnp.int32),
        indices=jnp.asarray(sp.indices, jnp.int32),
        data=jnp.asarray(sp.data),
        shape=tuple(sp.shape),
    )


def out_degrees(csr: CSR) -> Array:
    """Number of nonzeros per row (out-degree for a row->col adjacency)."""
    return csr.row_lengths()


def in_degrees(csr: CSR) -> Array:
    """Number of nonzeros per column (in-degree)."""
    _, n = csr.shape
    counts = jnp.zeros((n,), jnp.int32).at[csr.indices].add(1)
    return counts

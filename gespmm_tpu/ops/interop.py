"""Interop with `jax.experimental.sparse` (BCOO/BCSR).

The reference's third integration surface is drop-in kernel replacement
inside DGL (`dgl-custom/binary_reduce_sum.cu:362-523`); the JAX-ecosystem
counterpart is the stock sparse library: these adapters let any code
holding a BCOO/BCSR matrix route through our kernels (and our ops return
matrices stock code can consume), and the benchmark harness uses
`bcoo_dot_general` as the "stock framework" baseline tier (the role stock
DGL/PyG play in `gcn_pyg.py` vs `gcn_custom.py`).

`cusparse_spmm` is the library baseline of the reference's benchmark
(cuSPARSE's CSR SpMM, `spmm_test.cu:714-762`), reached through BCSR.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from gespmm_tpu.sparse.formats import COO, CSR, csr_from_coo

Array = jax.Array


def csr_from_bcoo(mat) -> CSR:
    """jax.experimental.sparse.BCOO -> our CSR (host-side canonicalize).

    Requires an unbatched 2-D BCOO; duplicates summed, entries sorted.
    """
    from jax.experimental import sparse as jsparse

    if not isinstance(mat, jsparse.BCOO):
        raise TypeError(f"expected BCOO, got {type(mat)}")
    if mat.ndim != 2 or mat.n_batch or mat.n_dense:
        raise ValueError("only plain 2-D BCOO supported")
    mat = mat.sum_duplicates()
    rows = np.asarray(mat.indices[:, 0])
    cols = np.asarray(mat.indices[:, 1])
    vals = np.asarray(mat.data)
    order = np.lexsort((cols, rows))
    coo = COO(
        row=jnp.asarray(rows[order].astype(np.int32)),
        col=jnp.asarray(cols[order].astype(np.int32)),
        data=jnp.asarray(vals[order]),
        shape=tuple(mat.shape),
    )
    return csr_from_coo(coo)


def csr_to_bcoo(csr: CSR):
    """Our CSR -> jax.experimental.sparse.BCOO."""
    from jax.experimental import sparse as jsparse

    coo = csr.to_coo()
    data = (
        jnp.ones((csr.nnz,), jnp.float32) if csr.data is None else csr.data
    )
    indices = jnp.stack([coo.row, coo.col], axis=1)
    return jsparse.BCOO((data, indices), shape=csr.shape)


def bcoo_spmm_baseline(csr: CSR, B: Array) -> Array:
    """Stock-library SpMM tier: BCOO @ dense via bcoo_dot_general."""
    return csr_to_bcoo(csr) @ B


def csr_to_bcsr(csr: CSR):
    """Our CSR -> jax.experimental.sparse.BCSR (float32 values, int32
    indices: the types cuSPARSE's CSR SpMM takes)."""
    from jax.experimental import sparse as jsparse

    data = (
        jnp.ones((csr.nnz,), jnp.float32) if csr.data is None
        else csr.data.astype(jnp.float32)
    )
    return jsparse.BCSR(
        (data, csr.indices.astype(jnp.int32), csr.indptr.astype(jnp.int32)),
        shape=csr.shape,
    )


@contextlib.contextmanager
def cusparse_lowering():
    """Lower BCSR/BCOO matmuls to cuSPARSE while the block is open.

    Without ``jax_bcoo_cusparse_lowering`` JAX lowers them to XLA gathers
    on the GPU too.  JAX reads the flag when it lowers and does not key its
    jit cache on it, so compile inside the block.
    """
    prev = jax.config.jax_bcoo_cusparse_lowering
    jax.config.update("jax_bcoo_cusparse_lowering", True)
    try:
        yield
    finally:
        jax.config.update("jax_bcoo_cusparse_lowering", prev)


def cusparse_spmm(bcsr, B: Array):
    """``bcsr @ B`` through cuSPARSE's CSR SpMM, compiled for B's shape.

    Returns the compiled function, called as ``f(bcsr, B)``.  Raises when
    the compiled program holds no cuSPARSE call (no GPU, or a lowering
    that fell back to XLA), so a timing labelled cuSPARSE is cuSPARSE.
    """
    with cusparse_lowering():
        compiled = jax.jit(lambda M, b: M @ b).lower(bcsr, B).compile()
    if 'custom_call_target="cusparse' not in compiled.as_text():
        raise RuntimeError(
            "BCSR @ dense did not lower to cuSPARSE on the "
            f"{jax.default_backend()!r} backend"
        )
    return compiled


@jax.tree_util.register_pytree_node_class
class AdjacencyMatrix:
    """A sparse matrix that QUACKS like `jax.experimental.sparse.BCOO`
    (`@`, `.T`, `.shape`, `.dtype`, `.todense()`) but routes every matmul
    through this framework's kernels and custom VJPs.

    The drop-in integration surface: where the reference template-
    specializes DGL's CallBinaryReduce so stock `update_all` calls hit its
    kernels (`dgl-custom/binary_reduce_sum.cu:445-461`), stock JAX code
    holding an `A @ x` call site only needs its matrix object swapped —
    no call-site changes:

        A = AdjacencyMatrix.from_bcoo(bcoo_mat)   # or .from_csr(csr)
        out = A @ x                                # spmm(method="auto") + VJP
        grad = jax.grad(lambda x: f(A @ x))(x)     # transpose-paired bwd

    Registered as a pytree, so it passes through jit/grad/vmap like any
    array-like; `.T` is O(1) (the Adjacency carries both orderings).
    """

    def __init__(self, adj, transposed: bool = False):
        from gespmm_tpu.ops.spmm import Adjacency

        if not isinstance(adj, Adjacency):
            raise TypeError(f"expected Adjacency, got {type(adj)}")
        self.adj = adj
        self.transposed = bool(transposed)

    def tree_flatten(self):
        return (self.adj,), (self.transposed,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_csr(cls, csr: CSR, plan=True, **plan_kwargs) -> "AdjacencyMatrix":
        from gespmm_tpu.ops.spmm import Adjacency

        return cls(Adjacency.from_csr(csr, plan=plan, **plan_kwargs))

    @classmethod
    def from_bcoo(cls, mat, plan=True, **plan_kwargs) -> "AdjacencyMatrix":
        return cls.from_csr(csr_from_bcoo(mat), plan=plan, **plan_kwargs)

    @classmethod
    def from_scipy(cls, mat, plan=True, **plan_kwargs) -> "AdjacencyMatrix":
        from gespmm_tpu.sparse.formats import csr_from_scipy

        return cls.from_csr(csr_from_scipy(mat.tocsr()), plan=plan,
                            **plan_kwargs)

    # -- BCOO-compatible surface ------------------------------------------
    @property
    def _eff(self):
        return self.adj.transpose() if self.transposed else self.adj

    @property
    def shape(self):
        m, n = self.adj.shape
        return (n, m) if self.transposed else (m, n)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        d = self.adj.csr.data
        return jnp.float32 if d is None else d.dtype

    @property
    def nse(self) -> int:  # BCOO's name for nnz
        return self.adj.nnz

    @property
    def nnz(self) -> int:
        return self.adj.nnz

    @property
    def T(self) -> "AdjacencyMatrix":
        return AdjacencyMatrix(self.adj, not self.transposed)

    def transpose(self) -> "AdjacencyMatrix":
        return self.T

    def __matmul__(self, other):
        from gespmm_tpu.ops.spmm import spmm

        if isinstance(other, AdjacencyMatrix):
            return NotImplemented
        other = jnp.asarray(other)
        if other.ndim == 1:
            return spmm(self._eff, other[:, None])[:, 0]
        if other.ndim == 2:
            return spmm(self._eff, other)
        return NotImplemented

    def __rmatmul__(self, other):
        # x @ A == (Aᵀ @ xᵀ)ᵀ — still one kernel call on the paired
        # ordering, no materialized transpose of the sparse matrix.
        other = jnp.asarray(other)
        if other.ndim == 1:
            return (self.T @ other[None, :].T)[:, 0]
        if other.ndim == 2:
            return (self.T @ other.T).T
        return NotImplemented

    def todense(self):
        m, n = self.shape
        eff = self._eff
        data = (
            jnp.ones((self.nnz,), self.dtype)
            if eff.csr.data is None else eff.csr.data
        )
        rows = (
            eff.rows if eff.rows is not None else eff.csr.row_ids()
        )
        out = jnp.zeros((m, n), self.dtype)
        return out.at[rows, eff.csr.indices].add(data)

    def to_bcoo(self):
        return csr_to_bcoo(self._eff.csr)

    def with_data(self, data) -> "AdjacencyMatrix":
        if self.transposed:
            raise ValueError("set data on the untransposed matrix")
        return AdjacencyMatrix(self.adj.with_data(data))

    def __repr__(self):
        m, n = self.shape
        return (f"AdjacencyMatrix({m}x{n}, nse={self.nnz}, "
                f"dtype={self.dtype})")

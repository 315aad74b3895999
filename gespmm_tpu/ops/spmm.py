"""SpMM primitive with transpose-paired custom VJP and kernel dispatch.

The structural insight carried over from the reference: **backward of SpMM is
SpMM on Aᵀ** (`pytorch-custom/op.py:20-36` runs the CSC ordering in backward;
DGL integration pairs in-CSR forward with out-CSR backward,
`binary_reduce_sum.cu:455,491`).  We therefore carry both orderings in one
`Adjacency` pytree, built once per graph, and the VJP never transposes at
step time.

Improvements over the reference:
  * edge-value gradients ARE supported (the reference explicitly does not,
    `op.py:22-27`): grad_vals = SDDMM(pattern, grad_out, B) — the natural
    dual, computed by our SDDMM kernels.
  * max/min reductions are differentiable (even tie-splitting, matching
    `jnp.max`'s VJP), where the reference's max kernels are forward-only.
  * mean reduction (DGL parity) built compositionally on sum.

Dispatch (`_resolve_method`, the counterpart of the K-based heuristic at
`spmm_kernel.cu:186-206`) lives in this module alone.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp

from gespmm_tpu.sparse.formats import CSC, CSR, expand_indptr
from gespmm_tpu.ops import reference as ref

Array = jax.Array


# ---------------------------------------------------------------------------
# Adjacency: CSR + CSC + permutation, the unit the op layer consumes
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Adjacency:
    """A sparse matrix with both row- and column-compressed orderings.

    ``perm`` maps CSC edge order -> CSR edge order: ``csc_data = data[perm]``.
    ``plan`` / ``plan_t`` are optional tiled slot layouts for A and Aᵀ
    (built eagerly on host by :meth:`from_csr` when ``plan=True``).
    """

    csr: CSR
    csc: CSC
    perm: Array
    plan: Optional[object] = None
    plan_t: Optional[object] = None
    # Precomputed per-nonzero row ids for CSR and CSC order (the expanded
    # indptr): computed once per graph so no per-call cumsum over nnz runs
    # inside jitted steps.
    rows: Optional[Array] = None
    rows_t: Optional[Array] = None
    # Inverse of ``perm`` (host-precomputed): ``transpose()`` needs it,
    # and computing it on device is an nnz-sized scatter per call — it
    # sat in the hot path of every SDDMM backward (GAT layers).
    inv_perm: Optional[Array] = None

    def tree_flatten(self):
        return (
            self.csr, self.csc, self.perm, self.plan, self.plan_t,
            self.rows, self.rows_t, self.inv_perm,
        ), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_csr(cls, csr: CSR, plan=False, plan_transpose=True,
                 **plan_kwargs) -> "Adjacency":
        """Build the paired adjacency.

        plan: False (no plan) | True / "auto" / "tiled" (the tiled slot
        layout of `sparse/partition.build_tiled_plan`, which the tiled
        SpMM, the fused attention and the slot-order edge reductions use).
        plan_transpose=False skips the TRANSPOSE plan (forward-only use,
        e.g. inference or the benchmark sweep — halves plan memory; the
        backward then rides the XLA tier).

        All preprocessing is staged on the host (one device fetch per
        array, native C++ transpose when available).
        """
        import types

        import numpy as np

        indptr_h = np.asarray(csr.indptr)
        indices_h = np.asarray(csr.indices)
        data_h = None if csr.data is None else np.asarray(csr.data)
        m, n = csr.shape
        nnz = int(indices_h.shape[0])

        from gespmm_tpu.utils import native as _native

        nat = _native.csr_to_csc_native(indptr_h, indices_h, m, n)
        if nat is not None:
            colptr_h, csc_rows_h, perm_h = nat
        else:
            order = np.argsort(indices_h, kind="stable")
            csc_rows_h = np.repeat(
                np.arange(m, dtype=np.int32), np.diff(indptr_h)
            )[order]
            colptr_h = np.zeros(n + 1, np.int64)
            np.add.at(colptr_h, indices_h + 1, 1)
            colptr_h = np.cumsum(colptr_h).astype(np.int32)
            perm_h = order.astype(np.int32)
        csc = CSC(
            indptr=jnp.asarray(colptr_h),
            indices=jnp.asarray(csc_rows_h),
            data=None if data_h is None else jnp.asarray(data_h[perm_h]),
            shape=(m, n),
        )

        p = pt = None
        if plan:
            kind = "auto" if plan is True else plan
            host_csr = types.SimpleNamespace(
                indptr=indptr_h, indices=indices_h, data=data_h,
                shape=(m, n), nnz=nnz,
            )
            host_csr_t = types.SimpleNamespace(
                indptr=colptr_h, indices=csc_rows_h,
                data=None, shape=(n, m), nnz=nnz,
            )
            p = _build_plan(host_csr, kind, plan_kwargs)
            pt = (
                _build_plan(host_csr_t, kind, plan_kwargs)
                if plan_transpose else None
            )
        rows = jnp.asarray(
            np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr_h))
        )
        rows_t = jnp.asarray(
            np.repeat(np.arange(n, dtype=np.int32), np.diff(colptr_h))
        )
        inv_perm_h = np.empty_like(perm_h)
        inv_perm_h[perm_h] = np.arange(nnz, dtype=perm_h.dtype)
        return cls(
            csr=csr, csc=csc, perm=jnp.asarray(perm_h), plan=p, plan_t=pt,
            rows=rows, rows_t=rows_t, inv_perm=jnp.asarray(inv_perm_h),
        )

    @property
    def shape(self):
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    @property
    def data(self):
        return self.csr.data

    def with_data(self, data: Optional[Array]) -> "Adjacency":
        csc_data = None if data is None else data[self.perm]
        return Adjacency(
            csr=self.csr.with_data(data),
            csc=self.csc.with_data(csc_data),
            perm=self.perm,
            plan=self.plan,
            plan_t=self.plan_t,
            rows=self.rows,
            rows_t=self.rows_t,
            inv_perm=self.inv_perm,
        )

    def without_plans(self) -> "Adjacency":
        """The same matrix with no tiled plans: every op on it takes the
        XLA formulations."""
        return dataclasses.replace(self, plan=None, plan_t=None)

    def transpose(self) -> "Adjacency":
        """Adjacency of Aᵀ (cheap — reuses the paired orderings)."""
        m, n = self.shape
        t_csr = CSR(
            indptr=self.csc.indptr,
            indices=self.csc.indices,
            data=self.csc.data,
            shape=(n, m),
        )
        t_csc = CSC(
            indptr=self.csr.indptr,
            indices=self.csr.indices,
            data=self.csr.data,
            shape=(n, m),
        )
        # perm for Aᵀ: maps (csc of Aᵀ = csr of A) order -> (csr of Aᵀ = csc
        # of A) order; that's the inverse permutation (host-precomputed by
        # from_csr; the device scatter only runs for hand-built Adjacency).
        inv = self.inv_perm
        if inv is None:
            inv = jnp.zeros_like(self.perm).at[self.perm].set(
                jnp.arange(self.perm.shape[0], dtype=self.perm.dtype)
            )
        return Adjacency(
            csr=t_csr, csc=t_csc, perm=inv, plan=self.plan_t,
            plan_t=self.plan, rows=self.rows_t, rows_t=self.rows,
            inv_perm=self.perm,
        )


@dataclasses.dataclass(frozen=True)
class _SpmmConfig:
    """Static (hashable) op configuration for the custom-VJP core."""

    reduce: str
    m: int
    n: int
    method: str


# ---------------------------------------------------------------------------
# Forward dispatch
# ---------------------------------------------------------------------------

def _build_plan(csr: CSR, kind: str, kwargs: dict):
    from gespmm_tpu.sparse.partition import build_tiled_plan

    if kind not in ("auto", "tiled"):
        raise ValueError(f"unknown plan kind {kind!r}")
    import inspect

    sig = inspect.signature(build_tiled_plan)
    kw = {k: v for k, v in kwargs.items() if k in sig.parameters}
    return build_tiled_plan(csr, **kw)


# When the Triton CSR kernel runs sum-reduce SpMM on the GPU in place of
# XLA's gather + sorted segment-sum (H100, PERF.md).  The kernel pays one
# program per row; wide rows (many nonzeros) or wide B (many columns per
# program) pay for it.  XLA won at K <= 64 on graphs of average degree 4
# and 14, the kernel at K=512 on every graph and at K <= 32 on every graph
# of degree 28 or more; the GCN step at K=256 ran about 11% faster on it.
CSR_KERNEL_MIN_K = 256
CSR_KERNEL_MIN_DEGREE = 20


def _resolve_method(method: str, plan, K: int, reduce: str = "sum",
                    avg_degree: float = 0.0) -> str:
    """The one place ``method="auto"`` is decided for SpMM.

    On the GPU, sum-reduce SpMM runs the one-pass Triton CSR kernel
    (`kernels/spmm_csr.py`) when ``K >= CSR_KERNEL_MIN_K`` or the average
    row holds ``avg_degree >= CSR_KERNEL_MIN_DEGREE`` nonzeros, else the
    XLA gather + segment-sum formulation.  Max/min, and everything off
    the GPU, use the tiled slot layout when the adjacency carries one,
    else the XLA formulation.  No choice here runs a kernel in interpret
    mode.  (Attention's fused-or-composed choice is `fused_attention`.)
    """
    if method != "auto":
        return method
    if reduce == "sum" and jax.default_backend() == "gpu":
        wide = K >= CSR_KERNEL_MIN_K or avg_degree >= CSR_KERNEL_MIN_DEGREE
        return "pallas" if wide else "xla"
    if plan is not None:
        from gespmm_tpu.sparse.partition import TiledSpmmPlan

        if isinstance(plan, TiledSpmmPlan):
            return "tiled"
    return "xla"


def fused_attention(method: str, adj: Adjacency) -> bool:
    """Whether attention over ``adj`` runs the fused slot-space chain
    (`kernels/gat_fused`), which needs tiled plans for A and Aᵀ.

    ``method="tiled"`` asks for it.  Under ``"auto"`` it runs off the GPU
    only: on the H100 the chain ran 5.9x slower than the unfused
    composition (PERF.md), which callers run on ``adj.without_plans()``.
    """
    from gespmm_tpu.sparse.partition import TiledSpmmPlan

    planned = isinstance(adj.plan, TiledSpmmPlan) and isinstance(
        adj.plan_t, TiledSpmmPlan
    )
    if method == "tiled":
        return planned
    return planned and method == "auto" and jax.default_backend() != "gpu"


def _forward(cfg: _SpmmConfig, indptr, indices, data, plan, B, rows=None) -> Array:
    avg_degree = indices.shape[0] / max(indptr.shape[0] - 1, 1)
    method = _resolve_method(cfg.method, plan, B.shape[-1], cfg.reduce,
                             avg_degree)
    if method == "tiled" and plan is not None and cfg.reduce in (
        "sum", "max", "min"
    ):
        from gespmm_tpu.kernels.spmm_stream import spmm_tiled
        from gespmm_tpu.sparse.partition import TiledSpmmPlan

        if isinstance(plan, TiledSpmmPlan):
            return spmm_tiled(plan, data, B, cfg.m, reduce=cfg.reduce)
    if method == "pallas" and cfg.reduce == "sum":
        from gespmm_tpu.kernels import spmm_csr as _csr

        return _csr.spmm_csr(indptr, indices, data, B, cfg.m)
    if method == "scatter" and cfg.reduce == "sum":
        # Push-formulation benchmark tier (≙ the Gunrock baseline's
        # atomicAdd-into-destination, `spmm_enactor.cuh:92-105`).
        r = rows if rows is not None else expand_indptr(
            indptr, indices.shape[0]
        )
        return ref.spmm_scatter_xla(r, indices, data, B, cfg.m)
    if method == "dense" and cfg.reduce == "sum":
        # Densify-and-matmul crossover baseline (≙ the merge-spmm third-
        # baseline role, `run_test.sh:12-16`): quantifies where sparsity
        # stops paying.  Size-guarded; small graphs only.
        r = rows if rows is not None else expand_indptr(
            indptr, indices.shape[0]
        )
        return ref.spmm_dense_xla(r, indices, data, B, cfg.m)
    return ref.spmm_best_xla(
        indptr, indices, data, B, reduce=cfg.reduce, rows=rows
    )


# ---------------------------------------------------------------------------
# custom_vjp core (sum / max / min; mean is compositional on sum)
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _spmm_core(cfg, indptr, indices, rows, t_indptr, t_indices, t_rows,
               perm, plan, plan_t, data, B):
    return _forward(cfg, indptr, indices, data, plan, B, rows=rows)


def _spmm_core_fwd(cfg, indptr, indices, rows, t_indptr, t_indices, t_rows,
                   perm, plan, plan_t, data, B):
    ties = None
    if cfg.reduce in ("max", "min"):
        # On the tiled path the forward also counts the achieving edges
        # per (row, k) — the VJP then skips its tie-recount stream
        # (phase 1 of spmm_minmax_vjp_tiled).
        from gespmm_tpu.sparse.partition import TiledSpmmPlan

        method = _resolve_method(cfg.method, plan, B.shape[-1], cfg.reduce)
        # Same gate as the backward (which also requires a tiled
        # TRANSPOSE plan): ties a non-tiled backward would ignore are
        # not computed.
        if (
            method == "tiled"
            and isinstance(plan, TiledSpmmPlan)
            and isinstance(plan_t, TiledSpmmPlan)
        ):
            from gespmm_tpu.kernels.spmm_stream import spmm_tiled

            out, ties = spmm_tiled(plan, data, B, cfg.m, reduce=cfg.reduce,
                                   want_ties=True)
        else:
            out = _forward(cfg, indptr, indices, data, plan, B, rows=rows)
        keep_out = out
    else:
        out = _forward(cfg, indptr, indices, data, plan, B, rows=rows)
        keep_out = None
    res = (indptr, indices, rows, t_indptr, t_indices, t_rows, perm,
           plan, plan_t, data, B, keep_out, ties)
    return out, res


def _spmm_core_bwd(cfg, res, g):
    (indptr, indices, rows, t_indptr, t_indices, t_rows, perm, plan,
     plan_t, data, B, out, ties) = res
    nnz = indices.shape[0]

    if cfg.reduce == "sum":
        # grad_B = Aᵀ @ g — SpMM on the paired CSC ordering
        # (≙ op.py:29 backward running csr_spmm on the CSC arrays).
        t_data = None if data is None else data[perm]
        t_cfg = _SpmmConfig(reduce="sum", m=cfg.n, n=cfg.m, method=cfg.method)
        grad_B = _forward(t_cfg, t_indptr, t_indices, t_data, plan_t, g,
                          rows=t_rows)
        grad_data = None
        if data is not None:
            # grad_val[e] = g[row(e)] · B[col(e)] — SDDMM duality.
            if rows is None:
                rows = expand_indptr(indptr, nnz)
            grad_data = ref.sddmm_xla(rows, indices, g, B).astype(data.dtype)
    else:  # max / min — route gradient through achieving edges.
        from gespmm_tpu.sparse.partition import TiledSpmmPlan

        method = _resolve_method(cfg.method, plan, B.shape[-1], cfg.reduce)
        if (
            method == "tiled"
            and isinstance(plan, TiledSpmmPlan)
            and isinstance(plan_t, TiledSpmmPlan)
        ):
            # Slot-layout backward: the forward ran the tiled path (same
            # dispatch), so achievement tests are bitwise-exact.
            from gespmm_tpu.kernels.spmm_stream import (
                spmm_minmax_vjp_aligned,
                spmm_minmax_vjp_tiled,
            )

            csc_data = None if data is None else data[perm]
            mm_t = getattr(plan_t, "minmax", None)
            if mm_t is not None and ties is not None:
                # Backward over the transpose's aligned layout (one
                # scattered gather).
                gd_csc, grad_B = spmm_minmax_vjp_aligned(
                    mm_t, csc_data, B, out, g, cfg.reduce, ties,
                )
            else:
                gd_csc, grad_B = spmm_minmax_vjp_tiled(
                    plan, plan_t, data, csc_data, B, out, g, cfg.reduce,
                    ties=ties,
                )
            grad_data = None
            if gd_csc is not None:
                grad_data = (
                    jnp.zeros((nnz,), jnp.float32).at[perm].set(gd_csc)
                ).astype(data.dtype)
            return (None, None, None, None, None, None, None, None, None,
                    grad_data, grad_B.astype(B.dtype))
        if rows is None:
            rows = expand_indptr(indptr, nnz)
        grad_contrib = ref.spmm_max_vjp_edges(
            rows, indices, data, B, out, g, cfg.m
        )  # [nnz, K] cotangent of val_e * B[col_e]
        if data is not None:
            scaled = grad_contrib * data[:, None].astype(grad_contrib.dtype)
            grad_data = jnp.sum(
                grad_contrib * jnp.take(B, indices, axis=0).astype(grad_contrib.dtype),
                axis=-1,
            ).astype(data.dtype)
        else:
            scaled = grad_contrib
            grad_data = None
        grad_B = jax.ops.segment_sum(
            scaled, indices, num_segments=cfg.n
        ).astype(B.dtype)

    return (None, None, None, None, None, None, None, None, None,
            grad_data, grad_B.astype(B.dtype))


_spmm_core.defvjp(_spmm_core_fwd, _spmm_core_bwd)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


# Reductions each EXPLICIT method supports (mean composes on sum, so any
# method that does sum does mean).  "auto" may fall back silently; an
# explicitly requested kernel must never silently measure something else.
_METHOD_REDUCES = {
    "tiled": ("sum", "mean", "max", "min"),
    "pallas": ("sum", "mean"),  # kernels/spmm_csr.py
    "scatter": ("sum", "mean"),
    "dense": ("sum", "mean"),
    "xla": ("sum", "mean", "max", "min"),
    "auto": ("sum", "mean", "max", "min"),
}


def _check_method(adj: "Adjacency", reduce: str, method: str) -> None:
    if method not in _METHOD_REDUCES:
        raise ValueError(
            f"unknown method {method!r}; expected one of "
            f"{tuple(_METHOD_REDUCES)}"
        )
    if reduce not in _METHOD_REDUCES[method]:
        raise ValueError(
            f"method={method!r} does not support reduce={reduce!r} "
            f"(supported: {_METHOD_REDUCES[method]}); use method='auto' "
            f"or 'xla'"
        )
    if method == "tiled":
        from gespmm_tpu.sparse.partition import TiledSpmmPlan

        if not isinstance(adj.plan, TiledSpmmPlan):
            raise ValueError(
                "method='tiled' needs an Adjacency built with "
                "plan=True/'tiled' (Adjacency.from_csr(csr, plan=True))"
            )


def spmm(
    adj: Union[Adjacency, CSR],
    B: Array,
    *,
    reduce: str = "sum",
    method: str = "auto",
) -> Array:
    """C = reduce_e A[r, c_e] * B[c_e, :]  — sparse × dense.

    Args:
      adj: `Adjacency` (preferred — carries the transpose pairing and any
        tiled plan) or a bare `CSR` (transpose built on the fly).
      B: dense matrix (n, K).
      reduce: "sum" | "mean" | "max" | "min".
      method: "auto" | "tiled" | "xla" | "pallas" (the Triton CSR kernel,
        GPU only) | "scatter" | "dense" (the densify-and-matmul crossover
        baseline; size-guarded).

    Differentiable in ``B`` and in ``adj``'s edge values (if present).
    """
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    if B.ndim != 2:
        raise ValueError(f"B must be rank 2, got shape {B.shape}")
    m, n = adj.shape
    if B.shape[0] != n:
        raise ValueError(f"A is {adj.shape}, B is {B.shape}: inner dims differ")
    _check_method(adj, reduce, method)

    if reduce == "mean":
        out = spmm(adj, B, reduce="sum", method=method)
        deg = (adj.csr.indptr[1:] - adj.csr.indptr[:-1]).astype(out.dtype)
        return out / jnp.maximum(deg, 1.0)[:, None]

    cfg = _SpmmConfig(reduce=reduce, m=m, n=n, method=method)
    return _spmm_core(
        cfg,
        adj.csr.indptr,
        adj.csr.indices,
        adj.rows,
        adj.csc.indptr,
        adj.csc.indices,
        adj.rows_t,
        adj.perm,
        adj.plan,
        adj.plan_t,
        adj.csr.data,
        B,
    )

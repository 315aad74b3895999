"""SDDMM primitive: sampled dense-dense matmul with custom VJP.

out[e] = D1[row(e), :] · D2[col(e), :] for every nonzero e of the sparsity
pattern — the op surface of `pytorch-custom/sddmm.cpp:63-68` (`coo_sddmm`,
`csr_sddmm`).  The reference exposes it forward-only; here it carries the
natural VJP, which is a pair of SpMMs (grad_D1 = A(g) @ D2,
grad_D2 = A(g)ᵀ @ D1) — the exact dual of SpMM's backward being an SDDMM.

Dispatch: "auto" is the XLA gather-dot formulation (the fused gather + dot
that GE-SpMM's `sddmm.cu` kernels hand-write); "tiled" computes it in the
slot order of an `Adjacency`'s tiled plan.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Union

import jax

from gespmm_tpu.sparse.formats import expand_indptr
from gespmm_tpu.ops import reference as ref

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class _SddmmConfig:
    m: int
    n: int
    method: str


def _forward(cfg: _SddmmConfig, rows, cols, D1, D2) -> Array:
    method = cfg.method
    if method == "auto":
        method = "xla"
    if method != "xla":
        raise ValueError(
            f"unknown sddmm method {method!r} (auto | xla | tiled; tiled "
            "needs an Adjacency with plan=True)"
        )
    return ref.sddmm_xla(rows, cols, D1, D2)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sddmm_core(cfg, rows, cols, D1, D2):
    return _forward(cfg, rows, cols, D1, D2)


def _sddmm_core_fwd(cfg, rows, cols, D1, D2):
    return _forward(cfg, rows, cols, D1, D2), (rows, cols, D1, D2)


def _sddmm_core_bwd(cfg, res, g):
    rows, cols, D1, D2 = res
    # grad_D1[r] = Σ_{e: row(e)=r} g[e] · D2[col(e)]  — an SpMM with edge
    # values g over the COO pattern; likewise transposed for grad_D2.
    grad_D1 = ref.spmm_rows_xla(
        rows, cols, g, D2, cfg.m, reduce="sum", rows_sorted=True
    ).astype(D1.dtype)
    grad_D2 = ref.spmm_rows_xla(
        cols, rows, g, D1, cfg.n, reduce="sum", rows_sorted=False
    ).astype(D2.dtype)
    return (None, None, grad_D1, grad_D2)


_sddmm_core.defvjp(_sddmm_core_fwd, _sddmm_core_bwd)


def sddmm_coo(
    rows: Array,
    cols: Array,
    D1: Array,
    D2: Array,
    *,
    shape=None,
    method: str = "auto",
) -> Array:
    """SDDMM over an explicit COO pattern. Returns per-edge values.

    ≙ `sddmm.coo_sddmm` (`sddmm.cpp:42-48` → `sddmm_cuda_coo`).
    """
    if D1.ndim != 2 or D2.ndim != 2 or D1.shape[1] != D2.shape[1]:
        raise ValueError(f"D1 {D1.shape} / D2 {D2.shape} must be (m,K)/(n,K)")
    m = D1.shape[0] if shape is None else shape[0]
    n = D2.shape[0] if shape is None else shape[1]
    cfg = _SddmmConfig(m=m, n=n, method=method)
    return _sddmm_core(cfg, rows, cols, D1, D2)


def _sddmm_adj_forward(fwd: str, adj, D1, D2):
    if fwd == "tiled":
        # Slot-layout SDDMM over the tiled plan (an explicit tier).
        from gespmm_tpu.kernels.spmm_stream import sddmm_tiled

        return sddmm_tiled(adj.plan, D1, D2)
    # "auto"/"xla": the XLA gather-dot formulation.  Routing through the
    # Adjacency gives the backward: both gradient SpMMs go through
    # `spmm(method="auto")` with the paired orderings.
    rows = (
        adj.rows
        if adj.rows is not None
        else expand_indptr(adj.csr.indptr, adj.csr.nnz)
    )
    return ref.sddmm_xla(rows, adj.csr.indices, D1, D2)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sddmm_adj_core(fwd, adj, D1, D2):
    return _sddmm_adj_forward(fwd, adj, D1, D2)


def _sddmm_adj_fwd(fwd, adj, D1, D2):
    return _sddmm_adj_core(fwd, adj, D1, D2), (adj, D1, D2)


def _sddmm_adj_bwd(fwd, res, g):
    # Both gradients are SpMMs with g as edge values — routed through the
    # public op, so they take whatever path auto picks.
    from gespmm_tpu.ops.spmm import spmm

    adj, D1, D2 = res
    weighted = adj.with_data(g)
    grad_D1 = spmm(weighted, D2, method="auto").astype(D1.dtype)
    grad_D2 = spmm(weighted.transpose(), D1, method="auto").astype(D2.dtype)
    return (None, grad_D1, grad_D2)


_sddmm_adj_core.defvjp(_sddmm_adj_fwd, _sddmm_adj_bwd)


def sddmm(
    adj: Union["CSR", "object"],
    D1: Array,
    D2: Array,
    *,
    method: str = "auto",
) -> Array:
    """SDDMM over a CSR/Adjacency pattern; per-edge values in CSR order.

    ≙ `sddmm.csr_sddmm` (`sddmm.cpp:50-61`) — where the CUDA kernel recovers
    each edge's row by binary search (`computeUtil.h:11-28`), we expand the
    indptr once into row ids (cheap cumsum, fused by XLA).

    When ``adj`` is an `Adjacency` carrying tiled plans and method is
    "auto"/"tiled", the VJP's two SpMMs run through `spmm` on the paired
    orderings.
    """
    from gespmm_tpu.ops.spmm import Adjacency
    from gespmm_tpu.sparse.partition import TiledSpmmPlan

    if isinstance(adj, Adjacency):
        if (
            method in ("auto", "tiled", "xla")
            and isinstance(adj.plan, TiledSpmmPlan)
            and isinstance(adj.plan_t, TiledSpmmPlan)
        ):
            if D1.ndim != 2 or D2.ndim != 2 or D1.shape[1] != D2.shape[1]:
                raise ValueError(
                    f"D1 {D1.shape} / D2 {D2.shape} must be (m,K)/(n,K)"
                )
            return _sddmm_adj_core(
                "tiled" if method == "tiled" else "xla", adj, D1, D2
            )
        csr = adj.csr
    else:
        csr = adj
    if method == "tiled":
        # An explicitly requested kernel tier must never silently measure
        # something else (same strictness rule as ops/spmm).
        raise ValueError(
            "method='tiled' needs an Adjacency built with plan=True "
            "(Adjacency.from_csr(csr, plan=True))"
        )
    rows = expand_indptr(csr.indptr, csr.nnz)
    return sddmm_coo(
        rows, csr.indices, D1, D2, shape=csr.shape, method=method
    )

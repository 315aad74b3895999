"""Fused slot-space GAT attention: logits -> softmax -> weighted SpMM.

The unfused composition (additive logits, leaky-relu, edge softmax,
alpha-weighted SpMM) exchanges nnz-length arrays in CSR order, so each
slot-order reduction pays a CSR->slot permute on entry, plus separate max /
normalizer / aggregate passes.

This module computes the ENTIRE attention layer in the tiled plan's slot
order; per-edge quantities are only ever *materialized* in slot space,
and the few node-space arrays (row max, denominator, rowdot) are small
(m x 1).  Two slot-order reductions forward:

  1. row max   m_r   = max_e leaky(src[r_e] + dst[c_e])     (K=1 reduce)
  2. aggregate [out_w | d]_r = sum_e z_e * [B[c_e] | 1]     (K+1 reduce)
     with z_e = exp(l_e - m_r) recomputed per slot; out = out_w / d.

The denominator rides the aggregate as an extra ones-column — the
softmax normalizer costs zero extra passes.  Backward is two more
passes, using the softmax-attention identity s_r = <g_r, out_r>:

  dl_e      = alpha_e (g[r_e]·B[c_e] - s_{r_e})
  d src[r]  = sum_{e: r_e=r} dl_e · leaky'(pre_e)            (plan)
  [dB | d dst]_c = sum_{e: c_e=c} [alpha_e g[r_e] | dl_e·leaky'] (plan_t)

where every per-edge factor (pre, z, alpha, dl) is RECOMPUTED in the
consuming plan's own slot order from node-space tables — no edge-order
permutes anywhere, forward or backward.

Reference parity: composes the SDDMM-consumer chain the reference
exposes but never exploits (`pytorch-custom/sddmm.cpp:63-68`); the
fusion itself has no reference counterpart (their SDDMM is
forward-only).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from gespmm_tpu.kernels.spmm_stream import (
    _part_rows_slice,
    _reduce_part,
    _slot_rows,
    _tile_gather,
)
from gespmm_tpu.sparse.partition import TiledSpmmPlan

Array = jax.Array

# exp() argument floor: arguments are <= 0 by construction (l <= row max);
# below -80 the result underflows past 1.8e-35 — clamping avoids both the
# useless subnormal range and XLA:CPU's vectorized-exp NaN on huge
# negative inputs (see parallel/edge_ops.py).
_EXP_FLOOR = -80.0
# Denominator guard must be a NORMAL f32 (1e-38 is subnormal; FTZ turns
# it into 0/0=NaN).  Any row with a valid edge has d >= exp(0) = 1, so
# the guard only serves empty rows.
_DENOM_EPS = 1e-20


def _leaky(x, slope):
    return jnp.where(x >= 0, x, slope * x)


def _dleaky(x, slope):
    return jnp.where(x >= 0, 1.0, slope)


def _slot_pre(part, src_pad, dst_pad):
    """Per-slot pre-activation logits src[r_e] + dst[c_e] (src sliced per
    part, dst per column tile).  (S, H) f32."""
    s_slot = jnp.take(
        _part_rows_slice(part, src_pad), _slot_rows(part), axis=0
    )
    d_slot = _tile_gather(part, dst_pad)
    return s_slot + d_slot


def _forward(plan, src2, dst2, B, slope, max_mode="exact", heads=1):
    """Head-batched forward: src2/dst2 are (m, H)/(n, H), B is
    (n, H*dh) in head blocks.  One K=H max pass + one (H*dh + H)-wide
    aggregate whose last H columns are the per-head denominators."""
    m, n = plan.shape
    H = heads
    KB = B.shape[1]
    dh = KB // H
    src_pad = src2.astype(jnp.float32)
    dst_pad = dst2.astype(jnp.float32)
    B32 = B.astype(jnp.float32)

    if max_mode == "bound":
        # O(n) softmax shift instead of the K=H max stream: leaky-relu
        # is monotone nondecreasing, so leaky(src[r] + max_c dst[c])
        # upper-bounds every edge logit per head.  Softmax is exactly
        # shift-invariant — the ONLY cost is underflow headroom:
        # bound - l_e <= max(dst) - dst[c_e] (leaky slope <= 1), so
        # alphas stay exact while the dst-score dynamic range is under
        # ~80 (f32 exp headroom; trained attention scores are O(10)).
        mx = _leaky(src_pad + jnp.max(dst_pad, axis=0), slope)
    else:
        # Pass 1: per-row logit max (K=H reduction).
        mx_parts = []
        for part in plan.parts:
            l = _leaky(_slot_pre(part, src_pad, dst_pad), slope)
            mp = _reduce_part(
                l, part.local_rows, part.row_start, part.m_pad,
                part.rows_per_block, op="max")
            mx_parts.append(mp[: part.m_part])
        mx = (mx_parts[0] if len(mx_parts) == 1
              else jnp.concatenate(mx_parts, 0))[:m]
        mx = jnp.where(jnp.isfinite(mx), mx, 0.0)  # empty rows

    # Pass 2: z-weighted aggregate with per-head denominators as the
    # last H columns.  All row-space operands ([src | mx]) gather as ONE
    # combined table, likewise all column-space operands ([dst | B]):
    # one per-slot take per table instead of one per operand.
    KK = KB + H
    row_tbl = jnp.concatenate([src_pad, mx], axis=1)  # (m, 2H)
    col_tbl = jnp.concatenate([dst_pad, B32], axis=1)  # (n, H + H*dh)
    out_parts, den_parts = [], []
    for part in plan.parts:
        rt = jnp.take(
            _part_rows_slice(part, row_tbl), _slot_rows(part), axis=0
        )
        ct = _tile_gather(part, col_tbl)
        pre = rt[:, :H] + ct[:, :H]
        l = _leaky(pre, slope)
        m_slot = rt[:, H:]
        z = jnp.exp(jnp.maximum(l - m_slot, _EXP_FLOOR))  # (S, H)
        gb = ct[:, H:]  # (S, H*dh)
        z_rep = z if H == 1 and dh == 1 else jnp.repeat(z, dh, axis=1)
        stream = jnp.concatenate([gb * z_rep, z], axis=1)  # (S, KK)
        res = _reduce_part(
            stream, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="sum")
        out_parts.append(res[: part.m_part, :KB])
        den_parts.append(res[: part.m_part, KB:KK])
    out_w = (out_parts[0] if len(out_parts) == 1
             else jnp.concatenate(out_parts, 0))[:m]
    den = (den_parts[0] if len(den_parts) == 1
           else jnp.concatenate(den_parts, 0))[:m]
    den = jnp.maximum(den, _DENOM_EPS)
    out = out_w / jnp.repeat(den, dh, axis=1)
    return out, mx, den


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _gat_core(slope, max_mode, heads, plan, plan_t, src2, dst2, B):
    out, _, _ = _forward(plan, src2, dst2, B, slope, max_mode, heads)
    return out.astype(B.dtype)


def _gat_fwd(slope, max_mode, heads, plan, plan_t, src2, dst2, B):
    out, mx, den = _forward(plan, src2, dst2, B, slope, max_mode, heads)
    out = out.astype(B.dtype)
    return out, (plan, plan_t, src2, dst2, B, out, mx, den)


def _gat_bwd(slope, max_mode, heads, res, g):
    plan, plan_t, src2, dst2, B, out, mx, den = res
    m, n = plan.shape
    H = heads
    KB = B.shape[1]
    dh = KB // H
    src_pad = src2.astype(jnp.float32)
    dst_pad = dst2.astype(jnp.float32)
    B32 = B.astype(jnp.float32)
    g32 = g.astype(jnp.float32)
    out32 = out.astype(jnp.float32)
    # Softmax-attention identity per head: the alpha-weighted row sum of
    # per-edge u_e = g_h·B_h equals <g_r, out_r> within the head block —
    # no extra reduction needed.
    s_row = jnp.sum(
        (g32 * out32).reshape(m, H, dh), axis=-1
    )  # (m, H)

    def _head_dot(a, b):
        # (S, H*dh) x (S, H*dh) -> per-head dots (S, H).
        S = a.shape[0]
        return jnp.sum((a * b).reshape(S, H, dh), axis=-1)

    # Pass 3 (plan): d src_score — edge cotangent recomputed per slot.
    # ONE combined row table ([src | mx | den | s_row | g]) and ONE
    # combined column table ([dst | B]): two per-slot takes instead of
    # seven.  Pass 4 reuses the SAME two tables with the roles swapped
    # (plan_t's rows are original columns).
    row_tbl = jnp.concatenate(
        [src_pad, mx, den, s_row, g32], axis=1
    )  # (m, 4H + KB)
    col_tbl = jnp.concatenate([dst_pad, B32], axis=1)  # (n, H + KB)
    gsrc_parts = []
    for part in plan.parts:
        rt = jnp.take(
            _part_rows_slice(part, row_tbl), _slot_rows(part), axis=0
        )
        ct = _tile_gather(part, col_tbl)
        pre = rt[:, :H] + ct[:, :H]
        l = _leaky(pre, slope)
        m_slot = rt[:, H : 2 * H]
        # Clamp: _part_rows_slice zero-pads den to m_pad, and INVALID
        # slots clamp onto those padded rows — an unguarded divide gives
        # inf there (pad slots are dropped by the reduce, but inf·0 NaNs
        # must not reach the edge-value paths).
        d_slot = jnp.maximum(rt[:, 2 * H : 3 * H], _DENOM_EPS)
        s_slot = rt[:, 3 * H : 4 * H]
        alpha = jnp.exp(jnp.maximum(l - m_slot, _EXP_FLOOR)) / d_slot
        g_slot = rt[:, 4 * H :]
        u = _head_dot(g_slot, ct[:, H:])  # (S, H)
        dpre = alpha * (u - s_slot) * _dleaky(pre, slope)
        gp = _reduce_part(
            dpre, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="sum")
        gsrc_parts.append(gp[: part.m_part])
    grad_src = (gsrc_parts[0] if len(gsrc_parts) == 1
                else jnp.concatenate(gsrc_parts, 0))[:m]

    # Pass 4 (plan_t): [dB | d dst_score] in one (H*dh + H)-wide reduce.
    # In transpose slot space the "rows" are original columns and the
    # tile gathers index original rows — every factor recomputed from
    # the node tables, no permutes.  Tables swap roles: col_tbl is now
    # row-indexed, row_tbl tile-gathered.
    KK = KB + H
    gB_parts, gdst_parts = [], []
    for part in plan_t.parts:
        rt = jnp.take(
            _part_rows_slice(part, col_tbl), _slot_rows(part), axis=0
        )
        ct = _tile_gather(part, row_tbl)
        pre = ct[:, :H] + rt[:, :H]
        l = _leaky(pre, slope)
        m_slot = ct[:, H : 2 * H]
        d_slot = jnp.maximum(ct[:, 2 * H : 3 * H], _DENOM_EPS)
        s_slot = ct[:, 3 * H : 4 * H]
        alpha = jnp.exp(jnp.maximum(l - m_slot, _EXP_FLOOR)) / d_slot
        b_slot = rt[:, H:]
        g_slot = ct[:, 4 * H :]
        u = _head_dot(g_slot, b_slot)
        dpre = alpha * (u - s_slot) * _dleaky(pre, slope)
        alpha_rep = alpha if H == 1 and dh == 1 else jnp.repeat(
            alpha, dh, axis=1
        )
        stream = jnp.concatenate([alpha_rep * g_slot, dpre], axis=1)
        res_p = _reduce_part(
            stream, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="sum")
        gB_parts.append(res_p[: part.m_part, :KB])
        gdst_parts.append(res_p[: part.m_part, KB:KK])
    grad_B = (gB_parts[0] if len(gB_parts) == 1
              else jnp.concatenate(gB_parts, 0))[:n]
    grad_dst = (gdst_parts[0] if len(gdst_parts) == 1
                else jnp.concatenate(gdst_parts, 0))[:n]
    return (None, None, grad_src.astype(src2.dtype),
            grad_dst.astype(dst2.dtype), grad_B.astype(B.dtype))


_gat_core.defvjp(_gat_fwd, _gat_bwd)


def _slot_pre_dot(part, D1_pad, D2_pad):
    """Per-slot dot-product logits D1[r_e] · D2[c_e] — the SDDMM
    computed directly in slot order (no CSR back-permute)."""
    d1 = jnp.take(
        _part_rows_slice(part, D1_pad), _slot_rows(part), axis=0
    )
    d2 = _tile_gather(part, D2_pad)
    return jnp.sum(d1 * d2, axis=-1, keepdims=True)


def _dot_forward(plan, D1, D2, B, slope):
    m, n = plan.shape
    K = B.shape[1]
    D1p = D1.astype(jnp.float32)
    D2p = D2.astype(jnp.float32)
    B32 = B.astype(jnp.float32)

    def act(x):
        return x if slope is None else _leaky(x, slope)

    mx_parts = []
    for part in plan.parts:
        l = act(_slot_pre_dot(part, D1p, D2p))
        mp = _reduce_part(
            l, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="max")
        mx_parts.append(mp[: part.m_part])
    mx = (mx_parts[0] if len(mx_parts) == 1
          else jnp.concatenate(mx_parts, 0))[:m]
    mx = jnp.where(jnp.isfinite(mx), mx, 0.0)

    # Combined tables (see _forward): row [D1 | mx], col [D2 | B] — one
    # take + one tile-gather per part instead of four.
    Ka = D1p.shape[1]
    row_tbl = jnp.concatenate([D1p, mx], axis=1)  # (m, Ka + 1)
    col_tbl = jnp.concatenate([D2p, B32], axis=1)  # (n, Ka + K)
    out_parts, den_parts = [], []
    for part in plan.parts:
        rt = jnp.take(
            _part_rows_slice(part, row_tbl), _slot_rows(part), axis=0
        )
        ct = _tile_gather(part, col_tbl)
        pre = jnp.sum(rt[:, :Ka] * ct[:, :Ka], axis=-1, keepdims=True)
        l = act(pre)
        m_slot = rt[:, Ka:]
        z = jnp.exp(jnp.maximum(l - m_slot, _EXP_FLOOR))
        gb = ct[:, Ka:]
        stream = jnp.concatenate([gb * z, z], axis=1)
        res = _reduce_part(
            stream, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="sum")
        out_parts.append(res[: part.m_part, :K])
        den_parts.append(res[: part.m_part, K : K + 1])
    out_w = (out_parts[0] if len(out_parts) == 1
             else jnp.concatenate(out_parts, 0))[:m]
    den = (den_parts[0] if len(den_parts) == 1
           else jnp.concatenate(den_parts, 0))[:m]
    den = jnp.maximum(den, _DENOM_EPS)
    return out_w / den, mx, den


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _dot_core(slope, plan, plan_t, D1, D2, B):
    out, _, _ = _dot_forward(plan, D1, D2, B, slope)
    return out.astype(B.dtype)


def _dot_fwd(slope, plan, plan_t, D1, D2, B):
    out, mx, den = _dot_forward(plan, D1, D2, B, slope)
    out = out.astype(B.dtype)
    return out, (plan, plan_t, D1, D2, B, out, mx, den)


def _dot_bwd(slope, res, g):
    plan, plan_t, D1, D2, B, out, mx, den = res
    m, n = plan.shape
    K = B.shape[1]
    Ka = D1.shape[1]
    D1p = D1.astype(jnp.float32)
    D2p = D2.astype(jnp.float32)
    B32 = B.astype(jnp.float32)
    g32 = g.astype(jnp.float32)
    out32 = out.astype(jnp.float32)
    s_row = jnp.sum(g32 * out32, axis=-1, keepdims=True)

    def dact(pre):
        return 1.0 if slope is None else _dleaky(pre, slope)

    # Pass 3 (plan): grad_D1 — Ka-wide reduce of dpre · D2[c_e].  One
    # combined row table [D1 | mx | den | s_row | g] and one combined
    # column table [D2 | B]; pass 4 reuses them with roles swapped
    # (same rationale as _gat_bwd).
    row_tbl = jnp.concatenate(
        [D1p, mx, den, s_row, g32], axis=1
    )  # (m, Ka + 3 + K)
    col_tbl = jnp.concatenate([D2p, B32], axis=1)  # (n, Ka + K)
    gD1_parts = []
    for part in plan.parts:
        rt = jnp.take(
            _part_rows_slice(part, row_tbl), _slot_rows(part), axis=0
        )
        ct = _tile_gather(part, col_tbl)
        d1s, d2s = rt[:, :Ka], ct[:, :Ka]
        pre = jnp.sum(d1s * d2s, axis=-1, keepdims=True)
        l = pre if slope is None else _leaky(pre, slope)
        m_slot = rt[:, Ka : Ka + 1]
        # Clamp: see _gat_bwd — padded den rows are zero and invalid
        # slots clamp onto them.
        d_slot = jnp.maximum(rt[:, Ka + 1 : Ka + 2], _DENOM_EPS)
        s_slot = rt[:, Ka + 2 : Ka + 3]
        alpha = jnp.exp(jnp.maximum(l - m_slot, _EXP_FLOOR)) / d_slot
        g_slot = rt[:, Ka + 3 :]
        u = jnp.sum(g_slot * ct[:, Ka:], axis=-1, keepdims=True)
        dpre = alpha * (u - s_slot) * dact(pre)
        gp = _reduce_part(
            dpre * d2s, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="sum")
        gD1_parts.append(gp[: part.m_part])
    grad_D1 = (gD1_parts[0] if len(gD1_parts) == 1
               else jnp.concatenate(gD1_parts, 0))[:m]

    # Pass 4 (plan_t): [dB | grad_D2] in one (K+Ka)-wide reduce.
    KK = K + Ka
    gB_parts, gD2_parts = [], []
    for part in plan_t.parts:
        rt = jnp.take(
            _part_rows_slice(part, col_tbl), _slot_rows(part), axis=0
        )
        ct = _tile_gather(part, row_tbl)
        d2s, d1s = rt[:, :Ka], ct[:, :Ka]
        pre = jnp.sum(d1s * d2s, axis=-1, keepdims=True)
        l = pre if slope is None else _leaky(pre, slope)
        m_slot = ct[:, Ka : Ka + 1]
        d_slot = jnp.maximum(ct[:, Ka + 1 : Ka + 2], _DENOM_EPS)
        s_slot = ct[:, Ka + 2 : Ka + 3]
        alpha = jnp.exp(jnp.maximum(l - m_slot, _EXP_FLOOR)) / d_slot
        b_slot = rt[:, Ka:]
        g_slot = ct[:, Ka + 3 :]
        u = jnp.sum(g_slot * b_slot, axis=-1, keepdims=True)
        dpre = alpha * (u - s_slot) * dact(pre)
        stream = jnp.concatenate([alpha * g_slot, dpre * d1s], axis=1)
        res_p = _reduce_part(
            stream, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="sum")
        gB_parts.append(res_p[: part.m_part, :K])
        gD2_parts.append(res_p[: part.m_part, K : KK])
    grad_B = (gB_parts[0] if len(gB_parts) == 1
              else jnp.concatenate(gB_parts, 0))[:n]
    grad_D2 = (gD2_parts[0] if len(gD2_parts) == 1
               else jnp.concatenate(gD2_parts, 0))[:n]
    return (None, None, grad_D1.astype(D1.dtype),
            grad_D2.astype(D2.dtype), grad_B.astype(B.dtype))


_dot_core.defvjp(_dot_fwd, _dot_bwd)


def dot_attention_aggregate(
    adj,
    D1: Array,
    D2: Array,
    B: Array,
    *,
    negative_slope: Optional[float] = None,
) -> Array:
    """out[r] = Σ_c softmax_c(act(D1[r]·D2[c])) · B[c] over the edge
    pattern — fused dot-product (transformer-style) graph attention.

    The SDDMM logits, the softmax, and the weighted aggregate all stay
    in slot order (the SDDMM consumer that "accepts slot order" and so
    never pays `sddmm_tiled`'s CSR back-permute).  ``act`` is identity
    (default) or leaky-relu when ``negative_slope`` is given.
    D1: (m, Ka); D2: (n, Ka); B: (n, K).  Differentiable w.r.t. all
    three (custom VJP; grads to D1/D2 are the attention-weighted SDDMM
    duals, fused into the same stream passes).
    """
    plan, plan_t = adj.plan, adj.plan_t
    if not (isinstance(plan, TiledSpmmPlan)
            and isinstance(plan_t, TiledSpmmPlan)):
        raise ValueError(
            "dot_attention_aggregate needs Adjacency.from_csr(csr, "
            "plan=True) (tiled stream plans for both directions)"
        )
    if D1.ndim != 2 or D2.ndim != 2 or D1.shape[1] != D2.shape[1]:
        raise ValueError(f"D1 {D1.shape} / D2 {D2.shape} must be (m,Ka)/(n,Ka)")
    if D1.shape[0] != plan.shape[0] or D2.shape[0] != plan.shape[1]:
        raise ValueError(
            f"D1/D2 rows {D1.shape[0]}/{D2.shape[0]} must match the "
            f"pattern {plan.shape}"
        )
    if B.ndim != 2 or B.shape[0] != plan.shape[1]:
        raise ValueError(f"B must be ({plan.shape[1]}, K), got {B.shape}")
    slope = None if negative_slope is None else float(negative_slope)
    return _dot_core(slope, plan, plan_t, D1, D2, B)


def gat_attention_aggregate(
    adj,
    src_score: Array,
    dst_score: Array,
    B: Array,
    *,
    negative_slope: float = 0.2,
    max_mode: str = "exact",
    heads: int = 1,
) -> Array:
    """out[r] = Σ_c softmax_c(leaky(src[r]+dst[c])) · B[c] over the edge
    pattern — the whole GATv1 attention layer as one fused op.

    Needs an ``Adjacency`` with tiled plans (``plan=True``).
    ``src_score``: (m,) or (m, H); ``dst_score``: (n,) or (n, H);
    ``B``: (n, H·dh) in head blocks (``heads`` = H).  ALL heads batch
    into one K=H max pass and one (H·dh + H)-wide aggregate instead of a
    per-head loop.  Differentiable
    w.r.t. all three tensors (custom VJP above).
    ``max_mode``: "exact" (per-row max via a K=H stream pass) or
    "bound" (O(n) shift via src[r]+max(dst) per head; exact alphas
    while the dst-score dynamic range is under ~80 — see _forward).
    """
    plan, plan_t = adj.plan, adj.plan_t
    if not (isinstance(plan, TiledSpmmPlan)
            and isinstance(plan_t, TiledSpmmPlan)):
        raise ValueError(
            "gat_attention_aggregate needs Adjacency.from_csr(csr, "
            "plan=True) (tiled stream plans for both directions)"
        )
    src2 = src_score[:, None] if src_score.ndim == 1 else src_score
    dst2 = dst_score[:, None] if dst_score.ndim == 1 else dst_score
    H = int(heads)
    if src2.shape != (plan.shape[0], H) or dst2.shape != (plan.shape[1], H):
        raise ValueError(
            f"score shapes {src_score.shape}/{dst_score.shape} must be "
            f"({plan.shape[0]}, {H})/({plan.shape[1]}, {H}) for "
            f"heads={H} (1-D accepted when heads=1; single head means "
            f"heads=1)"
        )
    if B.ndim != 2 or B.shape[0] != plan.shape[1] or B.shape[1] % H:
        raise ValueError(
            f"B must be ({plan.shape[1]}, {H}*dh), got {B.shape}"
        )
    if max_mode not in ("exact", "bound"):
        raise ValueError(f"max_mode must be exact|bound, got {max_mode!r}")
    return _gat_core(float(negative_slope), str(max_mode), H, plan, plan_t,
                     src2, dst2, B)

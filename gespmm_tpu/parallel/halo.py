"""Halo-exchange distributed SpMM: exchange only the needed remote rows.

Round 1's `dist_spmm` all-gathers the ENTIRE dense operand onto every
device — per-chip memory O(n·K) regardless of shard count, which caps the
graph size at the single-chip limit.  This module is the scalable design
(SURVEY §5.8): a host pre-pass computes, per shard pair (q → p), the sorted
unique set of B rows that shard p's edges actually touch in shard q's
range; at step time each shard gathers exactly those rows and a schedule
of `ppermute` rounds delivers them.  Per-chip footprint becomes
n/P·K + halo·K, where halo = Σ_r H_r is graph-locality-dependent
(assertable — see `HaloPartition.halo_rows`).

The exchange is RAGGED per round (round 3; was one padded `all_to_all`
with a single global H): round r ships shard q's rows to shard (q+r)%P,
padded only to that round's own maximum H_r = max_q |need[(q+r)%P][q]|.
One hub-heavy pair therefore inflates only its own round, not all P²
pairs, the send-index memory is P·ΣH_r instead of P²·H, and empty rounds
are dropped at trace time.  (`jax.lax.ragged_all_to_all` would express
this as one collective but does not lower on XLA:CPU, which the virtual
test mesh and the multi-chip dryrun require.)

This is the collective re-expression of the Gunrock scatter pattern
(`gunrock-test/app/spmm/spmm_enactor.cuh:92-105`): what the GPU baseline
does with per-edge atomicAdd into remote destinations becomes one
precomputed index exchange riding the interconnect (NCCL over NVLink on
GPUs).

Structure per shard (row slab p):
  A_p = [A_diag | A_halo]   — columns split by ownership:
  * A_diag: columns owned by p, remapped to the local B shard [0, cpp);
  * A_halo: remote columns, remapped into the received halo table
    [0, ΣH_r) at position (round_offset[(p-q)%P] + rank-in-need-set).
  out_p = A_diag @ B_p  +  A_halo @ halo_p
The diagonal SpMM takes only B_p — it has NO data dependency on any
exchange round by construction — which is the precondition XLA's
latency-hiding scheduler needs to overlap it with the collective on
hardware (the asynchronous collective-permute is split into start/done
pairs and independent compute is scheduled between them; the virtual CPU
mesh lowers a synchronous collective-permute, so overlap itself is not
observable there and is NOT asserted — only the dependency structure
is).  Backward is fully automatic for the XLA tier
(gather/ppermute/concat all have transposes) and rides a custom-VJP
pair over the tiled slot layout for the tiled tier — including
edge-value gradients: edge values are RUNTIME arrays fetched through
per-slot indices, so sharded attention-style models can train on it.

Reduction monoids: sum/mean for both tiers; max/min on the XLA tier
(identity-aware combine across the diag/halo split).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gespmm_tpu.sparse.formats import CSR
from gespmm_tpu.ops import reference as ref

Array = jax.Array

# ---------------------------------------------------------------------------
# Uniform per-shard tiled plans (one traced program serves all shards)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalTiledCfg:
    """Static layout of a uniform per-shard stream plan (hashable)."""

    tile_slices: Tuple  # ((col0, ncols, slot0, slot1), ...)
    m_pad: int
    rows_per_block: int
    chunk_nnz: int
    out_rows: int
    nnz_pad: int  # width of the per-shard edge-data array (src sentinel)
    with_vals: bool = False  # apply a runtime edge-value array?
    heads: int = 1  # runtime edge values per edge (head-blocked B)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LocalTiledArrays:
    """Stacked per-shard plan arrays (leading axis = shards).

    ``src`` maps each slot to its edge's index in the shard's LOCAL
    edge-data array (diag/halo block, forward edge order); sentinel =
    nnz_pad (out of bounds — reads 0 via take(mode="fill")).  Edge
    values are fetched through it at RUNTIME, so one structural plan
    serves every value of differentiable edge weights.
    """

    lcols: Array  # (P, S)
    local_rows: Array  # (P, C, E)
    row_start: Array  # (P, C)
    src: Array  # (P, S)

    def tree_flatten(self):
        return (self.lcols, self.local_rows, self.row_start, self.src), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _uniform_tiled_plans(
    slabs: List[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
    out_rows: int,
    table_rows: int,
    nnz_pad: int,
    col_tile: Optional[int] = None,
    rows_per_block: Optional[int] = None,
    chunk_nnz: int = 256,
    k_hint: int = 128,
) -> Tuple[LocalTiledCfg, LocalTiledArrays]:
    """Build one stream plan per local CSR slab, padded to a shared static
    layout (a `shard_map` requirement: one traced program, all shards).

    slabs: per shard (indptr, indices, src_map) of a local block with
    `out_rows` output rows and a `table_rows`-row gather table; src_map
    maps the slab's local edge order to the shard's edge-DATA order (for
    forward blocks that's arange, for transposed blocks the transpose
    permutation), or None for arange.
    """
    import types

    from gespmm_tpu.sparse.partition import build_tiled_plan, default_col_tile

    if col_tile is None:
        col_tile = default_col_tile(table_rows, k_hint)
    if rows_per_block is None:
        rows_per_block = max(-(-out_rows // 8) * 8, 8)
    E = int(chunk_nnz)

    plans = []
    for indptr, indices, _ in slabs:
        slab = types.SimpleNamespace(
            indptr=indptr, indices=indices, data=None,
            shape=(out_rows, table_rows), nnz=int(indices.shape[0]),
        )
        plan = build_tiled_plan(
            slab, col_tile=col_tile, rows_per_block=rows_per_block,
            chunk_nnz=E, part_rows=max(out_rows, 1), minmax_aligned=False,
        )
        plans.append(plan.parts[0])

    # Per column tile, pad every shard to the max chunk count.
    tile_ids = sorted(
        {c0 // col_tile for pp in plans for c0, _, _, _ in pp.tile_slices}
    ) or [0]
    per_tile = {}
    for t in tile_ids:
        cmax = 1
        for pp in plans:
            for c0, _, s0, s1 in pp.tile_slices:
                if c0 // col_tile == t:
                    cmax = max(cmax, (s1 - s0) // E)
        per_tile[t] = cmax
    C = sum(per_tile.values())
    S = C * E
    R = plans[0].rows_per_block
    m_pad = max(pp.m_pad for pp in plans)
    Pn = len(slabs)

    lcols = np.zeros((Pn, S), np.int32)
    local_rows = np.full((Pn, C, E), R, np.int32)
    row_start = np.zeros((Pn, C), np.int32)
    src_arr = np.full((Pn, S), nnz_pad, np.int32)  # sentinel -> fill 0
    tile_slices = []
    off = 0
    for t in tile_ids:
        ct = per_tile[t]
        col0 = t * col_tile
        ncols = min(col_tile, table_rows - col0)
        tile_slices.append((col0, ncols, off * E, (off + ct) * E))
        for p, pp in enumerate(plans):
            src_map = slabs[p][2]
            for c0, _, s0, s1 in pp.tile_slices:
                if c0 // col_tile != t:
                    continue
                nch = (s1 - s0) // E
                ch0 = s0 // E
                lcols[p, off * E : off * E + (s1 - s0)] = np.asarray(
                    pp.lcols[s0:s1]
                )
                local_rows[p, off : off + nch] = np.asarray(
                    pp.local_rows[ch0 : ch0 + nch]
                )
                row_start[p, off : off + nch] = np.asarray(
                    pp.row_start[ch0 : ch0 + nch]
                )
                src = np.asarray(pp.src[s0:s1])
                lr = np.asarray(pp.local_rows[ch0 : ch0 + nch]).reshape(-1)
                mapped = (
                    src if src_map is None or len(src_map) == 0
                    else src_map[np.minimum(src, len(src_map) - 1)]
                )
                src_arr[p, off * E : off * E + (s1 - s0)] = np.where(
                    lr < R, mapped, nnz_pad
                )
        off += ct

    cfg = LocalTiledCfg(
        tile_slices=tuple(tile_slices),
        m_pad=m_pad,
        rows_per_block=R,
        chunk_nnz=E,
        out_rows=out_rows,
        nnz_pad=nnz_pad,
    )
    arrays = LocalTiledArrays(
        lcols=jnp.asarray(lcols),
        local_rows=jnp.asarray(local_rows),
        row_start=jnp.asarray(row_start),
        src=jnp.asarray(src_arr),
    )
    return cfg, arrays


def _sliced_uniform_plans(
    slabs, out_rows: int, table_rows: int, nnz_pad: int,
    part_budget: Optional[int] = None, **kw,
):
    """Split a block's OUTPUT rows into windows of at most ``part_budget``
    rows (None: one window), building one uniform plan per window — the
    multi-part generalization of the single-part `_uniform_tiled_plans`.
    Returns (cfgs, arrs) tuples of equal length; window i owns output rows
    [i·w, min((i+1)·w, out_rows)).
    """
    budget = part_budget if part_budget is not None else max(out_rows, 1)
    if out_rows <= budget:
        cfg, arr = _uniform_tiled_plans(slabs, out_rows, table_rows,
                                        nnz_pad, **kw)
        return (cfg,), (arr,)
    n_slices = -(-out_rows // budget)
    w = -(-out_rows // n_slices)
    # 8-aligned windows keep the kernel's row tiles; align DOWN (clamped
    # to the budget) so a user-passed part_budget is a true ceiling — an
    # upward alignment could exceed it by up to 7 rows.
    w = min(-(-w // 8) * 8, (budget // 8) * 8)
    w = max(w, 8)
    cfgs, arrs = [], []
    for r0 in range(0, out_rows, w):
        r1 = min(r0 + w, out_rows)
        sub = []
        for indptr, indices, src_map in slabs:
            s, e = int(indptr[r0]), int(indptr[r1])
            sub_ip = (indptr[r0 : r1 + 1] - indptr[r0]).astype(np.int32)
            sub_ind = indices[s:e]
            # Edge DATA stays indexed in the shard's FULL edge order, so
            # an implicit (None) map must become the slice's offset range.
            sub_map = (
                np.arange(s, e, dtype=np.int32)
                if src_map is None else src_map[s:e]
            )
            sub.append((sub_ip, sub_ind, sub_map))
        cfg, arr = _uniform_tiled_plans(sub, r1 - r0, table_rows,
                                        nnz_pad, **kw)
        cfgs.append(cfg)
        arrs.append(arr)
    return tuple(cfgs), tuple(arrs)


# ---------------------------------------------------------------------------
# Local tiled SpMM with custom VJP (runs inside shard_map)
# ---------------------------------------------------------------------------


def _gather_slots(cfg: LocalTiledCfg, lcols, B32):
    pieces = [
        jnp.take(B32[c0 : c0 + nc], lcols[s0:s1], axis=0)
        for c0, nc, s0, s1 in cfg.tile_slices
    ]
    return pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, 0)


def _block_contrib(cfg: LocalTiledCfg, lcols, src, edata, B32):
    """Per-slot contribution stream: tile-gather of B32 rows, scaled by
    runtime edge values fetched through ``src`` when the cfg carries
    them.  Shared by the sum forward, the minmax forward, and the minmax
    backward's bitwise-exact achievement recompute."""
    contrib = _gather_slots(cfg, lcols, B32)
    if cfg.with_vals:
        K = B32.shape[1]
        v = jnp.take(edata.astype(jnp.float32), src, axis=0, mode="fill",
                     fill_value=0.0)
        if cfg.heads > 1:
            # Head-blocked B: per-head edge values (nnz_pad, H) repeat
            # across each head's dh feature columns.
            v = jnp.repeat(v, K // cfg.heads, axis=1)
            if v.shape[1] < contrib.shape[1]:  # K padding columns
                v = jnp.pad(v, ((0, 0), (0, contrib.shape[1] - v.shape[1])))
            contrib = contrib * v
        else:
            contrib = contrib * v[:, None]
    return contrib


def _tiled_apply(cfg: LocalTiledCfg, lcols, local_rows, row_start, src,
                 edata, B):
    """One shard's tiled SpMM over its uniform plan slice.

    ``edata``: (nnz_pad,) runtime edge values in the shard's local edge
    order, fetched per slot through ``src`` — or ignored when the cfg
    says the block is binary."""
    from gespmm_tpu.kernels.spmm_stream import _reduce_part

    contrib = _block_contrib(cfg, lcols, src, edata, B.astype(jnp.float32))
    out = _reduce_part(
        contrib, local_rows, row_start, cfg.m_pad, cfg.rows_per_block,
        op="sum",
    )
    return out[: cfg.out_rows].astype(B.dtype)


def _apply_slices(cfgs, arrs, edata, B):
    """Concatenate the per-window SpMMs of a (possibly multi-window)
    block."""
    outs = [
        _tiled_apply(c, a.lcols, a.local_rows, a.row_start, a.src, edata, B)
        for c, a in zip(cfgs, arrs)
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, 0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _local_tiled(cfgs_f, cfgs_b, arrs_f, arrs_b, edata, B):
    """Differentiable per-shard tiled SpMM (``cfgs``/``arrs`` are
    per-output-window tuples).  Backward w.r.t. B runs the transposed
    local block through the same kernel; backward w.r.t. the runtime
    edge values is the per-slot SDDMM dual grad_val[e] =
    Σ_k g[row_e]·B[col_e] scattered through ``src``."""
    return _apply_slices(cfgs_f, arrs_f, edata, B)


def _local_tiled_fwd(cfgs_f, cfgs_b, arrs_f, arrs_b, edata, B):
    out = _apply_slices(cfgs_f, arrs_f, edata, B)
    return out, (arrs_f, arrs_b, edata, B)


def _local_tiled_bwd(cfgs_f, cfgs_b, res, g):
    arrs_f, arrs_b, edata, B = res
    # Each backward window's gather table is the FULL forward output
    # (cfg_b.tile_slices index into g), so grad_B windows concatenate to
    # B's shape; cotangent dtype matches B's.
    grad_B = _apply_slices(cfgs_b, arrs_b, edata, g)
    zeros = (None, None)
    if not cfgs_f[0].with_vals:
        return zeros + (jnp.zeros_like(edata), grad_B)
    # grad_val in the forward slot layout: b_slot · g_slot summed over
    # each head's feature block (all of K when heads == 1); forward
    # windows own disjoint edge sets, so per-window scatter-sets compose.
    H = cfgs_f[0].heads
    trail = () if H == 1 else (H,)
    gd = jnp.zeros((cfgs_f[0].nnz_pad + 1,) + trail, jnp.float32)
    B32 = B.astype(jnp.float32)
    off = 0
    for cfg_f, af in zip(cfgs_f, arrs_f):
        g32 = g[off : off + cfg_f.out_rows].astype(jnp.float32)
        off += cfg_f.out_rows
        if g32.shape[0] < cfg_f.m_pad:
            g32 = jnp.pad(g32, ((0, cfg_f.m_pad - g32.shape[0]), (0, 0)))
        b_slot = _gather_slots(cfg_f, af.lcols, B32)
        R = cfg_f.rows_per_block
        slot_rows = jnp.minimum(
            (af.row_start[:, None] + af.local_rows).reshape(-1),
            cfg_f.m_pad - 1,
        )
        g_slot = jnp.take(g32, slot_rows, axis=0)
        if H > 1:
            S = b_slot.shape[0]
            dh = B.shape[1] // H
            prod = jnp.sum(
                (b_slot * g_slot).reshape(S, H, dh), axis=-1
            )  # (S, H)
        else:
            prod = jnp.sum(b_slot * g_slot, axis=-1)
        valid = (af.local_rows < R).reshape(-1)
        gd = gd.at[jnp.where(valid, af.src, cfg_f.nnz_pad)].set(prod)
    grad_edata = gd[: edata.shape[0]].astype(edata.dtype)
    return zeros + (grad_edata, grad_B)


_local_tiled.defvjp(_local_tiled_fwd, _local_tiled_bwd)


# ---------------------------------------------------------------------------
# Local tiled max/min with joint diag+halo tie semantics (inside shard_map)
# ---------------------------------------------------------------------------


def _minmax_block_raw(op, cfg, arr, edata, B, want_ties):
    """One block window's raw max/min reduction (±inf identities kept),
    optionally with the tie counts."""
    from gespmm_tpu.kernels.spmm_stream import _reduce_part

    contrib = _block_contrib(cfg, arr.lcols, arr.src, edata,
                             B.astype(jnp.float32))
    return _reduce_part(
        contrib, arr.local_rows, arr.row_start, cfg.m_pad,
        cfg.rows_per_block, op=op, want_ties=want_ties,
    )


def _minmax_fwd_raw(op, cfgs_df, cfgs_hf, arrs_df, arrs_hf,
                    dv, hv, B_shard, halo_tbl, want_ties):
    """Joint diag+halo raw extremum per output window, concatenated.
    The diag and halo forward blocks share the same window boundaries
    (both slice the shard's rpp output rows under the same budget)."""
    fold = jnp.maximum if op == "max" else jnp.minimum
    K = B_shard.shape[1]
    raws, ties = [], []
    for cfg_d, cfg_h, ad, ah in zip(cfgs_df, cfgs_hf, arrs_df, arrs_hf):
        rows = cfg_d.out_rows
        rd = _minmax_block_raw(op, cfg_d, ad, dv, B_shard, want_ties)
        rh = _minmax_block_raw(op, cfg_h, ah, hv, halo_tbl, want_ties)
        if want_ties:
            (od, td), (oh, th) = rd, rh
        else:
            od, oh = rd, rh
        raw = fold(od[:rows, :K], oh[:rows, :K])
        raws.append(raw)
        if want_ties:
            # Joint tie counts: a block's achievers achieve the joint
            # extremum iff the block's extremum equals it (empty blocks
            # hold ±inf and never match a finite joint value).
            ties.append(
                jnp.where(od[:rows, :K] == raw, td[:rows, :K], 0.0)
                + jnp.where(oh[:rows, :K] == raw, th[:rows, :K], 0.0)
            )
    raw = raws[0] if len(raws) == 1 else jnp.concatenate(raws, 0)
    if not want_ties:
        return raw
    return raw, ties[0] if len(ties) == 1 else jnp.concatenate(ties, 0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4))
def _local_tiled_minmax(op, cfgs_df, cfgs_db, cfgs_hf, cfgs_hb,
                        arrs_df, arrs_db, arrs_hf, arrs_hb,
                        dv, hv, B_shard, halo_tbl):
    """Per-shard max/min SpMM over the diag + halo blocks with JOINT
    even tie-splitting (matching jnp.max's VJP across ALL achieving
    edges of a row, not per block) — the distributed counterpart of
    `spmm_minmax_vjp_tiled`.  ≙ the reference's max kernel family
    (`dgl-custom/binary_reduce_max.cu:18-207`) in the sharded regime.
    """
    raw = _minmax_fwd_raw(op, cfgs_df, cfgs_hf, arrs_df, arrs_hf,
                          dv, hv, B_shard, halo_tbl, False)
    out = jnp.where(jnp.isfinite(raw), raw, 0.0)
    return out.astype(B_shard.dtype)


def _local_tiled_minmax_fwd(op, cfgs_df, cfgs_db, cfgs_hf, cfgs_hb,
                            arrs_df, arrs_db, arrs_hf, arrs_hb,
                            dv, hv, B_shard, halo_tbl):
    raw, ties = _minmax_fwd_raw(op, cfgs_df, cfgs_hf, arrs_df, arrs_hf,
                                dv, hv, B_shard, halo_tbl, True)
    out = jnp.where(jnp.isfinite(raw), raw, 0.0)
    res = (arrs_df, arrs_db, arrs_hf, arrs_hb, dv, hv, B_shard, halo_tbl,
           out, ties)
    return out.astype(B_shard.dtype), res


def _minmax_bwd_block(op, cfg_b, arr_b, edata, B, out_tbl, gt_tbl):
    """grad wrt one block window's gather table via the TRANSPOSED plan.

    Per transpose slot (output row = a forward table row c, gathered row
    = a forward output row r): recompute the forward contribution
    val_e·B[c] bitwise-exactly, test it against the joint extremum
    out[r], and stream w = 1[achieves]·g[r]/ties[r] (already folded into
    ``gt_tbl``) back: grad_B[c] += val_e·w; grad_val[e] = Σ_k w·B[c].
    Mirrors `spmm_minmax_vjp_tiled` phase 2.
    """
    from gespmm_tpu.kernels.spmm_stream import _reduce_part

    K = B.shape[1]
    # ``B`` here is the WINDOW's slice of the block's gather table (the
    # transpose window's output rows are window-local).
    B32 = B.astype(jnp.float32)
    if B32.shape[0] < cfg_b.m_pad:
        B32 = jnp.pad(B32, ((0, cfg_b.m_pad - B32.shape[0]), (0, 0)))
    # ONE combined row-space table per pass: [out | g/ties] (one per-slot
    # gather instead of two).
    og = jnp.concatenate([out_tbl, gt_tbl], axis=1)
    og_slot = _gather_slots(cfg_b, arr_b.lcols, og)
    out_slot = og_slot[:, :K]
    gt_slot = og_slot[:, K:]
    slot_rows = jnp.minimum(
        (arr_b.row_start[:, None] + arr_b.local_rows).reshape(-1),
        cfg_b.m_pad - 1,
    )
    b_slot = jnp.take(B32, slot_rows, axis=0)
    if cfg_b.with_vals:
        v = jnp.take(edata.astype(jnp.float32), arr_b.src, axis=0,
                     mode="fill", fill_value=0.0)
        contrib = b_slot * v[:, None]
    else:
        v = None
        contrib = b_slot
    valid = (arr_b.local_rows < cfg_b.rows_per_block).reshape(-1)
    eq = (contrib == out_slot) & valid[:, None]
    w = jnp.where(eq, gt_slot, 0.0)
    stream = w if v is None else w * v[:, None]
    gb = _reduce_part(
        stream, arr_b.local_rows, arr_b.row_start, cfg_b.m_pad,
        cfg_b.rows_per_block, op="sum",
    )
    grad_B = gb[: cfg_b.out_rows].astype(B.dtype)
    prod_scatter = None
    if cfg_b.with_vals:
        prod = jnp.sum(w * b_slot, axis=-1)
        prod_scatter = (jnp.where(valid, arr_b.src, cfg_b.nnz_pad), prod)
    return grad_B, prod_scatter


def _minmax_bwd_slices(op, cfgs_b, arrs_b, edata, B, out_tbl, gt_tbl):
    """grad wrt a block's gather table: transpose windows concatenate;
    edge-value grads scatter per window (disjoint edge sets)."""
    gbs = []
    gd = (
        jnp.zeros((cfgs_b[0].nnz_pad + 1,), jnp.float32)
        if cfgs_b[0].with_vals else None
    )
    off = 0
    for cfg_b, arr_b in zip(cfgs_b, arrs_b):
        gb, ps = _minmax_bwd_block(op, cfg_b, arr_b, edata,
                                   B[off : off + cfg_b.out_rows],
                                   out_tbl, gt_tbl)
        off += cfg_b.out_rows
        gbs.append(gb)
        if ps is not None:
            gd = gd.at[ps[0]].set(ps[1])
    grad_B = gbs[0] if len(gbs) == 1 else jnp.concatenate(gbs, 0)
    grad_edata = (
        None if gd is None else gd[: edata.shape[0]].astype(edata.dtype)
    )
    return grad_B, grad_edata


def _local_tiled_minmax_bwd(op, cfgs_df, cfgs_db, cfgs_hf, cfgs_hb, res, g):
    (arrs_df, arrs_db, arrs_hf, arrs_hb, dv, hv, B_shard, halo_tbl,
     out, ties) = res
    gt = g.astype(jnp.float32) / jnp.maximum(ties, 1.0)
    grad_B, gdv = _minmax_bwd_slices(
        op, cfgs_db, arrs_db, dv, B_shard, out, gt
    )
    grad_halo, ghv = _minmax_bwd_slices(
        op, cfgs_hb, arrs_hb, hv, halo_tbl, out, gt
    )
    return (None, None, None, None,
            gdv if gdv is not None else jnp.zeros_like(dv),
            ghv if ghv is not None else jnp.zeros_like(hv),
            grad_B, grad_halo)


_local_tiled_minmax.defvjp(_local_tiled_minmax_fwd, _local_tiled_minmax_bwd)


# ---------------------------------------------------------------------------
# Halo partition (host pre-pass)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Row-slab partition with per-shard diag/halo splits + ragged
    exchange schedule.

    Arrays (P shards):
      send_idx:   (P, ΣH_r) int32 — shard q's B-shard-local rows to send,
                  concatenated per round (pad -> 0); round r's slice goes
                  to shard (q+r)%P.
      diag_*:     per-shard CSR over local columns [0, cpp).
      halo_*:     per-shard CSR over the received halo table [0, ΣH_r).
      diag_src / halo_src: (P, max_nnz) int32 GLOBAL CSR edge id of each
                  local edge (sentinel -1) — the runtime edge-value
                  split rides these (`split_edge_values`).
      deg:        (P, rpp) f32 — TOTAL row degree (for mean).
    Static: shape (m, n), rpp, cpp, rounds ((r, H_r) per nonzero round),
      H = max H_r; optional uniform tiled plans for diag/halo
      forward+backward (the differentiable stream tier).
    """

    send_idx: Array
    diag_indptr: Array
    diag_indices: Array
    diag_data: Optional[Array]
    diag_mask: Array
    diag_src: Array
    halo_indptr: Array
    halo_indices: Array
    halo_data: Optional[Array]
    halo_mask: Array
    halo_src: Array
    deg: Array
    shape: Tuple[int, int]
    rpp: int
    cpp: int
    rounds: Tuple[Tuple[int, int], ...]
    tiled_cfgs: Optional[Tuple[LocalTiledCfg, ...]] = None
    tiled_arrays: Optional[Tuple[LocalTiledArrays, ...]] = None

    def tree_flatten(self):
        arrays = (
            self.send_idx, self.diag_indptr, self.diag_indices,
            self.diag_data, self.diag_mask, self.diag_src,
            self.halo_indptr, self.halo_indices, self.halo_data,
            self.halo_mask, self.halo_src, self.deg, self.tiled_arrays,
        )
        aux = (self.shape, self.rpp, self.cpp, self.rounds, self.tiled_cfgs)
        return arrays, aux

    @classmethod
    def tree_unflatten(cls, aux, arrays):
        (send_idx, dip, dii, did, dim_, dsr, hip, hii, hid, him, hsr, deg,
         tarr) = arrays
        shape, rpp, cpp, rounds, tcfg = aux
        return cls(send_idx, dip, dii, did, dim_, dsr, hip, hii, hid, him,
                   hsr, deg, shape, rpp, cpp, rounds, tcfg, tarr)

    @property
    def num_parts(self) -> int:
        return int(self.send_idx.shape[0])

    @property
    def H(self) -> int:
        """Largest per-round (= per-pair, 8-aligned) halo block."""
        return max((h for _, h in self.rounds), default=0)

    @property
    def halo_rows(self) -> int:
        """Halo-table rows per shard — the communicated footprint.

        Per-shard dense memory is (cpp + halo_rows)·K·4 bytes, vs n·K·4
        for the all-gather formulation.  Ragged: Σ_r H_r (was P·H)."""
        return max(sum(h for _, h in self.rounds), 8)

    @property
    def footprint_fraction(self) -> float:
        """(local + halo) rows / total rows — 1/P + halo share."""
        return (self.cpp + self.halo_rows) / max(self.shape[1], 1)


def _transpose_local(indptr, indices, src_map, rows_out, rows_of_edge):
    """CSC ordering of a local block (host): returns (indptr_t, indices_t,
    src_map_t) with `rows_out` output rows (= the block's column count).
    src_map_t maps the transposed edge order back to the FORWARD local
    edge order (composing any given src_map)."""
    order = np.argsort(indices, kind="stable")
    ind_t = rows_of_edge[order].astype(np.int32)
    ptr_t = np.zeros(rows_out + 1, np.int64)
    np.add.at(ptr_t, indices + 1, 1)
    ptr_t = np.cumsum(ptr_t).astype(np.int32)
    m_t = order.astype(np.int32) if src_map is None else src_map[order]
    return ptr_t, ind_t, m_t


def build_halo_partition(
    csr: CSR,
    num_parts: int,
    *,
    tiled: bool = True,
    chunk_nnz: int = 256,
    col_tile: Optional[int] = None,
    rows_per_block: Optional[int] = None,
    part_budget_rows: Optional[int] = None,
) -> HaloPartition:
    """Host pre-pass: slab rows, split columns by ownership, compute the
    ragged per-round halo schedule, remap, and (optionally) build the
    uniform stream plans for the differentiable tiled tier."""
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    data = None if csr.data is None else np.asarray(csr.data)
    m, n = csr.shape
    Pn = num_parts
    rpp = -(-m // Pn)
    cpp = -(-n // Pn)
    rows_all = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))

    # Pass 1: per shard, split edges and collect need-sets.
    shard_edges = []  # (lrows, cols, vals, owner, gids) for each shard
    need = [[None] * Pn for _ in range(Pn)]  # need[p][q] sorted unique cols
    for p in range(Pn):
        r0, r1 = p * rpp, min((p + 1) * rpp, m)
        s, e = int(indptr[min(r0, m)]), int(indptr[min(r1, m)])
        lrows = rows_all[s:e] - r0
        cols = indices[s:e]
        vals = None if data is None else data[s:e]
        owner = cols // cpp
        gids = np.arange(s, e, dtype=np.int32)
        shard_edges.append((lrows, cols, vals, owner, gids))
        for q in range(Pn):
            if q == p:
                continue
            need[p][q] = np.unique(cols[owner == q])

    # Ragged round schedule: round r ships q -> (q+r)%P; its size is the
    # max need over the P pairs IN THAT ROUND only (8-aligned).
    rounds: List[Tuple[int, int]] = []
    for r in range(1, Pn):
        Hr = max(
            (len(need[(q + r) % Pn][q]) for q in range(Pn)
             if need[(q + r) % Pn][q] is not None),
            default=0,
        )
        if Hr > 0:
            rounds.append((r, -(-Hr // 8) * 8))
    S_send = max(sum(h for _, h in rounds), 1)
    round_off = {}
    off = 0
    for r, h in rounds:
        round_off[r] = off
        off += h

    send_idx = np.zeros((Pn, S_send), np.int32)
    for q in range(Pn):
        for r, h in rounds:
            p = (q + r) % Pn
            cq = need[p][q]
            if cq is None or len(cq) == 0:
                continue
            o = round_off[r]
            send_idx[q, o : o + len(cq)] = cq - q * cpp

    # Pass 2: build local diag/halo CSRs (+ padded stacks + transposes).
    def stack_csrs(blocks, rows):
        max_nnz = max(max((b[1].shape[0] for b in blocks), default=1), 1)
        ip = np.zeros((Pn, rows + 1), np.int32)
        ii = np.zeros((Pn, max_nnz), np.int32)
        msk = np.zeros((Pn, max_nnz), bool)
        gsr = np.full((Pn, max_nnz), -1, np.int32)
        dd = (
            np.zeros((Pn, max_nnz), np.float32)
            if any(b[2] is not None for b in blocks)
            else None
        )
        for p, (lp, li, ld, lg) in enumerate(blocks):
            ip[p, : lp.shape[0]] = lp
            if lp.shape[0] < rows + 1:
                ip[p, lp.shape[0]:] = lp[-1]
            ii[p, : li.shape[0]] = li
            msk[p, : li.shape[0]] = True
            gsr[p, : lg.shape[0]] = lg
            if dd is not None and ld is not None:
                dd[p, : li.shape[0]] = ld
        return ip, ii, dd, msk, gsr, max_nnz

    def local_csr(lrows, lcols, lvals, lgids, rows):
        counts = np.bincount(lrows, minlength=rows)
        lp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        return lp, lcols.astype(np.int32), lvals, lgids

    halo_tbl_rows = max(sum(h for _, h in rounds), 8)
    diag_blocks, halo_blocks = [], []
    diag_t_blocks, halo_t_blocks = [], []
    deg = np.zeros((Pn, rpp), np.float32)
    for p in range(Pn):
        lrows, cols, vals, owner, gids = shard_edges[p]
        np.add.at(deg[p], lrows, 1.0)
        is_diag = owner == p
        # diag block: local column ids
        dr, dc = lrows[is_diag], (cols - p * cpp)[is_diag]
        dv = None if vals is None else vals[is_diag]
        dg = gids[is_diag]
        order = np.argsort(dr, kind="stable")  # rows must be sorted
        dr, dc, dg = dr[order], dc[order], dg[order]
        dv = None if dv is None else dv[order]
        diag_blocks.append(local_csr(dr, dc, dv, dg, rpp))
        diag_t_blocks.append(
            _transpose_local(diag_blocks[-1][0], diag_blocks[-1][1], None,
                             cpp, dr)
            if len(dr) else
            (np.zeros(cpp + 1, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.int32))
        )
        # halo block: remap remote cols to round_offset + rank
        hr_mask = ~is_diag
        hr, hc_g, ho = lrows[hr_mask], cols[hr_mask], owner[hr_mask]
        hv = None if vals is None else vals[hr_mask]
        hg = gids[hr_mask]
        hc = np.zeros_like(hc_g)
        for q in range(Pn):
            if q == p:
                continue
            sel = ho == q
            if not sel.any():
                continue
            r = (p - q) % Pn
            hc[sel] = round_off[r] + np.searchsorted(need[p][q], hc_g[sel])
        order = np.argsort(hr, kind="stable")
        hr, hc, hg = hr[order], hc[order], hg[order]
        hv = None if hv is None else hv[order]
        halo_blocks.append(local_csr(hr, hc, hv, hg, rpp))
        halo_t_blocks.append(
            _transpose_local(halo_blocks[-1][0], halo_blocks[-1][1], None,
                             halo_tbl_rows, hr)
            if len(hr) else
            (np.zeros(halo_tbl_rows + 1, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.int32))
        )

    dip, dii, did, dim_, dsr, d_nnz = stack_csrs(diag_blocks, rpp)
    hip, hii, hid, him, hsr, h_nnz = stack_csrs(halo_blocks, rpp)

    tiled_cfgs = tiled_arrays = None
    if tiled:
        slabs_df = [(b[0], b[1], None) for b in diag_blocks]
        slabs_db = [(b[0], b[1], b[2]) for b in diag_t_blocks]
        slabs_hf = [(b[0], b[1], None) for b in halo_blocks]
        slabs_hb = [(b[0], b[1], b[2]) for b in halo_t_blocks]
        kw = dict(col_tile=col_tile, rows_per_block=rows_per_block,
                  chunk_nnz=chunk_nnz, part_budget=part_budget_rows)
        cfg_df, arr_df = _sliced_uniform_plans(slabs_df, rpp, cpp, d_nnz, **kw)
        cfg_db, arr_db = _sliced_uniform_plans(slabs_db, cpp, rpp, d_nnz, **kw)
        cfg_hf, arr_hf = _sliced_uniform_plans(
            slabs_hf, rpp, halo_tbl_rows, h_nnz, **kw)
        cfg_hb, arr_hb = _sliced_uniform_plans(
            slabs_hb, halo_tbl_rows, rpp, h_nnz, **kw)
        has_data = data is not None
        tiled_cfgs = tuple(
            tuple(dataclasses.replace(c, with_vals=has_data) for c in cs)
            for cs in (cfg_df, cfg_db, cfg_hf, cfg_hb)
        )
        tiled_arrays = (arr_df, arr_db, arr_hf, arr_hb)

    return HaloPartition(
        send_idx=jnp.asarray(send_idx),
        diag_indptr=jnp.asarray(dip),
        diag_indices=jnp.asarray(dii),
        diag_data=None if did is None else jnp.asarray(did),
        diag_mask=jnp.asarray(dim_),
        diag_src=jnp.asarray(dsr),
        halo_indptr=jnp.asarray(hip),
        halo_indices=jnp.asarray(hii),
        halo_data=None if hid is None else jnp.asarray(hid),
        halo_mask=jnp.asarray(him),
        halo_src=jnp.asarray(hsr),
        deg=jnp.asarray(deg),
        shape=(m, n),
        rpp=rpp,
        cpp=cpp,
        rounds=tuple(rounds),
        tiled_cfgs=tiled_cfgs,
        tiled_arrays=tiled_arrays,
    )


def split_edge_values(hp: HaloPartition, vals: Array):
    """Split global CSR-ordered edge values into the per-shard stacked
    (diag_vals, halo_vals) runtime arrays the halo op consumes.

    Jittable and differentiable (gather; its transpose scatter-adds the
    per-shard cotangents back to CSR order) — the path by which sharded
    attention-style models feed per-step edge weights (e.g. softmaxed
    logits) into the distributed SpMM.
    """
    v = jnp.asarray(vals)
    dm = (hp.diag_src >= 0).astype(v.dtype)
    hm = (hp.halo_src >= 0).astype(v.dtype)
    if v.ndim == 2:  # (nnz, H) per-head values
        dm, hm = dm[..., None], hm[..., None]
    dv = jnp.take(v, jnp.maximum(hp.diag_src, 0), axis=0) * dm
    hv = jnp.take(v, jnp.maximum(hp.halo_src, 0), axis=0) * hm
    return dv, hv


# ---------------------------------------------------------------------------
# Runtime op
# ---------------------------------------------------------------------------


def make_exchange(hp: HaloPartition, axis: str):
    """Build the per-shard ragged halo-exchange closure (for shard_map
    bodies): gather all send rows once, then one ppermute per nonzero
    round (r ships q -> (q+r)%P).  The received blocks concatenate in
    round order — exactly the halo CSR's column layout.  Local diag
    compute has no data dependency on any round (see the module
    docstring for what that does and does not guarantee about overlap).
    Shared by halo_spmm and the sharded edge ops
    (`parallel.edge_ops`) so SDDMM/attention ride the identical
    schedule.  Differentiable (take + ppermute both transpose)."""
    Pn = hp.num_parts
    rounds = hp.rounds
    halo_tbl_rows = hp.halo_rows
    round_off = {}
    off = 0
    for r, h in rounds:
        round_off[r] = off
        off += h

    def exchange(send_idx, B_shard):
        K = B_shard.shape[1]
        if not rounds:
            return jnp.zeros((halo_tbl_rows, K), B_shard.dtype)
        req = jnp.take(B_shard, send_idx, axis=0)
        blocks = []
        for r, h in rounds:
            o = round_off[r]
            perm = [(q, (q + r) % Pn) for q in range(Pn)]
            blocks.append(
                jax.lax.ppermute(req[o : o + h], axis, perm=perm)
            )
        out = blocks[0] if len(blocks) == 1 else jnp.concatenate(blocks, 0)
        if out.shape[0] < halo_tbl_rows:
            out = jnp.pad(out, ((0, halo_tbl_rows - out.shape[0]), (0, 0)))
        return out

    return exchange


def _local_block_spmm(indptr, indices, data, mask, table, rows, reduce):
    """One local block (diag or halo) via the XLA tier; phantom-row
    padding keeps sentinel slots out of every monoid."""
    nnz_pad = indices.shape[0]
    vals = mask.astype(table.dtype) if data is None else data * mask
    indptr_ext = jnp.concatenate(
        [indptr, jnp.full((1,), nnz_pad, indptr.dtype)]
    )
    out = ref.spmm_xla(indptr_ext, indices, vals, table, reduce=reduce)
    return out[:rows]


def halo_spmm(
    hp: HaloPartition,
    B: Array,
    mesh: Mesh,
    *,
    reduce: str = "sum",
    method: str = "auto",
    axis: str = "data",
    model_axis: Optional[str] = "model",
    diag_vals: Optional[Array] = None,
    halo_vals: Optional[Array] = None,
) -> Array:
    """C = A @ B with A row-partitioned and B row-sharded over `axis`,
    exchanging ONLY the halo rows each shard needs (ragged ppermute
    rounds — see the module docstring).

    B: (num_parts*cpp, K) sharded P(axis, model_axis); result
    (num_parts*rpp, K) sharded the same.  Differentiable end-to-end on
    both tiers, INCLUDING edge values.

    diag_vals / halo_vals: optional (P, max_nnz) runtime edge-value
    stacks (from :func:`split_edge_values`) overriding the values baked
    at partition time — pass them to train edge-weighted models (both
    must be given together).

    method: "auto" (tiled whenever plans were built — every reduce rides
    the stream tier — else xla) | "tiled" | "xla".
    """
    if reduce not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown reduce {reduce!r}")
    Pn, rpp, cpp = hp.num_parts, hp.rpp, hp.cpp
    if B.shape[0] != Pn * cpp:
        raise ValueError(
            f"B must be padded to num_parts*cpp = {Pn * cpp} rows "
            f"(got {B.shape[0]}); pad with pad_for_halo()"
        )
    if (diag_vals is None) != (halo_vals is None):
        raise ValueError("pass diag_vals and halo_vals together")
    has_tiled = hp.tiled_cfgs is not None
    if method == "auto":
        method = "tiled" if has_tiled else "xla"
    if method == "tiled":
        if not has_tiled:
            raise ValueError(
                "method='tiled' needs build_halo_partition(tiled=True)"
            )
    model_in_mesh = model_axis if (model_axis in mesh.axis_names) else None

    base = reduce if reduce in ("max", "min") else "sum"
    rt_vals = diag_vals is not None
    dvals = diag_vals if rt_vals else hp.diag_data
    hvals = halo_vals if rt_vals else hp.halo_data
    has_dd = dvals is not None
    has_hd = hvals is not None
    exchange = make_exchange(hp, axis)

    def body_xla(send_idx, dip, dii, dd, dm, hip, hii, hd, hm, deg, B_shard):
        halo_tbl = exchange(send_idx[0], B_shard)
        od = _local_block_spmm(dip[0], dii[0], dd[0] if has_dd else None,
                               dm[0], B_shard, rpp, base)
        oh = _local_block_spmm(hip[0], hii[0], hd[0] if has_hd else None,
                               hm[0], halo_tbl, rpp, base)
        if base in ("max", "min"):
            ident = -jnp.inf if base == "max" else jnp.inf
            fold = jnp.maximum if base == "max" else jnp.minimum
            ddeg = (dip[0][1:] - dip[0][:-1])[:, None]
            hdeg = (hip[0][1:] - hip[0][:-1])[:, None]
            out = fold(
                jnp.where(ddeg > 0, od.astype(jnp.float32), ident),
                jnp.where(hdeg > 0, oh.astype(jnp.float32), ident),
            )
            out = jnp.where(jnp.isfinite(out), out, 0.0).astype(B_shard.dtype)
        else:
            out = od + oh
        if reduce == "mean":
            out = out / jnp.maximum(deg[0], 1.0)[:, None]
        return out

    def body_tiled(send_idx, deg, arr_df, arr_db, arr_hf, arr_hb,
                   dv, hv, B_shard):
        cfg_df, cfg_db, cfg_hf, cfg_hb = cfgs
        halo_tbl = exchange(send_idx[0], B_shard)

        def sla(arrs):
            return tuple(
                LocalTiledArrays(a.lcols[0], a.local_rows[0],
                                 a.row_start[0], a.src[0])
                for a in arrs
            )

        if base in ("max", "min"):
            return _local_tiled_minmax(
                base, cfg_df, cfg_db, cfg_hf, cfg_hb,
                sla(arr_df), sla(arr_db), sla(arr_hf), sla(arr_hb),
                dv[0], hv[0], B_shard, halo_tbl,
            )
        od = _local_tiled(cfg_df, cfg_db, sla(arr_df), sla(arr_db),
                          dv[0], B_shard)
        oh = _local_tiled(cfg_hf, cfg_hb, sla(arr_hf), sla(arr_hb),
                          hv[0], halo_tbl)
        out = od + oh
        if reduce == "mean":
            out = out / jnp.maximum(deg[0], 1.0)[:, None]
        return out

    sx = P(axis, None)
    heads = 1
    if rt_vals and diag_vals.ndim == 3:
        # Per-head runtime edge values (P, nnz, H) over head-blocked B
        # (tiled tier only — the XLA local tier takes scalar edge
        # values; loop heads there).
        heads = int(diag_vals.shape[2])
        if method != "tiled":
            raise ValueError(
                "per-head (3-D) edge values need method='tiled'"
            )
        if B.shape[1] % heads:
            raise ValueError(
                f"B width {B.shape[1]} must be heads={heads} blocks"
            )
        if base in ("max", "min"):
            raise ValueError(
                "per-head edge values are not supported with "
                "reduce=max/min on the tiled tier"
            )
    if method == "tiled":
        arrs = hp.tiled_arrays
        use_vals = has_dd
        cfgs = tuple(
            tuple(
                dataclasses.replace(c, with_vals=use_vals, heads=heads)
                for c in cs
            )
            for cs in hp.tiled_cfgs
        )
        dv = dvals if use_vals else jnp.zeros((Pn, 1), B.dtype)
        hv = hvals if use_vals else jnp.zeros((Pn, 1), B.dtype)
        vspec = sx if (not use_vals or dv.ndim == 2) else P(axis, None, None)

        def arr_spec(arrs_role):
            return tuple(
                LocalTiledArrays(
                    lcols=P(axis, None),
                    local_rows=P(axis, None, None),
                    row_start=P(axis, None),
                    src=P(axis, None),
                )
                for _ in arrs_role
            )

        in_specs = (
            P(axis, None), sx,
            arr_spec(arrs[0]), arr_spec(arrs[1]),
            arr_spec(arrs[2]), arr_spec(arrs[3]),
            vspec, vspec,
            P(axis, model_in_mesh),
        )
        fn = shard_map(
            body_tiled, mesh=mesh, in_specs=in_specs,
            out_specs=P(axis, model_in_mesh), check_vma=False,
        )
        return fn(hp.send_idx, hp.deg, *arrs, dv, hv, B)

    args = [hp.send_idx, hp.diag_indptr, hp.diag_indices]
    in_specs = [P(axis, None), sx, sx]
    dd = dvals if has_dd else jnp.zeros((1, 1), B.dtype)
    hd = hvals if has_hd else jnp.zeros((1, 1), B.dtype)
    args += [dd, hp.diag_mask, hp.halo_indptr, hp.halo_indices, hd,
             hp.halo_mask, hp.deg, B]
    in_specs += [sx if has_dd else P(None, None), sx, sx, sx,
                 sx if has_hd else P(None, None), sx, sx,
                 P(axis, model_in_mesh)]
    fn = shard_map(
        body_xla, mesh=mesh, in_specs=tuple(in_specs),
        out_specs=P(axis, model_in_mesh), check_vma=False,
    )
    return fn(*args)


def pad_for_halo(hp: HaloPartition, X: Array) -> Array:
    """Pad a node-indexed array to num_parts*cpp rows (B-side layout)."""
    pad = hp.num_parts * hp.cpp - X.shape[0]
    if pad < 0:
        raise ValueError(f"array has {X.shape[0]} rows > {hp.num_parts * hp.cpp}")
    if pad == 0:
        return X
    return jnp.pad(X, ((0, pad),) + ((0, 0),) * (X.ndim - 1))

"""Tiled SpMM over a host-built slot layout: XLA gather, XLA segment reduce.

The plan (`sparse/partition.build_tiled_plan`) sorts each row part's edges by
(column tile, row) and pads them into chunks of E slots whose rows fit a
window of R. The gather phase takes the rows of ``B`` that feed each slot,
one `take` per column tile, scaled by the edge values. The reduce phase folds
the slots into the part's output rows with `jax.ops.segment_sum` (in two
levels, runs then rows: `_sum_by_runs`) or `segment_max` / `segment_min`,
keyed by ``row_start[c] + local_rows[c, j]``; pad slots carry the key
``m_pad`` and are dropped.

Every per-edge composition in the package that works in slot order rides
`_reduce_part`: the tiled SpMM here, the edge softmax normalizers
(`edge_segment_reduce`), the max/min VJP, the fused attention chain in
`kernels/gat_fused.py` and the tiled halo tier in `parallel/halo.py`.

Reference parity: the edge-valued + binary SpMM kernel family
(`spmm_test.cu:64-454`, `spmm_kernel.cu:31-173`). The one-pass CSR kernel
that follows the reference's own design is `kernels/spmm_csr.py`.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from gespmm_tpu.sparse.partition import TiledPartPlan, TiledSpmmPlan

Array = jax.Array


def _stream_budget() -> int:
    """Byte cap on one materialized (slots x K) gather stream.

    A quarter of the device's memory limit: the stream and its per-run
    partial sums (`_sum_by_runs`, the same size) take half, leaving room
    for the operands, the output and the caller's live buffers. Backends that report no
    memory statistics (the CPU) get 4 GiB.
    """
    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"]) // 4
    return 4 << 30


def _k_slab(slots: int, K: int) -> Optional[int]:
    """Columns per pass when a (slots x K) f32 stream exceeds the budget
    (each pass re-gathers every slot); None when one pass fits."""
    budget = _stream_budget()
    if slots * 4 * K <= budget or K <= 128:
        return None
    return max(128, (budget // (slots * 4) // 128) * 128)


def _slot_segments(local_rows: Array, row_start: Array, rows_per_block: int,
                   m_pad: int) -> Array:
    """Flat per-slot output row; pad slots map to ``m_pad`` (dropped)."""
    seg = row_start[:, None] + local_rows
    return jnp.where(local_rows < rows_per_block, seg, m_pad).reshape(-1)


def _sum_by_runs(c: Array, local_rows: Array, seg: Array, m_pad: int):
    """Sum slots into rows in two levels, for float32 accuracy.

    A row's slots lie in runs of one chunk (rows ascend within a chunk), and
    a hub row's runs lie in many chunks and column tiles. One unsorted
    scatter-add over all slots sums a row of d nonzeros in arbitrary order,
    with error growing with d. Here each run is summed first, by a sorted
    segment-sum keyed by the run's first slot, and only the per-run
    partials (at most one per chunk) are scattered into the rows.
    """
    C, E = local_rows.shape
    pos = jnp.arange(E, dtype=jnp.int32)
    first = jnp.concatenate(
        [jnp.ones((C, 1), bool), local_rows[:, 1:] != local_rows[:, :-1]],
        axis=1,
    )
    start = jax.lax.cummax(jnp.where(first, pos, 0), axis=1)
    run = (jnp.arange(C, dtype=jnp.int32)[:, None] * E + start).reshape(-1)
    partial = jax.ops.segment_sum(c, run, num_segments=C * E,
                                  indices_are_sorted=True)
    return jax.ops.segment_sum(partial, seg, num_segments=m_pad)


@functools.partial(
    jax.jit, static_argnames=("m_pad", "rows_per_block", "op", "want_ties")
)
def _reduce_part(
    contrib: Array,  # (S, K), slot order
    local_rows: Array,  # (C, E), S = C * E
    row_start: Array,  # (C,)
    m_pad: int,
    rows_per_block: int,
    op: str = "sum",
    want_ties: bool = False,
):
    """Fold a part's slot stream into its (m_pad, K) float32 output.

    ``op`` "sum" | "max" | "min". Rows that receive no slot hold the
    monoid's identity (0, -inf, +inf); callers map ±inf to 0.
    ``want_ties`` (max/min): also return the per-(row, k) count of slots
    that achieve the extremum, as float32.
    """
    seg = _slot_segments(local_rows, row_start, rows_per_block, m_pad)
    c = contrib.astype(jnp.float32)
    if op == "sum":
        return _sum_by_runs(c, local_rows, seg, m_pad)
    reduce = jax.ops.segment_max if op == "max" else jax.ops.segment_min
    out = reduce(c, seg, num_segments=m_pad)
    if not want_ties:
        return out
    valid = (seg < m_pad)[:, None]
    hit = valid & (c == jnp.take(out, jnp.minimum(seg, m_pad - 1), axis=0))
    ties = jax.ops.segment_sum(hit.astype(jnp.float32), seg,
                               num_segments=m_pad)
    return out, ties


def _gather_part(part: TiledPartPlan, data: Optional[Array], B: Array) -> Array:
    """Gather phase: per column tile, take rows of that slice of B; scale
    by the edge values. Returns the (S, K) float32 contribution stream."""
    vals = None
    if data is not None:
        vals = jnp.take(data, part.src, axis=0).astype(jnp.float32)
    pieces = []
    for col0, ncols, slot0, slot1 in part.tile_slices:
        g = jnp.take(B[col0 : col0 + ncols], part.lcols[slot0:slot1],
                     axis=0).astype(jnp.float32)
        if vals is not None:
            g = g * vals[slot0:slot1, None]
        pieces.append(g)
    return pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, 0)


def spmm_tiled(
    plan: TiledSpmmPlan,
    data: Optional[Array],
    B: Array,
    m: int,
    *,
    reduce: str = "sum",
    want_ties: bool = False,
):
    """SpMM through the tiled slot layout.

    ``data``: per-edge values in CSR order, or None for implicit 1.0.
    Output dtype follows B (accumulation is always f32).
    ``reduce``: "sum" | "max" | "min".  Empty rows produce 0 under every
    monoid (matching ops/reference semantics).
    ``want_ties`` (max/min only): also return the (m, K) f32 count of
    edges achieving each output value, which the max/min VJP reuses.
    Returns ``out`` or ``(out, ties)``.
    """
    if reduce not in ("sum", "max", "min"):
        raise ValueError(f"spmm_tiled reduce must be sum/max/min, got {reduce!r}")
    if want_ties and reduce == "sum":
        raise ValueError("want_ties requires reduce='max' or 'min'")
    mm = getattr(plan, "minmax", None)
    if reduce in ("max", "min") and mm is not None:
        return spmm_minmax_aligned(
            mm, data, B, m, reduce=reduce, want_ties=want_ties,
        )
    K = B.shape[1]
    k_slab = _k_slab(max(p.num_slots for p in plan.parts), K)
    if k_slab is not None:
        outs = [
            spmm_tiled(plan, data, B[:, k0 : k0 + k_slab], m,
                       reduce=reduce, want_ties=want_ties)
            for k0 in range(0, K, k_slab)
        ]
        if want_ties:
            return (jnp.concatenate([o[0] for o in outs], axis=1),
                    jnp.concatenate([o[1] for o in outs], axis=1))
        return jnp.concatenate(outs, axis=1)

    outs = []
    ties = []
    for part in plan.parts:
        contrib = _gather_part(part, data, B)
        out_p = _reduce_part(
            contrib, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op=reduce, want_ties=want_ties,
        )
        if want_ties:
            out_p, ties_p = out_p
            ties.append(ties_p[: part.m_part])
        outs.append(out_p[: part.m_part])
    out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, 0)
    out = out[:m]
    if reduce in ("max", "min"):
        # Rows with no nonzeros still hold the ±inf identity.
        out = jnp.where(jnp.isfinite(out), out, 0.0)
    if want_ties:
        t = ties[0] if len(ties) == 1 else jnp.concatenate(ties, 0)
        return out.astype(B.dtype), t[:m]
    return out.astype(B.dtype)


def spmm_minmax_aligned(
    aplan,
    data: Optional[Array],
    B: Array,
    m: int,
    *,
    reduce: str = "max",
    want_ties: bool = False,
):
    """Scan-free max/min SpMM over the row-aligned layout.

    Pure XLA: per degree class one slice of a single padded-table gather
    reshape-reduces to per-row-segment candidates (+ achieving counts
    when ``want_ties``); mega rows recurse through the plan's extra
    levels; the final scatter is an inverse-permutation ``take``
    (rows partition across classes — see
    `sparse/partition.AlignedMinmaxPlan`).

    Semantics identical to the segment-reduce path: empty rows 0, even
    tie-splitting counts, exact selections.
    """
    n, K = B.shape
    fold = jnp.max if reduce == "max" else jnp.min
    ident = jnp.float32(-jnp.inf if reduce == "max" else jnp.inf)
    # Bound the materialized per-class gather (the same discipline as
    # spmm_tiled's K-slabbing).
    k_slab = _k_slab(aplan.num_slots, K)
    if k_slab is not None:
        outs = [
            spmm_minmax_aligned(
                aplan, data, B[:, k0 : k0 + k_slab], m, reduce=reduce,
                want_ties=want_ties,
            )
            for k0 in range(0, K, k_slab)
        ]
        if want_ties:
            return (jnp.concatenate([o[0] for o in outs], axis=1),
                    jnp.concatenate([o[1] for o in outs], axis=1))
        return jnp.concatenate(outs, axis=1)

    # Level-0 table: B (+ edge-value scaling) with a sentinel identity
    # row appended so pad slots need no mask.
    tbl = jnp.concatenate(
        [B.astype(jnp.float32), jnp.full((1, K), ident)], axis=0
    )
    data_ext = (
        None if data is None
        else jnp.concatenate(
            [data.astype(jnp.float32), jnp.ones((1,), jnp.float32)]
        )
    )
    cand_parts = []   # per-level candidate arrays (concat = index space)
    cnt_parts = []
    for li, lv in enumerate(aplan.levels):
        if li == 0:
            g = jnp.take(tbl, lv.idx, axis=0)
            if data_ext is not None:
                g = g * jnp.take(data_ext, lv.src, axis=0)[:, None]
            gc = None
        else:
            prev = jnp.concatenate(
                cand_parts + [jnp.full((1, K), ident)], axis=0
            )
            g = jnp.take(prev, lv.idx, axis=0)
            if want_ties:
                prevc = jnp.concatenate(
                    cnt_parts + [jnp.zeros((1, K), jnp.float32)], axis=0
                )
                gc = jnp.take(prevc, lv.idx, axis=0)
        cands = []
        cnts = []
        for s0, s1, W in lv.class_slices:
            gr = g[s0:s1].reshape(-1, W, K)
            cand = fold(gr, axis=1)
            cands.append(cand)
            if want_ties:
                hit = gr == cand[:, None, :]
                if li == 0:
                    # Pad slots hold the identity, which never equals a
                    # finite winning value (finite-values contract).
                    cnts.append(jnp.sum(hit.astype(jnp.float32), axis=1))
                else:
                    cnts.append(jnp.sum(
                        jnp.where(hit, gc[s0:s1].reshape(-1, W, K), 0.0),
                        axis=1,
                    ))
        cand_parts.append(
            cands[0] if len(cands) == 1 else jnp.concatenate(cands, axis=0)
        )
        if want_ties:
            cnt_parts.append(
                cnts[0] if len(cnts) == 1 else jnp.concatenate(cnts, axis=0)
            )

    all_cand = jnp.concatenate(
        cand_parts + [jnp.full((1, K), ident)], axis=0
    )
    out = jnp.take(all_cand, aplan.inv_map, axis=0)
    out = jnp.where(jnp.isfinite(out), out, 0.0)[:m, :K]
    if want_ties:
        all_cnt = jnp.concatenate(
            cnt_parts + [jnp.zeros((1, K), jnp.float32)], axis=0
        )
        ties = jnp.take(all_cnt, aplan.inv_map, axis=0)[:m, :K]
        return out.astype(B.dtype), ties
    return out.astype(B.dtype)


def spmm_minmax_vjp_aligned(
    aplan_t,
    csc_data: Optional[Array],
    B: Array,
    out: Array,
    g: Array,
    op: str,
    ties: Array,
):
    """Max/min VJP over the transpose's row-aligned layout.

    Replaces phase 2 of :func:`spmm_minmax_vjp_tiled` when the transpose
    plan carries an aligned layout and the forward emitted tie counts:
    slots are grouped by A-COLUMN (= B row), so the per-edge B value
    broadcasts from CANDIDATE granularity (`cand_rows`) instead of
    costing a per-slot gather, and the per-column reduction is the same
    reshape-sum + inverse-permutation `take` as the aligned forward —
    ONE scattered gather total (the (out | g/ties) table by A-row).

    Returns ``(grad_data_csc | None, grad_B)`` — the same contract as
    :func:`spmm_minmax_vjp_tiled`.
    """
    del op  # achievement tests are equality-based; identical for min
    m, K = out.shape
    n_B = B.shape[0]
    nnz = aplan_t.nnz
    B32 = B.astype(jnp.float32)
    gt = g.astype(jnp.float32) / jnp.maximum(ties, 1.0)
    og_ext = jnp.concatenate([
        jnp.concatenate([out.astype(jnp.float32), gt], axis=1),
        jnp.zeros((1, 2 * K), jnp.float32),
    ], axis=0)
    csc_ext = (
        None if csc_data is None
        else jnp.concatenate([
            csc_data.astype(jnp.float32), jnp.ones((1,), jnp.float32)
        ])
    )
    l0 = aplan_t.levels[0]
    b_cand = jnp.take(B32, aplan_t.cand_rows[: l0.ncand], axis=0)

    cand_parts = []
    gd_slots = [] if csc_ext is not None else None
    c0 = 0
    for s0, s1, W in l0.class_slices:
        ncs = (s1 - s0) // W
        # One gather PER CLASS (not one big one sliced per class): XLA
        # can then fuse each gather into its class's reshape-sum consumer
        # instead of materializing an (S, 2K) intermediate.
        og_c = jnp.take(og_ext, l0.idx[s0:s1], axis=0)
        val = (
            None if csc_ext is None
            else jnp.take(csc_ext, l0.src[s0:s1], axis=0)
        )
        ogr = og_c.reshape(ncs, W, 2 * K)
        out_s = ogr[..., :K]
        gt_s = ogr[..., K:]
        bc = b_cand[c0 : c0 + ncs][:, None, :]
        if val is not None:
            v = val.reshape(ncs, W, 1)
            contrib = bc * v
        else:
            contrib = jnp.broadcast_to(bc, (ncs, W, K))
        # Pad slots carry gt == 0 (zero sentinel row), so they add 0
        # regardless of how the achievement compare falls.
        w = jnp.where(contrib == out_s, gt_s, 0.0)
        cand_parts.append(jnp.sum(w * v if val is not None else w, axis=1))
        if gd_slots is not None:
            gd_slots.append(
                jnp.sum(jnp.where(contrib == out_s, gt_s * bc, 0.0),
                        axis=2).reshape(-1)
            )
        c0 += ncs
    for lv in aplan_t.levels[1:]:
        prev = jnp.concatenate(
            cand_parts + [jnp.zeros((1, K), jnp.float32)], axis=0
        )
        gl = jnp.take(prev, lv.idx, axis=0)
        for s0, s1, W in lv.class_slices:
            cand_parts.append(
                jnp.sum(gl[s0:s1].reshape(-1, W, K), axis=1)
            )
    all_cand = jnp.concatenate(
        cand_parts + [jnp.zeros((1, K), jnp.float32)], axis=0
    )
    grad_B = jnp.take(all_cand, aplan_t.inv_map, axis=0)[:n_B]
    gd = None
    if gd_slots is not None:
        flat = jnp.concatenate(gd_slots)
        gd = jnp.zeros((nnz + 1,), jnp.float32).at[l0.src].set(flat)[:nnz]
    return gd, grad_B


def edge_segment_reduce(
    plan: TiledSpmmPlan,
    vals: Array,
    op: str = "sum",
) -> Array:
    """Per-row reduction of per-edge values through the slot layout.

    vals: (nnz, K) edge values in CSR order (K is typically small — e.g.
    attention heads).  Returns (m, K).  Forward-only (callers wrap in
    custom VJPs — the transpose of a segment-sum is just a row-gather).
    """
    if vals.ndim != 2:
        raise ValueError(f"vals must be (nnz, K), got {vals.shape}")
    m = plan.shape[0]
    vals32 = vals.astype(jnp.float32)
    outs = []
    for part in plan.parts:
        contrib = jnp.take(vals32, part.src, axis=0)
        out_p = _reduce_part(
            contrib, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op=op,
        )
        outs.append(out_p[: part.m_part])
    out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, 0)
    out = out[:m]
    if op in ("max", "min"):
        out = jnp.where(jnp.isfinite(out), out, 0.0)
    return out.astype(vals.dtype)


def _part_rows_slice(part: TiledPartPlan, X: Array) -> Array:
    """X[row0 : row0+m_part] padded to m_pad rows (gather table per part)."""
    Xp = X[part.row0 : part.row0 + part.m_part]
    if Xp.shape[0] < part.m_pad:
        Xp = jnp.pad(Xp, ((0, part.m_pad - Xp.shape[0]), (0, 0)))
    return Xp


def _slot_rows(part: TiledPartPlan) -> Array:
    """Per-slot part-local output row (sentinel slots clamped in range)."""
    rows = (part.row_start[:, None] + part.local_rows).reshape(-1)
    return jnp.minimum(rows, part.m_pad - 1)


def _slot_valid(part: TiledPartPlan) -> Array:
    return (part.local_rows < part.rows_per_block).reshape(-1)


def _tile_gather(part: TiledPartPlan, X: Array) -> Array:
    """Gather X rows per column tile of the plan."""
    pieces = [
        jnp.take(X[col0 : col0 + ncols], part.lcols[s0:s1], axis=0)
        for col0, ncols, s0, s1 in part.tile_slices
    ]
    return pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, 0)


def spmm_minmax_vjp_tiled(
    plan: TiledSpmmPlan,
    plan_t: TiledSpmmPlan,
    data: Optional[Array],
    csc_data: Optional[Array],
    B: Array,
    out: Array,
    g: Array,
    op: str,
    *,
    ties: Optional[Array] = None,
):
    """Gradients of max/min-reduce SpMM through the stream plans.

    Returns ``(grad_data_csc | None, grad_B)`` — grad_data in CSC edge
    order (callers permute back to CSR with the adjacency's ``perm``).

    Semantics match jnp.max's VJP (even tie-splitting), i.e. the XLA path
    `ops/reference.spmm_max_vjp_edges`, with both nnz×K reductions in the
    plans' slot order:
      1. ties(r,k) = #achieving edges — taken from the forward when it
         ran with ``want_ties=True``, else recounted here: indicator
         stream over `plan`, sum-reduced;
      2. grad_B(c,k) = Σ val·g/ties over achieving edges — weight stream
         over `plan_t` (edges grouped by column), sum-reduced.
    Achievement tests are bitwise-exact: contributions are recomputed with
    the same f32 gather·scale as the forward, and max/min select exact
    f32 values.
    """
    K = B.shape[1]
    nnz = plan.nnz
    B32 = B.astype(jnp.float32)
    out32 = out.astype(jnp.float32)
    g32 = g.astype(jnp.float32)

    if ties is None:
        # Phase 1: tie counts over the forward plan.
        ties_parts = []
        for part in plan.parts:
            contrib = _gather_part(part, data, B32)
            out_slot = jnp.take(_part_rows_slice(part, out32),
                                _slot_rows(part), axis=0)
            ind = (
                (contrib == out_slot) & _slot_valid(part)[:, None]
            ).astype(jnp.float32)
            tp = _reduce_part(
                ind, part.local_rows, part.row_start, part.m_pad,
                part.rows_per_block, op="sum",
            )
            ties_parts.append(tp[: part.m_part])
        ties = (
            ties_parts[0] if len(ties_parts) == 1
            else jnp.concatenate(ties_parts, 0)
        )[: out.shape[0], :K]

    # Phase 2: weight stream over the transpose plan.  g/ties is folded
    # into ONE row-space table up front, and [out | g/ties] tile-gathers
    # as ONE combined column table (one per-slot gather instead of two).
    g_over_ties = g32 / jnp.maximum(ties, 1.0)
    og_tbl = jnp.concatenate([out32, g_over_ties], axis=1)
    grad_parts = []
    gd = None if data is None else jnp.zeros((nnz + 1,), jnp.float32)
    for part in plan_t.parts:
        vals_slot = (
            None if csc_data is None
            else jnp.take(csc_data, part.src, axis=0).astype(jnp.float32)
        )
        b_slot = jnp.take(_part_rows_slice(part, B32), _slot_rows(part),
                          axis=0)
        contrib = b_slot if vals_slot is None else b_slot * vals_slot[:, None]
        og = _tile_gather(part, og_tbl)
        out_slot = og[:, :K]
        gt_slot = og[:, K:]
        valid = _slot_valid(part)
        eq = (contrib == out_slot) & valid[:, None]
        w = jnp.where(eq, gt_slot, 0.0)
        stream = w if vals_slot is None else w * vals_slot[:, None]
        gb = _reduce_part(
            stream, part.local_rows, part.row_start, part.m_pad,
            part.rows_per_block, op="sum",
        )
        grad_parts.append(gb[: part.m_part])
        if gd is not None:
            gd_slot = jnp.sum(w * b_slot, axis=-1)
            gd = gd.at[jnp.where(valid, part.src, nnz)].set(gd_slot)
    grad_B = (
        grad_parts[0] if len(grad_parts) == 1
        else jnp.concatenate(grad_parts, 0)
    )[: B.shape[0], :K]
    return (None if gd is None else gd[:nnz]), grad_B


def sddmm_tiled(
    plan: TiledSpmmPlan,
    D1: Array,
    D2: Array,
) -> Array:
    """SDDMM over the stream plan's slot layout: out[e] = D1[row_e]·D2[col_e].

    Both gathers read per-part / per-tile slices (D1 sliced per row part,
    D2 per column tile).  Returns CSR-ordered edge values: the slot->edge
    return trip rides the plan's host-precomputed inverse map
    (`TiledPartPlan.edge_slot`) as a `take` + concat — each part owns a
    contiguous CSR edge range; hand-built plans without the map fall back
    to a scatter.
    """
    nnz = plan.nnz
    K = D1.shape[1]
    acc = jnp.promote_types(D1.dtype, jnp.float32)
    have_inverse = all(p.edge_slot is not None for p in plan.parts)
    out = None if have_inverse else jnp.zeros((nnz + 1,), acc)
    out_parts = []
    for part in plan.parts:
        R, E = part.rows_per_block, part.chunk_nnz
        D1p = D1[part.row0 : part.row0 + part.m_part]
        if D1p.shape[0] < part.m_pad:
            D1p = jnp.pad(D1p, ((0, part.m_pad - D1p.shape[0]), (0, 0)))
        rows_slot = _slot_rows(part)
        d1 = jnp.take(D1p, rows_slot, axis=0).astype(acc)
        pieces = []
        for col0, ncols, s0, s1 in part.tile_slices:
            pieces.append(
                jnp.take(D2[col0 : col0 + ncols], part.lcols[s0:s1], axis=0)
            )
        g2 = (
            pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, 0)
        ).astype(acc)
        prod = jnp.sum(d1 * g2, axis=-1)
        if have_inverse:
            out_parts.append(jnp.take(prod, part.edge_slot, axis=0))
        else:
            valid = (part.local_rows < R).reshape(-1)
            dst = jnp.where(valid, part.src, nnz)
            out = out.at[dst].set(prod)
    if have_inverse:
        out = (
            out_parts[0] if len(out_parts) == 1
            else jnp.concatenate(out_parts, 0)
        )
        return out.astype(D1.dtype)
    return out[:nnz].astype(D1.dtype)

"""Host-side slot layouts for the tiled SpMM and the max/min reductions.

The tiled plan sorts each row part's edges by (column tile, row) and packs
them into chunks of E slots whose rows fit a window of R output rows. The
gather phase (`kernels/spmm_stream.py`) reads one slice of B per column
tile; the reduce phase folds the slots into the part's output rows with a
segment reduction keyed by ``row_start[c] + local_rows[c, j]``.

Plans are built once per graph on the host (NumPy, or the native packer in
`native/graphio.cpp`) and carried in the `Adjacency` pytree; they depend
only on the sparsity *structure*, never on edge values, so one plan serves
every training step and every value of the (differentiable) edge weights.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gespmm_tpu.utils.profiling import PEAKS, TARGET_DEVICE_KIND


# ---------------------------------------------------------------------------
# Tiled plan: edges sorted by (column tile, row), packed in chunks of E slots
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TiledPartPlan:
    """Per-row-part slot layout for the tiled SpMM.

    The part owns rows [row0, row0 + m_part) of the output.  Its edges are
    sorted by (column tile, row); the gather phase produces one
    contribution row per SLOT (slot order == this sorted order, padded so
    each (tile, chunk) boundary is chunk-aligned), and the reduce phase
    folds slots into the part's output rows.

    Arrays (S slots, C chunks of E slots):
      src:        (S,) int32 — CSR edge index feeding each slot (pad -> 0)
      lcols:      (S,) int32 — column local to the slot's tile (pad -> 0)
      local_rows: (C, E) int32 — row - row_start[c]; pad sentinel = R
      row_start:  (C,) int32 — 8-aligned window start, row_start+R <= m_pad
      edge_slot:  (nnz_part,) int32 — inverse of ``src``: the slot feeding
                  CSR edge edge0 + i (the part owns a contiguous CSR edge
                  range, so slot-ordered per-edge results return to CSR
                  order with one `take` + concat)
    Static:
      tile_slices: tuple of (col0, ncols, slot0, slot1) — one per column
        tile that has edges; gather phase does take(B[col0:col0+ncols],
        lcols[slot0:slot1]).
      row0, m_part, m_pad, rows_per_block R, chunk_nnz E, edge0.
    """

    src: jax.Array
    lcols: jax.Array
    local_rows: jax.Array
    row_start: jax.Array
    tile_slices: Tuple = dataclasses.field(default=())
    row0: int = 0
    m_part: int = 0
    m_pad: int = 0
    rows_per_block: int = 0
    chunk_nnz: int = 0
    edge_slot: Optional[jax.Array] = None
    edge0: int = 0

    def tree_flatten(self):
        arrays = (self.src, self.lcols, self.local_rows, self.row_start,
                  self.edge_slot)
        aux = (self.tile_slices, self.row0, self.m_part, self.m_pad,
               self.rows_per_block, self.chunk_nnz, self.edge0)
        return arrays, aux

    @classmethod
    def tree_unflatten(cls, aux, arrays):
        return cls(
            src=arrays[0], lcols=arrays[1], local_rows=arrays[2],
            row_start=arrays[3], edge_slot=arrays[4],
            tile_slices=aux[0], row0=aux[1], m_part=aux[2], m_pad=aux[3],
            rows_per_block=aux[4], chunk_nnz=aux[5], edge0=aux[6],
        )

    @property
    def num_slots(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_chunks(self) -> int:
        return int(self.local_rows.shape[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TiledSpmmPlan:
    """Tiled SpMM plan: row parts x column tiles x slot chunks.

    ``minmax``: optional row-aligned max/min layout; when present,
    `spmm_tiled(reduce="max"/"min")` reduces over it instead of the slot
    layout.
    """

    parts: Tuple[TiledPartPlan, ...]
    col_tile: int
    shape: Tuple[int, int]
    nnz: int
    minmax: Optional["AlignedMinmaxPlan"] = None

    def tree_flatten(self):
        return (self.parts, self.minmax), (self.col_tile, self.shape,
                                           self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2], children[1])

    @property
    def num_slots(self) -> int:
        return sum(p.num_slots for p in self.parts)

    @property
    def padding_ratio(self) -> float:
        total = self.num_slots
        return (total - self.nnz) / max(total, 1)


# Bytes of B one column tile may hold by default: half the L2 cache of the
# card the defaults are sized for (`utils/profiling`), so a tile's
# gathered rows stay L2-resident while its slots stream past.
TILE_TABLE_BYTES = PEAKS[TARGET_DEVICE_KIND]["l2_bytes"] // 2


def _align_down(x: int, a: int) -> int:
    return (x // a) * a


def _finalize_part(
    lr, rs, src_flat, lc_flat, chunk_tile,
    *, row0, m_part, m_pad, Rp, E, edge0, nedges, n, col_tile,
):
    """Shared tail of the part builders: tile slices and the CSR-order
    inverse map.

    Inputs are chunk-major: lr (C, E), rs (C,), src/lc (C*E,), chunk_tile
    (C,) — the tile id of each chunk (chunks of one tile are contiguous).
    """
    C = lr.shape[0]
    src_p = src_flat.reshape(-1)
    valid_p = (lr < Rp).reshape(-1)

    tile_slices = []
    c0 = 0
    while c0 < C:
        c1 = c0
        while c1 < C and chunk_tile[c1] == chunk_tile[c0]:
            c1 += 1
        t = int(chunk_tile[c0])
        tile_slices.append(
            (t * col_tile, min(col_tile, n - t * col_tile),
             c0 * E, c1 * E)
        )
        c0 = c1

    es = np.zeros(nedges, np.int32)
    es[src_p[valid_p] - edge0] = np.flatnonzero(valid_p)

    return TiledPartPlan(
        src=jnp.asarray(src_p),
        lcols=jnp.asarray(lc_flat.reshape(-1)),
        local_rows=jnp.asarray(lr),
        row_start=jnp.asarray(rs.astype(np.int32)),
        tile_slices=tuple(tile_slices),
        row0=row0,
        m_part=m_part,
        m_pad=m_pad,
        rows_per_block=Rp,
        chunk_nnz=E,
        edge_slot=jnp.asarray(es),
        edge0=edge0,
    )


def default_col_tile(n: int, k_hint: int) -> int:
    """Whole B as one tile when it fits `TILE_TABLE_BYTES` at ``k_hint``
    features; otherwise the largest power of two of rows that does."""
    if n * 4 * max(k_hint, 1) <= TILE_TABLE_BYTES:
        return max(n, 1)
    rows = TILE_TABLE_BYTES // (4 * max(k_hint, 1))
    return max(1 << (max(rows, 1).bit_length() - 1), 1024)


def build_tiled_plan(
    csr,
    col_tile: Optional[int] = None,
    rows_per_block: Optional[int] = None,
    chunk_nnz: int = 256,
    part_rows: Optional[int] = None,
    k_hint: int = 128,
    minmax_aligned: bool = True,
) -> TiledSpmmPlan:
    """Host-side construction of the tiled plan.

    col_tile: B rows per gather tile.  Default (None): `default_col_tile`.
    rows_per_block (R): output-row window one chunk may cover.  Default
      (None): the whole part, so chunks break only at tile boundaries.
    chunk_nnz (E): slots per chunk.
    part_rows: output rows per part.  Default (None): one part.
    k_hint: feature width the tile size is chosen for.
    """
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    m, n = csr.shape
    nnz = int(indices.shape[0])
    E = int(chunk_nnz)
    if col_tile is None:
        col_tile = default_col_tile(n, k_hint)
    if part_rows is None:
        part_rows = max(m, 1)
    if rows_per_block is None:
        R = -(-min(part_rows, max(m, 1)) // 8) * 8
    else:
        R = int(rows_per_block)
    if R % 8 or E % 8:
        raise ValueError("rows_per_block and chunk_nnz must be multiples of 8")

    rows_all = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))
    parts = []
    for row0 in range(0, max(m, 1), part_rows):
        row1 = min(row0 + part_rows, m)
        m_part = row1 - row0
        m_pad = max(-(-m_part // 8) * 8, min(R, -(-m // 8) * 8))
        Rp = min(R, m_pad)
        s, e = int(indptr[row0]), int(indptr[row1])
        rows_p = rows_all[s:e] - row0
        cols_p = indices[s:e]
        src_p = np.arange(s, e, dtype=np.int32)
        tile_p = cols_p // col_tile
        order = np.lexsort((rows_p, tile_p))
        rows_p, cols_p, src_p, tile_p = (
            rows_p[order], cols_p[order], src_p[order], tile_p[order]
        )

        # Pack row-windowed chunks of E slots per tile: native C++ walk
        # when the graphio library is available (identical output,
        # cross-tested in tests/test_native.py), else the NumPy walk.
        packed = None
        if len(rows_p):
            from gespmm_tpu.utils.native import pack_chunks_native

            packed = pack_chunks_native(rows_p, tile_p, Rp, E, m_pad)
        if packed is not None:
            lr_n, rs_n, s2e, chunk_tile = packed
            safe = np.maximum(s2e, 0)
            src_n = np.where(s2e >= 0, src_p[safe], 0).astype(np.int32)
            lc_n = np.where(
                s2e >= 0,
                cols_p[safe] - chunk_tile[:, None] * col_tile,
                0,
            ).astype(np.int32)
            parts.append(_finalize_part(
                lr_n, rs_n.astype(np.int32), src_n.reshape(-1),
                lc_n.reshape(-1), np.asarray(chunk_tile),
                row0=row0, m_part=m_part, m_pad=m_pad, Rp=Rp, E=E,
                edge0=s, nedges=e - s, n=n, col_tile=col_tile,
            ))
            if m == 0:
                break
            continue

        src_slots, lcol_slots = [], []
        lrow_chunks, rstart_chunks, tile_chunks = [], [], []
        tids = np.unique(tile_p)
        bounds = np.searchsorted(tile_p, np.concatenate([tids, [tile_p[-1] + 1]])) if len(tile_p) else np.array([0])
        for ti, t in enumerate(tids):
            ts, te = int(bounds[ti]), int(bounds[ti + 1])
            t_rows = rows_p[ts:te]
            i = ts
            while i < te:
                r0 = _align_down(int(t_rows[i - ts]), 8)
                r0 = min(r0, m_pad - Rp)
                # furthest edge whose row < r0 + Rp
                j = ts + int(
                    np.searchsorted(t_rows, r0 + Rp, side="left")
                )
                j = min(j, i + E, te)
                cnt = j - i
                lr = np.full(E, Rp, np.int32)
                lr[:cnt] = rows_p[i:j] - r0
                sr = np.zeros(E, np.int32)
                sr[:cnt] = src_p[i:j]
                lc = np.zeros(E, np.int32)
                lc[:cnt] = cols_p[i:j] - int(t) * col_tile
                src_slots.append(sr)
                lcol_slots.append(lc)
                lrow_chunks.append(lr)
                rstart_chunks.append(r0)
                tile_chunks.append(int(t))
                i = j

        if not src_slots:  # empty part: one dummy chunk of pure padding
            src_slots.append(np.zeros(E, np.int32))
            lcol_slots.append(np.zeros(E, np.int32))
            lrow_chunks.append(np.full(E, Rp, np.int32))
            rstart_chunks.append(0)
            tile_chunks.append(0)

        parts.append(_finalize_part(
            np.stack(lrow_chunks),
            np.asarray(rstart_chunks, np.int32),
            np.concatenate(src_slots),
            np.concatenate(lcol_slots),
            np.asarray(tile_chunks, np.int64),
            row0=row0, m_part=m_part, m_pad=m_pad, Rp=Rp, E=E,
            edge0=s, nedges=e - s, n=n, col_tile=col_tile,
        ))
        if m == 0:
            break

    mm = build_aligned_minmax_plan(csr) if minmax_aligned else None
    return TiledSpmmPlan(
        parts=tuple(parts), col_tile=col_tile, shape=(m, n), nnz=nnz,
        minmax=mm,
    )


# ---------------------------------------------------------------------------
# Row-aligned max/min layout: reshape-reduce over fixed-width segments
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class AlignedLevel:
    """One reduction level of the aligned max/min layout.

    idx: (S,) int32 — gather index per slot.  Level 0 indexes the padded
      dense-operand table (pad -> n, a sentinel identity row the runtime
      appends); level l>0 indexes the concatenation of ALL previous
      levels' candidates (pad -> sentinel appended the same way).
    src: (S,) int32 — CSR edge index per slot (level 0 only; pad -> nnz,
      a sentinel 1.0 value the runtime appends when edge values exist).
    class_slices: ((s0, s1, W), ...) static — slots [s0, s1) reduce in
      segments of width W (s1 - s0 divisible by W).
    ncand: total candidates this level emits (sum of (s1-s0)//W).
    """

    idx: jax.Array
    src: Optional[jax.Array]
    class_slices: Tuple[Tuple[int, int, int], ...]
    ncand: int

    def tree_flatten(self):
        return (self.idx, self.src), (self.class_slices, self.ncand)

    @classmethod
    def tree_unflatten(cls, aux, arrays):
        return cls(arrays[0], arrays[1], *aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class AlignedMinmaxPlan:
    """Row-aligned slot layout for max/min SpMM.

    The reduction is a reshape-reduce over fixed-width segments instead of
    a scatter-style segment reduction:

      * rows are bucketed into degree classes; each row's edges pad to
        segments of the class width W, so the per-segment reduction is a
        reshape-reduce XLA fuses with the gather;
      * rows wider than the largest class recurse: their level-l
        candidates become level-(l+1) elements (levels beyond 0 are tiny
        — mega rows only) until every row holds ONE candidate;
      * the final "scatter" is therefore an inverse-permutation `take`
        (rows partition across classes).

    Pad slots gather a SENTINEL identity row appended to the table, so
    no validity mask is materialized.  (Caveat: a graph whose real
    contributions include ±inf would alias the sentinel; values are
    assumed finite, as everywhere else in the package.)

    inv_map: (m,) int32 — row -> its final candidate position in the
      all-levels concatenation (rows with no edges -> sentinel).
    cand_rows: (total_cands,) int32 — candidate -> its row, in the same
      concatenation order (the inverse of inv_map extended to the
      multi-candidate levels; consumers broadcast per-row constants to
      candidate granularity with it, e.g. the aligned minmax VJP's
      B-row values).
    """

    levels: Tuple[AlignedLevel, ...]
    inv_map: jax.Array
    cand_rows: jax.Array
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.levels, self.inv_map, self.cand_rows), (
            self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], *aux)

    @property
    def num_slots(self) -> int:
        return int(self.levels[0].idx.shape[0]) if self.levels else 0

    @property
    def seg_widths(self) -> Tuple[int, ...]:
        return tuple(
            sorted({w for lv in self.levels for _, _, w in lv.class_slices})
        )

    @property
    def padding_ratio(self) -> float:
        total = self.num_slots
        return (total - self.nnz) / max(total, 1)


def build_aligned_minmax_plan(
    csr,
    seg_widths: Optional[Tuple[int, ...]] = None,
) -> Optional[AlignedMinmaxPlan]:
    """Host-side construction of the row-aligned max/min layout.

    seg_widths: class widths (a row of count c lands in the smallest
      class with W >= c; bigger rows split into ceil(c/W_max) segments and
      recurse, so the widest class must be at least 2).  Default: powers
      of two from 1 — width-1 and width-2 classes matter, low-degree rows
      dominate real graphs.
    Returns None for an empty matrix.
    """
    if seg_widths is None:
        seg_widths = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
    W_list = sorted(set(int(w) for w in seg_widths))
    if not W_list or W_list[0] < 1 or W_list[-1] < 2:
        raise ValueError(
            f"seg_widths must be positive with a widest class >= 2 (rows "
            f"wider than it recurse), got {tuple(seg_widths)!r}"
        )
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    m, n = csr.shape
    nnz = int(indices.shape[0])
    if m == 0 or nnz == 0:
        return None
    deg = np.diff(indptr)
    W_arr = np.asarray(W_list)
    W_max = W_list[-1]

    # Level 0 elements: per-row CSR edge runs (index = column id).
    counts = deg.astype(np.int64)          # elements per row this level
    starts = indptr[:-1].astype(np.int64)  # element run start per row
    elem_idx = indices.astype(np.int64)    # gather index per element
    elem_src: Optional[np.ndarray] = indices  # placeholder, set below
    elem_src = np.arange(nnz, dtype=np.int64)
    space = n          # sentinel index for level-0 pads
    src_sentinel = nnz

    levels = []
    cand_base = 0      # offset of this level's candidates in the concat
    cand_rows_parts = []
    final_pos = np.full(m, -1, np.int64)   # row -> final candidate pos
    for _level in range(64):  # bounded: counts shrink by >= W_max>=2
        active = counts > 0
        cls_of = np.minimum(
            np.searchsorted(W_arr, np.maximum(counts, 1)), len(W_list) - 1
        )
        segs = np.zeros(m, np.int64)
        segs[active] = -(-counts[active] // W_arr[cls_of[active]])
        # Lay out classes in width order; rows ascending within a class.
        class_slices = []
        idx_parts, src_parts = [], []
        cand_pos = np.full(m, -1, np.int64)
        cpos = 0
        spos = 0
        for ci, W in enumerate(W_list):
            rows = np.flatnonzero(active & (cls_of == ci))
            if rows.size == 0:
                continue
            nseg = segs[rows]
            S = int(nseg.sum()) * W
            # Vectorized slot fill: element j of row r lands at
            # (row slot base) + j; tail pads to the segment width.
            tot = counts[rows]
            base = np.concatenate([[0], np.cumsum(nseg)])[:-1] * W
            eoff = np.arange(int(tot.sum()), dtype=np.int64)
            row_of_e = np.repeat(np.arange(rows.size), tot)
            eoff -= np.concatenate([[0], np.cumsum(tot)])[:-1][row_of_e]
            slots = base[row_of_e] + eoff
            gidx = np.full(S, space, np.int64)
            # Element e of row r sits at starts[r] + eoff (vectorized).
            epos = starts[rows][row_of_e] + eoff
            gidx[slots] = elem_idx[epos]
            idx_parts.append(gidx)
            if elem_src is not None:
                gsrc = np.full(S, src_sentinel, np.int64)
                gsrc[slots] = elem_src[epos]
                src_parts.append(gsrc)
            cand_pos[rows] = cand_base + cpos + base // W
            cand_rows_parts.append(np.repeat(rows, nseg))
            class_slices.append((spos, spos + S, W))
            cpos += int(nseg.sum())
            spos += S
        idx_all = (
            np.concatenate(idx_parts) if idx_parts
            else np.zeros(0, np.int64)
        )
        src_all = (
            np.concatenate(src_parts) if (src_parts and _level == 0)
            else None
        )
        levels.append(AlignedLevel(
            idx=jnp.asarray(idx_all.astype(np.int32)),
            src=(None if src_all is None
                 else jnp.asarray(src_all.astype(np.int32))),
            class_slices=tuple(class_slices),
            ncand=cpos,
        ))
        done = active & (segs == 1)
        final_pos[done] = cand_pos[done]
        if not (segs > 1).any():
            break
        # Next level: the multi-segment rows' candidates are the new
        # elements; they sit consecutively at cand_pos[r] .. +segs[r].
        nxt = segs > 1
        new_counts = np.zeros(m, np.int64)
        new_counts[nxt] = segs[nxt]
        counts = new_counts
        starts = np.where(nxt, cand_pos, 0)
        # Element index space = all candidates so far (this level ends
        # at cand_base + cpos); element i of row r = starts[r] + i.
        cand_base += cpos
        space = cand_base          # sentinel for the NEXT level's pads
        elem_idx = np.arange(cand_base, dtype=np.int64)
        elem_src = None

    total_cands = cand_base + levels[-1].ncand
    inv_map = np.where(final_pos >= 0, final_pos, total_cands)
    cand_rows = (
        np.concatenate(cand_rows_parts) if cand_rows_parts
        else np.zeros(0, np.int64)
    )
    return AlignedMinmaxPlan(
        levels=tuple(levels),
        inv_map=jnp.asarray(inv_map.astype(np.int32)),
        cand_rows=jnp.asarray(cand_rows.astype(np.int32)),
        shape=(m, n),
        nnz=nnz,
    )

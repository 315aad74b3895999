"""CSR SpMM kernel in Pallas through Triton: GE-SpMM's row-per-block design.

The reference (`spmm_test.cu:104-454`, `spmm_kernel.cu:115-206`) gives one
warp to each CSR row and combines two ideas:

  * Coalesced Row Caching (CRC): the row's next 32 ``(col, val)`` pairs are
    staged together, then each lane reads contiguous columns of ``B[col]``.
  * Coarse-grained Warp Merging (CWM): each thread keeps several output
    columns, so one staged index serves many of them.

Here one program owns one output row (or one segment of a long row) and
one ``BK``-wide column block. It walks the nonzeros in chunks of ``BN``
(CRC: one vector load of the column ids and values), gathers the
``BN x BK`` tile of ``B`` by indexing the ref with the column ids (Triton
turns the indexer into pointer offsets), and accumulates in float32
registers. ``BK`` is as wide as the feature dimension allows (CWM), chosen
by K the way `spmm_kernel.cu:186-206` dispatches on it. Rows longer than
``SEG`` nonzeros are split across programs, so a hub row does not
serialise the launch; their partial rows are added into the output after
the kernel. There is no per-edge intermediate.

Backward of SpMM is SpMM on the transpose, so the custom VJP in
`ops/spmm.py` runs this same kernel on the paired CSC arrays.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

Array = jax.Array


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def block_config(K: int):
    """(BN, BK, num_warps, num_stages, SEG) for feature width K.

    BN nonzeros are staged per chunk; BK output columns per program (all
    of K up to 256, so each staged index is loaded once per row); SEG is
    the most nonzeros one program reduces: longer rows are split into
    segments whose partial sums are added afterwards, so a hub row does
    not serialise the whole launch.  One warp per program, as in the
    reference.  The values are the fastest of a sweep on an H100
    (PERF.md): BN 16/32/64 x warps 1/2/4 x SEG 128/512 x BK, at K = 32,
    40, 256 and 512; within a few per cent of the best at every K.
    """
    bk = min(max(_next_pow2(K), 16), 256)
    return 16, bk, 1, 1, 128


def _work_items(indptr: Array, m: int, nnz: int, seg: int):
    """Per-program edge ranges: program i < m takes the first SEG edges of
    row i; program m + j takes the j-th extra segment of a row longer than
    SEG.  Returns (starts, ends, extra_rows); extra_rows[j] is the row of
    segment j, or m for the unused tail of the static bound nnz // SEG."""
    start0 = indptr[:-1]
    end_row = indptr[1:]
    first_end = jnp.minimum(end_row, start0 + seg)
    X = nnz // seg
    if X == 0:
        return start0, first_end, None
    extra = jnp.maximum((end_row - start0 + seg - 1) // seg - 1, 0)
    ptr = jnp.cumsum(extra)
    j = jnp.arange(X, dtype=jnp.int32)
    # Row of each extra segment by scatter + cumsum (no binary search);
    # the tail beyond sum(extra) repeats the last row and is masked.
    r = jnp.repeat(jnp.arange(m, dtype=jnp.int32), extra,
                   total_repeat_length=X)
    valid = j < ptr[-1]
    xrow = jnp.where(valid, r, m)
    xs = start0[r] + (j - (ptr[r] - extra[r]) + 1) * seg
    xe = jnp.minimum(end_row[r], xs + seg)
    starts = jnp.concatenate([start0, jnp.where(valid, xs, 0)])
    ends = jnp.concatenate([first_end, jnp.where(valid, xe, 0)])
    return starts, ends, xrow


def _kernel(starts_ref, ends_ref, indices_ref, *rest, bn: int, bk: int,
            K: int, m: int, binary: bool, split: bool):
    rest = list(rest)
    data_ref = None if binary else rest.pop(0)
    b_ref, o_ref = rest[0], rest[1]
    p_ref = rest[2] if split else None
    pid = pl.program_id(0)
    k0 = pl.program_id(1) * bk
    start = starts_ref[pid]
    end = ends_ref[pid]
    kcols = k0 + jnp.arange(bk, dtype=jnp.int32)
    kmask = kcols < K
    lanes = jnp.arange(bn, dtype=jnp.int32)

    def body(i, acc):
        e = start + i * bn + lanes
        emask = e < end
        cols = plgpu.load(indices_ref.at[e], mask=emask, other=0)
        tile = plgpu.load(
            b_ref.at[cols[:, None], kcols[None, :]],
            mask=emask[:, None] & kmask[None, :],
            other=0.0,
        ).astype(jnp.float32)
        if data_ref is not None:
            vals = plgpu.load(data_ref.at[e], mask=emask, other=0.0)
            tile = tile * vals.astype(jnp.float32)[:, None]
        return acc + jnp.sum(tile, axis=0)

    n_chunks = (end - start + bn - 1) // bn
    acc = jax.lax.fori_loop(0, n_chunks, body,
                            jnp.zeros((bk,), jnp.float32))
    acc = acc.astype(o_ref.dtype)
    if p_ref is None:
        plgpu.store(o_ref.at[pid, kcols], acc, mask=kmask)
    else:
        is_row = pid < m
        plgpu.store(o_ref.at[jnp.minimum(pid, m - 1), kcols], acc,
                    mask=kmask & is_row)
        plgpu.store(p_ref.at[jnp.maximum(pid - m, 0), kcols], acc,
                    mask=kmask & ~is_row)


@functools.partial(
    jax.jit, static_argnames=("m", "interpret", "config")
)
def _spmm_csr_call(indptr, indices, data, B, *, m: int, interpret: bool,
                   config=None):
    K = B.shape[1]
    nnz = indices.shape[0]
    bn, bk, num_warps, num_stages, seg = config or block_config(K)
    starts, ends, xrow = _work_items(indptr, m, nnz, seg)
    split = xrow is not None
    binary = data is None
    kernel = functools.partial(_kernel, bn=bn, bk=bk, K=K, m=m,
                               binary=binary, split=split)
    operands = (starts, ends, indices) + (() if binary else (data,)) + (B,)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out_shape = [jax.ShapeDtypeStruct((m, K), jnp.float32)]
    if split:
        out_shape.append(jax.ShapeDtypeStruct((xrow.shape[0], K), jnp.float32))
    res = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(starts.shape[0], pl.cdiv(K, bk)),
        in_specs=[any_spec] * len(operands),
        out_specs=[any_spec] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="gespmm_csr_spmm",
    )(*operands)
    out = res[0]
    if split:
        out = out.at[xrow].add(res[1], mode="drop", indices_are_sorted=True)
    return out.astype(B.dtype)


def spmm_csr(
    indptr: Array,
    indices: Array,
    data: Optional[Array],
    B: Array,
    m: int,
    *,
    interpret: bool = False,
) -> Array:
    """C = A @ B for CSR ``A`` of shape (m, B.shape[0]); sum reduce.

    ``data`` None means every stored entry is 1 (binary adjacency).
    Accumulates in float32; the output has B's dtype. ``interpret=True``
    runs the Pallas interpreter (for tests on a machine without a GPU).
    """
    if B.ndim != 2:
        raise ValueError(f"B must be rank 2, got shape {B.shape}")
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "spmm_csr compiles through Triton for the GPU; on the "
            f"{jax.default_backend()!r} backend use interpret=True (tests) "
            "or another spmm method"
        )
    if m == 0 or B.shape[1] == 0 or indices.shape[0] == 0:
        return jnp.zeros((m, B.shape[1]), B.dtype)
    return _spmm_csr_call(
        indptr.astype(jnp.int32), indices.astype(jnp.int32), data, B,
        m=m, interpret=interpret,
    )

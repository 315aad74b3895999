"""SpMM / SDDMM benchmark harness — CSV sweep + roofline report.

Capability parity with the reference's standalone driver + sweep scripts
(`spmm_test.cu:495-826`, `run_test.sh`): for each graph and K, time the
spmm methods and emit a CSV row

    data,K=<k>-xla-gflops,K=<k>-pallas-gflops,...

(schema shaped after `run_test.sh:3`, with our method names in place of
gespmm; ``cusparse`` is cuSPARSE's CSR SpMM through BCSR,
`ops/interop.cusparse_spmm`).  Metrics: GFLOPs = 2·nnz·K / t (`spmm_test.cu:728`)
and nnz/s.  Roofline: the one-pass SpMM's bytes against the device's
published HBM bandwidth (`utils/profiling.spmm_roofline`).  Timing needs a
GPU; ``--iters 0`` only validates.

Run:  python -m gespmm_tpu.bench.spmm_bench --graphs cl169343-14 rmat18 \
          --k 32 128 --validate
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _append_csv(csv_file: str, row: dict) -> None:
    """Merge a row into the CSV: one row per graph (re-running a subset
    REPLACES that graph's row — the round-3 stale-duplicate defect), and
    the schema is the column UNION across runs (a partial re-run, e.g. a
    single graph with a method subset, merges into the existing file
    instead of wiping it)."""
    import csv as _csv

    rows = {}
    cols = []
    if os.path.exists(csv_file):
        with open(csv_file) as f:
            rdr = _csv.DictReader(f)
            cols = list(rdr.fieldnames or [])
            # A pre-existing CSV without the 'data' key column (foreign
            # format) would KeyError here and lose the just-measured
            # results — rewrite such a file from scratch instead.
            if "data" in cols:
                for r in rdr:
                    rows[r["data"]] = r
            else:
                cols = []
    for c in row:
        if c not in cols:
            cols.append(c)
    merged = rows.get(str(row["data"]), {})
    merged.update({k: str(v) for k, v in row.items()})
    rows[str(row["data"])] = merged
    with open(csv_file, "w", newline="") as f:
        w = _csv.DictWriter(f, fieldnames=cols, restval="nan")
        w.writeheader()
        for r in rows.values():
            w.writerow(r)


def _load_graph(name: str, seed: int):
    from gespmm_tpu.utils.datasets import (
        find_graph, load_mtx_graph, synth_graph,
    )

    csr = synth_graph(name, seed=seed)
    if csr is None:
        if not find_graph(name) and not os.path.isfile(name):
            raise FileNotFoundError(name)
        csr = load_mtx_graph(name, binary=True)
    return csr


def _rel_err(got, golden) -> float:
    # float64 golden, mixed abs/rel tolerance: f32 accumulation of a
    # degree-d row carries ~eps*sqrt(d)*|row| of inherent order noise.
    got = np.asarray(got).astype(np.float64)
    return float((np.abs(got - golden) / (1.0 + np.abs(golden))).max())


def bench_graph(
    name: str,
    ks: List[int],
    iters: int = 50,
    methods=("xla", "tiled", "pallas", "cusparse"),
    csv_file: Optional[str] = None,
    seed: int = 0,
    validate: bool = False,
    tol: float = 2e-3,
):
    """Validate (``validate``) and time (``iters`` > 0, GPU only) each
    spmm method on graph ``name`` at each K.  Returns (csv row, cells)."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from gespmm_tpu.ops.spmm import Adjacency, spmm
    from gespmm_tpu.utils import timing

    csr = _load_graph(name, seed)
    m, n = csr.shape
    # Forward-only sum sweep: no transpose plan, no max/min layout.
    adj = Adjacency.from_csr(csr, plan="tiled" in methods,
                             plan_transpose=False, minmax_aligned=False)
    bcsr = None
    if "cusparse" in methods:
        from gespmm_tpu.ops.interop import csr_to_bcsr, cusparse_spmm

        bcsr = csr_to_bcsr(csr)
    A64 = sp.csr_matrix(
        (np.ones(csr.nnz) if csr.data is None
         else np.asarray(csr.data).astype(np.float64),
         np.asarray(csr.indices), np.asarray(csr.indptr)),
        shape=csr.shape,
    )
    rng = np.random.default_rng(seed)
    results = {}
    for K in ks:
        B = jnp.asarray(rng.standard_normal((n, K)).astype(np.float32))
        golden = A64 @ np.asarray(B, np.float64) if validate else None
        for method in methods:
            # Operands are jit ARGUMENTS: closed-over arrays would be
            # compiled in as constants.
            if method == "cusparse":
                fn, arg = cusparse_spmm(bcsr, B), bcsr
            else:
                fn = jax.jit(lambda a, b, _m=method: spmm(a, b, method=_m))
                arg = adj
            cell = {}
            if golden is not None:
                err = _rel_err(fn(arg, B), golden)
                if err > tol:
                    cell["error"] = f"VALIDATION FAILED: err={err:.2e}"
            if iters and "error" not in cell:
                t = timing.benchmark(lambda: fn(arg, B), iters=iters).median_s
                cell.update(ms=t * 1e3, nnz_per_s=csr.nnz / t,
                            gflops=timing.spmm_flops(csr.nnz, K) / t / 1e9)
            results[(K, method)] = cell

    row = {"data": name, "m": m, "n": n, "nnz": csr.nnz}
    for (K, method), v in results.items():
        row[f"K={K}-{method}-gflops"] = round(v.get("gflops", float("nan")), 2)
        if "ms" in v:
            row[f"K={K}-{method}-ms"] = v["ms"]
    if csv_file:
        _append_csv(csv_file, row)
    return row, results


def bench_sddmm_graph(
    name: str,
    ks: List[int],
    iters: int = 50,
    methods=("xla", "tiled"),
    csv_file: Optional[str] = None,
    seed: int = 0,
    validate: bool = False,
    tol: float = 2e-3,
):
    """SDDMM sweep: out[e] = D1[row_e]·D2[col_e] over the graph's
    pattern, validated against float64 and timed per (K, method).

    The reference exposes SDDMM as a first-class op
    (`pytorch-custom/sddmm.cpp:63-68`, kernels `sddmm.cu:427-484`) but
    never benchmarks it.
    """
    import jax
    import jax.numpy as jnp

    from gespmm_tpu.ops.sddmm import sddmm
    from gespmm_tpu.ops.spmm import Adjacency
    from gespmm_tpu.utils import timing

    csr = _load_graph(name, seed)
    m, n = csr.shape
    adj = Adjacency.from_csr(csr, plan=True)
    rng = np.random.default_rng(seed)
    rows_h = np.repeat(np.arange(m), np.diff(np.asarray(csr.indptr)))
    cols_h = np.asarray(csr.indices)
    results = {}
    for K in ks:
        D1 = jnp.asarray(rng.standard_normal((m, K)).astype(np.float32))
        D2 = jnp.asarray(rng.standard_normal((n, K)).astype(np.float32))
        for method in methods:
            fn = jax.jit(lambda a, x, y, _m=method: sddmm(a, x, y, method=_m))
            cell = {}
            if validate:
                golden = np.einsum(
                    "ek,ek->e",
                    np.asarray(D1).astype(np.float64)[rows_h],
                    np.asarray(D2).astype(np.float64)[cols_h],
                )
                err = _rel_err(fn(adj, D1, D2), golden)
                if err > tol:
                    cell["error"] = f"VALIDATION FAILED: err={err:.2e}"
            if iters and "error" not in cell:
                t = timing.benchmark(lambda: fn(adj, D1, D2),
                                     iters=iters).median_s
                cell.update(ms=t * 1e3,
                            gflops=timing.sddmm_flops(csr.nnz, K) / t / 1e9)
            results[(K, method)] = cell

    row = {"data": name, "m": m, "n": n, "nnz": csr.nnz}
    for (K, method), v in results.items():
        row[f"K={K}-sddmm-{method}-gflops"] = round(
            v.get("gflops", float("nan")), 2
        )
    if csv_file:
        _append_csv(csv_file, row)
    return row, results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--graphs", nargs="+", default=["cl169343-14"])
    p.add_argument("--k", nargs="+", type=int, default=[32, 64, 128, 256])
    p.add_argument("--iters", type=int, default=50,
                   help="timed calls per cell (0: validate only)")
    p.add_argument("--methods", nargs="+",
                   default=["xla", "tiled", "pallas", "cusparse"],
                   help="xla | tiled | pallas | scatter | cusparse")
    p.add_argument("--csv", default="",
                   help="merge one row per graph into this CSV file")
    p.add_argument("--validate", action="store_true",
                   help="golden-check each config vs scipy before timing")
    p.add_argument("--tol", type=float, default=2e-3,
                   help="max |out-golden64|/(1+|golden64|)")
    p.add_argument("--sddmm", action="store_true",
                   help="benchmark SDDMM methods (xla/tiled) instead "
                        "of SpMM")
    p.add_argument("--roofline", action="store_true",
                   help="append K=<k>-roofline-frac columns (fraction of "
                        "the one-pass SpMM's HBM bound, best method)")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}))
    for g in args.graphs:
        if args.sddmm:
            row, results = bench_sddmm_graph(
                g, args.k, iters=args.iters,
                methods=tuple(
                    m for m in args.methods if m in ("xla", "tiled")
                ) or ("xla", "tiled"),
                csv_file=args.csv, validate=args.validate, tol=args.tol,
            )
        else:
            row, results = bench_graph(
                g, args.k, iters=args.iters, methods=tuple(args.methods),
                validate=args.validate, tol=args.tol,
            )
            if args.roofline:
                from gespmm_tpu.utils.profiling import spmm_roofline

                for K in args.k:
                    best = min(
                        (v["ms"] for (kk, _), v in results.items()
                         if kk == K and "ms" in v),
                        default=None,
                    )
                    if best is not None:
                        row[f"K={K}-roofline-frac"] = round(spmm_roofline(
                            row["nnz"], row["m"], K, best * 1e-3
                        )["fraction_of_roofline"], 3)
            if args.csv:
                _append_csv(args.csv, row)
        print(json.dumps(row))
        errs = {f"K={k}-{m}": v["error"]
                for (k, m), v in results.items() if "error" in v}
        if errs:
            print(json.dumps({"data": g, "errors": errs}), file=sys.stderr)
            raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Distributed SpMM weak-scaling benchmark.

Row-partitioned SpMM over a (data,) mesh of GPUs with the problem size
grown proportionally to the device count, reporting nnz/s and efficiency
vs the single-device run.  Needs GPUs (one process drives all the cards
of a host).

Run:  python -m gespmm_tpu.bench.dist_bench --devices 1 2 4 --scale 16
"""

from __future__ import annotations

import argparse
import json


def bench_weak_scaling(devices_list, scale, k, edge_factor, iters=20,
                       method="xla", partition="none"):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gespmm_tpu.parallel.dist_spmm import (
        dist_spmm,
        partition_adjacency,
    )
    from gespmm_tpu.parallel.halo import (
        build_halo_partition,
        halo_spmm,
        pad_for_halo,
    )
    from gespmm_tpu.parallel.mesh import make_mesh
    from gespmm_tpu.utils import timing
    from gespmm_tpu.utils.datasets import rmat_graph

    timing.require_gpu()
    results = []
    base_rate = None
    for nd in devices_list:
        if nd > len(jax.devices()):
            print(json.dumps({"devices": nd, "skipped": "not enough devices"}))
            continue
        # Weak scaling: grow nodes with device count (edges grow ~linearly).
        extra = int(np.log2(nd))
        csr = rmat_graph(scale=scale + extra, edge_factor=edge_factor, seed=0)
        mesh = make_mesh(data=nd, model=1, devices=jax.devices()[:nd])
        n = csr.shape[1]
        B = jnp.asarray(
            np.random.default_rng(0).standard_normal((n, k)).astype(np.float32)
        )
        halo_frac = naive_frac = None
        if method in ("halo", "halo-tiled"):
            if partition != "none" and nd > 1:
                # Cut-reducing node partition (VERDICT r2 #3): permute the
                # graph so equal row slabs coincide with the computed
                # shards; B/features follow the same permutation.
                from gespmm_tpu.sparse.reorder import (
                    apply_permutation,
                    halo_need_stats,
                    partition_order,
                )

                naive_frac = round(
                    halo_need_stats(csr, nd)["footprint_frac"], 4
                )
                perm = partition_order(csr, nd, method=partition)
                csr = apply_permutation(csr, perm)
                B = B[jnp.asarray(perm)]
            hp = build_halo_partition(csr, nd, tiled=(method == "halo-tiled"))
            halo_frac = round(hp.footprint_fraction, 4)
            B = jax.device_put(
                pad_for_halo(hp, B), NamedSharding(mesh, P("data", None))
            )
            tier = "tiled" if method == "halo-tiled" else "xla"
            fn = jax.jit(
                lambda h, b: halo_spmm(h, b, mesh, method=tier,
                                       model_axis=None)
            )
            run = lambda: fn(hp, B)  # noqa: E731
        else:  # all-gather reference tier
            padj = partition_adjacency(csr, nd)
            n_pad = ((n + nd - 1) // nd) * nd
            B = jnp.pad(B, ((0, n_pad - n), (0, 0)))
            B = jax.device_put(B, NamedSharding(mesh, P("data", None)))
            fn = jax.jit(
                lambda p, b: dist_spmm(p, b, mesh, model_axis=None)
            )
            run = lambda: fn(padj, B)  # noqa: E731
        r = timing.benchmark(run, iters=iters)
        dt = r.median_s
        rate = csr.nnz / dt
        if base_rate is None:
            base_rate = rate / nd  # per-device rate at 1 device
        eff = rate / (base_rate * nd)
        row = {
            "devices": nd,
            "nodes": csr.shape[0],
            "nnz": csr.nnz,
            "k": k,
            "ms": round(dt * 1e3, 3),
            "nnz_per_s": round(rate, 0),
            "weak_scaling_efficiency": round(eff, 4),
            **({} if halo_frac is None else {"halo_footprint_frac": halo_frac}),
            **({} if naive_frac is None else
               {"naive_footprint_frac": naive_frac, "partition": partition}),
        }
        results.append(row)
        print(json.dumps(row))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4])
    p.add_argument("--scale", type=int, default=13,
                   help="log2 nodes at 1 device")
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--method", default="halo-tiled",
                   choices=["allgather", "halo", "halo-tiled"])
    p.add_argument("--partition", default="none",
                   choices=["none", "auto", "fennel", "random"],
                   help="cut-reducing node partition applied before the "
                        "halo split (sparse/reorder.partition_order)")
    args = p.parse_args(argv)
    bench_weak_scaling(
        args.devices, args.scale, args.k, args.edge_factor, args.iters,
        method=args.method, partition=args.partition,
    )


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Headline benchmark: one JSON line with one SpMM rate.

Metric: SpMM GFLOP/s (2·nnz·K / time, `spmm_test.cu:728`) through
``method="auto"`` at K=128 on an ogbn-arxiv-shaped graph (a generated
Chung-Lu graph with self-loops: 169,343 nodes, about 2.4M nonzeros).
``vs_baseline`` is cuSPARSE's time over ours, with cuSPARSE's CSR SpMM
reached through `jax.experimental.sparse` BCSR under JAX's cuSPARSE
lowering (`ops/interop.cusparse_spmm`) — the gespmm-vs-cuSPARSE framing of
`spmm_test.cu:714-762`.  Times are medians of data-chained steps in one
jit, each group ended by `block_until_ready` (`utils/timing.py`).

Needs a GPU: exits non-zero without one.
"""

import json
import sys


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from gespmm_tpu.ops.graph import add_self_loops
    from gespmm_tpu.ops.interop import (
        csr_to_bcsr, cusparse_lowering, cusparse_spmm,
    )
    from gespmm_tpu.ops.spmm import Adjacency, spmm
    from gespmm_tpu.utils import timing
    from gespmm_tpu.utils.datasets import synth_graph

    dev = timing.require_gpu()
    name = "cl169343-14"
    csr = add_self_loops(synth_graph(name, seed=0)).with_data(None)
    K = 128
    n = csr.shape[1]
    adj = Adjacency.from_csr(csr)
    B = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, K)).astype(np.float32)
        * 0.01
    )
    ours = timing.benchmark_chained(
        lambda a, x: spmm(a, x, method="auto") * 0.5, B, iters=100,
        groups=5, consts=adj,
    )
    bcsr = csr_to_bcsr(csr)
    cusparse_spmm(bcsr, B)  # raises unless BCSR @ dense reaches cuSPARSE
    with cusparse_lowering():
        stock = timing.benchmark_chained(
            lambda M, x: (M @ x) * 0.5, B, iters=100, groups=5, consts=bcsr,
        )
    gf = timing.spmm_flops(csr.nnz, K) / ours.median_s / 1e9
    print(json.dumps({
        "metric": f"spmm_gflops_{name}_k{K}",
        "value": round(gf, 3),
        "unit": "GFLOP/s",
        "vs_baseline": round(stock.median_s / ours.median_s, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

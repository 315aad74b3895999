"""gespmm_tpu — sparse linear algebra for graph learning, in JAX, on GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
GE-SpMM (hgyhungry/ge-spmm, SC'20): CSR SpMM with sum/max/mean reduction
monoids, SDDMM (COO and CSR), CSR<->CSC transforms with transpose-paired
autodiff, graph aggregation ops (GCN symmetric normalization, GraphSAGE
mean/gcn/pool), end-to-end GNN training, a benchmark harness, and — new
over the reference — multi-device scaling via `shard_map` row-partitioned
SpMM on a `jax.sharding.Mesh`.

Layering (bottom-up):
    sparse/    formats (CSR/COO pytrees), .mtx ingest, tile planner
    kernels/   Pallas-Triton CSR SpMM kernel; slot-layout compositions
    ops/       jittable primitives with custom VJPs + dispatch heuristics
    parallel/  mesh construction, distributed SpMM, sharded train steps
    models/    GCN, GraphSAGE (pure-functional modules)
    train/     training loops, checkpointing
    utils/     datasets, timing, native-IO bindings
    bench/     benchmark CLIs (GFLOPs / nnz-per-second CSV harness)
"""

from gespmm_tpu.sparse.formats import CSR, CSC, COO, csr_from_coo, csr_to_csc
from gespmm_tpu.ops.spmm import Adjacency, spmm
from gespmm_tpu.ops.sddmm import sddmm, sddmm_coo
from gespmm_tpu.ops.graph import (
    attention_aggregate,
    edge_softmax,
    gcn_aggregate,
)

__version__ = "0.1.0"

__all__ = [
    "Adjacency",
    "CSR",
    "CSC",
    "COO",
    "csr_from_coo",
    "csr_to_csc",
    "spmm",
    "sddmm",
    "sddmm_coo",
    "attention_aggregate",
    "edge_softmax",
    "gcn_aggregate",
    "__version__",
]

#!/bin/sh
# One-shot benchmark sweep on a GPU (capability parity with the reference's
# run_test.sh): SpMM and SDDMM CSV sweeps over generated graphs, then the
# GCN/SAGE/GAT end-to-end benchmarks.  Prints JSON lines; needs a GPU.
set -e
GRAPHS="${GRAPHS:-cl169343-14 rmat18}"
KS="${KS:-32 64 128 256}"
python -m gespmm_tpu.bench.spmm_bench --graphs $GRAPHS --k $KS --validate --roofline --csv spmm_bench_out.csv
python -m gespmm_tpu.bench.spmm_bench --graphs $GRAPHS --k 32 64 128 --sddmm --validate --csv sddmm_bench_out.csv
python -m gespmm_tpu.bench.gcn_bench --n-epochs 100 --log-every 0
python -m gespmm_tpu.bench.sage_bench --n-epochs 100 --aggregator-type mean --log-every 0
python -m gespmm_tpu.bench.sage_bench --n-epochs 100 --aggregator-type pool --log-every 0
python -m gespmm_tpu.bench.gat_bench --n-epochs 100 --log-every 0

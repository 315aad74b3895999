"""End-to-end GraphSAGE training benchmark.

Capability parity with `dgl-custom/benchmark/sage/sage_dgl.py`: the
`--aggregator-type` surface (`sage_dgl.py:181-182`), per-epoch time, and
the ETputs metric (thousands of traversed edges per second,
`sage_dgl.py:142-144`).

Run:  python -m gespmm_tpu.bench.sage_bench --aggregator-type pool
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="cl169343-14")
    p.add_argument("--n-hidden", type=int, default=16)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument(
        "--aggregator-type", default="mean",
        choices=["mean", "gcn", "pool", "sum", "lstm"],
    )
    p.add_argument("--max-neighbors", type=int, default=32,
                   help="lstm aggregator: neighbor sample cap per node")
    p.add_argument("--method", default="auto", choices=["auto", "xla", "pallas"])
    p.add_argument(
        "--impl", default="ours", choices=["ours", "stock"],
        help="'stock' trains the identical model on stock JAX ops "
        "(BCOO matmul / segment_max) — the A/B baseline",
    )
    p.add_argument("--log-every", type=int, default=20)
    args = p.parse_args(argv)

    from gespmm_tpu.models.sage import GraphSAGE
    from gespmm_tpu.ops.spmm import Adjacency
    from gespmm_tpu.train.loop import train_node_classifier
    from gespmm_tpu.utils.datasets import planetoid_style_dataset, sbm_graph

    if args.dataset == "sbm":
        ds = sbm_graph(n_per_class=500, num_classes=4)
    else:
        ds = planetoid_style_dataset(args.dataset)

    adj = Adjacency.from_csr(ds.csr, plan=True)
    dims = (
        [ds.features.shape[1]]
        + [args.n_hidden] * (args.n_layers - 1)
        + [ds.num_classes]
    )
    neighbor_table = None
    if args.aggregator_type == "lstm":
        from gespmm_tpu.models.sage_lstm import build_neighbor_table

        neighbor_table = build_neighbor_table(
            ds.csr, max_neighbors=args.max_neighbors
        )
    if args.impl == "stock":
        from gespmm_tpu.models.baselines import SAGEStock

        if args.aggregator_type not in ("mean", "sum", "pool"):
            raise SystemExit(
                "--impl stock supports mean/sum/pool aggregators"
            )
        model = SAGEStock(dims=dims, aggregator=args.aggregator_type,
                          dropout_rate=args.dropout)
        adj_nnz = adj.nnz
        adj = SAGEStock.from_adjacency(adj, args.aggregator_type)
    else:
        model = GraphSAGE(
            dims=dims, aggregator=args.aggregator_type,
            dropout_rate=args.dropout, method=args.method,
            neighbor_table=neighbor_table,
        )
        adj_nnz = adj.nnz
    res = train_node_classifier(
        model, adj, ds.features, ds.labels, ds.masks,
        epochs=args.n_epochs, lr=args.lr, weight_decay=args.weight_decay,
        log_every=args.log_every,
    )
    # ETputs: edges traversed per second per epoch (sage_dgl.py:142-144).
    etputs_kteps = (
        adj_nnz / res["mean_epoch_time"] / 1e3
        if res["mean_epoch_time"] > 0
        else float("nan")
    )
    print(json.dumps({
        "dataset": ds.name,
        "aggregator": args.aggregator_type,
        "impl": args.impl,
        "dims": dims,
        "mean_epoch_time_ms": round(res["mean_epoch_time"] * 1e3, 3),
        "etputs_kteps": round(etputs_kteps, 1),
        "train_acc": round(res["train_acc"], 4),
        "val_acc": round(res["val_acc"], 4),
        "test_acc": round(res["test_acc"], 4),
    }))


if __name__ == "__main__":
    main()

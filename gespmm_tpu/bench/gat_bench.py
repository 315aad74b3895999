"""End-to-end GAT training benchmark.

Beyond-reference model family (the reference ships GCN and GraphSAGE
benchmarks only): graph attention built compositionally from our SDDMM
(attention logits) + edge softmax + edge-valued SpMM, exercising the
differentiable-edge-value path the reference explicitly lacks
(`pytorch-custom/op.py:22-27`).  CLI and reporting mirror
`bench/gcn_bench.py` (≙ `dgl-custom/benchmark/gcn/gcn_dgl.py:205-225`).

Run:  python -m gespmm_tpu.bench.gat_bench --dataset cl169343-14 --n-hidden 64
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="cl169343-14",
                   help="bundled graph name, .mtx path, or 'sbm'")
    p.add_argument("--n-hidden", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=1)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--self-loop", action="store_true", default=True)
    p.add_argument("--no-self-loop", dest="self_loop", action="store_false")
    p.add_argument("--method", default="auto",
                   choices=["auto", "xla", "pallas", "tiled"])
    p.add_argument("--plan", action="store_true", default=False,
                   help="build the tiled slot layout (needed by "
                        "method='tiled', the fused attention chain)")
    p.add_argument(
        "--impl", default="ours", choices=["ours", "stock"],
        help="'stock' trains the identical model on stock JAX ops "
        "(segment_* softmax + BCOO matmul) — the A/B baseline",
    )
    p.add_argument("--log-every", type=int, default=20)
    args = p.parse_args(argv)

    from gespmm_tpu.models.gat import GAT
    from gespmm_tpu.ops.graph import add_self_loops
    from gespmm_tpu.ops.spmm import Adjacency
    from gespmm_tpu.train.loop import train_node_classifier
    from gespmm_tpu.utils.datasets import planetoid_style_dataset, sbm_graph

    if args.dataset == "sbm":
        ds = sbm_graph(n_per_class=500, num_classes=4)
    else:
        ds = planetoid_style_dataset(args.dataset)

    csr = add_self_loops(ds.csr) if args.self_loop else ds.csr
    adj = Adjacency.from_csr(csr, plan=args.plan)
    dims = (
        [ds.features.shape[1]]
        + [args.n_hidden] * (args.n_layers - 1)
        + [ds.num_classes]
    )
    if args.impl == "stock":
        from gespmm_tpu.models.baselines import GATStock

        model = GATStock(dims=dims)
        adj = GATStock.from_adjacency(adj)
    else:
        model = GAT(dims=dims, method=args.method, heads=args.n_heads)
    res = train_node_classifier(
        model, adj, ds.features, ds.labels, ds.masks,
        epochs=args.n_epochs, lr=args.lr,
        weight_decay=args.weight_decay, log_every=args.log_every,
    )
    print(
        json.dumps(
            {
                "dataset": args.dataset,
                "model": "gat",
                "n": csr.shape[0],
                "nnz": csr.nnz,
                "dims": dims,
                "impl": args.impl,
                "epochs": args.n_epochs,
                "mean_epoch_time_ms": round(
                    res["mean_epoch_time"] * 1e3, 3
                ),
                "train_acc": round(res["train_acc"], 4),
                "val_acc": round(res["val_acc"], 4),
                "test_acc": round(res["test_acc"], 4),
            }
        )
    )


if __name__ == "__main__":
    main()

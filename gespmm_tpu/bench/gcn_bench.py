"""End-to-end GCN training benchmark.

Capability parity with `pytorch-custom/gcn_custom.py` and
`dgl-custom/benchmark/gcn/gcn_dgl.py`: CLI flags (--dataset, --n-hidden,
--n-layers, --self-loop, --n-epochs — matching `gcn_dgl.py:205-225`),
per-epoch wall time (mean after 3 warmup epochs, ≙ `gcn_dgl.py:176-186`),
final train/val/test accuracy, and an optional jax.profiler trace (the
analogue of the torch profiler tables at `gcn_custom.py:134-143`).

Run:  python -m gespmm_tpu.bench.gcn_bench --dataset cl169343-14 \\
          --n-hidden 256 --n-layers 3
(``cl169343-14`` is a generated Chung-Lu graph with ogbn-arxiv's node
count and edge count; 128 features and 40 classes match ogbn-arxiv.)
"""

from __future__ import annotations

import argparse
import json


def train_gcn(ds, *, n_hidden: int, n_layers: int, dropout: float,
              lr: float, weight_decay: float, epochs: int, method: str,
              plan: bool, self_loop: bool = True, log_every: int = 0,
              checkpoint_dir=None, impl: str = "ours"):
    """Build the adjacency and model for ``ds`` and train.

    Returns ``(result, adj, dims)``: the `train_node_classifier` result,
    the `Adjacency` (self-loops included), and the layer widths.
    """
    from gespmm_tpu.models.gcn import GCN
    from gespmm_tpu.ops.graph import add_self_loops
    from gespmm_tpu.ops.spmm import Adjacency
    from gespmm_tpu.train.loop import train_node_classifier

    csr = add_self_loops(ds.csr) if self_loop else ds.csr
    adj = Adjacency.from_csr(csr, plan=plan)
    dims = [ds.features.shape[1]] + [n_hidden] * (n_layers - 1) + [
        ds.num_classes
    ]
    train_adj = adj
    if impl == "bcoo":
        from gespmm_tpu.models.baselines import GCNBcoo

        model = GCNBcoo(dims=dims, dropout_rate=dropout)
        train_adj = GCNBcoo.from_adjacency(adj)
    else:
        model = GCN(dims=dims, dropout_rate=dropout,
                    method=method).with_norms(adj)
    res = train_node_classifier(
        model, train_adj, ds.features, ds.labels, ds.masks,
        epochs=epochs, lr=lr, weight_decay=weight_decay,
        log_every=log_every, checkpoint_dir=checkpoint_dir,
        checkpoint_every=50 if checkpoint_dir else 0,
    )
    return res, adj, dims


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="cl169343-14",
                   help="generated graph name (see utils/datasets."
                        "synth_graph), bundled graph name, .mtx path, or "
                        "'sbm'")
    p.add_argument("--num-classes", type=int, default=40)
    p.add_argument("--feat-dim", type=int, default=128)
    p.add_argument("--n-hidden", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=3,
                   help="number of GCN layers (2 = one hidden)")
    p.add_argument("--n-epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--self-loop", action="store_true", default=True)
    p.add_argument("--no-self-loop", dest="self_loop", action="store_false")
    p.add_argument("--method", default="auto",
                   choices=["auto", "xla", "pallas", "tiled"])
    p.add_argument(
        "--impl", default="ours", choices=["ours", "bcoo"],
        help="'bcoo' trains the identical model on stock "
        "jax.experimental.sparse (the gcn_pyg.py-style A/B baseline)",
    )
    p.add_argument("--plan", action="store_true", default=False,
                   help="build the tiled slot layout for the adjacency "
                        "(needed by method='tiled')")
    p.add_argument("--profile-dir", default="",
                   help="write a jax.profiler trace here")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--log-every", type=int, default=20)
    args = p.parse_args(argv)

    import jax

    from gespmm_tpu.utils.datasets import planetoid_style_dataset, sbm_graph

    if args.dataset == "sbm":
        ds = sbm_graph(n_per_class=500, num_classes=4)
    else:
        ds = planetoid_style_dataset(args.dataset, feat_dim=args.feat_dim,
                                     num_classes=args.num_classes)

    def run():
        return train_gcn(
            ds, n_hidden=args.n_hidden, n_layers=args.n_layers,
            dropout=args.dropout, lr=args.lr,
            weight_decay=args.weight_decay, epochs=args.n_epochs,
            method=args.method, plan=args.plan or args.method == "tiled",
            self_loop=args.self_loop, log_every=args.log_every,
            checkpoint_dir=args.checkpoint_dir or None, impl=args.impl,
        )

    if args.profile_dir:
        with jax.profiler.trace(args.profile_dir):
            res, adj, dims = run()
    else:
        res, adj, dims = run()

    dev = jax.devices()[0]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "dataset": ds.name,
        "n": int(ds.features.shape[0]),
        "nnz": adj.nnz,
        "dims": dims,
        "impl": args.impl,
        "method": args.method,
        "epochs": args.n_epochs,
        "mean_epoch_time_ms": round(res["mean_epoch_time"] * 1e3, 3),
        "train_acc": round(res["train_acc"], 4),
        "val_acc": round(res["val_acc"], 4),
        "test_acc": round(res["test_acc"], 4),
    }))


if __name__ == "__main__":
    main()

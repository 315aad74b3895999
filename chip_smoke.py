#!/usr/bin/env python
"""Smoke test of gespmm on one NVIDIA GPU: the quickest proof the system runs.

    python chip_smoke.py           # one card: kernels, then GCN training
    python chip_smoke.py --four    # four cards: the sharded GCN only

One card:
  * Main path: GCN at the widths of OGB's ogbn-arxiv GCN baseline
    (snap-stanford/ogb, examples/nodeproppred/arxiv/gnn.py: 3 layers,
    128 -> 256 -> 256 -> 40, dropout 0.5, lr 0.01) trained for 20 steps
    through `bench/gcn_bench.train_gcn` with method="auto", and again with
    method="xla"; the losses must fall and agree.
  * SpMM (sum) on an ogbn-arxiv-shaped Chung-Lu graph and on R-MAT scale
    20, through every path: the Triton CSR kernel, the tiled slot layout,
    the plain XLA formulation and cuSPARSE's CSR SpMM (through
    `jax.experimental.sparse` BCSR with JAX's cuSPARSE lowering on), each
    checked against float64 scipy and timed.
  * Through method="auto": max/min SpMM with their VJP, SDDMM, and one GAT
    layer forward and backward (the unfused composition that "auto" takes,
    and the fused chain that method="tiled" asks for), each checked
    against the plain XLA reference.
Four cards (--four): `parallel/train_step.build_sharded_gcn` over the halo
tier on a Fennel-partitioned graph, against the same model, init and steps
on one card through the unsharded XLA path.

Every phase that fails raises, and the script exits non-zero; the last
line of output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The ogbn-arxiv shape: 169,343 nodes; 1,166,243 directed edges, which
# symmetrize to about 2.3M (a Chung-Lu graph at average degree 14 gives
# 2,278,016), plus one self-loop per node.
ARXIV_GRAPH = "cl169343-14"
ARXIV_FEATURES, ARXIV_CLASSES = 128, 40
REDUCED = [
    "ogbn-arxiv is replaced by a generated Chung-Lu graph of the same node "
    "and edge count (the real graph is not in the repository)",
    "the baseline's BatchNorm is left out (this GCN has none)",
]
# float32 gather/FMA paths use no tensor cores: max|err| <= 1e-5 max|ref|.
TOL_FMA = 1e-5
# cuSPARSE is a library baseline that sums in its own order.
TOL_CUSPARSE = 1e-4
# The GAT check runs ours and the reference at "highest" precision: at the
# default (TF32) the projections' rounding reaches 2.4e-2 of max|grad| on
# the attention vectors' cancelling gradients and would hide any sparse
# error.  What remains is exp/softmax chains summed in two orders (slot
# vs CSR) over rows of up to 22k edges.
TOL_GAT = 1e-4


def compile_cache_dir(environ=os.environ, repo: str = REPO) -> str:
    """Where the persistent compile cache goes: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else ``<repo>/.jax_cache``."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        repo, ".jax_cache")


def log(*a):
    print(*a, flush=True)


def rel_err(out, ref) -> float:
    import numpy as np

    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        raise AssertionError(f"shape {out.shape} != reference {ref.shape}")
    if not np.all(np.isfinite(out)):
        raise AssertionError("non-finite values in the output")
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max|err|/max|ref| = {err:.3e} > {tol}")


def median_ms(fn, reps: int = 20) -> float:
    from gespmm_tpu.utils import timing

    return timing.benchmark(fn, iters=reps).median_s * 1e3


def setup() -> str:
    import jax

    devs = jax.devices()
    log("jax", jax.__version__, "devices", devs)
    log("device_kind", devs[0].device_kind)
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found {devs[0].platform!r}")
    cache = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache)
    log("compile cache", cache)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    log("card:", card)
    return card


def arxiv_dataset():
    from gespmm_tpu.utils.datasets import planetoid_style_dataset

    t0 = time.perf_counter()
    ds = planetoid_style_dataset(ARXIV_GRAPH, feat_dim=ARXIV_FEATURES,
                                 num_classes=ARXIV_CLASSES)
    log(f"dataset {ds.name}: {ds.csr.shape[0]} nodes, {ds.csr.nnz} edges, "
        f"built in {time.perf_counter() - t0:.1f} s (set-up)")
    return ds


# ---------------------------------------------------------------------------
# Main path: GCN training
# ---------------------------------------------------------------------------


def gcn_phase(ds, card: str, steps: int = 20) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gespmm_tpu.bench.gcn_bench import train_gcn
    from gespmm_tpu.models.gcn import GCN
    from gespmm_tpu.train.loop import TrainState, make_train_step

    kw = dict(n_hidden=256, n_layers=3, dropout=0.5, lr=0.01,
              weight_decay=0.0, epochs=steps, plan=False)
    losses, times = {}, {"auto": [], "xla": []}
    # auto, xla, xla, auto: the two orders cancel a drift in clocks.
    for method in ("auto", "xla", "xla", "auto"):
        t0 = time.perf_counter()
        res, adj, dims = train_gcn(ds, method=method, **kw)
        losses.setdefault(method, np.asarray(res["history"]["loss"]))
        times[method].append(res["mean_epoch_time"] * 1e3)
        log(f"gcn method={method}: dims {dims}, {steps} steps in "
            f"{time.perf_counter() - t0:.1f} s with compilation, "
            f"{times[method][-1]:.3f} ms/step [{card}]")
        log(f"  loss {losses[method][0]:.5f} -> {losses[method][-1]:.5f}")
    log("gcn ms/step, auto: " + ", ".join(f"{t:.3f}" for t in times["auto"])
        + "; xla: " + ", ".join(f"{t:.3f}" for t in times["xla"]))
    la, lx = losses["auto"], losses["xla"]
    if not (np.all(np.isfinite(la)) and la[-1] < la[0]):
        raise AssertionError(f"GCN loss not finite and falling: {la}")
    rel = float(np.max(np.abs(la - lx) / np.abs(lx)))
    log(f"gcn auto vs xla losses: max rel diff {rel:.2e} (bar 1e-3)")
    if rel > 1e-3:
        raise AssertionError(f"GCN auto/xla losses differ by {rel:.2e}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"gcn peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    model = GCN(dims=dims, dropout_rate=0.5, method="auto").with_norms(adj)
    opt = optax.adamw(0.01, weight_decay=0.0)
    key = jax.random.PRNGKey(0)
    params = model.init(key)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(model, opt, adj=adj, base_key=key)
    compiled = step.jitted.lower(state, adj, key, ds.features, ds.labels,
                                 ds.masks["train"]).compile()
    log("gcn step memory_analysis:", compiled.memory_analysis())
    log("reduced:", "; ".join(REDUCED))


# ---------------------------------------------------------------------------
# SpMM through every path
# ---------------------------------------------------------------------------


def spmm_phase(name: str, csr, Ks, card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp

    from gespmm_tpu.ops.interop import csr_to_bcsr, cusparse_spmm
    from gespmm_tpu.ops.spmm import Adjacency, _resolve_method, spmm

    m, n = csr.shape
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    vals = (np.ones(csr.nnz, np.float32) if csr.data is None
            else np.asarray(csr.data, np.float32))
    A = sp.csr_matrix((vals.astype(np.float64), indices, indptr),
                      shape=(m, n))
    t0 = time.perf_counter()
    adj = Adjacency.from_csr(csr, plan=True, plan_transpose=False)
    log(f"{name}: {m} rows, {csr.nnz} nonzeros, max row "
        f"{int(np.diff(indptr).max())}; adjacency + tiled plan in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    bcsr = csr_to_bcsr(csr)
    # Each path gets only the arrays it reads: a call's time includes the
    # host's dispatch of its arguments, and the tiled plan's many arrays
    # would add to the paths that ignore it.
    plain = adj.without_plans()
    paths = {
        "spmm_csr": (jax.jit(lambda a, b: spmm(a, b, method="pallas")),
                     plain, TOL_FMA),
        "tiled_xla": (jax.jit(lambda a, b: spmm(a, b, method="tiled")),
                      adj, TOL_FMA),
        "xla": (jax.jit(lambda a, b: spmm(a, b, method="xla")), plain,
                TOL_FMA),
    }
    for K in Ks:
        B = jnp.asarray(np.random.default_rng(K).standard_normal(
            (n, K)).astype(np.float32))
        # cuSPARSE's CSR SpMM, compiled per shape under JAX's cuSPARSE
        # lowering (it raises if the program holds no cuSPARSE call).
        paths["cusparse"] = (cusparse_spmm(bcsr, B), bcsr, TOL_CUSPARSE)
        ref = A @ np.asarray(B, np.float64)
        row = {}
        for pname, (fn, a, tol) in paths.items():
            err = rel_err(fn(a, B), ref)
            check(f"{name} K={K} {pname}", err, tol)
            row[pname] = (median_ms(lambda: fn(a, B)), err)
        auto = _resolve_method("auto", None, K, "sum", csr.nnz / m)
        log(f"spmm {name} K={K}: " + ", ".join(
            f"{p} {t:.4f} ms (err {e:.1e})" for p, (t, e) in row.items())
            + f"; auto takes {auto} [{card}]")


def auto_ops_phase(csr, card: str) -> None:
    """max/min + VJP, SDDMM and a GAT layer through method="auto"."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gespmm_tpu as gt
    from gespmm_tpu.models.gat import gat_layer_apply, gat_layer_init
    from gespmm_tpu.ops.spmm import Adjacency

    adj = Adjacency.from_csr(csr, plan=True)
    plain = Adjacency.from_csr(csr)
    m, n = csr.shape
    rng = np.random.default_rng(7)
    K = 64
    B = jnp.asarray(rng.standard_normal((n, K)).astype(np.float32))
    W = jnp.asarray(rng.standard_normal((m, K)).astype(np.float32))

    for op in ("max", "min"):
        def loss(b, a, meth, _op=op):
            return jnp.sum(gt.spmm(a, b, reduce=_op, method=meth) * W)

        f = jax.jit(jax.value_and_grad(loss), static_argnums=2)
        (lo, g), (lr_, gr) = f(B, adj, "auto"), f(B, plain, "xla")
        out = gt.spmm(adj, B, reduce=op)
        ref = gt.spmm(plain, B, reduce=op, method="xla")
        e_out, e_g = rel_err(out, ref), rel_err(g, gr)
        check(f"{op} forward", e_out, TOL_FMA)
        check(f"{op} VJP", e_g, TOL_FMA)
        t = median_ms(lambda: f(B, adj, "auto"))
        t_x = median_ms(lambda: f(B, plain, "xla"))
        log(f"{op} K={K} fwd+VJP auto {t:.4f} ms, xla {t_x:.4f} ms "
            f"(err out {e_out:.1e}, grad {e_g:.1e}) [{card}]")

    D1 = jnp.asarray(rng.standard_normal((m, K)).astype(np.float32))
    sddmm = jax.jit(lambda a, x, y: gt.sddmm(a, x, y))
    rows = np.repeat(np.arange(m), np.diff(np.asarray(csr.indptr)))
    ref = np.einsum("ek,ek->e", np.asarray(D1, np.float64)[rows],
                    np.asarray(B, np.float64)[np.asarray(csr.indices)])
    e = rel_err(sddmm(adj, D1, B), ref)
    check("sddmm", e, TOL_FMA)
    log(f"sddmm K={K}: {median_ms(lambda: sddmm(adj, D1, B)):.4f} ms "
        f"(err {e:.1e}) [{card}]")

    x = jnp.asarray(rng.standard_normal((n, 128)).astype(np.float32))
    p = gat_layer_init(jax.random.PRNGKey(1), 128, 64)
    Wg = jnp.asarray(rng.standard_normal((m, 64)).astype(np.float32))

    def gat_loss(p, a, meth):
        return jnp.sum(gat_layer_apply(p, a, x, method=meth) * Wg)

    gat = jax.jit(jax.value_and_grad(gat_loss), static_argnums=2)
    # Both on the planned adjacency: "tiled" asks for the fused slot-space
    # chain; "auto" must take the unfused composition on the GPU.
    methods = {"fused": "tiled", "unfused": "auto"}
    with jax.default_matmul_precision("highest"):
        _, g_ref = gat(p, plain, "xla")
        out_ref = gat_layer_apply(p, plain, x, method="xla")
        checked = {label: (gat(p, adj, meth)[1],
                           gat_layer_apply(p, adj, x, method=meth))
                   for label, meth in methods.items()}
    for label, meth in methods.items():
        g, out = checked[label]
        e_out = rel_err(out, out_ref)
        e_g = max(rel_err(g[k], g_ref[k]) for k in g_ref)
        check(f"GAT {label} forward", e_out, TOL_GAT)
        check(f"GAT {label} grads", e_g, TOL_GAT)
        log(f"GAT layer 128->64 {label} (method={meth}) fwd+bwd at default "
            f"precision {median_ms(lambda: gat(p, adj, meth)):.4f} ms "
            f"(err at highest: out {e_out:.1e}, grads {e_g:.1e}) [{card}]")


# ---------------------------------------------------------------------------
# Four cards: the sharded GCN over the halo tier
# ---------------------------------------------------------------------------


FOUR_LR = 1e-2


def unsharded_gcn_losses(csr, params, x, labels, mask, steps: int):
    """The model of `build_sharded_gcn` (2 layers, mean aggregation,
    AdamW) on one card through the plain single-card path: `spmm` with
    method="xla" on the whole graph, no mesh, no halo partition."""
    import jax
    import numpy as np
    import optax

    from gespmm_tpu.ops.spmm import Adjacency, spmm
    from gespmm_tpu.train.loop import masked_nll_loss

    adj = Adjacency.from_csr(csr)

    def loss_fn(p, adj, x, labels, mask):
        h = x @ p["l1"]["w"] + p["l1"]["b"]
        h = jax.nn.relu(spmm(adj, h, reduce="mean", method="xla"))
        logits = h @ p["l2"]["w"] + p["l2"]["b"]
        logits = spmm(adj, logits, reduce="mean", method="xla")
        return masked_nll_loss(jax.nn.log_softmax(logits, axis=-1), labels,
                               mask)

    opt = optax.adamw(FOUR_LR)

    @jax.jit
    def step(p, s, adj, x, labels, mask):
        loss, g = jax.value_and_grad(loss_fn)(p, adj, x, labels, mask)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    params = jax.device_put(params, jax.devices()[0])
    state, hist = opt.init(params), []
    for _ in range(steps):
        params, state, loss = step(params, state, adj, x, labels, mask)
        hist.append(loss)
    return np.asarray([float(v) for v in hist])


def max_rel(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(a - b) / np.abs(b)))


def four_phase(ds, card: str, steps: int = 5) -> int:
    """`build_sharded_gcn` on four cards against the same model, init and
    inputs on one card unsharded (`unsharded_gcn_losses`); the halo tier
    on a one-card mesh is a second witness."""
    import jax
    import numpy as np

    from gespmm_tpu.ops.graph import add_self_loops
    from gespmm_tpu.parallel.mesh import make_mesh
    from gespmm_tpu.parallel.train_step import build_sharded_gcn
    from gespmm_tpu.sparse.reorder import apply_permutation, partition_order

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    csr = add_self_loops(ds.csr)
    t0 = time.perf_counter()
    order = partition_order(csr, 4, method="fennel")
    csr = apply_permutation(csr, order)
    x, labels, mask = (ds.features[order], ds.labels[order],
                       ds.masks["train"][order])
    log(f"fennel partition in {time.perf_counter() - t0:.1f} s (set-up)")
    losses, init = {}, None
    for cards in (4, 1):
        mesh = make_mesh(data=cards, model=1, devices=devs[:cards])
        step, (params, opt_state), prepare, hp = build_sharded_gcn(
            csr, ARXIV_FEATURES, 256, ARXIV_CLASSES, mesh, lr=FOUR_LR)
        if init is None:
            init = jax.device_get(params)
        xs, ls, ms = prepare(x, labels, mask)
        hist, t0 = [], None
        for i in range(steps):
            if i == 1:
                jax.block_until_ready(params)
                t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, xs, ls, ms)
            hist.append(loss)
        jax.block_until_ready(hist[-1])
        ms_step = (time.perf_counter() - t0) / (steps - 1) * 1e3
        losses[cards] = np.asarray([float(v) for v in hist])
        log(f"sharded gcn (halo tier) on {cards} card(s): losses "
            f"{losses[cards]}, {ms_step:.3f} ms/step [{card}]")
        if cards == 4:
            hlo = step.jitted.lower(params, opt_state, hp, xs, ls,
                                    ms).compile().as_text()
            ops = ("all-to-all", "collective-permute", "all-reduce",
                   "all-gather", "reduce-scatter")
            found = {o: hlo.count(o + "(") + hlo.count(o + "-start(")
                     for o in ops}
            log("collectives in the compiled 4-card step:",
                {o: c for o, c in found.items() if c})
    ref = unsharded_gcn_losses(csr, init, x, labels, mask, steps)
    log(f"unsharded gcn (method=xla) on one card: losses {ref} [{card}]")
    rel, rel1 = max_rel(losses[4], ref), max_rel(losses[1], ref)
    log(f"4-card vs unsharded losses: max rel diff {rel:.2e}; 1-card halo "
        f"vs unsharded {rel1:.2e} (bar 1e-3)")
    if not np.all(np.isfinite(losses[4])) or rel > 1e-3 or rel1 > 1e-3:
        raise AssertionError(
            f"sharded GCN losses differ from the unsharded run: 4 cards "
            f"{rel:.2e}, 1 card {rel1:.2e}")
    return 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded GCN on four cards and its "
                         "one-card comparison")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    card = setup()
    import jax

    ds = arxiv_dataset()
    if args.four:
        count = four_phase(ds, card)
    else:
        gcn_phase(ds, card)
        from gespmm_tpu.ops.graph import add_self_loops
        from gespmm_tpu.utils.datasets import rmat_graph

        arxiv = add_self_loops(ds.csr).with_data(None)
        auto_ops_phase(arxiv, card)
        spmm_phase("arxiv-shaped", arxiv, (32, 128, 256, 512), card)
        t0 = time.perf_counter()
        rmat = rmat_graph(20, 16, seed=0)
        log(f"rmat20 generated in {time.perf_counter() - t0:.1f} s (set-up)")
        spmm_phase("rmat20", rmat, (32, 128), card)
        count = 1
    dev = jax.devices()[0]
    log(f"card name, power limit: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

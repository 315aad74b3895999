"""Sharded GNN training over a (data, model) mesh.

The multi-device training capability the single-GPU reference lacks
(SURVEY §2.3): a full GCN training step jitted over a 2-D mesh —

  * "data" axis: graph rows partitioned; activations and labels
    row-sharded; the SpMM exchanges ONLY the per-shard halo rows via
    precomputed `ppermute` rounds (`parallel.halo`), and the local SpMM
    runs the differentiable tiled tier (backward collectives are
    autodiff-derived);
  * "model" axis: feature/hidden dims sharded; first-layer weights
    column-sharded, output-layer weights row-sharded (contraction inserts
    the psum), optimizer state follows the parameters.

Used by `__graft_entry__.dryrun_multichip` and testable on a virtual CPU
mesh; on real hardware call `parallel.mesh.maybe_distributed_init` first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gespmm_tpu.models.common import dense_init
from gespmm_tpu.parallel.halo import build_halo_partition, halo_spmm
from gespmm_tpu.train.loop import masked_nll_loss

Array = jax.Array


def shard_gcn_params(params: Dict, mesh: Mesh) -> Dict:
    """Place a 2-layer GCN param pytree with model-axis sharding."""
    w1_sh = {
        "w": NamedSharding(mesh, P(None, "model")),
        "b": NamedSharding(mesh, P("model")),
    }
    w2_sh = {
        "w": NamedSharding(mesh, P("model", None)),
        "b": NamedSharding(mesh, P(None)),
    }
    sh = {"l1": w1_sh, "l2": w2_sh}
    return jax.tree.map(
        lambda a, s: jax.device_put(a, s),
        params,
        sh,
        is_leaf=lambda t: isinstance(t, jax.Array),
    )


def build_sharded_gcn(
    csr,
    feat_dim: int,
    hidden: int,
    classes: int,
    mesh: Mesh,
    lr: float = 1e-2,
    seed: int = 0,
):
    """Returns (train_step, init_state, prepare_inputs, halo_partition).

    `train_step(params, opt_state, x, labels, mask)` is jitted over the
    mesh; `prepare_inputs` pads + shards node-indexed arrays.  The SpMM
    is the halo-exchange formulation with the tiled tier.
    """
    data_axis = mesh.shape["data"]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("build_sharded_gcn needs a square adjacency")
    hp = build_halo_partition(csr, data_axis, tiled=True)
    if hp.rpp != hp.cpp:
        raise ValueError("square adjacency must slab rows and columns alike")
    # Per-shard stacked arrays go to their shard once, here, so the step
    # moves no partition data.
    hp = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(
            mesh, P("data") if a.ndim and a.shape[0] == data_axis else P()
        )),
        hp,
    )
    m_pad = hp.num_parts * hp.rpp
    n = csr.shape[0]

    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    params = {
        "l1": dense_init(k1, feat_dim, hidden),
        "l2": dense_init(k2, hidden, classes),
    }
    params = shard_gcn_params(params, mesh)
    opt = optax.adamw(lr)
    opt_state = jax.device_put(
        opt.init(params), NamedSharding(mesh, P())
    )

    def prepare_inputs(x, labels, mask):
        def pad_rows(a):
            return jnp.pad(
                a, ((0, m_pad - a.shape[0]),) + ((0, 0),) * (a.ndim - 1)
            )

        x = jax.device_put(
            pad_rows(x), NamedSharding(mesh, P("data", "model"))
        )
        labels = jax.device_put(
            pad_rows(labels), NamedSharding(mesh, P("data"))
        )
        mask = jax.device_put(
            pad_rows(mask), NamedSharding(mesh, P("data"))
        )
        return x, labels, mask

    def forward(params, hp, x):
        h = x @ params["l1"]["w"] + params["l1"]["b"]
        h = halo_spmm(hp, h, mesh, reduce="mean")
        h = jax.nn.relu(h)
        logits = h @ params["l2"]["w"] + params["l2"]["b"]
        return halo_spmm(hp, logits, mesh, reduce="mean", model_axis=None)

    def loss_fn(params, hp, x, labels, mask):
        lp = jax.nn.log_softmax(forward(params, hp, x), axis=-1)
        return masked_nll_loss(lp, labels, mask)

    # The partition's arrays are a jit ARGUMENT: closed over, they would
    # be compiled in as constants.
    @jax.jit
    def step_hp(params, opt_state, hp, x, labels, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, hp, x, labels,
                                                  mask)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def train_step(params, opt_state, x, labels, mask):
        return step_hp(params, opt_state, hp, x, labels, mask)

    train_step.jitted = step_hp  # (params, opt_state, hp, x, labels, mask)
    return train_step, (params, opt_state), prepare_inputs, hp


def build_sharded_sage(
    csr,
    feat_dim: int,
    hidden: int,
    classes: int,
    mesh: Mesh,
    aggregator: str = "mean",
    lr: float = 1e-2,
    seed: int = 0,
):
    """Sharded 2-layer GraphSAGE training step (aggregator mean / sum /
    pool).  mean/sum ride the differentiable tiled halo tier; pool (max)
    rides the XLA halo tier (identity-aware diag/halo combine) — max
    gradients flow through the segment formulation.  Completes the
    reference's model families (`sage_dgl.py --aggregator-type`) in the
    distributed regime.

    Returns (train_step, init_state, prepare_inputs, halo_partition).
    """
    if aggregator not in ("mean", "sum", "pool"):
        raise ValueError(f"unknown aggregator {aggregator!r}")
    data_axis = mesh.shape["data"]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("build_sharded_sage needs a square adjacency")
    hp = build_halo_partition(csr, data_axis, tiled=True)
    m_pad = hp.num_parts * hp.rpp

    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    params = {
        # SAGEConv: W_self · h + W_neigh · agg(h_N); pool adds a
        # pre-pool MLP.
        "l1": {"self": dense_init(k1, feat_dim, hidden),
               "neigh": dense_init(k2, feat_dim, hidden)},
        "l2": {"self": dense_init(k3, hidden, classes),
               "neigh": dense_init(k4, hidden, classes)},
    }
    if aggregator == "pool":
        kp1, kp2 = jax.random.split(jax.random.split(key, 5)[-1])
        params["pool1"] = dense_init(kp1, feat_dim, feat_dim)
        params["pool2"] = dense_init(kp2, hidden, hidden)
    opt = optax.adamw(lr)
    opt_state = opt.init(params)

    def prepare_inputs(x, labels, mask):
        def pad_rows(a):
            return jnp.pad(
                a, ((0, m_pad - a.shape[0]),) + ((0, 0),) * (a.ndim - 1)
            )

        x = jax.device_put(
            pad_rows(x), NamedSharding(mesh, P("data", None))
        )
        labels = jax.device_put(
            pad_rows(labels), NamedSharding(mesh, P("data"))
        )
        mask = jax.device_put(
            pad_rows(mask), NamedSharding(mesh, P("data"))
        )
        return x, labels, mask

    def aggregate(h):
        if aggregator == "pool":
            # max rides the tiled tier when plans exist (round-4: joint
            # diag+halo tie semantics in _local_tiled_minmax).
            return halo_spmm(hp, h, mesh, reduce="max", model_axis=None)
        return halo_spmm(hp, h, mesh, reduce=aggregator, model_axis=None)

    def layer(p, h, pre_pool=None):
        hn = jax.nn.relu(pre_pool(h)) if pre_pool is not None else h
        agg = aggregate(hn)
        return (h @ p["self"]["w"] + p["self"]["b"]
                + agg @ p["neigh"]["w"] + p["neigh"]["b"])

    def forward(params, x):
        def pre(name):
            if aggregator != "pool":
                return None
            return lambda h: h @ params[name]["w"] + params[name]["b"]

        h = jax.nn.relu(layer(params["l1"], x, pre("pool1")))
        return layer(params["l2"], h, pre("pool2"))

    def loss_fn(params, x, labels, mask):
        lp = jax.nn.log_softmax(forward(params, x), axis=-1)
        return masked_nll_loss(lp, labels, mask)

    @jax.jit
    def train_step(params, opt_state, x, labels, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, labels, mask)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step, (params, opt_state), prepare_inputs, hp


def build_sharded_gat(
    csr,
    feat_dim: int,
    hidden: int,
    classes: int,
    mesh: Mesh,
    heads: int = 1,
    lr: float = 5e-3,
    seed: int = 0,
):
    """Sharded 2-layer GAT training step — attention ALL the way through
    the mesh (SURVEY §2.3 extended): per-edge logits, softmax, and the
    alpha-weighted aggregate run under shard_map via `parallel.edge_ops`,
    with gradients flowing through the reverse collectives.  The
    distributed regime the reference never had for its SDDMM surface
    (`pytorch-custom/sddmm.cpp:63-68`).

    Returns (train_step, init_state, prepare_inputs, halo_partition).
    Attention alphas feed `halo_spmm`'s RUNTIME edge values, so the
    tiled tier carries the weighted aggregate when plans exist.
    """
    from gespmm_tpu.parallel.edge_ops import (
        halo_additive_logits, halo_edge_softmax,
    )

    data_axis = mesh.shape["data"]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("build_sharded_gat needs a square adjacency")
    hp = build_halo_partition(csr, data_axis, tiled=True)
    m_pad = hp.num_parts * hp.rpp

    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    params = {
        "l1": dense_init(k1, feat_dim, hidden * heads),
        "att": {
            "src": 0.1 * jax.random.normal(k3, (hidden * heads, heads)),
            "dst": 0.1 * jax.random.normal(k4, (hidden * heads, heads)),
        },
        "l2": dense_init(k2, hidden * heads, classes),
    }
    opt = optax.adamw(lr)
    opt_state = opt.init(params)

    def prepare_inputs(x, labels, mask):
        def pad_rows(a):
            return jnp.pad(
                a, ((0, m_pad - a.shape[0]),) + ((0, 0),) * (a.ndim - 1)
            )

        x = jax.device_put(
            pad_rows(x), NamedSharding(mesh, P("data", None))
        )
        labels = jax.device_put(
            pad_rows(labels), NamedSharding(mesh, P("data"))
        )
        mask = jax.device_put(
            pad_rows(mask), NamedSharding(mesh, P("data"))
        )
        return x, labels, mask

    def attention_layer(h, a_src, a_dst):
        """All heads in one chain: logits/softmax carry a trailing head
        dim, and ONE halo_spmm aggregates every head's feature block
        with its per-head alphas (3-D runtime edge values on the tiled
        tier).  h: (m_pad, heads*dh)."""
        dl, hl = halo_additive_logits(
            hp, h @ a_src, h @ a_dst, mesh
        )
        dl = jax.nn.leaky_relu(dl, 0.2)
        hl = jax.nn.leaky_relu(hl, 0.2)
        ad, ah = halo_edge_softmax(hp, dl, hl, mesh)
        if heads == 1:
            return halo_spmm(hp, h, mesh, diag_vals=ad[..., 0],
                             halo_vals=ah[..., 0], model_axis=None)
        return halo_spmm(hp, h, mesh, diag_vals=ad, halo_vals=ah,
                         model_axis=None)

    def forward(params, x):
        h = x @ params["l1"]["w"] + params["l1"]["b"]
        h = attention_layer(h, params["att"]["src"], params["att"]["dst"])
        h = jax.nn.elu(h)
        logits = h @ params["l2"]["w"] + params["l2"]["b"]
        return halo_spmm(hp, logits, mesh, reduce="mean", model_axis=None)

    def loss_fn(params, x, labels, mask):
        lp = jax.nn.log_softmax(forward(params, x), axis=-1)
        return masked_nll_loss(lp, labels, mask)

    @jax.jit
    def train_step(params, opt_state, x, labels, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, labels, mask)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step, (params, opt_state), prepare_inputs, hp

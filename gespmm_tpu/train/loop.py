"""Training loop for node classification — the "app" tier.

Capability parity with the reference training scripts
(`pytorch-custom/gcn_custom.py:100-143`, `dgl-custom/benchmark/gcn/
gcn_dgl.py:156-201`): Adam, NLL loss on masked nodes, per-epoch timing,
train/val/test accuracy reporting.  Improvements: jitted full train step,
deterministic PRNG threading, and checkpoint/resume (absent from the
reference — SURVEY §5.4).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import optax

Array = jax.Array


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: Array

    def tree_flatten(self):
        return (self.params, self.opt_state, self.step), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def masked_nll_loss(log_probs: Array, labels: Array, mask: Array) -> Array:
    """Mean negative log-likelihood over masked nodes (≙ F.nll_loss on the
    train split, `gcn_custom.py:115`)."""
    ll = jnp.take_along_axis(log_probs, labels[:, None], axis=-1)[:, 0]
    mask = mask.astype(log_probs.dtype)
    return -(ll * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def accuracy(logits: Array, labels: Array, mask: Array) -> Array:
    pred = jnp.argmax(logits, axis=-1)
    hit = (pred == labels).astype(jnp.float32) * mask.astype(jnp.float32)
    return hit.sum() / jnp.maximum(mask.astype(jnp.float32).sum(), 1.0)


def make_train_step(
    model,
    optimizer: optax.GradientTransformation,
    *,
    loss_fn: Callable = masked_nll_loss,
    adj=None,
    base_key: Optional[Array] = None,
) -> Callable:
    """Build a jitted train step.

    With ``adj``/``base_key`` (the fast path used by the training loop):
    returns (state, x, labels, mask) -> (state, loss); the adjacency —
    including any plan arrays — is bound to the step but passed to the
    jitted function as an ARGUMENT (closed-over arrays would be compiled
    in as constants, which XLA then tries to constant-fold), and the
    dropout rng derives from ``state.step`` on device (no host-side key
    splitting per epoch).

    The jitted core is ``step.jitted(state, adj, key, x, labels, mask)``
    (for ``lower`` / ``compile`` / ``memory_analysis``).

    Without ``adj``: legacy signature
    (state, adj, x, labels, mask, rng) -> (state, loss).
    """

    def objective_and_update(state, a, x, labels, mask, rng):
        def objective(params):
            lp = model.log_probs(params, a, x, training=True, rng=rng)
            return loss_fn(lp, labels, mask)

        loss, grads = jax.value_and_grad(objective)(state.params)
        updates, opt_state = optimizer.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    if adj is not None:
        key0 = base_key if base_key is not None else jax.random.PRNGKey(0)

        @jax.jit
        def step_bound(state: TrainState, a, key, x, labels, mask):
            rng = jax.random.fold_in(key, state.step)
            return objective_and_update(state, a, x, labels, mask, rng)

        def step(state: TrainState, x, labels, mask):
            return step_bound(state, adj, key0, x, labels, mask)

        step.jitted = step_bound
        return step

    def step(state: TrainState, a, x, labels, mask, rng):
        return objective_and_update(state, a, x, labels, mask, rng)

    return jax.jit(step)


def train_node_classifier(
    model,
    adj,
    x: Array,
    labels: Array,
    masks: Dict[str, Array],
    *,
    seed: int = 0,
    lr: float = 1e-2,
    weight_decay: float = 5e-4,
    epochs: int = 200,
    log_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
) -> Dict[str, Any]:
    """Full training run; returns final params + metric history.

    Mirrors the reference protocol (200 epochs Adam(1e-2, wd 5e-4),
    `gcn_custom.py:106-117`) and reports epoch wall time the way the DGL
    benchmark does (mean epoch time skipping the first 3 warmup epochs,
    `gcn_dgl.py:176-186`).
    """
    key = jax.random.PRNGKey(seed)
    key, init_key, step_key = jax.random.split(key, 3)
    params = model.init(init_key)
    optimizer = optax.adamw(lr, weight_decay=weight_decay)
    state = TrainState(params, optimizer.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(model, optimizer, adj=adj, base_key=step_key)
    apply_fn = jax.jit(lambda p, a, x: model.apply(p, a, x))

    def eval_fn(p):
        return apply_fn(p, adj, x)

    start_epoch = 0
    if checkpoint_dir:
        from gespmm_tpu.train.checkpoint import latest_checkpoint, restore

        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt is not None:
            state, start_epoch = restore(ckpt, state)

    # Epoch timing: groups of epochs between host syncs, each group ended
    # by `block_until_ready` on its last loss; the first epochs (which
    # compile) are excluded.
    history = {"loss": [], "val_acc": [], "epoch_time": []}
    loss_devs = []  # device scalars; fetched once after the loop
    warmup_end = start_epoch + min(3, max(epochs - start_epoch - 1, 0))
    group_t0 = None
    group_n = 0
    for epoch in range(start_epoch, epochs):
        state, loss = step(state, x, labels, masks["train"])
        loss_devs.append(loss)
        group_n += 1
        log_now = bool(
            log_every and (epoch % log_every == 0 or epoch == epochs - 1)
        )
        ckpt_now = bool(
            checkpoint_dir
            and checkpoint_every
            and (epoch + 1) % checkpoint_every == 0
        )
        if epoch == warmup_end:
            jax.block_until_ready(loss)
            group_t0, group_n = time.perf_counter(), 0
        elif (log_now or ckpt_now or epoch == epochs - 1) and group_n:
            jax.block_until_ready(loss)
            if group_t0 is not None:
                dt = (time.perf_counter() - group_t0) / group_n
                history["epoch_time"].extend([dt] * group_n)
        if log_now:
            loss_val = float(loss)
            logits = eval_fn(state.params)
            val = float(accuracy(logits, labels, masks["val"]))
            history["val_acc"].append(val)
            ms = history["epoch_time"][-1] * 1e3 if history["epoch_time"] else float("nan")
            print(
                f"epoch {epoch:04d} | loss {loss_val:.4f} | "
                f"val acc {val:.4f} | {ms:.1f} ms/epoch"
            )
        if ckpt_now:
            from gespmm_tpu.train.checkpoint import save

            save(checkpoint_dir, state, epoch + 1)
        if log_now or ckpt_now:
            group_t0, group_n = time.perf_counter(), 0

    if loss_devs:
        import numpy as _np

        history["loss"] = [
            float(v) for v in _np.asarray(jnp.stack(loss_devs))
        ]
    logits = eval_fn(state.params)
    result = {
        "params": state.params,
        "history": history,
        "train_acc": float(accuracy(logits, labels, masks["train"])),
        "val_acc": float(accuracy(logits, labels, masks["val"])),
        "test_acc": float(accuracy(logits, labels, masks["test"])),
        "mean_epoch_time": (
            sum(history["epoch_time"]) / len(history["epoch_time"])
            if history["epoch_time"]
            else float("nan")
        ),
    }
    return result

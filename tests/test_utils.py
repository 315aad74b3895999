"""Profiling/timing utilities and dtype coverage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gespmm_tpu.ops.spmm import Adjacency, spmm
from gespmm_tpu.utils import profiling, timing
from tests.conftest import random_csr


def test_benchmark_returns_sane_result():
    # Off the GPU every timing entry point refuses to run; the summary
    # arithmetic is checked on synthetic samples.
    f = jax.jit(lambda x: x * 2.0)
    x = jnp.ones((128, 128))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        timing.benchmark(lambda: f(x), iters=30)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        timing.benchmark_chained(lambda v: v * 0.5, x, iters=2)
    r = timing._summary([3e-3, 1e-3, 2e-3], 1)
    assert r.mean_s > 0 and r.best_s <= r.median_s
    assert r.median_s == 2e-3 and r.iters == 3
    assert abs(r.gflops(1e9 * r.mean_s) - 1.0) < 1e-9  # definition check


def test_op_cost_table():
    cost = profiling.op_cost_table(
        lambda a, b: a @ b, jnp.ones((64, 64)), jnp.ones((64, 64))
    )
    assert isinstance(cost, dict)
    assert cost.get("flops", 0) > 0


def test_spmm_roofline_math():
    kind = "NVIDIA H100 80GB HBM3"
    r = profiling.spmm_roofline(nnz=1000, m=100, k=128, measured_s=1e-3,
                                device_kind=kind)
    assert r["bytes_moved"] == 1000 * 128 * 4 + 1000 * 8 + 100 * 128 * 4
    assert r["speed_of_light_s"] == r["bytes_moved"] / 3.35e12
    assert 0 < r["fraction_of_roofline"] < 1
    assert r["achieved_gflops"] > 0


@pytest.mark.parametrize("kind", [None, "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
def test_roofline_unknown_device_kind_raises(kind):
    # None resolves to this machine's first device (the CPU here), which
    # has no entry: an unknown device is an error, never a default.
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.spmm_roofline(nnz=10, m=4, k=8, measured_s=1e-3,
                                device_kind=kind)


def test_peaks_table_h100_entry():
    p = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["l2_bytes"] == 50 * 2**20
    assert p["bf16_flops"] == 989e12 and p["tf32_flops"] == 495e12
    assert p["fp32_flops"] == 67e12 and "data sheet" in p["source"]


def test_spmm_bf16():
    csr, mat = random_csr(40, 35, density=0.15, seed=1)
    adj = Adjacency.from_csr(csr)
    B = jnp.asarray(
        np.random.default_rng(1).standard_normal((35, 16)), jnp.bfloat16
    )
    out = spmm(adj, B)
    assert out.dtype == jnp.bfloat16
    oracle = mat @ np.asarray(B.astype(jnp.float32))
    # bf16 storage, f32 accumulate: tolerance at bf16 resolution.
    np.testing.assert_allclose(
        np.asarray(out.astype(jnp.float32)), oracle, rtol=3e-2, atol=3e-2
    )


def test_gcn_trains_in_bf16():
    from gespmm_tpu.models.gcn import GCN
    from gespmm_tpu.train.loop import make_train_step, TrainState
    import optax

    from gespmm_tpu.utils.datasets import sbm_graph

    ds = sbm_graph(n_per_class=50, num_classes=3, feat_dim=16, seed=2)
    adj = Adjacency.from_csr(ds.csr)
    model = GCN(dims=[16, 8, 3], dropout_rate=0.0)
    params = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-2)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(model, opt)
    x16 = ds.features.astype(jnp.bfloat16)
    losses = []
    for i in range(5):
        state, loss = step(
            state, adj, x16, ds.labels, ds.masks["train"],
            jax.random.PRNGKey(i),
        )
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_synth_graph_generators():
    # Corpus widening (VERDICT r3 #8): banded, rectangular and SBM
    # matrices resolve by name and produce valid CSR structures.
    import numpy as np
    from gespmm_tpu.utils.datasets import synth_graph

    b = synth_graph("banded256-3")
    assert b.shape == (256, 256)
    ip = np.asarray(b.indptr)
    # interior rows have exactly 2*bw neighbors
    assert (np.diff(ip)[3:-3] == 6).all()

    r = synth_graph("rect512x128-4")
    assert r.shape == (512, 128)
    assert np.asarray(r.indices).max() < 128
    assert r.nnz > 512  # ~4 edges/row minus dedup collisions

    s = synth_graph("sbm64")
    assert s.shape == (256, 256)
    assert synth_graph("nosuch") is None

    m = synth_graph("rmat8")
    assert m.shape == (256, 256)


def test_bench_rectangular_graph_cpu():
    # The sweep path must handle a NON-SQUARE matrix end to end
    # (distinct row/col spaces through plans, golden check, timing).
    from gespmm_tpu.bench.spmm_bench import bench_graph

    row, results = bench_graph(
        "rect512x128-4", [8], iters=0, methods=("xla", "tiled"),
        validate=True,
    )
    assert row["m"] == 512 and row["n"] == 128
    for key, v in results.items():
        assert "error" not in v, (key, v)
    # Timing is GPU-only: off the card the sweep refuses to time.
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench_graph("rect512x128-4", [8], iters=3, methods=("xla",))


def test_append_csv_field_merge():
    # One row per graph; partial re-runs (method subsets after a worker
    # fault) field-merge into the union schema instead of wiping rows.
    import os
    import tempfile
    from gespmm_tpu.bench.spmm_bench import _append_csv

    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "t.csv")
        _append_csv(f, {"data": "a", "x": 1, "y": 2})
        _append_csv(f, {"data": "b", "x": 3, "y": 4})
        _append_csv(f, {"data": "b", "y": 9, "z": 7})
        lines = open(f).read().strip().split("\n")
        assert lines[0] == "data,x,y,z"
        assert lines[1] == "a,1,2,nan"
        assert lines[2] == "b,3,9,7"


def test_synth_graph_generators_r5():
    # Round-5 corpus widening (VERDICT r4 #7): Chung-Lu power-law, 2-D
    # grid stencil, and extreme-hub graphs resolve by name.
    import numpy as np
    from gespmm_tpu.utils.datasets import synth_graph

    cl = synth_graph("cl1024-8")
    assert cl.shape == (1024, 1024)
    deg = np.diff(np.asarray(cl.indptr))
    # Power-law: the top node's degree dwarfs the mean.
    assert deg.max() > 10 * deg.mean()

    g5 = synth_graph("grid32")
    assert g5.shape == (1024, 1024)
    d5 = np.diff(np.asarray(g5.indptr))
    assert d5.max() == 4 and d5.min() == 2  # corners have 2 neighbors
    g9 = synth_graph("grid32-9")
    assert np.diff(np.asarray(g9.indptr)).max() == 8

    h = synth_graph("hub1024-2")
    assert h.shape == (1024, 1024)
    dh = np.diff(np.asarray(h.indptr))
    # Hubs reach ~hub_frac of all nodes; background degree is tiny.
    assert dh.max() > 1024 * 0.2
    assert np.median(dh) < 20


def test_append_csv_foreign_format_rewrites():
    # A pre-existing CSV WITHOUT the 'data' key column must not KeyError
    # (and lose the just-measured row) — it is rewritten from scratch.
    import os
    import tempfile
    from gespmm_tpu.bench.spmm_bench import _append_csv

    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "t.csv")
        with open(f, "w") as fh:
            fh.write("name,val\nfoo,1\n")
        _append_csv(f, {"data": "a", "x": 1})
        lines = open(f).read().strip().split("\n")
        assert lines[0] == "data,x"
        assert lines[1] == "a,1"

"""The Triton CSR SpMM kernel (`kernels/spmm_csr.py`) in Pallas interpret
mode against float64 scipy, its gradients through the op layer's custom
VJP, the work split of long rows, and the GPU dispatch rule."""

import ast
import functools
import importlib
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from gespmm_tpu.kernels import spmm_csr as sc
from gespmm_tpu.ops.spmm import Adjacency, spmm
from gespmm_tpu.sparse.formats import csr_from_scipy

spmm_mod = importlib.import_module("gespmm_tpu.ops.spmm")
REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5  # float32 gather/FMA: max|err| <= 1e-5 max|ref|


def _matrix(m, n, seed, binary, density=0.15):
    """Random CSR with an empty row and a hub row covering every column."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, format="lil", random_state=rng,
                  dtype=np.float64)
    A[1, :] = 0.0
    A[0, :] = rng.standard_normal(n)
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    A.data = rng.standard_normal(A.nnz)
    A.sort_indices()
    if binary:
        A.data[:] = 1.0
    assert A.indptr[2] - A.indptr[1] == 0 and A.indptr[1] == n
    return A


def _run(A, B, binary, config=None):
    data = None if binary else jnp.asarray(A.data.astype(np.float32))
    return sc._spmm_csr_call(
        jnp.asarray(A.indptr, jnp.int32), jnp.asarray(A.indices, jnp.int32),
        data, B, m=A.shape[0], interpret=True, config=config,
    )


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("K", [1, 7, 32, 100, 128, 300])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("shape", [(48, 20), (20, 70), (40, 40)],
                         ids=["tall", "wide", "square"])
def test_spmm_csr_interpret_matches_scipy(shape, binary, K):
    A = _matrix(*shape, seed=sum(shape) + K, binary=binary)
    B = np.random.default_rng(K).standard_normal((shape[1], K))
    out = _run(A, jnp.asarray(B.astype(np.float32)), binary)
    assert out.shape == (shape[0], K) and out.dtype == jnp.float32
    assert _rel(out, A @ B.astype(np.float32).astype(np.float64)) <= TOL
    assert np.all(np.asarray(out)[1] == 0)  # the empty row


@pytest.mark.parametrize("seg", [4, 8, 32])
@pytest.mark.parametrize("bn", [4, 8])
def test_spmm_csr_hub_row_spans_many_chunks_and_segments(bn, seg):
    # Row 0 holds 70 nonzeros: many chunks of bn, split into segments of
    # seg whose partial sums the wrapper adds back.
    A = _matrix(30, 70, seed=seg, binary=False)
    B = np.random.default_rng(seg).standard_normal((70, 24)).astype(np.float32)
    out = _run(A, jnp.asarray(B), False, config=(bn, 16, 1, 1, seg))
    assert _rel(out, A @ B.astype(np.float64)) <= TOL


@pytest.mark.parametrize("binary", [False, True])
def test_spmm_csr_bf16_B(binary):
    A = _matrix(40, 36, seed=5, binary=binary)
    B = jnp.asarray(np.random.default_rng(5).standard_normal((36, 48)),
                    jnp.bfloat16)
    out = _run(A, B, binary)
    assert out.dtype == jnp.bfloat16
    ref = A @ np.asarray(B.astype(jnp.float32), np.float64)
    # f32 accumulation of bf16 inputs, rounded once to bf16 at the end.
    assert _rel(out, ref) <= 2 ** -8


@pytest.mark.parametrize("seg", [2, 5, 256])
def test_work_items_cover_every_edge_once(seg):
    A = _matrix(25, 40, seed=seg, binary=True, density=0.3)
    m, nnz = A.shape[0], A.nnz
    starts, ends, xrow = sc._work_items(jnp.asarray(A.indptr, jnp.int32),
                                        m, nnz, seg)
    starts, ends = np.asarray(starts), np.asarray(ends)
    assert np.all(ends - starts <= seg)
    rows = np.concatenate([np.arange(m)] + (
        [] if xrow is None else [np.asarray(xrow)]))
    seen = np.zeros(nnz, int)
    for s, e, r in zip(starts, ends, rows):
        if e > s:
            assert A.indptr[r] <= s and e <= A.indptr[r + 1]
            seen[s:e] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("K", [1, 7, 32, 40, 100, 256, 512])
def test_block_config_widths(K):
    bn, bk, warps, stages, seg = sc.block_config(K)
    for v in (bn, bk):
        assert v & (v - 1) == 0  # Triton blocks are powers of two
    assert bk >= min(K, 256) and bk <= max(16, 2 * K)
    assert seg % bn == 0 and warps >= 1 and stages >= 1


@pytest.mark.parametrize("binary", [False, True])
def test_spmm_csr_grads_through_custom_vjp(binary, monkeypatch):
    # method="pallas" runs the kernel forward and, on the paired CSC
    # arrays, backward; here both in interpret mode.
    monkeypatch.setattr(sc, "spmm_csr",
                        functools.partial(sc.spmm_csr, interpret=True))
    A = _matrix(30, 26, seed=11, binary=binary)
    adj = Adjacency.from_csr(csr_from_scipy(A.astype(np.float32)))
    if binary:
        adj = adj.with_data(None)
    rng = np.random.default_rng(11)
    B = jnp.asarray(rng.standard_normal((26, 12)).astype(np.float32))
    W = jnp.asarray(rng.standard_normal((30, 12)).astype(np.float32))

    def loss(b, a, method):
        return jnp.sum(spmm(a, b, method=method) * W)

    g = jax.grad(loss)(B, adj, "pallas")
    g_x = jax.grad(loss)(B, adj, "xla")
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_x), rtol=1e-5,
                               atol=1e-5)
    if not binary:
        gv = jax.grad(lambda v: loss(B, adj.with_data(v), "pallas"))(adj.data)
        gv_x = jax.grad(lambda v: loss(B, adj.with_data(v), "xla"))(adj.data)
        np.testing.assert_allclose(np.asarray(gv), np.asarray(gv_x),
                                   rtol=1e-5, atol=1e-5)


def test_spmm_csr_refuses_compiled_off_gpu():
    A = _matrix(8, 8, seed=1, binary=True)
    with pytest.raises(ValueError, match="Triton"):
        sc.spmm_csr(jnp.asarray(A.indptr), jnp.asarray(A.indices), None,
                    jnp.ones((8, 4)), 8)


@pytest.mark.parametrize("degree", [4.0, 14.5, 30.0])
@pytest.mark.parametrize("K", [40, 256])
@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_resolve_method_never_interprets(backend, with_plan, reduce, K,
                                         degree, monkeypatch):
    A = _matrix(24, 24, seed=3, binary=True)
    adj = Adjacency.from_csr(csr_from_scipy(A.astype(np.float32)),
                             plan=with_plan)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    got = spmm_mod._resolve_method("auto", adj.plan, K, reduce, degree)
    if backend == "gpu" and reduce == "sum":
        # Wide B or wide rows go to the Triton kernel, compiled (spmm_csr
        # never chooses interpret itself; it raises off the GPU instead).
        wide = (K >= spmm_mod.CSR_KERNEL_MIN_K
                or degree >= spmm_mod.CSR_KERNEL_MIN_DEGREE)
        assert got == ("pallas" if wide else "xla")
    else:
        assert got == ("tiled" if with_plan else "xla")
    assert spmm_mod._resolve_method("xla", adj.plan, K, reduce,
                                    degree) == "xla"


@pytest.mark.parametrize("deg", [3, 40])
@pytest.mark.parametrize("K", [8, 300])
def test_auto_on_gpu_routes_by_width_and_degree(K, deg, monkeypatch):
    # The degree the dispatcher sees is the matrix's own nnz / rows, for
    # the forward (CSR) and the backward (the CSC of the transpose).
    m = 64
    rng = np.random.default_rng(deg)
    cols = np.concatenate([rng.choice(m, deg, replace=False)
                           for _ in range(m)])
    A = sp.csr_matrix((np.ones(m * deg, np.float32), cols,
                       np.arange(0, m * deg + 1, deg)), shape=(m, m))
    adj = Adjacency.from_csr(csr_from_scipy(A))
    B = jnp.asarray(rng.standard_normal((m, K)), jnp.float32)
    seen, real = [], sc.spmm_csr

    def fake_csr(indptr, indices, data, B, m, interpret=False):
        seen.append(indices.shape[0] / (indptr.shape[0] - 1))
        return real(indptr, indices, data, B, m, interpret=True)

    monkeypatch.setattr(sc, "spmm_csr", fake_csr)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    out, grad = jax.value_and_grad(
        lambda b: jnp.sum(spmm(adj, b, method="auto") ** 2))(B)
    wide = K >= spmm_mod.CSR_KERNEL_MIN_K or deg >= (
        spmm_mod.CSR_KERNEL_MIN_DEGREE)
    assert seen == ([deg, deg] if wide else [])
    ref = A.astype(np.float64) @ np.asarray(B, np.float64)
    assert abs(float(out) - float((ref ** 2).sum())) <= 1e-4 * float(
        (ref ** 2).sum())


@pytest.mark.gpu
def test_spmm_csr_compiled_matches_scipy(gpu):
    A = _matrix(300, 280, seed=9, binary=False)
    B = np.random.default_rng(9).standard_normal((280, 96)).astype(np.float32)
    out = sc.spmm_csr(jnp.asarray(A.indptr), jnp.asarray(A.indices),
                      jnp.asarray(A.data.astype(np.float32)),
                      jnp.asarray(B), 300)
    assert _rel(out, A @ B.astype(np.float64)) <= TOL


def _sources():
    files = sorted((REPO / "gespmm_tpu").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "bench.py",
                    REPO / "__graft_entry__.py"]


# The only Pallas modules the package may import: the core API and the
# Triton route.  Anything else (another accelerator's Pallas dialect)
# would not compile for the GPU.
ALLOWED_PALLAS = {"jax.experimental.pallas", "jax.experimental.pallas.triton"}


def test_only_gpu_pallas_modules_imported():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            names = [n for n in names
                     if n.startswith("jax.experimental.pallas")]
            bad += [f"{path.name}: {n}" for n in names
                    if n not in ALLOWED_PALLAS]
    assert not bad, bad
    src = (REPO / "gespmm_tpu" / "kernels" / "spmm_csr.py").read_text()
    assert "from jax.experimental.pallas import triton" in src


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("env_dir", [None, "/cache/elsewhere"])
def test_compile_cache_path_rule(env_dir):
    cs = _load_chip_smoke()
    env = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    got = cs.compile_cache_dir(env, repo="/some/checkout")
    assert got == (env_dir or os.path.join("/some/checkout", ".jax_cache"))


def test_chip_smoke_refuses_without_gpu():
    # On the CPU the smoke test must stop before doing any work.
    cs = _load_chip_smoke()
    with pytest.raises(SystemExit) as e:
        cs.setup()
    assert "needs a GPU" in str(e.value)


def test_four_card_phase_matches_unsharded_on_virtual_mesh():
    # `chip_smoke.py --four` on four virtual CPU devices: the halo-tier
    # GCN on a 4-way mesh against the unsharded single-device XLA run.
    from gespmm_tpu.utils.datasets import planetoid_style_dataset

    cs = _load_chip_smoke()
    ds = planetoid_style_dataset("cl1500-6", feat_dim=cs.ARXIV_FEATURES,
                                 num_classes=cs.ARXIV_CLASSES)
    assert cs.four_phase(ds, "cpu", steps=3) == 4

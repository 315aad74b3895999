"""Dataset utilities: benchmark graphs and node-classification fixtures.

The reference's corpus (SURVEY §2 comp. 20): ~60 SNAP/SuiteSparse graphs
fetched by `data/download_SNAP.sh`, plus bundled cora/citeseer/pubmed .mtx.
This sandbox has zero egress, so:

  * `load_mtx_graph` reads any .mtx on disk (the bundled reference graphs
    are found automatically via `sparse.io.default_dataset_dir`);
  * `snap_download_script` emits the wget list for machines WITH egress
    (capability parity with download_SNAP.sh, not run here);
  * synthetic generators (`rmat_graph`, `sbm_graph`) produce power-law and
    community-structured graphs of arbitrary scale for benchmarks and for
    accuracy tests (SBM graphs give GNNs real signal to learn).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from gespmm_tpu.sparse.formats import CSR, csr_from_coo, COO
from gespmm_tpu.sparse.io import default_dataset_dir, read_mtx_csr

# The SNAP/SuiteSparse sweep of the reference benchmark
# (`data/download_SNAP.sh:4-71`) — names only; fetch requires egress.
SNAP_GRAPHS = [
    "amazon0302", "amazon0312", "amazon0505", "amazon0601",
    "ca-AstroPh", "ca-CondMat", "ca-GrQc", "ca-HepPh", "ca-HepTh",
    "cit-HepPh", "cit-HepTh", "cit-Patents",
    "com-Amazon", "com-DBLP", "com-LiveJournal", "com-Youtube",
    "email-Enron", "email-EuAll",
    "loc-Brightkite", "loc-Gowalla",
    "p2p-Gnutella04", "p2p-Gnutella24", "p2p-Gnutella25",
    "p2p-Gnutella30", "p2p-Gnutella31",
    "roadNet-CA", "roadNet-PA", "roadNet-TX",
    "soc-Epinions1", "soc-LiveJournal1", "soc-Pokec",
    "soc-Slashdot0811", "soc-Slashdot0902",
    "web-BerkStan", "web-Google", "web-NotreDame", "web-Stanford",
    "wiki-Talk", "wiki-Vote",
]

BUNDLED = ("cora", "citeseer", "pubmed")


@dataclass
class GraphDataset:
    """A node-classification problem: graph + features + labels + splits."""

    csr: CSR
    features: jnp.ndarray
    labels: jnp.ndarray
    masks: Dict[str, jnp.ndarray]
    num_classes: int
    name: str = ""


def find_graph(name: str, data_dir: Optional[str] = None) -> Optional[str]:
    """Locate `<name>.mtx` in the dataset dir (or GESPMM_TPU_DATA)."""
    d = data_dir or default_dataset_dir()
    if not d:
        return None
    path = os.path.join(d, f"{name}.mtx")
    return path if os.path.isfile(path) else None


def load_mtx_graph(name_or_path: str, binary: bool = True) -> CSR:
    path = (
        name_or_path
        if os.path.isfile(name_or_path)
        else find_graph(name_or_path)
    )
    if path is None:
        raise FileNotFoundError(
            f"graph {name_or_path!r} not found; set GESPMM_TPU_DATA or pass a path"
        )
    return read_mtx_csr(path, binary=binary)


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    symmetrize: bool = True,
) -> CSR:
    """R-MAT power-law random graph (Graph500-style), 2^scale nodes.

    Fills the role of the SNAP corpus for offline benchmarking: realistic
    degree skew at any size.  Vectorized bit-recursive construction.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    ne = n * edge_factor
    rows = np.zeros(ne, np.int64)
    cols = np.zeros(ne, np.int64)
    for bit in range(scale):
        r = rng.random(ne)
        # Quadrant probabilities (a, b, c, d) with noise per level.
        go_right = r > (a + b)
        go_down = ((r > a) & (r <= a + b)) | (r > (a + b + c))
        rows |= (go_right.astype(np.int64)) << bit
        cols |= (go_down.astype(np.int64)) << bit
    if symmetrize:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    # Dedup + remove self loops + sort row-major.
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    key = rows * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    coo = COO(
        row=jnp.asarray(rows.astype(np.int32)),
        col=jnp.asarray(cols.astype(np.int32)),
        data=None,
        shape=(n, n),
    )
    return csr_from_coo(coo)


def banded_graph(n: int, bandwidth: int = 8, seed: int = 0) -> CSR:
    """Banded sparse matrix: each row links to its ±bandwidth neighbors.

    The locality-extreme end of the benchmark corpus (≙ mesh/PDE-style
    SuiteSparse matrices in the reference's SNAP sweep — maximal gather
    reuse, zero degree skew); complements the power-law R-MATs.
    """
    offs = [o for o in range(-bandwidth, bandwidth + 1) if o != 0]
    rows = np.concatenate(
        [np.arange(max(0, -o), min(n, n - o), dtype=np.int64) for o in offs]
    )
    cols = np.concatenate(
        [np.arange(max(0, -o), min(n, n - o), dtype=np.int64) + o
         for o in offs]
    )
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    coo = COO(
        row=jnp.asarray(rows.astype(np.int32)),
        col=jnp.asarray(cols.astype(np.int32)),
        data=None,
        shape=(n, n),
    )
    return csr_from_coo(coo)


def bipartite_graph(
    m: int, n: int, row_degree: int = 16, seed: int = 0,
    skew: float = 1.2,
) -> CSR:
    """RECTANGULAR (m x n) sparse matrix with Zipf-skewed column
    popularity — bipartite interaction data (user x item).  The corpus'
    non-square case: SpMM here has distinct row/column spaces, so the
    CSR↔CSC pairing and the K-tiled gather tables cannot assume m == n.
    """
    rng = np.random.default_rng(seed)
    ne = m * row_degree
    rows = np.repeat(np.arange(m, dtype=np.int64), row_degree)
    # Zipf-ish column popularity via inverse-CDF on a power law.
    u = rng.random(ne)
    cols = np.minimum(
        (n * u ** skew).astype(np.int64), n - 1
    )
    key = rows * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    coo = COO(
        row=jnp.asarray(rows.astype(np.int32)),
        col=jnp.asarray(cols.astype(np.int32)),
        data=None,
        shape=(m, n),
    )
    return csr_from_coo(coo)


def _coo_to_csr(rows: np.ndarray, cols: np.ndarray, shape) -> CSR:
    """Dedup + sort row-major + build CSR (shared tail of the generators)."""
    m, n = shape
    key = rows.astype(np.int64) * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    coo = COO(
        row=jnp.asarray(rows.astype(np.int32)),
        col=jnp.asarray(cols.astype(np.int32)),
        data=None,
        shape=(m, n),
    )
    return csr_from_coo(coo)


def chung_lu_graph(
    n: int, avg_degree: int = 16, gamma: float = 2.3, seed: int = 0,
) -> CSR:
    """Chung-Lu power-law graph: edge (i,j) sampled ∝ w_i·w_j with
    Pareto weights w_i ∝ (i+1)^(-1/(γ-1)).

    Unlike R-MAT (recursive quadrant bias → fractal community structure),
    Chung-Lu has an EXACT target degree-distribution shape and no
    block structure — the other canonical power-law family the
    reference's SNAP corpus spans (soc-*/web-* graphs).  Sampled by
    inverse-CDF on the weight distribution (vectorized, no rejection).
    """
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (gamma - 1.0))
    p = w / w.sum()
    cdf = np.cumsum(p)
    ne = n * avg_degree // 2
    rows = np.searchsorted(cdf, rng.random(ne)).astype(np.int64)
    cols = np.searchsorted(cdf, rng.random(ne)).astype(np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    rows, cols = (
        np.concatenate([rows, cols]), np.concatenate([cols, rows]),
    )
    return _coo_to_csr(rows, cols, (n, n))


def grid2d_graph(side: int, stencil: int = 5) -> CSR:
    """2-D grid/stencil matrix (side × side nodes, 5- or 9-point
    stencil, diagonal excluded): the mesh/PDE regime of the reference's
    SuiteSparse corpus — perfectly uniform degree, maximal spatial
    locality in 2-D but NOT in the 1-D row order (unlike banded_graph,
    neighbors sit ±side away), which is what stresses gather-table
    locality.
    """
    if stencil not in (5, 9):
        raise ValueError("stencil must be 5 or 9")
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if stencil == 9:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    n = side * side
    ii = np.arange(n, dtype=np.int64)
    x, y = ii // side, ii % side
    rows_l, cols_l = [], []
    for dx, dy in offs:
        ok = (x + dx >= 0) & (x + dx < side) & (y + dy >= 0) & (y + dy < side)
        rows_l.append(ii[ok])
        cols_l.append((x[ok] + dx) * side + (y[ok] + dy))
    return _coo_to_csr(
        np.concatenate(rows_l), np.concatenate(cols_l), (n, n)
    )


def hub_graph(
    n: int, n_hubs: int = 4, hub_frac: float = 0.25,
    base_degree: int = 4, seed: int = 0,
) -> CSR:
    """Extreme-hub graph: a sparse uniform background (degree
    ``base_degree``) plus ``n_hubs`` nodes each adjacent to a random
    ``hub_frac`` of ALL nodes.  The degree distribution's worst case for
    row-windowed plans and row-per-program kernels: one row spans many
    chunks (hub_frac·n nonzeros), far beyond anything R-MAT's smooth skew
    produces.
    """
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=n * base_degree).astype(np.int64)
    cols = rng.integers(0, n, size=n * base_degree).astype(np.int64)
    hub_ids = rng.choice(n, size=n_hubs, replace=False).astype(np.int64)
    per_hub = int(n * hub_frac)
    for h in hub_ids:
        nbrs = rng.choice(n, size=per_hub, replace=False).astype(np.int64)
        rows = np.concatenate([rows, np.full(per_hub, h, np.int64)])
        cols = np.concatenate([cols, nbrs])
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    rows, cols = (
        np.concatenate([rows, cols]), np.concatenate([cols, rows]),
    )
    return _coo_to_csr(rows, cols, (n, n))


def synth_graph(name: str, seed: int = 0) -> Optional[CSR]:
    """Resolve a synthetic-corpus name to its generator:

    ``rmat<scale>`` | ``banded<n>[-<bw>]`` | ``rect<m>x<n>[-<deg>]`` |
    ``cl<n>[-<deg>]`` (Chung-Lu) | ``grid<side>[-<stencil>]`` |
    ``hub<n>[-<nhubs>]`` | ``sbm<n_per_class>``.
    Returns None for unknown names.
    """
    import re

    if m := re.fullmatch(r"rmat(\d+)", name):
        return rmat_graph(scale=int(m.group(1)), edge_factor=16, seed=seed)
    if m := re.fullmatch(r"banded(\d+)(?:-(\d+))?", name):
        return banded_graph(int(m.group(1)),
                            int(m.group(2) or 8), seed=seed)
    if m := re.fullmatch(r"rect(\d+)x(\d+)(?:-(\d+))?", name):
        return bipartite_graph(int(m.group(1)), int(m.group(2)),
                               int(m.group(3) or 16), seed=seed)
    if m := re.fullmatch(r"cl(\d+)(?:-(\d+))?", name):
        return chung_lu_graph(int(m.group(1)),
                              int(m.group(2) or 16), seed=seed)
    if m := re.fullmatch(r"grid(\d+)(?:-(\d+))?", name):
        return grid2d_graph(int(m.group(1)), int(m.group(2) or 5))
    if m := re.fullmatch(r"hub(\d+)(?:-(\d+))?", name):
        return hub_graph(int(m.group(1)), int(m.group(2) or 4), seed=seed)
    if m := re.fullmatch(r"sbm(\d+)", name):
        return sbm_graph(n_per_class=int(m.group(1)), seed=seed).csr
    return None


def sbm_graph(
    n_per_class: int = 300,
    num_classes: int = 4,
    p_in: float = 0.05,
    p_out: float = 0.002,
    feat_dim: int = 64,
    signal: float = 1.0,
    seed: int = 0,
) -> GraphDataset:
    """Stochastic block model with class-correlated Gaussian features.

    Serves as the accuracy-parity fixture: a GCN must reach high accuracy
    here (homophilous communities), so a broken kernel shows up as a
    collapsed score — the same role PubMed accuracy plays for the reference
    (SURVEY §4.3).
    """
    rng = np.random.default_rng(seed)
    n = n_per_class * num_classes
    labels = np.repeat(np.arange(num_classes), n_per_class)
    # Sample undirected edges block by block.
    rows_l, cols_l = [], []
    for ci in range(num_classes):
        for cj in range(ci, num_classes):
            p = p_in if ci == cj else p_out
            ni = nj = n_per_class
            mask = rng.random((ni, nj)) < p
            if ci == cj:
                mask = np.triu(mask, 1)
            r, c = np.nonzero(mask)
            rows_l.append(r + ci * n_per_class)
            cols_l.append(c + cj * n_per_class)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    rows, cols = (
        np.concatenate([rows, cols]),
        np.concatenate([cols, rows]),
    )
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    coo = COO(
        row=jnp.asarray(rows.astype(np.int32)),
        col=jnp.asarray(cols.astype(np.int32)),
        data=None,
        shape=(n, n),
    )
    csr = csr_from_coo(coo)

    centers = rng.standard_normal((num_classes, feat_dim)) * signal
    feats = centers[labels] + rng.standard_normal((n, feat_dim))

    perm = rng.permutation(n)
    n_train, n_val = int(0.3 * n), int(0.2 * n)
    masks = {k: np.zeros(n, bool) for k in ("train", "val", "test")}
    masks["train"][perm[:n_train]] = True
    masks["val"][perm[n_train : n_train + n_val]] = True
    masks["test"][perm[n_train + n_val :]] = True

    return GraphDataset(
        csr=csr,
        features=jnp.asarray(feats.astype(np.float32)),
        labels=jnp.asarray(labels.astype(np.int32)),
        masks={k: jnp.asarray(v) for k, v in masks.items()},
        num_classes=num_classes,
        name=f"sbm_{n}",
    )


def planetoid_style_dataset(
    name: str = "pubmed",
    feat_dim: int = 128,
    num_classes: int = 3,
    seed: int = 0,
) -> GraphDataset:
    """A graph + synthetic features/labels.

    ``name``: a generated graph (any `synth_graph` name, e.g.
    ``cl169343-14`` for an ogbn-arxiv-shaped Chung-Lu graph) or a bundled
    ``.mtx`` graph.  The reference gets real Planetoid features via PyG's
    downloader (`gcn_custom.py:18-27`); without egress we attach
    structure-derived labels (propagated from random seeds, so they
    correlate with the graph) and class-correlated features — preserving
    the benchmark's compute shape AND giving models real signal.
    """
    csr = synth_graph(name, seed=seed)
    if csr is None:
        csr = load_mtx_graph(name, binary=True)
    n = csr.shape[0]
    rng = np.random.default_rng(seed)

    # Labels: propagate class seeds along edges (structure-correlated).
    import scipy.sparse as sp

    A = sp.csr_matrix(
        (
            np.ones(csr.nnz, np.float32),
            np.asarray(csr.indices),
            np.asarray(csr.indptr),
        ),
        shape=csr.shape,
    )
    scores = rng.standard_normal((n, num_classes)).astype(np.float32) * 0.1
    seeds = rng.choice(n, size=num_classes * 20, replace=False)
    for i, s in enumerate(seeds):
        scores[s, i % num_classes] += 10.0
    deg = np.maximum(A.sum(1).A.ravel(), 1)
    for _ in range(10):
        scores = 0.5 * scores + 0.5 * (A @ scores) / deg[:, None]
    labels = scores.argmax(1)

    centers = rng.standard_normal((num_classes, feat_dim)) * 0.8
    feats = centers[labels] + rng.standard_normal((n, feat_dim))

    perm = rng.permutation(n)
    n_train, n_val = int(0.1 * n), int(0.2 * n)
    masks = {k: np.zeros(n, bool) for k in ("train", "val", "test")}
    masks["train"][perm[:n_train]] = True
    masks["val"][perm[n_train : n_train + n_val]] = True
    masks["test"][perm[n_train + n_val :]] = True

    return GraphDataset(
        csr=csr,
        features=jnp.asarray(feats.astype(np.float32)),
        labels=jnp.asarray(labels.astype(np.int32)),
        masks={k: jnp.asarray(v) for k, v in masks.items()},
        num_classes=num_classes,
        name=name,
    )


def snap_download_script(dest: str = "data/snap") -> str:
    """Emit a shell script fetching the SNAP sweep (egress required).

    Capability parity with `data/download_SNAP.sh` — emitted rather than
    executed because this environment has no network access.
    """
    lines = ["#!/bin/sh", f"mkdir -p {dest}", "set -e"]
    for g in SNAP_GRAPHS:
        lines.append(
            f"wget -nc -P {dest} "
            f"https://suitesparse-collection-website.herokuapp.com/MM/SNAP/{g}.tar.gz"
        )
        lines.append(f"tar -xzf {dest}/{g}.tar.gz -C {dest}")
    return "\n".join(lines) + "\n"

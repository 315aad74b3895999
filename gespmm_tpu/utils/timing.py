"""Benchmark timing on the GPU.

Counterpart of the reference's cudaEvent loops (`spmm_test.cu:714-762`):
warm-up (which compiles), then timed calls that each end in
`jax.block_until_ready`, with the same throughput definitions —
GFLOPs = 2·nnz·K / time (`spmm_test.cu:728`) plus nnz/s.

A timing taken on the CPU says nothing about the card, so every entry
point here refuses to run without a GPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import jax
import numpy as np


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU; raises otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"timing needs a GPU, but JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); no CPU fallback is measured"
        )
    return dev


@dataclass
class BenchResult:
    mean_s: float
    median_s: float
    best_s: float
    iters: int

    def gflops(self, flops: float) -> float:
        return flops / self.mean_s / 1e9

    def rate(self, count: float) -> float:
        return count / self.mean_s


def _summary(times, iters_per_sample: int) -> BenchResult:
    t = np.asarray(times) / iters_per_sample
    return BenchResult(
        mean_s=float(t.mean()),
        median_s=float(np.median(t)),
        best_s=float(t.min()),
        iters=len(times) * iters_per_sample,
    )


def benchmark(
    fn: Callable[[], jax.Array],
    iters: int = 50,
    warmup: int = 3,
) -> BenchResult:
    """Time ``fn()`` (which returns arrays) call by call on the GPU."""
    require_gpu()
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return _summary(times, 1)


def benchmark_chained(
    step: Callable[..., jax.Array],
    x0: jax.Array,
    iters: int = 50,
    groups: int = 5,
    consts=None,
) -> BenchResult:
    """Steady-state time of one ``step``: ``iters`` data-chained steps in
    ONE jitted loop, timed ``groups`` times.

    Removes per-dispatch overhead (the analogue of the reference timing
    only kernel execution with cudaEvents, `spmm_test.cu:730-760`).
    ``step`` maps an array to an array of the same shape/dtype, so the
    iterations depend on each other and cannot be elided or overlapped.
    ``consts``: optional pytree passed as ``step(consts, x)`` as a jit
    ARGUMENT — closed-over arrays would be compiled in as constants.
    """
    require_gpu()
    if consts is None:
        @jax.jit
        def chain(x):
            return jax.lax.fori_loop(0, iters, lambda i, v: step(v), x)

        run = lambda: chain(x0)  # noqa: E731
    else:
        @jax.jit
        def chain_c(c, x):
            return jax.lax.fori_loop(0, iters, lambda i, v: step(c, v), x)

        run = lambda: chain_c(consts, x0)  # noqa: E731
    jax.block_until_ready(run())
    times = []
    for _ in range(groups):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return _summary(times, iters)


def spmm_flops(nnz: int, k: int) -> float:
    """2·nnz·K — the reference's FLOP definition (`spmm_test.cu:728`)."""
    return 2.0 * nnz * k


def sddmm_flops(nnz: int, k: int) -> float:
    return 2.0 * nnz * k

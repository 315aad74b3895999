"""Profiling and roofline analysis.

Counterparts of the reference's two tracing mechanisms (SURVEY §5.1):
cudaEvent timing loops -> `utils.timing.benchmark`; torch profiler tables ->
`trace()` (jax.profiler, view in TensorBoard/XProf) plus `op_cost_table`
(XLA's own HLO cost analysis — the closest thing to a per-kernel table
without a viewer).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context: `with trace('/tmp/trace'): step()`."""
    with jax.profiler.trace(log_dir):
        yield


def op_cost_table(fn: Callable, *args) -> Dict[str, float]:
    """Compile `fn(*args)` and return XLA's cost analysis.

    Keys include 'flops', 'bytes accessed', 'transcendentals', etc.
    """
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    try:
        (analysis,) = [compiled.cost_analysis()] if isinstance(
            compiled.cost_analysis(), dict
        ) else [compiled.cost_analysis()[0]]
    except (TypeError, IndexError):
        analysis = compiled.cost_analysis()
    return dict(analysis) if analysis else {}


# Published peaks per device kind, as `jax.devices()[0].device_kind`
# reports it.  Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part,
# dense rates without sparsity, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "l2_bytes": 50 * 2**20,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5",
    },
}

# The card whose figures size host-side defaults (the tiled plan's column
# tile) when no device is asked, e.g. while a plan is built for later use.
TARGET_DEVICE_KIND = "NVIDIA H100 80GB HBM3"


def device_peaks(device_kind: Optional[str] = None) -> Dict[str, float]:
    """Peak rates of ``device_kind`` (default: JAX's first device).

    A device that is not in `PEAKS` is an error, not a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


def spmm_roofline(
    nnz: int, m: int, k: int, measured_s: float,
    device_kind: Optional[str] = None,
) -> Dict[str, float]:
    """Roofline of a one-pass f32 SpMM against the device's HBM peak.

    The least traffic is every nonzero's row of B (nnz·k·4 bytes), its
    column index and value (8 bytes), and the output (m·k·4 bytes); the
    FLOPs (2·nnz·k) are far below any compute roof, so the bound is
    bytes over peak bandwidth.
    """
    peaks = device_peaks(device_kind)
    bytes_moved = nnz * k * 4 + nnz * 8 + m * k * 4
    sol_s = bytes_moved / peaks["hbm_bytes_per_s"]
    flops = 2.0 * nnz * k
    return {
        "bytes_moved": float(bytes_moved),
        "speed_of_light_s": sol_s,
        "achieved_gflops": flops / measured_s / 1e9,
        "sol_gflops": flops / sol_s / 1e9,
        "fraction_of_roofline": sol_s / measured_s,
    }

"""Device mesh construction and multi-host initialization.

The reference is single-GPU with no collective layer (SURVEY §2.3); this
module is the new capability: a `jax.sharding.Mesh` that the
row-partitioned SpMM and the sharded train steps run on.  It is
`jax.devices()` reshaped, which fits cards joined all to all (NVLink): every
card reaches every other at the same rate, so the axes follow the
algorithm alone.

Axes convention:
  "data"  — graph-row partitioning (each device owns a slab of output rows
            and the matching slab of B rows); collectives: all_gather of B
            forward, psum_scatter backward (NCCL on GPUs).
  "model" — feature-dimension sharding (embarrassingly parallel for SpMM;
            dense layer weights are column-sharded).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def maybe_distributed_init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize multi-host JAX if requested (no-op single-process).

    Call once at program start on multi-host runs; mirrors
    `jax.distributed.initialize` conventions.
    """
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    data: int = 0,
    model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("data", "model") mesh.

    data=0 means "use all remaining devices on the data axis".
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data == 0:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, ("data", "model"))

"""Multi-process runtime setup.

Each process runs the same program; jax.distributed wires the processes
into one global device mesh. Call initialize() once at startup, then build
meshes with global_mesh() — the sharded smoothing/BA steps
(flame_tpu.parallel.sharding / distributed_ba) are expressed over mesh
axes and run unchanged on multi-process meshes.
"""

from typing import Sequence

import numpy as np
import jax
from jax.sharding import Mesh

from flame_tpu.parallel.sharding import AXIS


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Initialize the distributed runtime. The coordinator address
    (host:port of process 0), the process count and this process's id
    are given explicitly; nothing is auto-detected."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def _device_grid(shape):
    """Devices in enumeration order. The cards of one host are joined all
    to all, so the mesh follows the algorithm alone."""
    return np.asarray(jax.devices()).reshape(tuple(shape))


def global_mesh(axis: str = AXIS) -> Mesh:
    """1-D mesh over every device across all hosts."""
    return Mesh(_device_grid((len(jax.devices()),)), (axis,))


def grid_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """N-D mesh over all global devices, e.g. (hosts, devices-per-host)
    for keyframe-block x graph sharding."""
    return Mesh(_device_grid(shape), tuple(axes))


def is_coordinator() -> bool:
    return jax.process_index() == 0

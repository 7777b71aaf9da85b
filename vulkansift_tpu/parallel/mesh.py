"""Device mesh setup — the replacement for the reference's device manager
(reference: vkenv/vulkan_device.c — instance creation, GPU scoring/selection,
queue discovery). The runtime is PJRT; this module only names devices into a
mesh and initializes the multi-host runtime.

The reference is single-GPU; everything here is NEW design surface
(SURVEY.md §2.5): data parallelism over images rides the ``"data"`` axis,
sharded pairwise matching rides the same axis as a ``ppermute`` ring
(:mod:`.ring_match`). A 1-D mesh fits GPUs joined all to all by NVLink,
where every device reaches every other at the same rate.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"

_distributed_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the multi-host runtime (jax.distributed). Safe to call on
    single-host setups (no-op without a coordinator address)."""
    global _distributed_initialized
    if _distributed_initialized:
        return
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    _distributed_initialized = True


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))

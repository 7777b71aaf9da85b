"""Data-parallel batched detection over a device mesh.

NEW design surface (the reference is single-GPU; SURVEY.md §2.5): images are
sharded over the mesh's data axis, every device runs the monolithic detect
program (:mod:`vulkansift_tpu.pipeline`) on its local sub-batch, and outputs
stay sharded — ready for sharded matching (:mod:`.ring_match`) or a gathered
host download. No collectives are needed in the forward pass (pure DP), so
scaling efficiency is bounded only by compile-time constants and host I/O.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import SiftConfig
from ..pipeline import make_detect_fn


def make_dp_detect_fn(config: SiftConfig, width: int, height: int,
                      mesh: Mesh, axis_name: str = "data"):
    """Build a jitted data-parallel batched detect over ``mesh``.

    Returned ``fn(images u8[B, H, W]) -> DetectOutput`` with leading batch
    dim on every output leaf; B must be divisible by the mesh axis size.
    """
    detect = make_detect_fn(config, width, height)

    def local_fn(images):
        # lax.map of the full single-image program: each device scans its
        # local sub-batch with the same per-frame work as the single-image
        # path (see pipeline.make_detect_batched).
        return jax.lax.map(detect, images)

    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis_name, None, None),),
        out_specs=P(axis_name),
        check_vma=False)

    return jax.jit(sharded)


def shard_batch(images, mesh: Mesh, axis_name: str = "data"):
    """Place a (B, H, W) host batch sharded over the mesh's data axis."""
    sharding = NamedSharding(mesh, P(axis_name, None, None))
    return jax.device_put(jnp.asarray(images), sharding)

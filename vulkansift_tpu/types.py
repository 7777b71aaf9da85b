"""Core array types: feature sets and 2-NN match sets.

The reference stores features as a 48-byte C struct header + 128 u8
descriptor (``vksift_Feature``, reference: include/vulkansift/
vulkansift_types.h:17-31) in sectioned GPU buffers. The layout here is
a **structure of arrays** pytree with a static capacity and a dynamic valid
count — the XLA-idiomatic replacement for the reference's atomic-append
buffers (see SURVEY.md §7 "dynamic keypoint counts").

Interop: :func:`features_to_numpy` / :func:`features_from_numpy` convert to a
NumPy structured array with exactly the ``vksift_Feature`` field layout so
externally-persisted feature databases round-trip, mirroring
vksift_downloadFeatures/vksift_uploadFeatures (reference: vulkansift.h:74-78).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .config import DESC_SIZE

# NumPy structured dtype bit-compatible with vksift_Feature
# (reference: include/vulkansift/vulkansift_types.h:17-31).
FEATURE_DTYPE = np.dtype([
    ("x", np.float32),
    ("y", np.float32),
    ("scale_x", np.float32),
    ("scale_y", np.float32),
    ("scale_idx", np.uint32),
    ("octave_idx", np.int32),
    ("sigma", np.float32),
    ("orientation", np.float32),
    ("intensity", np.float32),
    ("descriptor", np.uint8, (DESC_SIZE,)),
])

# NumPy structured dtype bit-compatible with vksift_Match_2NN
# (reference: include/vulkansift/vulkansift_types.h:33-41).
MATCH_DTYPE = np.dtype([
    ("idx_a", np.uint32),
    ("idx_b1", np.uint32),
    ("idx_b2", np.uint32),
    ("dist_a_b1", np.float32),
    ("dist_a_b2", np.float32),
])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Features:
    """A fixed-capacity feature set; entries [0, count) are valid.

    All leading dimensions are the static capacity N (optionally with batch
    dims in front under vmap/shard_map).
    """

    x: jax.Array            # f32[N] position in the input image
    y: jax.Array            # f32[N]
    scale_x: jax.Array      # f32[N] position in the pyramid octave image
    scale_y: jax.Array      # f32[N]
    scale_idx: jax.Array    # i32[N] gaussian scale image index
    octave_idx: jax.Array   # i32[N] octave (-1 = upscaled octave)
    sigma: jax.Array        # f32[N] blur level (halved if upsampling used)
    orientation: jax.Array  # f32[N] radians
    intensity: jax.Array    # f32[N] refined DoG value at the keypoint
    descriptor: jax.Array   # u8[N, 128]
    count: jax.Array        # i32[] number of valid entries

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    @staticmethod
    def empty(capacity: int, dtype=jnp.float32) -> "Features":
        z = jnp.zeros((capacity,), dtype)
        zi = jnp.zeros((capacity,), jnp.int32)
        return Features(
            x=z, y=z, scale_x=z, scale_y=z,
            scale_idx=zi, octave_idx=zi,
            sigma=z, orientation=z, intensity=z,
            descriptor=jnp.zeros((capacity, DESC_SIZE), jnp.uint8),
            count=jnp.zeros((), jnp.int32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Matches2NN:
    """2-nearest-neighbor match set; entries [0, count) are valid.

    Distances are L2 in u8 descriptor space, identical to the reference's
    Get2NearestNeighbors output (reference: shaders/Get2NearestNeighbors
    .comp:98-102).
    """

    idx_a: jax.Array    # i32[N]
    idx_b1: jax.Array   # i32[N] nearest neighbor in set B
    idx_b2: jax.Array   # i32[N] second nearest neighbor in set B
    dist_a_b1: jax.Array  # f32[N]
    dist_a_b2: jax.Array  # f32[N]
    count: jax.Array    # i32[]

    @property
    def capacity(self) -> int:
        return self.idx_a.shape[-1]


def features_to_numpy(feats: Features, count: int | None = None) -> np.ndarray:
    """Pack valid features into a vksift_Feature-layout structured array."""
    n = int(feats.count) if count is None else int(count)
    out = np.zeros((n,), FEATURE_DTYPE)
    # Download only the valid prefix (padded to a power of two so the slice
    # program count stays bounded) — full-capacity transfers are wasteful,
    # especially over slow host links. Blocking (parity with the reference's
    # fence wait): also flips is_ready() for is_buffer_available() polls.
    cap = feats.capacity
    npad = min(cap, max(256, 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)))
    sliced = jax.tree.map(lambda a: a[:npad] if a.ndim >= 1 else a, feats)
    host = jax.device_get(jax.block_until_ready(sliced))
    for name in ("x", "y", "scale_x", "scale_y", "scale_idx", "octave_idx",
                 "sigma", "orientation", "intensity", "descriptor"):
        out[name] = np.asarray(getattr(host, name))[:n]
    return out


def features_from_numpy(arr: np.ndarray, capacity: int) -> Features:
    """Load features from a vksift_Feature-layout structured array into a
    fixed-capacity set (parity: vksift_uploadFeatures)."""
    if arr.dtype != FEATURE_DTYPE:
        raise ValueError("expected FEATURE_DTYPE structured array")
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"{n} features exceed capacity {capacity}")

    def pad(v: np.ndarray, dtype: Any) -> jnp.ndarray:
        shape = (capacity,) + v.shape[1:]
        out = np.zeros(shape, dtype)
        out[:n] = v
        return jnp.asarray(out)

    return Features(
        x=pad(arr["x"], np.float32),
        y=pad(arr["y"], np.float32),
        scale_x=pad(arr["scale_x"], np.float32),
        scale_y=pad(arr["scale_y"], np.float32),
        scale_idx=pad(arr["scale_idx"].astype(np.int32), np.int32),
        octave_idx=pad(arr["octave_idx"], np.int32),
        sigma=pad(arr["sigma"], np.float32),
        orientation=pad(arr["orientation"], np.float32),
        intensity=pad(arr["intensity"], np.float32),
        descriptor=pad(arr["descriptor"], np.uint8),
        count=jnp.asarray(n, jnp.int32),
    )


def matches_to_numpy(m: Matches2NN, count: int | None = None) -> np.ndarray:
    """Pack valid matches into a vksift_Match_2NN-layout structured array."""
    n = int(m.count) if count is None else int(count)
    out = np.zeros((n,), MATCH_DTYPE)
    host = jax.device_get(jax.block_until_ready(m))
    out["idx_a"] = np.asarray(host.idx_a)[:n].astype(np.uint32)
    out["idx_b1"] = np.asarray(host.idx_b1)[:n].astype(np.uint32)
    out["idx_b2"] = np.asarray(host.idx_b2)[:n].astype(np.uint32)
    out["dist_a_b1"] = np.asarray(host.dist_a_b1)[:n]
    out["dist_a_b2"] = np.asarray(host.dist_a_b2)[:n]
    return out

"""Fixed-size keypoint patch geometry and gathering.

The reference's orientation/descriptor shaders sample sigma-dependent,
rotated pixel neighborhoods directly from the octave's gaussian image with a
workgroup per keypoint (shaders/ComputeOrientation.comp:84-99,
shaders/ComputeDescriptors.comp:131-143). Data-dependent window sizes are
hostile to XLA, so this design gathers ONE static square patch per
keypoint — sized for the worst-case descriptor radius — and both the
orientation and descriptor kernels read from it with masking:

* sigma in octave pixels is ``seed * 2^(subpix_s / nb_scales)`` with
  ``subpix_s <= nb_scales + 1`` (ExtractKeypoints.comp:219 with the final
  test at :202), so the radii have static octave-independent bounds;
* descriptor radius: ``floor(sqrt(2)*3*sigma*(NB_HIST+1)/2 + 0.5)``
  (ComputeDescriptors.comp:106-109);
* orientation radius: ``floor(3*1.5*sigma)`` (ComputeOrientation.comp:70-71),
  always smaller than the descriptor radius;
* +1 ring for the central-difference gradient stencil.

One gather per keypoint serves both kernels: extra orientations of the same
keypoint reuse the same patch, like the reference's appended keypoints reuse
the same image region.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import LAMBDA_DESCRIPTOR, LAMBDA_ORIENTATION, NB_HIST, SiftConfig


def sigma_remap_enabled() -> bool:
    """Sigma-scaled sampling (see :func:`build_patchset`); kill switch for
    hardware A/Bs and debugging."""
    return os.environ.get("VKSIFT_NO_SIGMA_REMAP") != "1"


def max_sigma_octave_pixels(config: SiftConfig) -> float:
    """Worst-case keypoint sigma in octave pixel units."""
    s = config.nb_scales_per_octave
    return config.seed_scale_sigma * 2.0 ** ((s + 1) / s)


def max_descriptor_radius(config: SiftConfig) -> int:
    sig = max_sigma_octave_pixels(config)
    return int(math.floor(math.sqrt(2.0) * LAMBDA_DESCRIPTOR * sig
                          * (NB_HIST + 1) * 0.5 + 0.5))


def max_orientation_radius(config: SiftConfig) -> int:
    sig = max_sigma_octave_pixels(config)
    return int(math.floor(3.0 * LAMBDA_ORIENTATION * sig))


def patch_size(config: SiftConfig) -> int:
    """Patch edge length: descriptor window + gradient ring."""
    return 2 * (max_descriptor_radius(config) + 1) + 1


class PatchSet(NamedTuple):
    """Per-keypoint patches + the metadata both kernels need."""

    patches: jax.Array   # f32/bf16[K, P, P] gaussian-image windows
    cx: jax.Array        # i32[K] round(scale_x) — patch center column
    cy: jax.Array        # i32[K]
    scale_x: jax.Array   # f32[K] subpixel keypoint position (octave coords)
    scale_y: jax.Array   # f32[K]
    sigma_oct: jax.Array  # f32[K] sigma / 2^octave (octave pixel units)
    width: jax.Array     # i32[K] octave image width (for bounds masking)
    height: jax.Array    # i32[K]


@functools.partial(jax.jit, static_argnames=("patch_edge",))
def gather_patches(gauss: jax.Array, scale_idx: jax.Array, cx: jax.Array,
                   cy: jax.Array, *, patch_edge: int) -> jax.Array:
    """Gather (K, P, P) windows centered at (cy, cx) from layer scale_idx of
    the (S+3, H, W) gaussian octave. Out-of-image texels are zero; callers
    mask them out via image bounds, so the fill value never contributes.
    """
    rp = (patch_edge - 1) // 2
    pad = rp + 1
    padded = jnp.pad(gauss, ((0, 0), (pad, pad), (pad, pad)))

    def one(si, yy, xx):
        si = jnp.clip(si, 0, gauss.shape[0] - 1)
        return jax.lax.dynamic_slice(
            padded, (si, yy - rp + pad, xx - rp + pad),
            (1, patch_edge, patch_edge))[0]

    return jax.vmap(one)(scale_idx, cy, cx)


def build_patchset(gaussians: Sequence[jax.Array], o: int, refined,
                   config: SiftConfig,
                   oct_res: Sequence[Tuple[int, int]],
                   patch_edge: int) -> PatchSet:
    """PatchSet for octave-``o`` keypoints with sigma-scaled sampling.

    Keypoints refined to the octave's top scales (``scale_idx >=
    nb_scales``) sample the NEXT octave's gaussian band at half
    resolution: ``G[o+1][scale_idx - s]`` carries the same absolute blur
    as ``G[o][scale_idx]`` (octave o+1 is seeded by downsampling
    ``G[o][s]``, reference sift_detector.c:1003-1034), and at
    sigma >= ~3 octave pixels the gaussian is bandlimited far below the
    half-resolution Nyquist rate — so the half-res grid is an equivalent
    sampling of the same image function at a quarter of the window area
    (the dominant orientation/descriptor cost is linear in window area).
    The reference shaders always sample full resolution
    (ComputeDescriptors.comp:131-143); match-level quality parity is
    asserted by the OpenCV differential tests and perf/parity.py
    (>= 0.95 recall parity). Disable with VKSIFT_NO_SIGMA_REMAP=1.
    """
    s = config.nb_scales_per_octave
    ow, oh = oct_res[o]
    k = refined.scale_x.shape[0]
    cx = jnp.clip(jnp.round(refined.scale_x), 0, ow).astype(jnp.int32)
    cy = jnp.clip(jnp.round(refined.scale_y), 0, oh).astype(jnp.int32)
    sig = config.seed_scale_sigma * jnp.exp2(refined.subpix_s / s)
    if o + 1 >= len(oct_res) or not sigma_remap_enabled():
        patches = gather_patches(gaussians[o], refined.scale_idx, cx, cy,
                                 patch_edge=patch_edge)
        return PatchSet(
            patches=patches, cx=cx, cy=cy,
            scale_x=refined.scale_x, scale_y=refined.scale_y,
            sigma_oct=sig,
            width=jnp.full((k,), ow, jnp.int32),
            height=jnp.full((k,), oh, jnp.int32))

    ow2, oh2 = oct_res[o + 1]
    remap = refined.scale_idx >= s
    # Octave o+1 is seeded with G_lo[i] = G_hi[2i+1] (odd texels — the
    # reference's half-pixel-center nearest blit, scale_space.
    # downsample2x_nearest), so hi-res coordinate u lands at lo-res
    # (u - 1) / 2; plain u/2 mis-centers every window by half a lo pixel
    # (measured -8% match recall on the CPU quality-regression pair).
    sx2 = (refined.scale_x - 1.0) * 0.5
    sy2 = (refined.scale_y - 1.0) * 0.5
    cx2 = jnp.clip(jnp.round(sx2), 0, ow2).astype(jnp.int32)
    cy2 = jnp.clip(jnp.round(sy2), 0, oh2).astype(jnp.int32)
    p_hi = gather_patches(gaussians[o], refined.scale_idx, cx, cy,
                          patch_edge=patch_edge)
    p_lo = gather_patches(gaussians[o + 1], refined.scale_idx - s,
                          cx2, cy2, patch_edge=patch_edge)

    def pick(a, b):
        return jnp.where(remap, a, b)

    return PatchSet(
        patches=jnp.where(remap[:, None, None], p_lo, p_hi),
        cx=pick(cx2, cx), cy=pick(cy2, cy),
        scale_x=pick(sx2, refined.scale_x),
        scale_y=pick(sy2, refined.scale_y),
        sigma_oct=pick(sig * 0.5, sig),
        width=pick(jnp.full((k,), ow2, jnp.int32),
                   jnp.full((k,), ow, jnp.int32)),
        height=pick(jnp.full((k,), oh2, jnp.int32),
                    jnp.full((k,), oh, jnp.int32)))


def patch_gradients(patches: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Central-difference gradients over (K, P, P) patches.

    Returns (gx, gy) of shape (K, P-2, P-2); entry [k, i, j] is the gradient
    at patch pixel (i+1, j+1). Matches the shaders' 0.5*(right-left) /
    0.5*(down-up) stencil (ComputeOrientation.comp:101-102).
    """
    p = patches.astype(jnp.float32)
    gx = 0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])
    gy = 0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1])
    return gx, gy

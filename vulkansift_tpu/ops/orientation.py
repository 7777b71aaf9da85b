"""Keypoint orientation assignment (pure XLA, patch-based).

Replaces the reference's ComputeOrientation shader (reference:
src/vulkansift/shaders/ComputeOrientation.comp) — a 32-thread workgroup per
keypoint accumulating a 36-bin gradient histogram via fixed-point
shared-memory atomics — with a dense vectorized formulation over the static
per-keypoint patches from :mod:`.patches`:

* gaussian-weighted gradient magnitudes over the box of radius
  ``floor(3 * 1.5 * sigma)`` (ComputeOrientation.comp:70-81); like the
  shader, the weighting window is the full square box (the shader's
  circular-window test only triggers together with the image-bounds test,
  ComputeOrientation.comp:96-99 — the gaussian weight makes the corners
  negligible either way). Out-of-image gradient stencils are excluded;
* the histogram is accumulated with 36 masked dense reductions instead of
  atomics — float math replaces the shader's online fixed-point conversion
  (ComputeOrientation.comp:74-81), which was itself an approximation of
  float accumulation;
* smoothed 6 times with a circular [1,1,1]/3 box (ComputeOrientation.comp:
  130-147);
* peaks are strict local maxima >= 0.8*max with parabolic interpolation and
  the (idx + 0.5) bin-center convention (ComputeOrientation.comp:152-168).

Divergence from the reference (documented): the shader writes the first
orientation in place and atomically appends the rest in nondeterministic
order (ComputeOrientation.comp:170-184); we return up to
``config.orientation_capacity`` orientations per keypoint ordered by
descending histogram peak value (principal orientation first), which is
deterministic and keeps a static shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import (LAMBDA_ORIENTATION, NB_ORI_HIST_BINS, ORI_PEAK_RATIO)
from .patches import PatchSet, patch_gradients

_TWO_PI = 2.0 * jnp.pi


class Orientations(NamedTuple):
    angles: jax.Array  # f32[K, CAP] radians
    valid: jax.Array   # bool[K, CAP]


@functools.partial(jax.jit, static_argnames=("ori_radius", "capacity"))
def compute_orientations(ps: PatchSet, *, ori_radius: int,
                         capacity: int) -> Orientations:
    """Compute up to ``capacity`` orientations per keypoint.

    Args:
      ps: patch set (patches sized >= 2*(ori_radius+1)+1).
      ori_radius: static max box radius (patches.max_orientation_radius).
      capacity: static per-keypoint orientation bound
        (config.orientation_capacity).
    """
    k, p, _ = ps.patches.shape
    rp = (p - 1) // 2  # patch center index
    r = ori_radius
    w = 2 * r + 1

    gx_full, gy_full = patch_gradients(ps.patches)  # (K, P-2, P-2), center rp-1
    c = rp - 1
    gx = gx_full[:, c - r:c + r + 1, c - r:c + r + 1]  # (K, W, W)
    gy = gy_full[:, c - r:c + r + 1, c - r:c + r + 1]

    dyx = jnp.arange(-r, r + 1, dtype=jnp.float32)
    dx = dyx[None, None, :]  # (1, 1, W)
    dy = dyx[None, :, None]  # (1, W, W broadcast)

    # Per-keypoint dynamic radius and gaussian weighting
    # (ComputeOrientation.comp:69-72).
    scaled_lambda = LAMBDA_ORIENTATION * ps.sigma_oct  # (K,)
    box_radius = jnp.floor(3.0 * scaled_lambda)
    expf_scale = -1.0 / (2.0 * scaled_lambda * scaled_lambda)

    fx = ps.scale_x - ps.cx.astype(jnp.float32)  # subpixel offset in [-.5,.5]
    fy = ps.scale_y - ps.cy.astype(jnp.float32)
    sdx = dx - fx[:, None, None]  # (K, 1->W, W) subpix_delta_x
    sdy = dy - fy[:, None, None]
    sqrdist = sdx * sdx + sdy * sdy

    # Masks: inside the dynamic box; gradient stencil inside the image
    # (ComputeOrientation.comp:84-99).
    br = box_radius[:, None, None]
    in_box = (jnp.abs(dx) <= br) & (jnp.abs(dy) <= br)
    px = ps.cx[:, None, None] + dx.astype(jnp.int32)
    py = ps.cy[:, None, None] + dy.astype(jnp.int32)
    in_img = ((px >= 1) & (px < ps.width[:, None, None] - 1)
              & (py >= 1) & (py < ps.height[:, None, None] - 1))
    mask = in_box & in_img

    mag = jnp.exp(sqrdist * expf_scale[:, None, None]) * jnp.sqrt(
        gx * gx + gy * gy)
    mag = jnp.where(mask, mag, 0.0)
    theta = jnp.arctan2(gy, gx)
    theta = jnp.where(theta < 0, theta + _TWO_PI, theta)
    bins = jnp.floor(theta * (NB_ORI_HIST_BINS / _TWO_PI)).astype(jnp.int32)
    bins = jnp.clip(bins, 0, NB_ORI_HIST_BINS - 1)

    # Histogram: 36 fused masked reductions (no scatter).
    mag2 = mag.reshape(k, -1)
    bins2 = bins.reshape(k, -1)
    hist = jnp.stack(
        [jnp.sum(jnp.where(bins2 == b, mag2, 0.0), axis=-1)
         for b in range(NB_ORI_HIST_BINS)], axis=-1)  # (K, 36)

    return peaks_from_histograms(hist, capacity)


def _smooth_shift_matrix() -> "np.ndarray":
    """(36, 108) matrix computing [smoothed, prev, next] in one matmul.

    The 6x circular [1,1,1]/3 smoothing is a fixed circulant linear map;
    One (36, 108) matmul yields the smoothed histogram and both of its
    circular neighbours, in place of 12 jnp.roll slice+pad chains on
    (capacity, 36).
    """
    import numpy as np
    n = NB_ORI_HIST_BINS
    eye = np.eye(n)
    s = (np.roll(eye, 1, 1) + eye + np.roll(eye, -1, 1)) / 3.0
    m6 = np.linalg.matrix_power(s, 6)
    return np.concatenate(
        [m6, m6 @ np.roll(eye, 1, 1), m6 @ np.roll(eye, -1, 1)],
        axis=1).astype(np.float32)


def peaks_from_histograms(hist: jax.Array, capacity: int) -> Orientations:
    """Smooth + peak-pick a batch of 36-bin orientation histograms.

    6x circular [1,1,1]/3 smoothing (ComputeOrientation.comp:130-147), then
    strict local maxima >= 0.8*max with parabolic interpolation
    (:152-168), strongest first, up to ``capacity`` per row.
    """
    nb = NB_ORI_HIST_BINS
    combo = jnp.asarray(_smooth_shift_matrix())
    hp = jax.lax.dot_general(
        hist.astype(jnp.float32), combo, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    hist, prev, nxt = hp[:, :nb], hp[:, nb:2 * nb], hp[:, 2 * nb:]
    hmax = jnp.max(hist, axis=-1, keepdims=True)
    is_peak = (hist >= ORI_PEAK_RATIO * hmax) & (hist > prev) & (hist > nxt)

    denom = prev - 2.0 * hist + nxt
    interp = jnp.where(denom == 0.0, 0.0, 0.5 * (prev - nxt)
                       / jnp.where(denom == 0.0, 1.0, denom))
    bin_idx = jnp.arange(NB_ORI_HIST_BINS, dtype=jnp.float32)[None, :]
    angles_all = (bin_idx + interp + 0.5) * (_TWO_PI / NB_ORI_HIST_BINS)

    # Keep the top-`capacity` peaks by histogram value (strongest first).
    peak_vals = jnp.where(is_peak, hist, -jnp.inf)
    top_vals, top_idx = jax.lax.top_k(peak_vals, capacity)
    # One-hot contraction instead of take_along_axis: a dense
    # compare+select+reduce over 36 bins in place of a per-row gather.
    onehot = (top_idx[:, :, None]
              == jnp.arange(nb, dtype=top_idx.dtype)[None, None, :])
    angles = jnp.sum(jnp.where(onehot, angles_all[:, None, :], 0.0),
                     axis=-1)
    valid = jnp.isfinite(top_vals)
    return Orientations(angles=angles, valid=valid)

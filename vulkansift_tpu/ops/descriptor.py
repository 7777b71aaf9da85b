"""128-D SIFT descriptor computation (pure XLA, matmul-shaped).

Replaces the reference's ComputeDescriptors shader (reference:
src/vulkansift/shaders/ComputeDescriptors.comp) — a 64-thread workgroup per
keypoint with trilinear soft-binning into a fixed-point shared-memory
accumulator — with a dense **hat-product** formulation:

each window pixel's trilinear contribution to the (4, 4, 8) histogram grid
(ComputeDescriptors.comp:183-198) factorizes as an outer product of three
hat-function weight vectors::

    desc[y, x, o] = sum_p mag_p * wy_p[y] * wx_p[x] * wo_p[o]
    wy_p[i] = relu(1 - |i - ty_p|)        (ty = fhist_y - 0.5)
    wo_p[o] = relu(1 - circdist_8(o, fbin_p))

so the whole accumulation is one (4 x Np) @ (Np x 32) matmul per keypoint —
dense work with zero scatters/atomics, replacing the shader's fixed-point
atomicAdd protocol (ComputeDescriptors.comp:40-77) which was itself an
approximation of float accumulation.

Algorithm parity notes:

* window radius ``floor(sqrt(2)*3*sigma*(NB_HIST+1)/2 + 0.5)``, rotation by
  the keypoint orientation, gaussian weight ``exp(-(ox^2+oy^2)/8)`` in
  lambda units (ComputeDescriptors.comp:106-123);
* out-of-image gradient stencils are skipped; like the shader, the window is
  the full square box (ComputeDescriptors.comp:139-141);
* UBC vs VLFeat formats differ by orientation-bin direction
  (ComputeDescriptors.comp:167-172). DIVERGENCE: for UBC the shader computes
  ``floor(-rel*8/2pi)`` and indexes with a possibly-negative C-style ``%``
  (undefined in GLSL); we use the proper modulo ``mod(-rel, 2pi)*8/2pi``,
  which is what OpenCV/Lowe do — parity target is OpenCV matching behavior,
  not the shader's UB;
* normalization: L2 -> clamp at 0.2*norm -> renormalize -> *512 ->
  floor -> saturate to u8 (ComputeDescriptors.comp:201-265), in float math.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import (DESC_SIZE, DescriptorFormat, L2_NORM_THRESHOLD,
                      LAMBDA_DESCRIPTOR, NB_HIST, NB_ORI)
from .patches import PatchSet, patch_gradients

_TWO_PI = 2.0 * jnp.pi
# Precision of the histogram contraction. Full float32: TF32 inputs would
# move bins that are then floored to u8. Read when the detect program is
# traced; scripts/desc_precision_ab.py swaps it to time TF32 on the GPU.
DESC_PRECISION = jax.lax.Precision.HIGHEST


def _descriptor_chunk(patches, cx, cy, scale_x, scale_y, sigma_oct, width,
                      height, orientation, *, desc_radius: int,
                      use_vlfeat: bool) -> jax.Array:
    """Raw (unnormalized) descriptors for a chunk of keypoints.

    patches: (K, P, P); returns (K, 128) float32.
    """
    k, p, _ = patches.shape
    rp = (p - 1) // 2
    r = desc_radius
    w = 2 * r + 1

    gx_full, gy_full = patch_gradients(patches)
    c = rp - 1
    gx = gx_full[:, c - r:c + r + 1, c - r:c + r + 1]  # (K, W, W)
    gy = gy_full[:, c - r:c + r + 1, c - r:c + r + 1]

    dvec = jnp.arange(-r, r + 1, dtype=jnp.float32)
    dx = dvec[None, None, :]
    dy = dvec[None, :, None]

    scaled_lambda = LAMBDA_DESCRIPTOR * sigma_oct  # (K,)
    radius = jnp.sqrt(2.0) * scaled_lambda * (NB_HIST + 1) * 0.5
    int_radius = jnp.floor(radius + 0.5)

    fx = scale_x - cx.astype(jnp.float32)
    fy = scale_y - cy.astype(jnp.float32)
    sdx = dx - fx[:, None, None]  # (K, 1, W)
    sdy = dy - fy[:, None, None]  # (K, W, 1)

    ir = int_radius[:, None, None]
    in_box = (jnp.abs(dx) <= ir) & (jnp.abs(dy) <= ir)
    px = cx[:, None, None] + dx.astype(jnp.int32)
    py = cy[:, None, None] + dy.astype(jnp.int32)
    in_img = ((px >= 1) & (px < width[:, None, None] - 1)
              & (py >= 1) & (py < height[:, None, None] - 1))
    mask = in_box & in_img

    inv_lambda = 1.0 / scaled_lambda
    kcos = jnp.cos(orientation) * inv_lambda
    ksin = jnp.sin(orientation) * inv_lambda
    ox = kcos[:, None, None] * sdx + ksin[:, None, None] * sdy  # (K, W, W)
    oy = kcos[:, None, None] * sdy - ksin[:, None, None] * sdx

    expf_scale = -1.0 / (2.0 * (NB_HIST / 2) * (NB_HIST / 2))
    mag = jnp.exp(expf_scale * (ox * ox + oy * oy)) * jnp.sqrt(
        gx * gx + gy * gy)
    mag = jnp.where(mask, mag, 0.0)

    theta = jnp.arctan2(gy, gx)
    theta = jnp.where(theta < 0, theta + _TWO_PI, theta)
    rel = theta - orientation[:, None, None]
    rel = jnp.mod(rel, _TWO_PI)
    if use_vlfeat:
        fbin = rel * (NB_ORI / _TWO_PI)
    else:
        fbin = jnp.mod(-rel, _TWO_PI) * (NB_ORI / _TWO_PI)

    # Hat-product weights.
    ty = (oy + NB_HIST / 2 - 0.5)  # continuous cell coordinate
    tx = (ox + NB_HIST / 2 - 0.5)
    cells = jnp.arange(NB_HIST, dtype=jnp.float32)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(
        cells[None, None, None, :] - ty[..., None]))  # (K, W, W, 4)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(
        cells[None, None, None, :] - tx[..., None]))
    obins = jnp.arange(NB_ORI, dtype=jnp.float32)
    od = jnp.abs(obins[None, None, None, :] - fbin[..., None])
    wo = jnp.maximum(0.0, 1.0 - jnp.minimum(od, NB_ORI - od))  # (K, W, W, 8)

    n = w * w
    wy = wy.reshape(k, n, NB_HIST)
    wx = wx.reshape(k, n, NB_HIST)
    wo = wo.reshape(k, n, NB_ORI)
    mag = mag.reshape(k, n)

    # (x, o) outer product scaled by mag, then one matmul with wy per kp:
    # desc[y, x, o] = sum_p wy[p,y] * (mag[p] * wx[p,x] * wo[p,o])
    wxo = (wx[..., :, None] * wo[..., None, :]).reshape(k, n, NB_HIST * NB_ORI)
    wxo = wxo * mag[..., None]
    desc = jnp.einsum("kpy,kpz->kyz", wy, wxo, precision=DESC_PRECISION,
                      preferred_element_type=jnp.float32)  # (K, 4, 32)
    return desc.reshape(k, DESC_SIZE)


def normalize_descriptor(raw: jax.Array) -> jax.Array:
    """L2 normalize / clamp at 0.2*norm / renormalize / *512 / floor / u8
    (ComputeDescriptors.comp:201-265)."""
    norm = jnp.sqrt(jnp.sum(raw * raw, axis=-1, keepdims=True))
    clipped = jnp.minimum(raw, L2_NORM_THRESHOLD * norm)
    norm2 = jnp.sqrt(jnp.sum(clipped * clipped, axis=-1, keepdims=True))
    safe = jnp.where(norm2 == 0.0, 1.0, norm2)
    vals = jnp.floor(clipped * (512.0 / safe))
    return jnp.clip(vals, 0.0, 255.0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=(
    "desc_radius", "use_vlfeat", "chunk_size"))
def compute_descriptors(ps: PatchSet, orientation: jax.Array, *,
                        desc_radius: int, use_vlfeat: bool,
                        chunk_size: int = 128) -> jax.Array:
    """Descriptors for K (keypoint, orientation) pairs -> u8 (K, 128).

    ``ps`` holds one patch per pair (extra orientations repeat the parent
    keypoint's patch). Work is chunked over keypoints to bound the
    (K, W^2, 32) intermediate. Chunk padding runs on dummy data.
    """
    k = ps.patches.shape[0]
    ck = min(chunk_size, k)
    pad = (-k) % ck
    if pad:
        def padk(a):
            return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:],
                                                 a.dtype)], axis=0)
        ps = PatchSet(*[padk(a) for a in ps])
        orientation = padk(orientation)

    def run(chunk):
        psc, oric = chunk
        return _descriptor_chunk(
            psc.patches, psc.cx, psc.cy, psc.scale_x, psc.scale_y,
            jnp.maximum(psc.sigma_oct, 1e-6), psc.width, psc.height, oric,
            desc_radius=desc_radius, use_vlfeat=use_vlfeat)

    nchunks = (k + pad) // ck
    ps_c = jax.tree.map(lambda a: a.reshape((nchunks, ck) + a.shape[1:]), ps)
    ori_c = orientation.reshape(nchunks, ck)
    raw = jax.lax.map(run, (ps_c, ori_c))
    raw = raw.reshape(nchunks * ck, DESC_SIZE)[:k]
    return normalize_descriptor(raw)

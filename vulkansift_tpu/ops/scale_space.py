"""Gaussian scale-space pyramid construction (pure XLA).

Replaces the reference's GaussianBlur/GaussianBlurInterpolated/
DifferenceOfGaussian compute shaders and the blit-based octave seeding
(reference: src/vulkansift/shaders/GaussianBlur.comp,
shaders/DifferenceOfGaussian.comp, and the command recording in
src/vulkansift/sift_detector.c:893-1037) with a dense array formulation:

* each octave is a single ``(nb_scales+3, H, W)`` array — the analogue of the
  reference's image arrays with one layer per scale;
* the separable blur is a shift-and-multiply-accumulate over symmetric
  (MIRRORED_REPEAT-equivalent) padding — XLA fuses the tap loop into one
  vectorized pass per direction; boundary handling matches the reference's
  sampler addressing mode;
* the 2x upsample matches ``vkCmdBlitImage`` with VK_FILTER_LINEAR
  (half-pixel centers, clamp-to-edge), the 2x downsample matches
  VK_FILTER_NEAREST which picks odd source texels
  (sift_detector.c:906-916, :1003-1024);
* DoG is ``G[s+1] - G[s]`` over scale layers
  (shaders/DifferenceOfGaussian.comp:14-16).

Scale-space semantics (sigma schedule) live in :mod:`.gaussian`.

The per-octave construction is sequential by nature (each scale blurs the
previous, each octave downsamples the previous); everything inside a scale is
data-parallel and handled by XLA fusion. Pyramid dtype is float32 or IEEE
float16 per ``config.pyramid_precision`` (fp16 storage like the reference;
see build_pyramid), with blur accumulation always in float32.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PyramidPrecision, SiftConfig
from . import gaussian


def _conv1d_symmetric(x: jax.Array, taps: np.ndarray, axis: int) -> jax.Array:
    """1-D convolution with a symmetric odd-length kernel along ``axis``,
    with symmetric (mirror) boundary handling.

    ``taps`` is the half-kernel [center, t1, ..., tk]; the convolution
    computed is ``y[i] = c*x[i] + sum_j t_j*(x[i-j] + x[i+j])`` — exactly the
    reference blur shader's accumulation (shaders/GaussianBlur.comp:33-44).
    """
    k = len(taps) - 1
    out_dtype = x.dtype
    x = x.astype(jnp.float32)
    if k == 0:
        return (x * float(taps[0])).astype(out_dtype)
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (k, k)
    xp = jnp.pad(x, pad_width, mode="symmetric")
    n = x.shape[axis]

    def shifted(off: int) -> jax.Array:
        # slice [k+off : k+off+n) along axis
        return jax.lax.slice_in_dim(xp, k + off, k + off + n, axis=axis)

    acc = shifted(0) * float(taps[0])
    for j in range(1, k + 1):
        acc = acc + (shifted(-j) + shifted(j)) * float(taps[j])
    return acc.astype(out_dtype)


def blur_separable(img: jax.Array, taps: np.ndarray) -> jax.Array:
    """Separable gaussian blur of (..., H, W) with a half-kernel."""
    img = _conv1d_symmetric(img, taps, axis=img.ndim - 1)  # horizontal
    return _conv1d_symmetric(img, taps, axis=img.ndim - 2)  # vertical


def upsample2x_linear(img: jax.Array) -> jax.Array:
    """2x bilinear upsample matching vkCmdBlitImage(VK_FILTER_LINEAR)
    (half-pixel sample positions, clamp-to-edge).

    dst[2k]   = 0.25*src[k-1] + 0.75*src[k]
    dst[2k+1] = 0.75*src[k]   + 0.25*src[k+1]
    applied separably to rows then columns.
    """

    def up1d_parts(x: jax.Array, axis: int):
        n = x.shape[axis]
        pad = [(0, 0)] * x.ndim
        pad[axis] = (1, 1)
        xp = jnp.pad(x, pad, mode="edge")
        prev = jax.lax.slice_in_dim(xp, 0, n, axis=axis)       # src[k-1]
        cur = jax.lax.slice_in_dim(xp, 1, n + 1, axis=axis)    # src[k]
        nxt = jax.lax.slice_in_dim(xp, 2, n + 2, axis=axis)    # src[k+1]
        even = 0.25 * prev + 0.75 * cur
        odd = 0.75 * cur + 0.25 * nxt
        return even, odd

    def up1d(x: jax.Array, axis: int) -> jax.Array:
        n = x.shape[axis]
        even, odd = up1d_parts(x, axis)
        stacked = jnp.stack([even, odd], axis=axis + 1)
        new_shape = list(x.shape)
        new_shape[axis] = 2 * n
        return stacked.reshape(new_shape)

    img = up1d(img, img.ndim - 2)
    img = up1d(img, img.ndim - 1)
    return img


def downsample2x_nearest(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """2x nearest downsample matching vkCmdBlitImage(VK_FILTER_NEAREST):
    with half-pixel centers dst texel x samples src texel 2x+1
    (sift_detector.c:1003-1024).
    """
    rows = img[..., 1::2, :][..., :out_h, :]
    return rows[..., 1::2][..., :out_w]


class ScaleSpace(Tuple):
    """(gaussians, dogs): per-octave tuples of (S+3|S+2, H, W) arrays."""


def build_pyramid(
    image: jax.Array,
    config: SiftConfig,
    octave_shapes: Sequence[Tuple[int, int]],
) -> Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...]]:
    """Construct the full gaussian + DoG pyramids.

    Args:
      image: (H, W) float32 grayscale in [0, 1].
      config: static SIFT configuration.
      octave_shapes: static per-octave (height, width) sizes.

    Returns:
      (gaussians, dogs): tuples over octaves; gaussians[o] has shape
      (nb_scales+3, H_o, W_o), dogs[o] has (nb_scales+2, H_o, W_o); dtype per
      config.pyramid_precision.
    """
    s = config.nb_scales_per_octave
    # FLOAT16 = IEEE fp16 STORAGE (reference parity, sift_memory.c:139);
    # bf16's 8-bit mantissa corrupts downstream gradients enough to
    # collapse match recall to ~0.25 of f32 (measured via perf/parity.py).
    #
    # The ENTIRE arithmetic chain (blur cascade, octave seeding, DoG
    # subtraction) runs in f32 and quantizes only at storage: feeding
    # fp16-rounded layers back into the cascade puts gaussian-scale
    # (~0.5) rounding error (~2.4e-4 absolute) onto DoG values that are
    # only ~0.01 — a 2-3% relative error that collapses the strict
    # 26-neighbor extremum comparisons and cost 37% of keypoints.
    # Quantizing the finished DoG instead introduces error at the DoG's
    # own scale (fp16 is floating — ~0.05% here), which the recall
    # metrics don't see.
    dtype = (jnp.float16 if config.pyramid_precision == PyramidPrecision.FLOAT16
             else jnp.float32)
    kernels = [gaussian.half_kernel(sig) for sig in gaussian.kernel_sigmas(config)]

    gaussians: List[jax.Array] = []
    dogs: List[jax.Array] = []

    # Octave 0 seed: (optionally upsampled) input blurred to seed sigma.
    seed = upsample2x_linear(image) if config.use_input_upsampling else image
    base = blur_separable(seed.astype(jnp.float32), kernels[0])

    for o, (h, w) in enumerate(octave_shapes):
        if o > 0:
            base = downsample2x_nearest(base_top, h, w)
        layers = [base]
        dlayers = []
        prev = base
        for i in range(1, s + 3):
            y = blur_separable(prev, kernels[i])
            layers.append(y)
            dlayers.append(y - prev)
            prev = y
            if i == s:
                base_top = y  # f32 seed for the next octave
        gaussians.append(jnp.stack(layers).astype(dtype))
        dogs.append(jnp.stack(dlayers).astype(dtype))

    return tuple(gaussians), tuple(dogs)


@functools.partial(jax.jit, static_argnums=(1, 2))
def build_pyramid_jit(image, config: SiftConfig, octave_shapes):
    return build_pyramid(image, config, octave_shapes)

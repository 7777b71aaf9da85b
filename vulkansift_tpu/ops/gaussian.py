"""Gaussian kernel schedule for scale-space construction.

Implements the same incremental-blur math as the reference's
``setupGaussianKernels`` (reference: src/vulkansift/sift_detector.c:52-145):

* kernel 0 takes the input image from its assumed blur level (doubled when
  2x upsampling is active) to ``seed_scale_sigma``;
* kernel s (s >= 1) takes scale s-1 to scale s where scale s has absolute
  blur ``seed_scale_sigma * 2^(s/nb_scales)``, so the separable increment is
  ``sqrt(sig_total^2 - sig_prev^2)``;
* half-kernel tap count is ``ceil(4*sigma) + 1`` capped at
  MAX_GAUSSIAN_KERNEL_SIZE (=20), taps ``exp(-i^2 / (2 sigma^2))``
  normalized so the full symmetric kernel sums to 1.

The reference's hardware-bilinear "interpolated kernel" packing
(sift_detector.c:122-135) halves GPU texture fetches; it is mathematically a
re-expression of the same convolution, so we always convolve with the
plain symmetric taps.

These are Python-time (static) computations: kernels depend only on config,
never on data, exactly as in the reference where they are computed once at
detector creation.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..config import MAX_GAUSSIAN_KERNEL_SIZE, SiftConfig


def kernel_sigmas(config: SiftConfig) -> List[float]:
    """Separable increment sigma for each of the nb_scales+3 blur steps."""
    s = config.nb_scales_per_octave
    sigmas = []
    for scale_i in range(s + 3):
        if scale_i == 0:
            init_blur = config.input_image_blur_level * (
                2.0 if config.use_input_upsampling else 1.0)
            sig = math.sqrt(max(config.seed_scale_sigma ** 2 - init_blur ** 2, 0.0))
        else:
            sig_prev = (2.0 ** ((scale_i - 1) / s)) * config.seed_scale_sigma
            sig_total = sig_prev * (2.0 ** (1.0 / s))
            sig = math.sqrt(sig_total ** 2 - sig_prev ** 2)
        sigmas.append(sig)
    return sigmas


def half_kernel(sigma: float) -> np.ndarray:
    """Symmetric half-kernel taps [center, +1, ..., +(k-1)], normalized so
    center + 2*sum(tail) == 1. Matches the reference's tap count and
    normalization (sift_detector.c:103-121)."""
    if sigma <= 0.0:
        return np.array([1.0], np.float32)
    k = int(math.ceil(sigma * 4.0) + 1.0)
    k = min(k, MAX_GAUSSIAN_KERNEL_SIZE)
    i = np.arange(k, dtype=np.float64)
    taps = np.exp(-0.5 * i ** 2 / sigma ** 2)
    taps /= taps[0] + 2.0 * taps[1:].sum()
    return taps.astype(np.float32)


def full_kernel(sigma: float) -> np.ndarray:
    """Full symmetric 1-D kernel [-(k-1) .. +(k-1)], sums to 1."""
    h = half_kernel(sigma)
    return np.concatenate([h[:0:-1], h]).astype(np.float32)


def octave_kernels(config: SiftConfig) -> Tuple[np.ndarray, ...]:
    """Full symmetric kernels for the nb_scales+3 blur steps of one octave
    (identical across octaves, as in the reference)."""
    return tuple(full_kernel(s) for s in kernel_sigmas(config))


def absolute_sigmas(config: SiftConfig) -> List[float]:
    """Absolute blur level of each gaussian scale image within an octave
    (in that octave's pixel units): seed * 2^(s/nb_scales)."""
    s = config.nb_scales_per_octave
    return [config.seed_scale_sigma * (2.0 ** (i / s)) for i in range(s + 3)]

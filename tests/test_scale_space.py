"""Golden tests for the gaussian kernel schedule and pyramid construction
(reference semantics: sift_detector.c:52-145, :893-1037)."""

import math

import numpy as np
import pytest
import scipy.ndimage

from vulkansift_tpu import SiftConfig
from vulkansift_tpu.config import PyramidPrecision
from vulkansift_tpu.golden import reference as gold
from vulkansift_tpu.ops import gaussian, scale_space


def test_kernel_sigma_schedule():
    c = SiftConfig(use_input_upsampling=True, input_image_blur_level=0.5,
                   seed_scale_sigma=1.6, nb_scales_per_octave=3)
    sig = gaussian.kernel_sigmas(c)
    assert len(sig) == 6  # nb_scales + 3
    # Kernel 0: doubled input blur 1.0 -> seed 1.6.
    assert sig[0] == pytest.approx(math.sqrt(1.6 ** 2 - 1.0 ** 2))
    # Incremental sigmas: sqrt(sig_s^2 - sig_{s-1}^2).
    for s in range(1, 6):
        prev = 1.6 * 2 ** ((s - 1) / 3)
        tot = prev * 2 ** (1 / 3)
        assert sig[s] == pytest.approx(math.sqrt(tot ** 2 - prev ** 2))


def test_kernel_taps_normalized():
    for sigma in (0.8, 1.2266, 2.0, 5.0):
        h = gaussian.half_kernel(sigma)
        assert h[0] + 2 * h[1:].sum() == pytest.approx(1.0, abs=1e-6)
        assert len(h) <= 20  # MAX_GAUSSIAN_KERNEL_SIZE
        assert len(h) == min(int(math.ceil(sigma * 4) + 1), 20)


def test_blur_matches_scipy():
    rng = np.random.default_rng(1)
    img = rng.random((64, 80)).astype(np.float32)
    sigma = 1.6
    taps = gaussian.half_kernel(sigma)
    ours = np.asarray(scale_space.blur_separable(img, taps))
    full = gaussian.full_kernel(sigma).astype(np.float64)
    # scipy "reflect" == np.pad "symmetric" == GLSL MIRRORED_REPEAT at edges.
    ref = scipy.ndimage.convolve1d(img.astype(np.float64), full, axis=1,
                                   mode="reflect")
    ref = scipy.ndimage.convolve1d(ref, full, axis=0, mode="reflect")
    np.testing.assert_allclose(ours, ref, atol=2e-6)


def test_upsample2x_matches_golden():
    rng = np.random.default_rng(2)
    img = rng.random((12, 17)).astype(np.float32)
    ours = np.asarray(scale_space.upsample2x_linear(img))
    ref = gold.upsample2x_np(img)
    assert ours.shape == (24, 34)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_downsample_nearest_odd_texels():
    img = np.arange(8 * 10, dtype=np.float32).reshape(8, 10)
    out = np.asarray(scale_space.downsample2x_nearest(img, 4, 5))
    np.testing.assert_array_equal(out, img[1::2, 1::2])


@pytest.mark.parametrize("upsampling", [False, True])
@pytest.mark.heavy
def test_pyramid_matches_golden(small_image, upsampling):
    c = SiftConfig(use_input_upsampling=upsampling)
    img = small_image.astype(np.float32) / 255.0
    h, w = img.shape
    oct_res = c.octave_resolutions(w, h)
    shapes = tuple((hh, ww) for (ww, hh) in oct_res)
    gaussians, dogs = scale_space.build_pyramid(img, c, shapes)
    g_ref, d_ref = gold.build_pyramid_np(img, c)
    assert len(gaussians) == len(g_ref)
    for o in range(len(gaussians)):
        assert gaussians[o].shape == g_ref[o].shape
        np.testing.assert_allclose(np.asarray(gaussians[o], np.float64),
                                   g_ref[o], atol=3e-5)
        np.testing.assert_allclose(np.asarray(dogs[o], np.float64),
                                   d_ref[o], atol=6e-5)


def test_pyramid_bf16_close_to_f32(small_image):
    c32 = SiftConfig(use_input_upsampling=False)
    c16 = SiftConfig(use_input_upsampling=False,
                     pyramid_precision=PyramidPrecision.FLOAT16)
    img = small_image.astype(np.float32) / 255.0
    h, w = img.shape
    shapes = tuple((hh, ww) for (ww, hh) in c32.octave_resolutions(w, h))
    g32, _ = scale_space.build_pyramid(img, c32, shapes)
    g16, _ = scale_space.build_pyramid(img, c16, shapes)
    for a, b in zip(g32, g16):
        assert str(b.dtype) == "float16"  # IEEE fp16 (reference parity)
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=2e-3)

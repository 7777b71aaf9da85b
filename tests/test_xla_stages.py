"""The stages the GPU runs, against the float64 golden reference.

Pyramid blur + DoG, the dense frontend (extrema + walk codes), the back half
(orientation + descriptor) inside the full detect program, and the bucketed
matcher the product calls. The CPU backend runs the same XLA programs the
GPU does, so these are the CPU-side half of ``chip_smoke.py``'s checks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vulkansift_tpu import SiftConfig
from vulkansift_tpu.golden import compare, reference as gold
from vulkansift_tpu.ops import extract, gaussian, scale_space
from vulkansift_tpu.ops.match import match_2nn, match_2nn_auto
from vulkansift_tpu.pipeline import make_detect_fn
from vulkansift_tpu.types import features_to_numpy

from conftest import make_blob_image


def _rand(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w)).astype(np.float32)


# ---------------------------------------------------------------------------
# Separable blur + DoG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(96, 256), (128, 384), (104, 512),
                                 (96, 1664), (96, 2048)])
@pytest.mark.parametrize("sigma", [1.226, 3.09])
def test_blur_and_dog_match_golden(h, w, sigma):
    x = _rand(h, w)
    taps = gaussian.half_kernel(sigma)
    y = scale_space.blur_separable(jnp.asarray(x), taps)
    ref = gold.blur_np(x, taps.astype(np.float64))
    np.testing.assert_allclose(np.asarray(y, np.float64), ref, rtol=0,
                               atol=2e-6)
    # The pyramid's DoG layer is the difference of consecutive blurs.
    np.testing.assert_allclose(np.asarray(y - x, np.float64), ref - x,
                               rtol=0, atol=2e-6)


def test_blur_border_band_matches_golden():
    # The outer k-band is where the mirror boundary acts: compare only it.
    h, w = 96, 256
    x = _rand(h, w, seed=3)
    taps = gaussian.half_kernel(3.09)  # k = 13
    k = len(taps) - 1
    y = np.asarray(scale_space.blur_separable(jnp.asarray(x), taps),
                   np.float64)
    ref = gold.blur_np(x, taps.astype(np.float64))
    band = np.zeros((h, w), bool)
    band[:k + 1], band[-k - 1:], band[:, :k + 1], band[:, -k - 1:] = (
        True, True, True, True)
    assert band.sum() < band.size
    np.testing.assert_allclose(y[band], ref[band], rtol=0, atol=2e-6)


def test_pyramid_seed_blur_without_dog():
    # Octave 0's base layer is a blur with no DoG partner: it must equal
    # the golden seed blur of the input.
    img = _rand(64, 96, seed=5)
    cfg = SiftConfig(use_input_upsampling=False)
    shapes = tuple((hh, ww) for (ww, hh) in cfg.octave_resolutions(96, 64))
    g, d = scale_space.build_pyramid(jnp.asarray(img), cfg, shapes)
    k0 = gaussian.half_kernel(gaussian.kernel_sigmas(cfg)[0])
    np.testing.assert_allclose(np.asarray(g[0][0], np.float64),
                               gold.blur_np(img, k0.astype(np.float64)),
                               rtol=0, atol=2e-6)
    assert len(d[0]) == len(g[0]) - 1


# ---------------------------------------------------------------------------
# Dense frontend: extrema + walk codes
# ---------------------------------------------------------------------------

def _rand_dog(shape, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 64, 128), (5, 48, 200)])
def test_dense_frontend_matches_golden(shape):
    dog = _rand_dog(shape)
    thr = 0.04 / 3
    cand, code = extract.dense_frontend(jnp.asarray(dog), thr, 4096)
    n = int(cand.count)
    got = list(zip(np.asarray(cand.s)[:n].tolist(),
                   np.asarray(cand.y)[:n].tolist(),
                   np.asarray(cand.x)[:n].tolist()))
    ref = gold.extrema_np(dog.astype(np.float64), thr)
    assert n > 0 and got == ref  # same set, same raster order
    # The Newton-step walk code agrees with the division-free (Cramer)
    # classifier on every interior cell.
    np.testing.assert_array_equal(
        np.asarray(code), np.asarray(extract._dense_walk_code(dog)))


def test_dense_frontend_capacity_clamp():
    dog = jnp.asarray(_rand_dog((5, 64, 128), seed=1))
    thr = 0.001  # very low threshold -> many candidates
    full, _ = extract.dense_frontend(dog, thr, 4096)
    n = int(full.count)
    assert n > 64
    cap = n // 2
    c, _ = extract.dense_frontend(dog, thr, cap)
    assert int(c.count) == cap
    for f in ("s", "y", "x"):  # raster-order prefix
        np.testing.assert_array_equal(np.asarray(getattr(c, f))[:cap],
                                      np.asarray(getattr(full, f))[:cap])


# ---------------------------------------------------------------------------
# Back half (orientation + descriptor) inside the detect program
# ---------------------------------------------------------------------------

def _detect(cfg, img):
    h, w = img.shape
    out = jax.jit(make_detect_fn(cfg, w, h))(jnp.asarray(img))
    n = int(out.features.count)
    return out, features_to_numpy(out.features, n)


def _edge_blob_image(h, w, seed):
    """Blob clusters hugging both vertical edges (incl. within one window
    radius of x=0 and x=w-1)."""
    rng = np.random.default_rng(seed)
    ys_, xs_ = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.08 * rng.standard_normal((h, w))
    for _ in range(30):
        cy = rng.uniform(8, h - 8)
        cx = rng.choice([rng.uniform(2, 40), rng.uniform(w - 40, w - 2)])
        s = rng.uniform(1.5, 4.0)
        img += rng.uniform(0.4, 1.0) * np.exp(
            -((ys_ - cy) ** 2 + (xs_ - cx) ** 2) / (2 * s * s))
    img -= img.min()
    return (255.0 * img / img.max()).astype(np.uint8)


@pytest.mark.heavy
@pytest.mark.parametrize("scenario", ["small_octave", "border_clamp"])
def test_backhalf_matches_golden(scenario):
    if scenario == "small_octave":
        # One octave shorter than the descriptor window: every patch
        # reaches past the image.
        img = make_blob_image(56, 80, seed=9, nb_blobs=25)
    else:
        img = _edge_blob_image(96, 640, seed=11)
    h, w = img.shape
    cfg = SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=512,
                     input_image_max_size=w * h)
    _, feats = _detect(cfg, img)
    ref = gold.detect_np(img, cfg)
    golden = np.zeros(len(ref), feats.dtype)
    for name in feats.dtype.names:
        golden[name] = [r[name] for r in ref]
    if scenario == "border_clamp":
        xs = feats["x"]
        assert (xs < 48).any() and (xs > w - 48).any()
    # Top-scale keypoints sample the next octave at half resolution
    # (ops/patches.build_patchset), which the golden detector does not.
    summary, failures = compare.compare_features(
        scenario, golden, feats,
        desc_mask=golden["scale_idx"] < cfg.nb_scales_per_octave)
    assert not failures, summary


@pytest.mark.heavy
def test_backhalf_capacity_clamp_and_lost():
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    big = SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=512,
                     input_image_max_size=128 * 96)
    _, full = _detect(big, img)
    n = len(full)
    assert n > 8
    cap = max(n // 2, 1)
    small = SiftConfig(use_input_upsampling=False,
                       max_nb_sift_per_buffer=cap,
                       input_image_max_size=128 * 96)
    out, clamped = _detect(small, img)
    assert 0 < len(clamped) <= cap
    # Features beyond capacity are counted lost (pair-stage clamp) or
    # dropped at the per-octave candidate sections; what is kept is a
    # subset of the uncapped run, bit for bit.
    assert int(out.lost) > 0 or len(clamped) < n
    pair = compare.pair_features(clamped, full, use_angle=True)
    assert (pair >= 0).all()
    np.testing.assert_array_equal(clamped["descriptor"],
                                  full["descriptor"][pair])


# ---------------------------------------------------------------------------
# The product's matcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("na,nb,ca,cb", [
    (4096, 4096, 4096, 4096),   # full: several A buckets, several B tiles
    (64, 64, 4, 1),             # tiny counts: one B column, +inf seconds
    (2500, 3001, 2300, 2999),   # not tile multiples, live counts < rows
])
def test_match_2nn_auto_bit_identical(na, nb, ca, cb):
    rng = np.random.default_rng(na + nb)
    a = rng.integers(0, 256, (na, 128), dtype=np.uint8)
    b = rng.integers(0, 256, (nb, 128), dtype=np.uint8)
    b[nb - 2] = b[nb // 3]
    b[min(cb, nb) - 1] = a[0]
    args = (jnp.asarray(a), jnp.int32(ca), jnp.asarray(b), jnp.int32(cb))
    auto, ref = match_2nn_auto(*args), match_2nn(*args)
    for f in ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2"):
        np.testing.assert_array_equal(np.asarray(getattr(auto, f))[:ca],
                                      np.asarray(getattr(ref, f))[:ca])
    if cb == 1:
        assert np.isinf(np.asarray(auto.dist_a_b2)[:ca]).all()


def test_exact_sqrt_correctly_rounded_for_all_distances():
    # Every squared u8-descriptor distance is an integer below 2^24: the
    # matcher's root must equal the correctly rounded float32 sqrt for all
    # of them, whatever the device's own sqrt does.
    from vulkansift_tpu.ops.match import exact_sqrt
    d = np.arange(1 << 24, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(exact_sqrt)(d)),
                                  np.sqrt(d))
    assert np.isinf(np.asarray(exact_sqrt(jnp.asarray([np.inf])))).all()


@pytest.mark.parametrize("nb", [300, 1])
def test_golden_dense_2nn_matches_serial_scan(nb):
    rng = np.random.default_rng(nb)
    a = rng.integers(0, 256, (40, 128), dtype=np.uint8)
    b = rng.integers(0, 256, (nb, 128), dtype=np.uint8)
    if nb > 2:  # exact ties: duplicated rows and copies of A rows
        b[250] = b[17]
        b[90] = b[200] = a[3]
    dense = gold.match_2nn_dense_np(a, b, chunk=16)
    scan = gold.match_2nn_np(a, b)
    np.testing.assert_array_equal(dense[:, :2], scan[:, :2])
    np.testing.assert_array_equal(np.sqrt(dense[:, 2:]), scan[:, 2:])


# ---------------------------------------------------------------------------
# Contraction precision (a float32 matmul may otherwise run in TF32)
# ---------------------------------------------------------------------------

def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for j in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(j, "jaxpr") and hasattr(j.jaxpr, "eqns"):
                    out.extend(_dot_precisions(j.jaxpr))
                elif hasattr(j, "eqns"):
                    out.extend(_dot_precisions(j))
    return out


def _descriptor_jaxpr():
    from vulkansift_tpu.ops.descriptor import compute_descriptors
    from vulkansift_tpu.ops.patches import PatchSet
    k, p = 4, 31
    ps = PatchSet(patches=jnp.zeros((k, p, p)), cx=jnp.zeros(k, jnp.int32),
                  cy=jnp.zeros(k, jnp.int32), scale_x=jnp.zeros(k),
                  scale_y=jnp.zeros(k), sigma_oct=jnp.ones(k),
                  width=jnp.full(k, 64, jnp.int32),
                  height=jnp.full(k, 64, jnp.int32))
    return jax.make_jaxpr(lambda ps, o: compute_descriptors(
        ps, o, desc_radius=13, use_vlfeat=False))(ps, jnp.zeros(k))


def _bundle_adjust_jaxpr():
    from vulkansift_tpu.sfm import BAProblem, Camera, bundle_adjust
    n, c, p = 8, 2, 4
    cam = Camera(fx=jnp.float32(1), fy=jnp.float32(1), cx=jnp.float32(0),
                 cy=jnp.float32(0))
    prob = BAProblem(poses=jnp.zeros((c, 6)), points=jnp.ones((p, 3)),
                     cam_idx=jnp.zeros(n, jnp.int32),
                     pt_idx=jnp.zeros(n, jnp.int32), uv=jnp.zeros((n, 2)),
                     valid=jnp.ones(n, bool), camera=cam)
    return jax.make_jaxpr(lambda q: bundle_adjust(
        q, nb_iters=1, nb_cg_iters=1))(prob)


def _pose_graph_jaxpr():
    from vulkansift_tpu.sfm import PoseGraph, optimize_pose_graph
    g = PoseGraph(poses=jnp.zeros((3, 6)), edge_i=jnp.asarray([0, 1]),
                  edge_j=jnp.asarray([1, 2]), meas=jnp.zeros((2, 6)),
                  weight=jnp.ones(2))
    return jax.make_jaxpr(lambda q: optimize_pose_graph(q, nb_iters=1))(g)


@pytest.mark.parametrize("build", [_descriptor_jaxpr, _bundle_adjust_jaxpr,
                                   _pose_graph_jaxpr],
                         ids=["descriptor", "bundle_adjust", "pose_graph"])
def test_contractions_ask_for_highest_precision(build):
    precisions = _dot_precisions(build().jaxpr)
    assert precisions, "no contraction found"
    highest = jax.lax.Precision.HIGHEST
    for prec in precisions:
        assert prec is not None and all(q == highest for q in prec), prec


def test_descriptor_precision_read_at_trace_time(monkeypatch):
    # scripts/desc_precision_ab.py swaps the constant and drops traced
    # programs to compile a TF32 arm; the swap must reach the contraction.
    from vulkansift_tpu.ops import descriptor
    default = jax.lax.Precision.DEFAULT
    monkeypatch.setattr(descriptor, "DESC_PRECISION", default)
    jax.clear_caches()
    try:
        precisions = _dot_precisions(_descriptor_jaxpr().jaxpr)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    assert precisions and all(q == default for p in precisions for q in p)
    assert all(q == jax.lax.Precision.HIGHEST for p in _dot_precisions(
        _descriptor_jaxpr().jaxpr) for q in p)

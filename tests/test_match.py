"""Golden tests for the matmul-tiled 2-NN matcher
(reference semantics: shaders/Get2NearestNeighbors.comp)."""

import numpy as np
import jax.numpy as jnp

from vulkansift_tpu.golden import reference as gold
from vulkansift_tpu.ops.match import cross_check_mask, lowe_ratio_mask, match_2nn


def _rand_desc(rng, n):
    return rng.integers(0, 256, (n, 128), dtype=np.uint8)


def test_match_exact_vs_golden():
    rng = np.random.default_rng(7)
    a = _rand_desc(rng, 100)
    b = _rand_desc(rng, 333)
    m = match_2nn(jnp.asarray(a), jnp.asarray(100),
                  jnp.asarray(b), jnp.asarray(333), tile=128)
    ref = gold.match_2nn_np(a, b)
    np.testing.assert_array_equal(np.asarray(m.idx_b1), ref[:, 0])
    np.testing.assert_array_equal(np.asarray(m.idx_b2), ref[:, 1])
    # Distance arithmetic is exact integer math in f32.
    np.testing.assert_allclose(np.asarray(m.dist_a_b1), ref[:, 2], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(m.dist_a_b2), ref[:, 3], rtol=1e-6)


def test_match_tie_breaking_earliest_index():
    # Duplicate descriptors across tiles: earliest index must win (strict <
    # updates, Get2NearestNeighbors.comp:85-95).
    rng = np.random.default_rng(8)
    a = _rand_desc(rng, 8)
    b = np.zeros((300, 128), np.uint8)
    b[:] = rng.integers(0, 256, (1, 128), dtype=np.uint8)  # all identical
    m = match_2nn(jnp.asarray(a), jnp.asarray(8),
                  jnp.asarray(b), jnp.asarray(300), tile=64)
    np.testing.assert_array_equal(np.asarray(m.idx_b1), 0)
    np.testing.assert_array_equal(np.asarray(m.idx_b2), 1)
    # Exact duplicate of A at two positions: d1 == 0 at earliest.
    b2 = _rand_desc(rng, 200)
    b2[70] = a[0]
    b2[130] = a[0]
    m2 = match_2nn(jnp.asarray(a), jnp.asarray(8),
                   jnp.asarray(b2), jnp.asarray(200), tile=64)
    assert int(m2.idx_b1[0]) == 70
    assert int(m2.idx_b2[0]) == 130
    assert float(m2.dist_a_b1[0]) == 0.0


def test_match_count_masking():
    rng = np.random.default_rng(9)
    a = _rand_desc(rng, 16)
    b = _rand_desc(rng, 128)
    # Only first 50 B rows valid: winners must be < 50.
    m = match_2nn(jnp.asarray(a), jnp.asarray(16),
                  jnp.asarray(b), jnp.asarray(50), tile=32)
    assert (np.asarray(m.idx_b1) < 50).all()
    assert (np.asarray(m.idx_b2) < 50).all()
    ref = gold.match_2nn_np(a, b[:50])
    np.testing.assert_array_equal(np.asarray(m.idx_b1), ref[:, 0])


def test_match_non_multiple_tile():
    rng = np.random.default_rng(10)
    a = _rand_desc(rng, 33)
    b = _rand_desc(rng, 97)  # prime, forces padding
    m = match_2nn(jnp.asarray(a), jnp.asarray(33),
                  jnp.asarray(b), jnp.asarray(97), tile=64)
    ref = gold.match_2nn_np(a, b)
    np.testing.assert_array_equal(np.asarray(m.idx_b1), ref[:, 0])
    np.testing.assert_array_equal(np.asarray(m.idx_b2), ref[:, 1])


def test_lowe_ratio_and_cross_check():
    rng = np.random.default_rng(11)
    base = _rand_desc(rng, 60)
    noise = rng.integers(-4, 5, base.shape)
    b = np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8)
    perm = rng.permutation(60)
    m_ab = match_2nn(jnp.asarray(base), jnp.asarray(60),
                     jnp.asarray(b[perm]), jnp.asarray(60))
    ratio = np.asarray(lowe_ratio_mask(m_ab, 0.75))
    # Small perturbations of random u8 descriptors: nearest must be the
    # perturbed copy, and the ratio test must keep nearly all.
    inv = np.argsort(perm)
    np.testing.assert_array_equal(np.asarray(m_ab.idx_b1), inv)
    assert ratio.mean() > 0.95
    m_ba = match_2nn(jnp.asarray(b[perm]), jnp.asarray(60),
                     jnp.asarray(base), jnp.asarray(60))
    cc = np.asarray(cross_check_mask(m_ab, m_ba))
    assert cc.all()

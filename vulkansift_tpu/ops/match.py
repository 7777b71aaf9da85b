"""Brute-force 2-nearest-neighbor descriptor matching (matmul-tiled).

Replaces the reference's Get2NearestNeighbors shader (reference:
src/vulkansift/shaders/Get2NearestNeighbors.comp) — one thread per A-feature
serially scanning ALL of B (an O(N_A * N_B * 128) scalar loop) — with a
matrix-product formulation: the u8 descriptor L2 distances are

    d2(a, b) = |a|^2 + |b|^2 - 2 a.b

so each B-tile step is one (N_A x 128) @ (128 x T) bf16 matmul (tensor
cores, float32 accumulation) plus a vectorized top-2 merge, streamed over
B tiles so the N_A x N_B distance matrix is never materialized.

Exactness: descriptors are integers in [0, 255]; products <= 255^2 and
row sums <= 128*255^2 = 8,323,200 < 2^24, so bfloat16 inputs (exact for
integers < 256) with float32 accumulation reproduce the reference's integer
distance arithmetic bit-exactly; the output is the correctly rounded float32
sqrt(d2) (:func:`exact_sqrt`), matching Get2NearestNeighbors.comp:43-53.

Tie-breaking parity: the reference keeps the earliest B index on equal
distances (strict ``<`` updates, Get2NearestNeighbors.comp:85-95); the tile
argmin picks the first occurrence and merges preserve earlier tiles, so
indices agree.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..types import Matches2NN

# Plain Python float, NOT jnp.float32(...): a module-level device
# constant would initialize the JAX backend at import time, which
# breaks jax.distributed.initialize (must run before backend init).
_INF = float("inf")


# Packed-key top-2: squared u8-descriptor distances are exact integers
# <= 128*255^2 = 8,323,200 < 2^23, so with a 512-column subtile the pair
# (distance, column) packs into ONE uint32 key
#
#     key = d2 << 9 | col        (max 4,261,478,911 < 2^32 - 1)
#
# and ``min(key)`` IS the reference's serial scan semantics — smallest
# distance, earliest column on ties (strict ``<`` updates,
# Get2NearestNeighbors.comp:85-95). This replaces the two variadic
# argmin reductions + two per-row ``take_along_axis`` gathers of the
# original formulation (each argmin is a compare+select pair on two
# streams, and the row gathers are latency-bound) with two plain
# min-reductions and one select — about 4x fewer elementwise ops per
# tile element, and no gather remains.
_TILE_BITS = 9
_SUBTILE = 1 << _TILE_BITS           # 512
_KEY_INVALID = (1 << 32) - 1         # all-ones: > any valid key


def exact_sqrt(d2: jax.Array) -> jax.Array:
    """Correctly rounded float32 sqrt of exact integer squared distances.

    A device's own sqrt may be approximate: on the H100 it is one ulp off
    for ~17% of the integers below 2^24, so distances would differ
    between devices and from the reference. Squared u8-descriptor
    distances are integers < 2^24, so the root is taken digit by digit in
    int32 (restoring square root of ``d * 4^s``, scaled to 48 bits, plus
    one guard bit) and rounded to nearest even. +inf passes through.
    """
    finite = jnp.isfinite(d2)
    d = jnp.where(finite, d2, 0.0).astype(jnp.int32)
    msb = 31 - jax.lax.clz(jnp.maximum(d, 1))
    s = (47 - msb) // 2                  # d * 4^s lies in [2^46, 2^48)
    q = jnp.zeros_like(d)
    r = jnp.zeros_like(d)                # r <= 2q < 2^26: no overflow
    for i in range(25):                  # 24 result bits + 1 guard bit
        pos = 46 - 2 * i - 2 * s         # this bit pair's place in d
        pair = jnp.where(pos >= 0, (d >> jnp.maximum(pos, 0)) & 3, 0)
        r = (r << 2) | pair
        trial = (q << 2) | 1
        take = r >= trial
        r = jnp.where(take, r - trial, r)
        q = (q << 1) | take.astype(jnp.int32)
    round_up = (q & 1) & ((r != 0) | ((q >> 1) & 1)).astype(jnp.int32)
    mant = (q >> 1) + round_up           # <= 2^24: exact in float32
    two_pow_minus_s = jax.lax.bitcast_convert_type((127 - s) << 23,
                                                   jnp.float32)
    return jnp.where(finite, mant.astype(jnp.float32) * two_pow_minus_s, d2)


def _top2_of_tile(d2: jax.Array, col_offset: jax.Array, col_valid: jax.Array
                  ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-row (best, best_idx, second, second_idx) of a (N, T) tile.

    ``T`` must be a multiple of 512; ``col_valid`` is the (N-broadcastable)
    (1, T) bool mask of live B columns. Invalid columns get the all-ones
    key so they can never win.
    """
    n, t = d2.shape
    col_valid = jnp.broadcast_to(col_valid, (1, t))
    if t % _SUBTILE and t > _SUBTILE:
        # Arbitrary widths (e.g. ring-match shards): pad to a subtile
        # multiple with invalid columns (the pad fuses into the key mask).
        padt = (-t) % _SUBTILE
        d2 = jnp.pad(d2, ((0, 0), (0, padt)))
        col_valid = jnp.pad(col_valid, ((0, 0), (0, padt)))
        t += padt
    sub = _SUBTILE if t % _SUBTILE == 0 else t  # small test tiles: 1 group
    g = t // sub
    d2r = d2.reshape(n, g, sub)
    vr = col_valid.reshape(1, g, sub)
    cols = jax.lax.broadcasted_iota(jnp.uint32, (n, g, sub), 2)
    key = (d2r.astype(jnp.uint32) << _TILE_BITS) | cols
    key = jnp.where(vr, key, jnp.uint32(_KEY_INVALID))
    k1 = jnp.min(key, axis=2)                                   # (N, g)
    key2 = jnp.where(key == k1[:, :, None], jnp.uint32(_KEY_INVALID), key)
    k2 = jnp.min(key2, axis=2)                                  # (N, g)

    def decode(k, j):
        invalid = k == jnp.uint32(_KEY_INVALID)
        d = jnp.where(invalid, _INF,
                      (k >> _TILE_BITS).astype(jnp.float32))
        i = jnp.where(invalid, 0,
                      (k & (_SUBTILE - 1)).astype(jnp.int32)
                      + (col_offset + j * sub))
        return d, i

    # Tree-merge the g per-subtile sorted pairs (tiny: ops on (N,) slices).
    parts = []
    for j in range(g):
        d1, i1 = decode(k1[:, j], j)
        d2nd, i2 = decode(k2[:, j], j)
        parts.append((d1, i1, d2nd, i2))
    while len(parts) > 1:
        nxt = [_merge_top2(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _lex_lt(da, ia, db, ib):
    """(distance, index) lexicographic less-than."""
    return (da < db) | ((da == db) & (ia < ib))


def _merge_top2(r, t):
    """Merge two per-row top-2 streams with (distance, index) lexicographic
    ordering. Smallest-index-wins tie-breaking matches the reference's
    earliest-index serial scan (strict ``<`` updates,
    Get2NearestNeighbors.comp:85-95) and — unlike order-dependent
    tie-breaking — is associative/commutative, so the same merge serves the
    sequential tile scan and the multi-chip ``ppermute`` ring
    (:mod:`vulkansift_tpu.parallel.ring_match`), where B shards arrive out
    of global column order.

    Within each stream (d1, i1) <= (d2, i2) lexicographically (tile top-2
    picks the earliest index first), so this is a merge of two sorted pairs:
    best = min(r1, t1); second = min(loser-of-best-contest, winner's own
    second) — the loser stream's second can never place.
    """
    rd1, ri1, rd2, ri2 = r
    td1, ti1, td2, ti2 = t
    take_t1 = _lex_lt(td1, ti1, rd1, ri1)
    nd1 = jnp.where(take_t1, td1, rd1)
    ni1 = jnp.where(take_t1, ti1, ri1)
    loser_d = jnp.where(take_t1, rd1, td1)
    loser_i = jnp.where(take_t1, ri1, ti1)
    win2_d = jnp.where(take_t1, td2, rd2)
    win2_i = jnp.where(take_t1, ti2, ri2)
    take_loser = _lex_lt(loser_d, loser_i, win2_d, win2_i)
    nd2 = jnp.where(take_loser, loser_d, win2_d)
    ni2 = jnp.where(take_loser, loser_i, win2_i)
    return nd1, ni1, nd2, ni2


@functools.partial(jax.jit, static_argnames=("tile",))
def match_2nn(desc_a: jax.Array, count_a: jax.Array, desc_b: jax.Array,
              count_b: jax.Array, *, tile: int = 2048) -> Matches2NN:
    """2-NN of every valid A descriptor among valid B descriptors.

    Args:
      desc_a: u8 (NA, 128), valid rows first (packed).
      count_a: i32 number of valid A rows.
      desc_b: u8 (NB, 128), packed likewise.
      count_b: i32 number of valid B rows.
      tile: static B-tile width for the scan.

    Returns a Matches2NN with capacity NA and ``count = count_a``; rows at
    index >= count_a are meaningless. Invalid B columns are masked to +inf
    so they can never win (the reference assumes count_b >= 2,
    sift_matcher.c:408-486; with fewer the extra slots stay at +inf).
    """
    na, d = desc_a.shape
    nb = desc_b.shape[0]
    pad_b = (-nb) % tile
    if pad_b:
        desc_b = jnp.concatenate(
            [desc_b, jnp.zeros((pad_b, d), desc_b.dtype)], axis=0)
    nb_padded = nb + pad_b
    steps = nb_padded // tile

    a16 = desc_a.astype(jnp.bfloat16)
    b16 = desc_b.astype(jnp.bfloat16)
    a_sq = jnp.sum(jnp.square(desc_a.astype(jnp.float32)), axis=1)  # (NA,)
    b_sq = jnp.sum(jnp.square(desc_b.astype(jnp.float32)), axis=1)  # (NBp,)

    b_tiles = b16.reshape(steps, tile, d)
    bsq_tiles = b_sq.reshape(steps, tile)

    def step(carry, inp):
        b_t, bsq_t, offset = inp
        dots = jax.lax.dot_general(
            a16, b_t.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)  # (NA, T)
        d2 = a_sq[:, None] + bsq_t[None, :] - 2.0 * dots
        col = offset + jnp.arange(tile)[None, :]
        t = _top2_of_tile(d2, offset, col < count_b)
        return _merge_top2(carry, t), None

    init = (jnp.full((na,), _INF), jnp.zeros((na,), jnp.int32),
            jnp.full((na,), _INF), jnp.zeros((na,), jnp.int32))
    offsets = jnp.arange(steps, dtype=jnp.int32) * tile
    (d1, i1, d2_, i2), _ = jax.lax.scan(
        step, init, (b_tiles, bsq_tiles, offsets))

    d1, d2_ = exact_sqrt(d1), exact_sqrt(d2_)
    return Matches2NN(
        idx_a=jnp.arange(na, dtype=jnp.int32),
        idx_b1=i1, idx_b2=i2,
        dist_a_b1=d1, dist_a_b2=d2_,
        count=count_a.astype(jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("tile", "min_bucket"))
def match_2nn_auto(desc_a: jax.Array, count_a: jax.Array,
                   desc_b: jax.Array, count_b: jax.Array, *,
                   tile: int = 2048,
                   min_bucket: int = 2048) -> Matches2NN:
    """2-NN matching whose device work scales with the LIVE counts.

    ``match_2nn`` computes over the full static capacities, so callers had
    to host-sync the counts and slice before dispatch. This variant keeps
    everything on device — the analogue of the reference reading counters from *mapped*
    memory at ~zero cost before recording the dispatch
    (sift_matcher.c:408-414, dispatch ceil(nb_A/64) workgroups):

    * A rows: a ``lax.switch`` over power-of-two size buckets — every
      bucket's matmul is compiled once, the branch matching ``count_a``
      executes, so compute scales with the bucketed live count.
    * B columns: a ``lax.while_loop`` over tiles with a data-dependent
      trip count ``ceil(count_b / tile)``.

    Results are bit-identical to ``match_2nn`` for rows < count_a (same
    tile order, same associative lexicographic merge).
    """
    na, d = desc_a.shape
    nb = desc_b.shape[0]
    with jax.named_scope("Matching"):
        pad_b = (-nb) % tile
        if pad_b:
            desc_b = jnp.concatenate(
                [desc_b, jnp.zeros((pad_b, d), desc_b.dtype)], axis=0)
        b16 = desc_b.astype(jnp.bfloat16)
        b_sq = jnp.sum(jnp.square(desc_b.astype(jnp.float32)), axis=1)
        a16_full = desc_a.astype(jnp.bfloat16)
        asq_full = jnp.sum(jnp.square(desc_a.astype(jnp.float32)), axis=1)
        nsteps_live = jax.lax.div(count_b + (tile - 1), tile)

        def match_k(k: int):
            def run():
                a16 = jax.lax.dynamic_slice(a16_full, (0, 0), (k, d))
                a_sq = jax.lax.dynamic_slice(asq_full, (0,), (k,))

                def cond(state):
                    return state[0] < nsteps_live

                def body(state):
                    step, carry = state
                    offset = step * tile
                    b_t = jax.lax.dynamic_slice(
                        b16, (offset, 0), (tile, d))
                    bsq_t = jax.lax.dynamic_slice(b_sq, (offset,), (tile,))
                    dots = jax.lax.dot_general(
                        a16, b_t.T, (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)
                    d2 = a_sq[:, None] + bsq_t[None, :] - 2.0 * dots
                    col = offset + jnp.arange(tile)[None, :]
                    t = _top2_of_tile(d2, offset, col < count_b)
                    return step + 1, _merge_top2(carry, t)

                init = (jnp.full((k,), _INF), jnp.zeros((k,), jnp.int32),
                        jnp.full((k,), _INF), jnp.zeros((k,), jnp.int32))
                _, (d1, i1, d2_, i2) = jax.lax.while_loop(
                    cond, body, (jnp.int32(0), init))
                pad = na - k
                return tuple(jnp.pad(x, (0, pad)) for x in (d1, i1, d2_, i2))
            return run

        ks = []
        k = min(min_bucket, na)
        while k < na:
            ks.append(k)
            k *= 2
        ks.append(na)
        # Branch index: smallest bucket >= count_a.
        idx = jnp.sum(jnp.asarray(
            [count_a > kk for kk in ks[:-1]], jnp.int32)) \
            if len(ks) > 1 else jnp.int32(0)
        d1, i1, d2_, i2 = jax.lax.switch(idx, [match_k(kk) for kk in ks])

        d1, d2_ = exact_sqrt(d1), exact_sqrt(d2_)
        return Matches2NN(
            idx_a=jnp.arange(na, dtype=jnp.int32),
            idx_b1=i1, idx_b2=i2,
            dist_a_b1=d1, dist_a_b2=d2_,
            count=count_a.astype(jnp.int32),
        )


def lowe_ratio_mask(m: Matches2NN, ratio: float = 0.75) -> jax.Array:
    """Lowe ratio-test mask (harness parity: src/perf/perf_matching.cpp:5,
    test_sift_match.cpp:90-107): keep matches with d1 < ratio * d2."""
    valid = jnp.arange(m.idx_a.shape[0]) < m.count
    return valid & (m.dist_a_b1 < ratio * m.dist_a_b2)


def cross_check_mask(m_ab: Matches2NN, m_ba: Matches2NN) -> jax.Array:
    """Mutual-nearest-neighbor mask: A->B best maps back B->A best."""
    back = m_ba.idx_b1[m_ab.idx_b1]
    valid = jnp.arange(m_ab.idx_a.shape[0]) < m_ab.count
    return valid & (back == m_ab.idx_a)

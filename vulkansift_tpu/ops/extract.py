"""DoG extrema detection and subpixel refinement (pure XLA, dense-first).

Replaces the reference's ExtractKeypoints compute shader
(reference: src/vulkansift/shaders/ExtractKeypoints.comp) with a design
built around dense vectorized passes instead of per-thread scalar work:

1. :func:`extremum_candidates` — dense 3x3x3 strict-extremum test with the
   |v| > 0.8*dog_threshold pre-filter (ExtractKeypoints.comp:57-116),
   compacted to a static per-octave capacity with a cumsum + searchsorted
   rank-select (raster order, deterministic) — the XLA-idiomatic replacement
   for the shader's atomicAdd append (ExtractKeypoints.comp:208-224).
2. :func:`refine_candidates` — the 5-step iterative subpixel refinement via
   3x3 Hessian solve (ExtractKeypoints.comp:133-188). Dense/sparse split:
   the per-cell Newton step (gradient, Hessian solve, 0.6-convergence and
   move decision) is computed DENSELY for every interior DoG cell and packed
   into a one-byte walk code; each candidate then just *walks* the code
   field for 5 steps (tiny gathers instead of per-candidate 3x3x3
   dynamic-slice chains). The final offsets/DoG-value/edge tests
   (ExtractKeypoints.comp:194-206) are recomputed exactly once at each
   candidate's final cell from a 27-point gather. Semantics are identical
   to the reference's loop (VLFeat-style no-move-on-last-iteration, clamped
   integer moves, singular-Hessian rejection).

The candidate capacity policy is the reference's geometric-halves section
sizing (SiftConfig.octave_section_capacities; reference sift_memory.c:40-87).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import NB_REFINEMENT_STEPS, SiftConfig


class Candidates(NamedTuple):
    """Compacted extremum candidates for one octave (static capacity)."""

    s: jax.Array  # i32[K] scale index of the DoG center layer (1..nb_scales)
    y: jax.Array  # i32[K]
    x: jax.Array  # i32[K]
    count: jax.Array  # i32[]


class RefinedKeypoints(NamedTuple):
    """Refinement output; ``valid`` marks survivors of all final tests."""

    valid: jax.Array      # bool[K]
    scale_x: jax.Array    # f32[K] subpixel x in octave coords
    scale_y: jax.Array    # f32[K]
    subpix_s: jax.Array   # f32[K] subpixel scale
    scale_idx: jax.Array  # i32[K] round(subpix_s)
    sigma: jax.Array      # f32[K] absolute blur level (includes 2^octave)
    intensity: jax.Array  # f32[K] refined DoG value
    x: jax.Array          # f32[K] input-image x (= scale_x * 2^octave)
    y: jax.Array          # f32[K]


# Switch point between the two rank_select formulations. Tuned on the
# accelerator the system was first built for; not yet measured on the
# H100 (ROADMAP S3).
_RANK_SCATTER_MAX_N = 1 << 18


def bucket_sizes(total: int, lo: int = 2048):
    """Power-of-two live-count buckets [lo, 2*lo, ..., total] for
    lax.switch-based capacity scaling."""
    sizes = []
    b = lo
    while b < total:
        sizes.append(b)
        b *= 2
    sizes.append(total)
    return sizes


def rank_select(mask_flat: jax.Array, capacity: int) -> Tuple[jax.Array, jax.Array]:
    """Indices of the first ``capacity`` true elements, in order.

    Two formulations, picked by mask size (``_RANK_SCATTER_MAX_N``); both
    avoid jnp.nonzero(size=), which lowers to a sort-like pattern:

    * small masks: cumsum + 1-D rank scatter with out-of-range drop (the
      binary search of the other arm issues capacity*log(n) random
      gathers).
    * large masks: cumsum + searchsorted (scatter cost scales with n).

    Returns (indices i32[capacity], true_count i32[] clamped to capacity).
    Slots beyond the true count are zero-filled.
    """
    n = mask_flat.shape[0]
    mask = mask_flat.astype(jnp.int32)
    cs = jnp.cumsum(mask)
    count = jnp.minimum(cs[-1], capacity)
    if n <= _RANK_SCATTER_MAX_N:
        rank = jnp.where(mask_flat, cs - 1, capacity)  # invalid -> dropped
        idx = jnp.zeros((capacity,), jnp.int32).at[rank].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop")
        return idx, count
    ranks = jnp.arange(1, capacity + 1, dtype=jnp.int32)
    idx = jnp.searchsorted(cs, ranks, side="left")
    idx = jnp.clip(idx, 0, n - 1).astype(jnp.int32)
    idx = jnp.where(ranks <= count, idx, 0)
    return idx, count


def dense_frontend(dog: jax.Array, dog_threshold: float,
                   capacity: int) -> Tuple[Candidates, jax.Array]:
    """Fused dense front half: extremum candidates AND the refinement
    walk-code field from ONE set of 3x3x3 neighbor slices (the extremum
    test and the Newton solve read identical neighborhoods; computing them
    together lets XLA fuse the dense passes)."""
    d = dog.astype(jnp.float32)
    ns, h, w = d.shape

    nb = {(a, b, c): jax.lax.dynamic_slice(
        d, (a, b, c), (ns - 2, h - 2, w - 2))
        for a in (0, 1, 2) for b in (0, 1, 2) for c in (0, 1, 2)}
    ctr = nb[(1, 1, 1)]
    nb_max = None
    nb_min = None
    for key, v in nb.items():
        if key == (1, 1, 1):
            continue
        nb_max = v if nb_max is None else jnp.maximum(nb_max, v)
        nb_min = v if nb_min is None else jnp.minimum(nb_min, v)
    mask = (jnp.abs(ctr) > (dog_threshold * 0.8)) & (
        (ctr > nb_max) | (ctr < nb_min))

    idx, count = rank_select(mask.reshape(-1), capacity)
    hw = (h - 2) * (w - 2)
    s = idx // hw + 1
    rem = idx % hw
    y = rem // (w - 2) + 1
    x = rem % (w - 2) + 1
    cand = Candidates(s=s.astype(jnp.int32), y=y.astype(jnp.int32),
                      x=x.astype(jnp.int32), count=count)

    off_s, off_x, off_y, _, _, _, singular = _newton_step(
        *[nb[(a, b, c)] for a in (0, 1, 2) for b in (0, 1, 2)
          for c in (0, 1, 2)])
    conv = ((jnp.abs(off_x) < 0.6) & (jnp.abs(off_y) < 0.6)
            & (jnp.abs(off_s) < 0.6))

    def sign_code(off):
        return jnp.where(off >= 0.6, 2, jnp.where(off <= -0.6, 0, 1))

    code = (sign_code(off_s) + 3 * sign_code(off_x) + 9 * sign_code(off_y)
            + _CODE_CONV * conv.astype(jnp.int32)
            + _CODE_SING * singular.astype(jnp.int32))
    return cand, code.astype(jnp.int8)


def extremum_candidates(dog: jax.Array, dog_threshold: float,
                        capacity: int) -> Candidates:
    """Find strict 26-neighbor extrema above the pre-threshold.

    Args:
      dog: (S+2, H, W) DoG images for one octave (any float dtype).
      dog_threshold: already divided by nb_scales (sift_detector.c:1136).
      capacity: static max number of candidates (octave section capacity).

    Returns compacted (s, y, x) indices in raster order plus the (clamped)
    true count. Centers range over s in [1, S], y in [1, H-2], x in [1, W-2]
    (ExtractKeypoints.comp:46-53).
    """
    d = dog.astype(jnp.float32)
    ns, h, w = d.shape
    c = d[1:-1, 1:-1, 1:-1]

    nb_max = jnp.full_like(c, -jnp.inf)
    nb_min = jnp.full_like(c, jnp.inf)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = jax.lax.dynamic_slice(
                    d, (1 + ds, 1 + dy, 1 + dx), (ns - 2, h - 2, w - 2))
                nb_max = jnp.maximum(nb_max, nb)
                nb_min = jnp.minimum(nb_min, nb)

    mask = (jnp.abs(c) > (dog_threshold * 0.8)) & (
        (c > nb_max) | (c < nb_min))

    idx, count = rank_select(mask.reshape(-1), capacity)
    hw = (h - 2) * (w - 2)
    s = idx // hw + 1
    rem = idx % hw
    y = rem // (w - 2) + 1
    x = rem % (w - 2) + 1
    return Candidates(s=s.astype(jnp.int32), y=y.astype(jnp.int32),
                      x=x.astype(jnp.int32), count=count)


# ---------------------------------------------------------------------------
# Dense Newton-step fields + walk-code packing
# ---------------------------------------------------------------------------

# Walk-code layout (int8): ms+1 (base 3) | mx+1 (base 3) | my+1 (base 3)
# | converged (base 2) | singular (base 2) -> values in [0, 107].
_CODE_CONV = 27
_CODE_SING = 54


def _newton_step(n000, n001, n002, n010, n011, n012, n020, n021, n022,
                 n100, n101, n102, n110, n111, n112, n120, n121, n122,
                 n200, n201, n202, n210, n211, n212, n220, n221, n222):
    """One 3x3x3 Newton solve. Arguments n{s}{y}{x} are the neighborhood
    values (scalars or same-shape arrays); index order (s, y, x), offsets
    0/1/2 meaning -1/0/+1. Returns (off_s, off_x, off_y, g_s, g_x, g_y,
    singular). Math mirrors ExtractKeypoints.comp:124-165."""
    g_s = 0.5 * (n211 - n011)
    g_x = 0.5 * (n112 - n110)
    g_y = 0.5 * (n121 - n101)
    ctr = n111
    h11 = n211 + n011 - 2.0 * ctr  # d2/ds2
    h22 = n112 + n110 - 2.0 * ctr  # d2/dx2
    h33 = n121 + n101 - 2.0 * ctr  # d2/dy2
    h12 = 0.25 * (n212 - n210 - n012 + n010)  # ds dx
    h13 = 0.25 * (n221 - n201 - n021 + n001)  # ds dy
    h23 = 0.25 * (n122 - n120 - n102 + n100)  # dx dy

    det = (h11 * (h22 * h33 - h23 * h23)
           - h12 * (h12 * h33 - h13 * h23)
           + h13 * (h12 * h23 - h13 * h22))
    singular = det == 0.0
    # One reciprocal instead of six divides (this runs densely over every
    # interior DoG cell).
    rdet = 1.0 / jnp.where(singular, 1.0, det)
    inv11 = (h22 * h33 - h23 * h23) * rdet
    inv12 = -(h12 * h33 - h13 * h23) * rdet
    inv13 = (h12 * h23 - h13 * h22) * rdet
    inv22 = (h11 * h33 - h13 * h13) * rdet
    inv23 = -(h11 * h23 - h13 * h12) * rdet
    inv33 = (h11 * h22 - h12 * h12) * rdet

    off_s = -inv11 * g_s - inv12 * g_x - inv13 * g_y
    off_x = -inv12 * g_s - inv22 * g_x - inv23 * g_y
    off_y = -inv13 * g_s - inv23 * g_x - inv33 * g_y
    return off_s, off_x, off_y, g_s, g_x, g_y, singular


def _walk_classify(n000, n001, n002, n010, n011, n012, n020, n021, n022,
                   n100, n101, n102, n110, n111, n112, n120, n121, n122,
                   n200, n201, n202, n210, n211, n212, n220, n221, n222):
    """Walk-code classification WITHOUT the reciprocal/inverse: the walk
    only needs each Newton offset classified into {<= -0.6, interior,
    >= 0.6}, and Cramer gives off_i = det_i / det — so compare the
    numerators det_i (sign-corrected by det) against 0.6*|det| directly.
    Saves the reciprocal and the 6 inverse-entry products of
    :func:`_newton_step` over every dense cell. Returns (cs, cx, cy,
    conv, singular) with c* in {0, 1, 2} (the move-sign codes)."""
    g_s = 0.5 * (n211 - n011)
    g_x = 0.5 * (n112 - n110)
    g_y = 0.5 * (n121 - n101)
    ctr = n111
    h11 = n211 + n011 - 2.0 * ctr
    h22 = n112 + n110 - 2.0 * ctr
    h33 = n121 + n101 - 2.0 * ctr
    h12 = 0.25 * (n212 - n210 - n012 + n010)
    h13 = 0.25 * (n221 - n201 - n021 + n001)
    h23 = 0.25 * (n122 - n120 - n102 + n100)

    m11 = h22 * h33 - h23 * h23
    m12 = h12 * h33 - h13 * h23
    m13 = h12 * h23 - h13 * h22
    det = h11 * m11 - h12 * m12 + h13 * m13
    singular = det == 0.0
    # off_s*det, off_x*det, off_y*det (Cramer numerators of H off = -g).
    num_s = -g_s * m11 + g_x * m12 - g_y * m13
    num_x = (g_s * m12 - g_x * (h11 * h33 - h13 * h13)
             + g_y * (h11 * h23 - h13 * h12))
    num_y = (-g_s * m13 + g_x * (h11 * h23 - h12 * h13)
             - g_y * (h11 * h22 - h12 * h12))
    thr = 0.6 * jnp.abs(det)
    neg = det < 0.0

    def cls(num):
        n = jnp.where(neg, -num, num)   # sign-corrected numerator
        return jnp.where(n >= thr, 2, jnp.where(n <= -thr, 0, 1))

    cs, cx, cy = cls(num_s), cls(num_x), cls(num_y)
    conv = (cs == 1) & (cx == 1) & (cy == 1)
    return cs, cx, cy, conv, singular


def _dense_walk_code(dog: jax.Array) -> jax.Array:
    """Per-interior-cell walk code: move signs (|off| >= 0.6 per axis),
    convergence, and Hessian-singularity, packed into one int8."""
    d = dog.astype(jnp.float32)
    ns, h, w = d.shape

    def sl(ds, dy, dx):
        return jax.lax.dynamic_slice(
            d, (1 + ds, 1 + dy, 1 + dx), (ns - 2, h - 2, w - 2))

    nb = {(a, b, c): sl(a - 1, b - 1, c - 1)
          for a in (0, 1, 2) for b in (0, 1, 2) for c in (0, 1, 2)}
    cs, cx, cy, conv, singular = _walk_classify(
        *[nb[(a, b, c)] for a in (0, 1, 2) for b in (0, 1, 2)
          for c in (0, 1, 2)])
    code = (cs + 3 * cx + 9 * cy
            + _CODE_CONV * conv.astype(jnp.int32)
            + _CODE_SING * singular.astype(jnp.int32))
    return code.astype(jnp.int8)


def _gather_flat(flat: jax.Array, idx: jax.Array) -> jax.Array:
    return flat[jnp.clip(idx, 0, flat.shape[0] - 1)]


def _gather_neighborhood_2d(d2: jax.Array, base_row: jax.Array,
                            layer_rows: int, col: jax.Array) -> dict:
    """27-point neighborhoods from a 2-D ``(S*H, W)`` view of the DoG
    stack, as 27 element gathers. ``base_row = s*H + y``;
    ``layer_rows = H``."""
    nr, w = d2.shape
    nb = {}
    for a in (0, 1, 2):
        for b in (0, 1, 2):
            r = jnp.clip(base_row + (a - 1) * layer_rows + (b - 1),
                         0, nr - 1)
            for c in (0, 1, 2):
                cc = jnp.clip(col + c - 1, 0, w - 1)
                nb[(a, b, c)] = d2[r, cc]
    return nb


@functools.partial(jax.jit, static_argnames=(
    "nb_scales", "width", "height", "dog_threshold", "edge_threshold",
    "seed_sigma", "octave_idx"))
def refine_candidates(dog: jax.Array, cand: Candidates, *, nb_scales: int,
                      width: int, height: int, dog_threshold: float,
                      edge_threshold: float, seed_sigma: float,
                      octave_idx: int,
                      code: Optional[jax.Array] = None) -> RefinedKeypoints:
    """Subpixel refinement of compacted candidates (see module docstring).

    Slots at index >= cand.count walk dummy data and are masked invalid.
    ``octave_idx`` already includes the -1 shift for the upsampled octave
    (sift_detector.c:1134).
    """
    d = dog.astype(jnp.float32)
    ns, h, w = d.shape

    if code is None:
        code = _dense_walk_code(dog)
    # Interior layout (S, H-2, W-2), indexed [s-1, y-1, x-1].
    chr_, cwr = code.shape[1], code.shape[2]
    # Materialize the dense code field BEFORE the walk scan: without the
    # barrier XLA fuses the whole dense Newton computation into the while
    # body and recomputes it every step (~10 ms/octave at octave 0,
    # observed in traces) instead of gathering from 1 byte/cell in HBM.
    code = jax.lax.optimization_barrier(code)
    code2 = code.reshape(code.shape[0] * chr_, cwr)

    def code_at(rs, ry, rx):
        row = jnp.clip((rs - 1) * chr_ + (ry - 1), 0, code2.shape[0] - 1)
        cc = jnp.clip(rx - 1, 0, cwr - 1)
        return code2[row, cc].astype(jnp.int32)

    # --- 5-step walk over the dense code field -------------------------
    def step(carry, step_i):
        rs, ry, rx, valid, done = carry
        c = code_at(rs, ry, rx)
        sing = (c // _CODE_SING) % 2 == 1
        conv = (c // _CODE_CONV) % 2 == 1
        active = valid & jnp.logical_not(done)
        valid = jnp.where(active & sing, False, valid)
        act2 = active & jnp.logical_not(sing)
        done = jnp.where(act2 & conv, True, done)
        may_move = act2 & jnp.logical_not(conv) & (
            step_i < NB_REFINEMENT_STEPS - 1)
        mm = may_move.astype(jnp.int32)
        ms = c % 3 - 1
        mx = (c // 3) % 3 - 1
        my = (c // 9) % 3 - 1
        # Clamped integer moves (ExtractKeypoints.comp:183-188): with
        # |m| <= 1 and positions already interior, "refuse the move if it
        # leaves the interior" == clip(pos + m) to the interior — fewer
        # ops on the latency-bound (k,) walk chains.
        rx = jnp.clip(rx + mx * mm, 1, width - 2)
        ry = jnp.clip(ry + my * mm, 1, height - 2)
        rs = jnp.clip(rs + ms * mm, 1, nb_scales)
        return (rs, ry, rx, valid, done), None

    k = cand.s.shape[0]
    d2 = d.reshape(ns * h, w)

    def refine_at(kb):
        """Walk + final tests on the first ``kb`` candidate slots, padded
        back to ``k``. Bucketed by the live candidate count: the walk and
        neighborhood gathers are latency-bound per element, so running
        them at the bucket size scales refine with actual candidates."""

        def run():
            carry = (cand.s[:kb], cand.y[:kb], cand.x[:kb],
                     jnp.ones((kb,), jnp.bool_), jnp.zeros((kb,), jnp.bool_))
            # Unrolled (NB_REFINEMENT_STEPS is 5 and static): no loop
            # control flow around the latency-bound gathers.
            for step_i in range(NB_REFINEMENT_STEPS):
                carry, _ = step(carry, step_i)
            rs, ry, rx, valid, _ = carry

            # Final Newton solve + acceptance tests at the stop cell.
            # Walk stops are interior cells, so all 27 neighbors are
            # in-bounds; fetch as 9 contiguous 3-element slices from the
            # 2-D view (no 1-D flatten relayout).
            nb = _gather_neighborhood_2d(d2, rs * h + ry, h, rx)
            off_s, off_x, off_y, g_s, g_x, g_y, singular = _newton_step(
                *[nb[(a, b, c)] for a in (0, 1, 2) for b in (0, 1, 2)
                  for c in (0, 1, 2)])
            valid &= jnp.logical_not(singular)

            subpix_x = rx.astype(jnp.float32) + off_x
            subpix_y = ry.astype(jnp.float32) + off_y
            subpix_s = rs.astype(jnp.float32) + off_s

            ctr = nb[(1, 1, 1)]
            new_val = ctr + 0.5 * (g_x * off_x + g_y * off_y + g_s * off_s)

            ok = valid
            ok &= jnp.abs(new_val) > dog_threshold
            ok &= ((jnp.abs(off_x) < 1.5) & (jnp.abs(off_y) < 1.5)
                   & (jnp.abs(off_s) < 1.5))
            ok &= (subpix_x >= 0) & (subpix_x < width)
            ok &= (subpix_y >= 0) & (subpix_y < height)
            ok &= (subpix_s >= 0) & (subpix_s <= nb_scales + 1)

            # 2x2 spatial Hessian edge test (ExtractKeypoints.comp:
            # 197-206).
            h11 = nb[(1, 1, 2)] + nb[(1, 1, 0)] - 2.0 * ctr
            h22 = nb[(1, 2, 1)] + nb[(1, 0, 1)] - 2.0 * ctr
            h12 = 0.25 * (nb[(1, 2, 2)] - nb[(1, 0, 2)] - nb[(1, 2, 0)]
                          + nb[(1, 0, 0)])
            det2 = h11 * h22 - h12 * h12
            edgeness = jnp.where(
                det2 == 0.0, jnp.inf,
                (h11 + h22) ** 2 / jnp.where(det2 == 0.0, 1.0, det2))
            e = edge_threshold
            ok &= (edgeness < ((e + 1.0) ** 2 / e)) & (edgeness >= 0)
            ok &= jnp.arange(kb) < cand.count

            pad = (0, k - kb)
            return tuple(jnp.pad(a, pad) for a in (
                ok, subpix_x, subpix_y, subpix_s, new_val))
        return run

    sizes = bucket_sizes(k, lo=2048)
    if len(sizes) == 1:
        ok, subpix_x, subpix_y, subpix_s, new_val = refine_at(k)()
    else:
        bi = sum((cand.count > s).astype(jnp.int32) for s in sizes[:-1])
        ok, subpix_x, subpix_y, subpix_s, new_val = jax.lax.switch(
            bi, [refine_at(s) for s in sizes])

    scale_factor = 2.0 ** octave_idx
    sigma = seed_sigma * jnp.exp2(subpix_s / nb_scales) * scale_factor
    return RefinedKeypoints(
        valid=ok,
        scale_x=subpix_x,
        scale_y=subpix_y,
        subpix_s=subpix_s,
        scale_idx=jnp.round(subpix_s).astype(jnp.int32),
        sigma=sigma,
        intensity=new_val,
        x=subpix_x * scale_factor,
        y=subpix_y * scale_factor,
    )

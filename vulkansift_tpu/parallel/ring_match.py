"""Sharded brute-force 2-NN matching over a device mesh (ppermute ring).

The reference's matcher is a single-GPU O(N_A * N_B * 128) scan
(shaders/Get2NearestNeighbors.comp). When feature sets (or batches of pairs)
exceed one device, the distance computation shards ring-attention-style
(SURVEY.md §5.7): A-descriptors stay resident (sharded over the mesh axis),
B-descriptor shards stream around a ring via ``jax.lax.ppermute`` (NCCL
over NVLink on a multi-GPU host), and each device folds every visiting B
shard into a running per-row top-2. The N_A x N_B distance matrix is never
materialized, per-step compute is one bf16 matmul of the local shards, and
each ring step's collective moves only ``NB/n * 132`` bytes per link.

The top-2 merge uses (distance, index) lexicographic ordering
(:func:`vulkansift_tpu.ops.match._merge_top2`), which is associative and
commutative — results are bit-identical to the single-device matcher no
matter the shard visit order.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.match import _merge_top2, _top2_of_tile, exact_sqrt
from ..types import Matches2NN

# Plain Python float, NOT jnp.float32(...): a module-level device
# constant would initialize the JAX backend at import time, which
# breaks jax.distributed.initialize (must run before backend init).
_INF = float("inf")


def make_ring_match_fn(mesh: Mesh, axis_name: str = "data"):
    """Build a jitted sharded 2-NN matcher over ``mesh``.

    Returned signature matches :func:`vulkansift_tpu.ops.match.match_2nn`:
    ``fn(desc_a u8[NA,128], count_a, desc_b u8[NB,128], count_b) ->
    Matches2NN`` for ARBITRARY NA/NB: descriptors are padded internally to
    the next mesh-axis multiple (zero rows, masked out by the live counts),
    so raw detect outputs are directly matchable — the same contract as the
    single-chip ``match_2nn``. Output capacity is the padded NA; rows at
    index >= count_a are meaningless, as in the single-chip matcher.
    ``desc_a``/outputs are sharded over rows; ``desc_b`` is sharded over rows
    and streamed around the ring.
    """
    n = mesh.shape[axis_name]

    def local_fn(desc_a, count_a, desc_b, count_b):
        # Shapes here are per-device shards: (NA/n, 128), (NB/n, 128).
        na_l = desc_a.shape[0]
        nb_l = desc_b.shape[0]
        my = jax.lax.axis_index(axis_name)

        a16 = desc_a.astype(jnp.bfloat16)
        a_sq = jnp.sum(jnp.square(desc_a.astype(jnp.float32)), axis=1)
        b16 = desc_b.astype(jnp.bfloat16)
        # Row sums <= 128*255^2 < 2^24: exact in f32 (see ops.match docs).
        b_sq = jnp.sum(jnp.square(desc_b.astype(jnp.float32)), axis=1)

        perm = [(i, (i + 1) % n) for i in range(n)]

        def step(carry, i):
            top2, b16_cur, bsq_cur = carry
            # At step i this device holds global B shard (my - i) mod n.
            shard_id = jax.lax.rem(my - i + n, n)
            offset = shard_id * nb_l
            dots = jax.lax.dot_general(
                a16, b16_cur.T, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            d2 = a_sq[:, None] + bsq_cur[None, :] - 2.0 * dots
            col = offset + jnp.arange(nb_l, dtype=jnp.int32)[None, :]
            t = _top2_of_tile(d2, offset, col < count_b)
            top2 = _merge_top2(top2, t)
            # Rotate the B shard to the next device (skippable on the last
            # step, but keeping it unconditional lets XLA overlap it).
            if n > 1:
                b16_cur = jax.lax.ppermute(b16_cur, axis_name, perm)
                bsq_cur = jax.lax.ppermute(bsq_cur, axis_name, perm)
            return (top2, b16_cur, bsq_cur), None

        init_top2 = (jnp.full((na_l,), _INF), jnp.zeros((na_l,), jnp.int32),
                     jnp.full((na_l,), _INF), jnp.zeros((na_l,), jnp.int32))
        (top2, _, _), _ = jax.lax.scan(
            step, (init_top2, b16, b_sq), jnp.arange(n, dtype=jnp.int32))
        d1, i1, d2_, i2 = top2
        d1, d2_ = exact_sqrt(d1), exact_sqrt(d2_)
        row0 = my * na_l
        idx_a = row0 + jnp.arange(na_l, dtype=jnp.int32)
        return idx_a, i1, i2, d1, d2_

    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis_name, None), P(), P(axis_name, None), P()),
        out_specs=(P(axis_name), P(axis_name), P(axis_name),
                   P(axis_name), P(axis_name)),
        check_vma=False)

    @jax.jit
    def ring_match(desc_a, count_a, desc_b, count_b) -> Matches2NN:
        # Pad row counts to mesh-axis multiples (static shapes, so this is
        # free glue); the live counts mask the zero rows — padded B columns
        # have global index >= count_b and can never win the top-2, padded
        # A rows land at index >= count_a where results are undefined by
        # contract.
        pad_a = (-desc_a.shape[0]) % n
        pad_b = (-desc_b.shape[0]) % n
        if pad_a:
            desc_a = jnp.concatenate(
                [desc_a, jnp.zeros((pad_a, desc_a.shape[1]),
                                   desc_a.dtype)], axis=0)
        if pad_b:
            desc_b = jnp.concatenate(
                [desc_b, jnp.zeros((pad_b, desc_b.shape[1]),
                                   desc_b.dtype)], axis=0)
        idx_a, i1, i2, d1, d2_ = sharded(
            desc_a, jnp.asarray(count_a, jnp.int32),
            desc_b, jnp.asarray(count_b, jnp.int32))
        return Matches2NN(idx_a=idx_a, idx_b1=i1, idx_b2=i2,
                          dist_a_b1=d1, dist_a_b2=d2_,
                          count=jnp.asarray(count_a, jnp.int32))

    return ring_match

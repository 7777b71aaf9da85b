"""Monolithic fully-jitted detection pipeline (the performance path).

The staged :class:`~vulkansift_tpu.detector.SiftDetector` mirrors the
reference's host-visible structure (counts readable between stages, like the
reference's mapped count staging, sift_memory.c:1060-1106) at the cost of two
host round-trips per image. This module is the *performance* path: ONE XLA
program per (resolution, config) that takes a uint8 image and returns a
packed fixed-capacity :class:`~vulkansift_tpu.types.Features` buffer — zero
host synchronization, so images can be pipelined back-to-back and batched
(the analogue of the reference's recorded-once command buffer replayed per
dispatch, sift_detector.c:1313-1410).

Dynamic keypoint counts are handled with the fixed-capacity mask/compact
design (SURVEY.md §7 "hard parts"): every data-dependent size runs at its
static per-octave section capacity (geometric halves, sift_memory.c:40-87)
and invalid lanes are masked. Features beyond capacity are dropped and
counted (``lost`` output), matching the reference's clamping + "features
lost" accounting (sift_memory.c:1088-1102).

The back half (orientation + descriptor) is a patch gather + masked
reductions + hat-product einsum (:mod:`.ops.orientation`,
:mod:`.ops.descriptor`); its compute scales with per-octave *capacity*.

Batch/data parallelism: :func:`make_detect_fn` returns a pure function, so
``jax.lax.map``/``jax.vmap`` give batched multi-image detect and
``shard_map`` over a mesh axis gives multi-device data parallelism (see
:mod:`vulkansift_tpu.parallel`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .config import DescriptorFormat, SiftConfig
from .ops import extract, patches as patches_mod, scale_space
from .ops.descriptor import compute_descriptors
from .ops.orientation import compute_orientations
from .ops.patches import PatchSet
from .types import Features


class DetectOutput(NamedTuple):
    features: Features
    lost: jax.Array              # i32[] features dropped at capacity clamps
    per_octave_counts: jax.Array  # i32[nb_octaves]


def _backhalf_octave(gaussians, o, refined, *, cfg: SiftConfig, oct_res,
                     cap_o: int, octave_idx: int, patch_edge: int,
                     ori_radius: int, desc_radius: int):
    """Orientation + descriptor for one octave's refined keypoints."""
    ori_cap = cfg.orientation_capacity
    use_vlfeat = cfg.descriptor_format == DescriptorFormat.VLFEAT

    # Sigma-scaled sampling: top-scale keypoints sample the next octave at
    # half resolution (see patches.build_patchset).
    with jax.named_scope("ComputeOrientation"):
        ps = patches_mod.build_patchset(gaussians, o, refined, cfg, oct_res,
                                        patch_edge)
        ori = compute_orientations(ps, ori_radius=ori_radius,
                                   capacity=ori_cap)

        pair_valid = (ori.valid & refined.valid[:, None]).reshape(-1)
        pair_total = jnp.sum(pair_valid, dtype=jnp.int32)
        pair_count = jnp.minimum(pair_total, cap_o)
        pidx, _ = extract.rank_select(pair_valid, cap_o)
        parent = (pidx // ori_cap).astype(jnp.int32)
        angle = ori.angles.reshape(-1)[pidx]

    with jax.named_scope("ComputeDescriptors"):
        ps_pairs = PatchSet(*[a[parent] for a in ps])
        desc = compute_descriptors(ps_pairs, angle, desc_radius=desc_radius,
                                   use_vlfeat=use_vlfeat)
    in_count = jnp.arange(cap_o) < pair_count
    return dict(
        x=refined.x[parent], y=refined.y[parent],
        scale_x=refined.scale_x[parent],
        scale_y=refined.scale_y[parent],
        scale_idx=refined.scale_idx[parent],
        octave_idx=jnp.full((cap_o,), octave_idx, jnp.int32),
        sigma=refined.sigma[parent],
        orientation=angle,
        intensity=refined.intensity[parent],
        descriptor=desc,
        valid=in_count,
    ), pair_count, pair_total


def octave_plan(config: SiftConfig, width: int, height: int,
                bucket: int = 1) -> Tuple[Tuple[int, int], ...]:
    """The per-octave (width, height) sizes the compiled pipeline will use
    for this (possibly bucket-padded) resolution. Under bucketing
    (``bucket > 1``) the octave count is derived conservatively from the
    smallest resolution mapping to the bucket (one program serves the whole
    bucket), so it can be one less than the exact-resolution count — the
    instance records this plan per buffer so the debug APIs report what was
    actually computed."""
    oct_res = config.octave_resolutions(width, height)
    if bucket > 1:
        n_cap = config.max_octaves_for(max(width - bucket + 1, 32),
                                       max(height - bucket + 1, 32))
        oct_res = oct_res[:n_cap]
    return oct_res


def make_detect_fn(config: SiftConfig, width: int, height: int,
                   *, return_pyramid: bool = False, bucket: int = 1):
    """Build the single-program detect function for one static resolution.

    Args:
      config: static configuration. ``max_nb_sift_per_buffer`` bounds the
        output capacity AND the per-octave back-half compute.
      width/height: static input resolution.
      return_pyramid: also return (gaussians, dogs) for the debug APIs.
      bucket: bucket size > 1 enables the resolution-bucketing mode:
        ``detect`` takes extra traced ``(valid_w, valid_h)`` scalars, the
        octave count is derived conservatively from the smallest resolution
        mapping to this bucket (one compiled program serves the whole
        bucket — the analogue of the reference's image re-creation on
        preallocated memory, sift_memory.c:891-924), and keypoints outside
        the valid region are masked out. Detection near the padded border
        can differ slightly from exact-resolution detection (the blur sees
        edge-replicated pixels instead of the mirror boundary).

    Returns:
      ``detect(image_u8[, valid_w, valid_h]) -> DetectOutput`` (or
      ``(DetectOutput, gaussians, dogs)``), a pure jit-compatible function.
    """
    cfg = config
    s = cfg.nb_scales_per_octave
    bucketed = bucket > 1
    oct_res = octave_plan(cfg, width, height, bucket)
    nb_oct = len(oct_res)
    caps = cfg.octave_section_capacities(nb_oct)
    oct_shapes = tuple((h, w) for (w, h) in oct_res)
    patch_edge = patches_mod.patch_size(cfg)
    ori_radius = patches_mod.max_orientation_radius(cfg)
    desc_radius = patches_mod.max_descriptor_radius(cfg)
    capacity = cfg.max_nb_sift_per_buffer

    def detect(image_u8: jax.Array, valid_w=None, valid_h=None):
        # jax.named_scope = the reference's per-stage debug-marker regions
        # (sift_detector.c:29-50): names land in the HLO metadata, so
        # profiler device traces attribute time to pipeline stages.
        with jax.named_scope("ScaleSpace"):
            img = image_u8.astype(jnp.float32) * (1.0 / 255.0)
            gaussians, dogs = scale_space.build_pyramid(img, cfg, oct_shapes)

        with jax.named_scope("ExtractKeypoints"):
            refined_list = []
            for o, (ow, oh) in enumerate(oct_res):
                with jax.named_scope("DenseFrontend"):
                    cand, code = extract.dense_frontend(
                        dogs[o], cfg.dog_threshold, caps[o])
                octave_idx = o - (1 if cfg.use_input_upsampling else 0)
                with jax.named_scope("Refine"):
                    refined_list.append(extract.refine_candidates(
                        dogs[o], cand, nb_scales=s, width=ow,
                        height=oh, dog_threshold=cfg.dog_threshold,
                        edge_threshold=cfg.edge_threshold,
                        seed_sigma=cfg.seed_scale_sigma,
                        octave_idx=octave_idx, code=code))
            if bucketed and valid_w is not None:
                # Drop keypoints detected in the bucket's padding region.
                vw = jnp.asarray(valid_w, jnp.float32)
                vh = jnp.asarray(valid_h, jnp.float32)
                refined_list = [
                    r._replace(valid=r.valid & (r.x < vw) & (r.y < vh))
                    for r in refined_list]
            # The back half reads each refined field several times;
            # materialize once so XLA cannot rematerialize the refine
            # gather chain per consumer.
            refined_list = jax.lax.optimization_barrier(refined_list)

        # Back half: per octave, then pack.
        per_oct = []
        lost = jnp.zeros((), jnp.int32)
        counts = []
        for o, (ow, oh) in enumerate(oct_res):
            cap_o = caps[o]
            octave_idx = o - (1 if cfg.use_input_upsampling else 0)
            fields, pair_count, pair_total = _backhalf_octave(
                gaussians, o, refined_list[o], cfg=cfg, oct_res=oct_res,
                cap_o=cap_o, octave_idx=octave_idx,
                patch_edge=patch_edge, ori_radius=ori_radius,
                desc_radius=desc_radius)
            lost = lost + (pair_total - pair_count)
            per_oct.append(fields)
            counts.append(pair_count)

        with jax.named_scope("PackFeatures"):
            valid = jnp.concatenate([d["valid"] for d in per_oct])
            total = jnp.sum(valid, dtype=jnp.int32)
            count = jnp.minimum(total, capacity)
            lost = lost + (total - count)
            keep, _ = extract.rank_select(valid, capacity)
            in_range = jnp.arange(capacity) < count

            def pack(name):
                cat = jnp.concatenate([d[name] for d in per_oct], axis=0)
                out = cat[keep]
                mask = in_range if out.ndim == 1 else in_range[:, None]
                return jnp.where(mask, out, jnp.zeros_like(out))

            feats = Features(
                x=pack("x"), y=pack("y"),
                scale_x=pack("scale_x"), scale_y=pack("scale_y"),
                scale_idx=pack("scale_idx"), octave_idx=pack("octave_idx"),
                sigma=pack("sigma"), orientation=pack("orientation"),
                intensity=pack("intensity"), descriptor=pack("descriptor"),
                count=count,
            )
        out = DetectOutput(features=feats, lost=lost,
                           per_octave_counts=jnp.stack(counts))
        if return_pyramid:
            return out, gaussians, dogs
        return out

    return detect


def make_detect_batched(config: SiftConfig, width: int, height: int):
    """Batched multi-image detect: (B, H, W) u8 -> DetectOutput with leading
    batch dims (BASELINE config #4).

    Implemented as ``lax.map`` (a scan) of the full single-image program,
    so per-frame work equals the single-image path while B images go out
    in one dispatch (the multi-buffer pipelining contract,
    vksift_Config.sift_buffer_count)."""
    detect = make_detect_fn(config, width, height)
    return lambda images: jax.lax.map(detect, images)

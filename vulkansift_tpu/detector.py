"""SIFT detection pipeline orchestration.

The replacement for the reference's SiftDetector + its recorded
command buffer (reference: src/vulkansift/sift_detector.c:1313-1410 and
vksift_dispatchSiftDetection :1462-1542). Where the reference launches
data-dependent work with GPU-side atomics + ``vkCmdDispatchIndirect``
(SURVEY.md §2.5), XLA needs static shapes, so detection runs as three jitted
stages around two tiny host count readbacks, with data-dependent sizes
quantized to power-of-two *buckets* so the number of compiled programs stays
bounded:

* **S1** (compiled per input resolution): pyramid construction + dense
  extremum candidate extraction, compacted to the reference's
  geometric-halves per-octave section capacities (sift_memory.c:40-87).
* readback: per-octave candidate counts (the analogue of the reference's
  host read of the section counters in pack_BufferMemory,
  sift_memory.c:957-1047).
* **S2** (compiled per resolution x candidate-bucket profile): subpixel
  refinement, per-candidate patch gather, orientation assignment, and
  compaction of valid (keypoint, orientation) pairs.
* readback: per-octave pair counts.
* **S3** (compiled per bucket profiles only — resolution-independent):
  descriptor computation + assembly into a packed fixed-capacity
  :class:`~vulkansift_tpu.types.Features` buffer.

The per-octave feature-capacity clamping and "features lost" accounting
mirror the reference (sift_memory.c:1088-1102).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DESC_SIZE, DescriptorFormat, SiftConfig
from .ops import extract, patches as patches_mod, scale_space
from .ops.descriptor import compute_descriptors
from .ops.orientation import compute_orientations
from .ops.patches import PatchSet, build_patchset
from .types import Features
from .utils.logging import logger

_MIN_BUCKET = 64


def _bucket(n: int, cap: int) -> int:
    """Power-of-two bucket >= n, floored at _MIN_BUCKET, capped at cap."""
    n = max(int(n), 1)
    b = 1 << max(int(math.ceil(math.log2(n))), 0)
    return max(min(max(b, _MIN_BUCKET), max(cap, _MIN_BUCKET)), 1)


class SiftDetector:
    """Owns the staged, cached-compiled detection programs for one config."""

    def __init__(self, config: SiftConfig):
        self.config = config
        self.patch_edge = patches_mod.patch_size(config)
        self.ori_radius = patches_mod.max_orientation_radius(config)
        self.desc_radius = patches_mod.max_descriptor_radius(config)
        self.ori_capacity = config.orientation_capacity

    # ------------------------------------------------------------------
    # Stage 1: pyramid + candidate extraction (compiled per resolution)
    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnames=("self", "width", "height"))
    def _stage1(self, image_u8: jax.Array, *, width: int, height: int):
        cfg = self.config
        img = image_u8.astype(jnp.float32) / 255.0
        oct_res = cfg.octave_resolutions(width, height)
        oct_shapes = tuple((h, w) for (w, h) in oct_res)
        gaussians, dogs = scale_space.build_pyramid(img, cfg, oct_shapes)
        caps = cfg.octave_section_capacities(len(oct_shapes))
        cands = tuple(
            extract.extremum_candidates(dogs[o], cfg.dog_threshold, caps[o])
            for o in range(len(oct_shapes)))
        counts = jnp.stack([c.count for c in cands])
        return gaussians, dogs, cands, counts

    # ------------------------------------------------------------------
    # Stage 2: refine + patches + orientation (per resolution x profile)
    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnames=(
        "self", "width", "height", "profile"))
    def _stage2(self, gaussians, dogs, cands, *, width: int, height: int,
                profile: Tuple[int, ...]):
        cfg = self.config
        s = cfg.nb_scales_per_octave
        oct_res = cfg.octave_resolutions(width, height)
        caps = cfg.octave_section_capacities(len(oct_res))
        out = []
        pair_counts = []
        for o, (ow, oh) in enumerate(oct_res):
            bk = profile[o]
            cand = extract.Candidates(
                s=cands[o].s[:bk], y=cands[o].y[:bk], x=cands[o].x[:bk],
                count=jnp.minimum(cands[o].count, bk))
            octave_idx = o - (1 if cfg.use_input_upsampling else 0)
            refined = extract.refine_candidates(
                dogs[o], cand, nb_scales=s, width=ow, height=oh,
                dog_threshold=cfg.dog_threshold,
                edge_threshold=cfg.edge_threshold,
                seed_sigma=cfg.seed_scale_sigma, octave_idx=octave_idx)

            # Sigma-scaled sampling: top-scale keypoints sample the next
            # octave at half resolution (see patches.build_patchset).
            ps = build_patchset(gaussians, o, refined, cfg, oct_res,
                                self.patch_edge)
            ori = compute_orientations(
                ps, ori_radius=self.ori_radius, capacity=self.ori_capacity)

            pair_valid = (ori.valid & refined.valid[:, None]).reshape(-1)
            pair_cap = min(bk * self.ori_capacity, caps[o])
            (pidx,) = jnp.nonzero(pair_valid, size=pair_cap, fill_value=0)
            pair_total = jnp.sum(pair_valid, dtype=jnp.int32)
            pair_count = jnp.minimum(pair_total, pair_cap)
            parent = (pidx // self.ori_capacity).astype(jnp.int32)
            angle = ori.angles.reshape(-1)[pidx]

            out.append(dict(
                patchset=ps,
                refined=refined,
                pair_parent=parent,
                pair_angle=angle,
                pair_count=pair_count,
                pair_total=pair_total,
                octave_idx=jnp.full((bk,), octave_idx, jnp.int32),
                sigma=refined.sigma,
            ))
            pair_counts.append(pair_count)
        return out, jnp.stack(pair_counts)

    # ------------------------------------------------------------------
    # Stage 3: descriptors + assembly (resolution-independent compile key)
    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnames=("self", "dprofile"))
    def _stage3(self, stage2_out, *, dprofile: Tuple[int, ...]) -> Features:
        cfg = self.config
        use_vlfeat = cfg.descriptor_format == DescriptorFormat.VLFEAT
        capacity = cfg.max_nb_sift_per_buffer

        fields: Dict[str, List[jax.Array]] = {
            k: [] for k in ("x", "y", "scale_x", "scale_y", "scale_idx",
                            "octave_idx", "sigma", "orientation",
                            "intensity", "descriptor", "valid")}
        for o, oct_data in enumerate(stage2_out):
            db = dprofile[o]
            parent = oct_data["pair_parent"][:db]
            angle = oct_data["pair_angle"][:db]
            count = jnp.minimum(oct_data["pair_count"], db)
            ps: PatchSet = oct_data["patchset"]
            ps_pairs = PatchSet(*[a[parent] for a in ps])
            desc = compute_descriptors(
                ps_pairs, angle, desc_radius=self.desc_radius,
                use_vlfeat=use_vlfeat)
            refined = oct_data["refined"]
            fields["x"].append(refined.x[parent])
            fields["y"].append(refined.y[parent])
            fields["scale_x"].append(refined.scale_x[parent])
            fields["scale_y"].append(refined.scale_y[parent])
            fields["scale_idx"].append(refined.scale_idx[parent])
            fields["octave_idx"].append(oct_data["octave_idx"][parent])
            fields["sigma"].append(oct_data["sigma"][parent])
            fields["orientation"].append(angle)
            fields["intensity"].append(refined.intensity[parent])
            fields["descriptor"].append(desc)
            fields["valid"].append(jnp.arange(db) < count)

        valid = jnp.concatenate(fields.pop("valid"))
        total = jnp.sum(valid, dtype=jnp.int32)
        count = jnp.minimum(total, capacity)
        (keep,) = jnp.nonzero(valid, size=capacity, fill_value=0)
        in_range = jnp.arange(capacity) < count

        def pack(parts, fill_dtype=None):
            cat = jnp.concatenate(parts, axis=0)
            out = cat[keep]
            # Zero the tail so padding is deterministic.
            zeros = jnp.zeros_like(out)
            mask = in_range if out.ndim == 1 else in_range[:, None]
            return jnp.where(mask, out, zeros)

        return Features(
            x=pack(fields["x"]),
            y=pack(fields["y"]),
            scale_x=pack(fields["scale_x"]),
            scale_y=pack(fields["scale_y"]),
            scale_idx=pack(fields["scale_idx"]),
            octave_idx=pack(fields["octave_idx"]),
            sigma=pack(fields["sigma"]),
            orientation=pack(fields["orientation"]),
            intensity=pack(fields["intensity"]),
            descriptor=pack(fields["descriptor"]),
            count=count,
        )

    # ------------------------------------------------------------------
    def detect(self, image, width: int, height: int):
        """Run the full detection pipeline.

        Args:
          image: (height, width) uint8 grayscale, device or host array.
          width/height: static resolution (already bucket-padded by caller).

        Returns:
          (features, gaussians, dogs, per_octave_counts): a packed Features
          buffer plus the retained pyramids (or None) and the host-side
          per-octave feature counts.
        """
        cfg = self.config
        image = jnp.asarray(image)
        gaussians, dogs, cands, cand_counts = self._stage1(
            image, width=width, height=height)
        caps = cfg.octave_section_capacities(
            len(cfg.octave_resolutions(width, height)))
        host_counts = np.asarray(cand_counts)
        profile = tuple(_bucket(int(c), caps[o])
                        for o, c in enumerate(host_counts))

        stage2_out, pair_counts = self._stage2(
            gaussians, dogs, cands, width=width, height=height,
            profile=profile)
        host_pairs = np.asarray(pair_counts)
        # Detect per-octave capacity overflow for "features lost" accounting
        # (parity: sift_memory.c:1088-1102).
        totals = jax.device_get([d["pair_total"] for d in stage2_out])
        lost = int(sum(int(t) - int(p) for t, p in zip(totals, host_pairs)))
        if lost > 0:
            logger.warning(
                "Buffer too small to store all detected features "
                "(%d features lost)", lost)
        dprofile = tuple(
            _bucket(int(p), min(profile[o] * self.ori_capacity, caps[o]))
            for o, p in enumerate(host_pairs))
        features = self._stage3(stage2_out, dprofile=dprofile)

        per_octave = [int(p) for p in host_pairs]
        if not cfg.retain_pyramid:
            gaussians, dogs = None, None
        return features, gaussians, dogs, per_octave

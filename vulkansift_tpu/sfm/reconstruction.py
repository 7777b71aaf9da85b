"""Small-scale sequential SfM driver: detect -> match -> initialize ->
triangulate -> bundle adjust.

NEW design surface (BASELINE.json config #5). Device work (detection,
matching, RANSAC, triangulation, BA) is JAX; the track bookkeeping
(union-find over matches) is host-side NumPy — it is O(matches) pointer
chasing with no parallel structure, the classic CPU-side role (the
reference similarly keeps orchestration on the host, vulkansift.c).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from ..ops.match import lowe_ratio_mask, match_2nn
from .bundle_adjustment import BAProblem, BAResult, bundle_adjust
from .geometry import SE3, Camera, decompose_essential, ransac_essential, \
    triangulate_linear


@dataclasses.dataclass
class Reconstruction:
    poses: np.ndarray        # (C, 6) world->cam tangents
    points: np.ndarray       # (P, 3)
    point_valid: np.ndarray  # (P,) bool
    initial_cost: float
    final_cost: float


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _pairwise_matches(feats: Sequence[np.ndarray], ratio: float,
                      max_pairs_gap: int = 1):
    """Lowe-filtered 2-NN matches for consecutive frame pairs."""
    out = []
    for i in range(len(feats) - 1):
        for j in range(i + 1, min(i + 1 + max_pairs_gap, len(feats))):
            a, b = feats[i], feats[j]
            if len(a) < 8 or len(b) < 8:
                continue
            m = match_2nn(jnp.asarray(a["descriptor"]), jnp.asarray(len(a)),
                          jnp.asarray(b["descriptor"]), jnp.asarray(len(b)))
            keep = np.asarray(lowe_ratio_mask(m, ratio))[:len(a)]
            ia = np.asarray(m.idx_a)[:len(a)][keep]
            ib = np.asarray(m.idx_b1)[:len(a)][keep]
            out.append((i, j, ia, ib))
    return out


def reconstruct_sequence(
        features: Sequence[np.ndarray], camera: Camera, *,
        ratio: float = 0.75,
        ransac_iters: int = 256,
        ransac_threshold: float = 2e-5,
        min_track_views: int = 2,
        ba_iters: int = 30,
        max_pairs_gap: int = 1,
        pose_graph_iters: int = 15,
        seed: int = 0) -> Reconstruction:
    """Reconstruct a camera trajectory + sparse map from per-frame features.

    Args:
      features: per-frame FEATURE_DTYPE structured arrays (x, y used).
      camera: shared pinhole intrinsics.
      max_pairs_gap: match frames (i, j) with j - i <= gap. 1 = consecutive
        only; larger gaps add loop-closure edges, which feed a pose-graph
        optimization (:mod:`.pose_graph`) before triangulation/BA.
      pose_graph_iters: Gauss-Newton iterations for the pose graph (only
        runs when non-consecutive relative-pose edges exist).

    Pipeline: pairwise essential-matrix RANSAC -> pose chaining ->
    pose-graph optimization over ALL relative-pose edges (when loop
    closures exist) -> union-find track building -> linear triangulation ->
    LM bundle adjustment (matrix-free Schur). Scale is fixed by unit
    baselines between consecutive views (monocular gauge).
    """
    nb = len(features)
    assert nb >= 2, "need at least two frames"
    key = jax.random.PRNGKey(seed)
    matches = _pairwise_matches(features, ratio, max_pairs_gap=max_pairs_gap)

    # --- relative poses for consecutive pairs + inlier masks -------------
    rel = {}
    inliers = {}
    for (i, j, ia, ib) in matches:
        uv1 = np.stack([features[i]["x"][ia], features[i]["y"][ia]], 1)
        uv2 = np.stack([features[j]["x"][ib], features[j]["y"][ib]], 1)
        n = len(ia)
        npad = max(64, 1 << int(np.ceil(np.log2(max(n, 2)))))
        r1 = np.zeros((npad, 3), np.float32)
        r2 = np.zeros((npad, 3), np.float32)
        r1[:n] = np.asarray(camera.unproject(jnp.asarray(uv1)))
        r2[:n] = np.asarray(camera.unproject(jnp.asarray(uv2)))
        valid = np.arange(npad) < n
        key, k = jax.random.split(key)
        e, inl, nin = ransac_essential(
            jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid), k,
            threshold=ransac_threshold, nb_iters=ransac_iters)
        if int(nin) < 8:
            continue
        # Cheirality vote over INLIERS only — outliers can flip the
        # (R, t) branch selection.
        inl_padded = np.zeros(npad, bool)
        inl_padded[:n] = np.asarray(inl)[:n]
        inl = inl_padded[:n]
        pose = decompose_essential(e, jnp.asarray(r1), jnp.asarray(r2),
                                   jnp.asarray(inl_padded))
        rel[(i, j)] = SE3(np.asarray(pose.r), np.asarray(pose.t))
        inliers[(i, j)] = inl

    # --- chain consecutive poses (unit-baseline monocular gauge) ---------
    poses = [SE3(np.eye(3), np.zeros(3))]
    for i in range(1, nb):
        if (i - 1, i) in rel:
            rp = rel[(i - 1, i)]
            prev = poses[i - 1]
            poses.append(SE3(rp.r @ prev.r,
                             rp.r @ prev.t + rp.t))
        else:
            poses.append(poses[i - 1])

    # --- pose-graph optimization over loop-closure edges -----------------
    # Chaining accumulates drift; non-consecutive relative-pose edges
    # (loop closures) constrain it. Nodes are the INVERSE poses
    # S_i = T_i^{-1} so that the graph convention Z_ij = S_i^{-1} S_j
    # equals rel_ij^{-1} (rel_ij = T_j T_i^{-1} from two-view geometry) —
    # a pure measurement, independent of the estimates. Unit-baseline
    # measured translations are rescaled to the chained estimate's edge
    # baseline (monocular scale is unobservable per edge).
    has_loops = any(j - i > 1 for (i, j) in rel)
    if has_loops and pose_graph_iters > 0:
        from .pose_graph import PoseGraph, optimize_pose_graph
        inv_tangents = np.stack([
            np.asarray(SE3(jnp.asarray(p.r),
                           jnp.asarray(p.t)).inverse().log())
            for p in poses]).astype(np.float32)
        ei, ej, meas, wt = [], [], [], []
        for (i, j), rp in rel.items():
            er = poses[i].r @ poses[j].r.T           # est T_i T_j^{-1}
            et = poses[i].t - er @ poses[j].t
            scale = float(np.linalg.norm(et))
            mr = rp.r.T                              # rel_ij^{-1}
            mt = -rp.r.T @ rp.t
            mt = mt * (scale / max(float(np.linalg.norm(mt)), 1e-9))
            meas.append(np.asarray(
                SE3(jnp.asarray(mr), jnp.asarray(mt)).log()))
            ei.append(i)
            ej.append(j)
            wt.append(float(inliers[(i, j)].sum()))
        graph = PoseGraph(
            poses=jnp.asarray(inv_tangents),
            edge_i=jnp.asarray(ei, jnp.int32),
            edge_j=jnp.asarray(ej, jnp.int32),
            meas=jnp.asarray(np.stack(meas), jnp.float32),
            weight=jnp.asarray(wt, jnp.float32) / max(max(wt), 1.0))
        opt = optimize_pose_graph(graph, nb_iters=pose_graph_iters)
        opt_tangents = np.asarray(opt.poses)
        poses = []
        for t in opt_tangents:
            s = SE3.from_tangent(jnp.asarray(t)).inverse()
            poses.append(SE3(np.asarray(s.r), np.asarray(s.t)))

    # --- tracks via union-find over inlier matches ------------------------
    offsets = np.cumsum([0] + [len(f) for f in features])
    uf = _UnionFind(offsets[-1])
    for (i, j, ia, ib) in matches:
        inl = inliers.get((i, j))
        if inl is None:
            continue
        for a, b in zip(ia[inl], ib[inl]):
            uf.union(offsets[i] + a, offsets[j] + b)

    roots = {}
    obs_cam, obs_pt, obs_uv = [], [], []
    for f_idx, f in enumerate(features):
        for k_idx in range(len(f)):
            gid = offsets[f_idx] + k_idx
            root = uf.find(gid)
            if root == gid and uf.parent[gid] == gid:
                pass
            tid = roots.setdefault(root, len(roots))
            obs_cam.append(f_idx)
            obs_pt.append(tid)
            obs_uv.append((f["x"][k_idx], f["y"][k_idx]))
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_pt = np.asarray(obs_pt, np.int32)
    obs_uv = np.asarray(obs_uv, np.float32)
    nb_tracks = len(roots)

    # Keep tracks seen from >= min_track_views distinct cameras.
    views = np.zeros((nb_tracks, nb), bool)
    views[obs_pt, obs_cam] = True
    track_nviews = views.sum(1)
    good = track_nviews >= min_track_views
    remap = -np.ones(nb_tracks, np.int64)
    remap[good] = np.arange(good.sum())
    keep = good[obs_pt]
    obs_cam, obs_pt, obs_uv = (obs_cam[keep], remap[obs_pt[keep]].astype(
        np.int32), obs_uv[keep])
    nb_pts = int(good.sum())
    if nb_pts == 0:
        raise ValueError("no multi-view tracks; matching failed")

    # --- triangulate each track (vectorized over tracks) -----------------
    pose_r = jnp.asarray(np.stack([p.r for p in poses]))
    pose_t = jnp.asarray(np.stack([p.t for p in poses]))
    max_views = int(np.bincount(obs_pt, minlength=nb_pts).max())
    tr_cam = np.zeros((nb_pts, max_views), np.int32)
    tr_uv = np.zeros((nb_pts, max_views, 2), np.float32)
    tr_msk = np.zeros((nb_pts, max_views), bool)
    fill = np.zeros(nb_pts, np.int32)
    for c, p, uv in zip(obs_cam, obs_pt, obs_uv):
        k = fill[p]
        if k < max_views:
            tr_cam[p, k] = c
            tr_uv[p, k] = uv
            tr_msk[p, k] = True
            fill[p] = k + 1

    def tri_one(cams, uvs, msk):
        rays = camera.unproject(jnp.asarray(uvs))
        p = SE3(pose_r[cams], pose_t[cams])
        return triangulate_linear(p, rays, msk)

    pts, ok = jax.vmap(tri_one)(jnp.asarray(tr_cam), jnp.asarray(tr_uv),
                                jnp.asarray(tr_msk))
    pts = np.asarray(pts)
    ok = np.asarray(ok)

    # Drop observations of failed triangulations plus any observation whose
    # initial reprojection is wild (bad track / behind-camera point) — BA
    # cannot recover from a poisoned initialization.
    obs_valid = ok[obs_pt]
    obs_pose = SE3(np.asarray(pose_r)[obs_cam], np.asarray(pose_t)[obs_cam])
    x_cam = np.asarray(obs_pose.apply(jnp.asarray(pts[obs_pt])))
    in_front = x_cam[:, 2] > 0.05
    uv_hat = np.asarray(camera.project(jnp.asarray(x_cam)))
    reproj_err = np.linalg.norm(uv_hat - obs_uv, axis=1)
    obs_valid = obs_valid & in_front & (reproj_err < 30.0)

    # --- bundle adjust ----------------------------------------------------
    pose_tangents = np.stack([np.concatenate([
        np.asarray(SE3(jnp.asarray(p.r), jnp.asarray(p.t)).log())])
        for p in poses]).astype(np.float32)

    npad = 1 << int(np.ceil(np.log2(max(len(obs_cam), 2))))
    pad = npad - len(obs_cam)
    problem = BAProblem(
        poses=jnp.asarray(pose_tangents),
        points=jnp.asarray(pts, jnp.float32),
        cam_idx=jnp.asarray(np.pad(obs_cam, (0, pad))),
        pt_idx=jnp.asarray(np.pad(obs_pt, (0, pad))),
        uv=jnp.asarray(np.pad(obs_uv, ((0, pad), (0, 0)))),
        valid=jnp.asarray(np.pad(obs_valid, (0, pad))),
        camera=camera)
    result = bundle_adjust(problem, nb_iters=ba_iters)

    return Reconstruction(
        poses=np.asarray(result.poses),
        points=np.asarray(result.points),
        point_valid=ok,
        initial_cost=float(result.initial_cost),
        final_cost=float(result.final_cost))

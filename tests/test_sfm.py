"""SfM back-end tests on synthetic scenes with exact ground truth."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vulkansift_tpu.sfm import (BAProblem, Camera, PoseGraph, SE3,
                                bundle_adjust, decompose_essential,
                                exp_so3, log_so3, make_distributed_ba,
                                optimize_pose_graph, pose_graph_cost,
                                ransac_essential, triangulate_linear)
from vulkansift_tpu.parallel import make_mesh

CAM = Camera(fx=jnp.float32(500.0), fy=jnp.float32(500.0),
             cx=jnp.float32(320.0), cy=jnp.float32(240.0))


def _synthetic_scene(rng, nb_cams=6, nb_pts=120, noise_px=0.0):
    """Cameras on an arc looking at a point cloud around the origin."""
    pts = rng.uniform(-2, 2, (nb_pts, 3))
    pts[:, 2] += 8.0
    poses = []
    for i in range(nb_cams):
        angle = 0.08 * (i - nb_cams / 2)
        w = np.array([0.0, angle, 0.0])
        t = np.array([0.6 * i - 0.3 * nb_cams, 0.05 * i, 0.0])
        poses.append(np.concatenate([w, t]))
    poses = np.asarray(poses, np.float32)

    cam_idx, pt_idx, uvs = [], [], []
    for c in range(nb_cams):
        se3 = SE3.from_tangent(jnp.asarray(poses[c]))
        uv = np.asarray(CAM.project(se3.apply(jnp.asarray(pts))))
        vis = ((uv[:, 0] > 10) & (uv[:, 0] < 630)
               & (uv[:, 1] > 10) & (uv[:, 1] < 470))
        idx = np.nonzero(vis)[0]
        cam_idx.append(np.full(len(idx), c))
        pt_idx.append(idx)
        uvs.append(uv[idx] + noise_px * rng.standard_normal((len(idx), 2)))
    return (poses, pts.astype(np.float32),
            np.concatenate(cam_idx).astype(np.int32),
            np.concatenate(pt_idx).astype(np.int32),
            np.concatenate(uvs).astype(np.float32))


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.uniform(-1.5, 1.5, (50, 3)), jnp.float32)  # |w| < pi
    r = exp_so3(w)
    # Orthonormality and roundtrip.
    eye = jnp.einsum("nij,nkj->nik", r, r)
    np.testing.assert_allclose(np.asarray(eye),
                               np.broadcast_to(np.eye(3), (50, 3, 3)),
                               atol=1e-5)
    w2 = log_so3(r)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-4)


def test_se3_compose_inverse():
    rng = np.random.default_rng(1)
    a = SE3.from_tangent(jnp.asarray(rng.uniform(-1, 1, 6), jnp.float32))
    b = SE3.from_tangent(jnp.asarray(rng.uniform(-1, 1, 6), jnp.float32))
    x = jnp.asarray(rng.uniform(-1, 1, 3), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(a.compose(b).apply(x)),
        np.asarray(a.apply(b.apply(x))), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(a.inverse().apply(a.apply(x))), np.asarray(x), atol=1e-5)


def test_triangulation_exact():
    rng = np.random.default_rng(2)
    poses_t = jnp.asarray([[0, 0, 0, 0, 0, 0],
                           [0, 0.1, 0, -1.0, 0, 0],
                           [0.05, -0.1, 0, 1.0, 0.2, 0]], jnp.float32)
    poses = SE3.from_tangent(poses_t)
    x_true = jnp.asarray([0.3, -0.4, 5.0])
    rays = poses.apply(jnp.broadcast_to(x_true, (3, 3)))
    rays = rays / rays[:, 2:3]
    x, ok = triangulate_linear(poses, rays, jnp.array([True] * 3))
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_true), atol=1e-4)


def test_ransac_essential_and_pose_recovery():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (128, 3))
    pts[:, 2] += 6.0
    rel_true = SE3.from_tangent(jnp.asarray(
        [0.03, 0.2, -0.02, 1.0, 0.1, 0.05], jnp.float32))
    r1 = jnp.asarray(pts / pts[:, 2:3], jnp.float32)
    p2 = np.asarray(rel_true.apply(jnp.asarray(pts, jnp.float32)))
    r2 = jnp.asarray(p2 / p2[:, 2:3], jnp.float32)
    # 20% outliers
    n_out = 25
    r2 = r2.at[:n_out, :2].set(jnp.asarray(rng.uniform(-0.5, 0.5, (n_out, 2))))
    valid = jnp.ones(128, bool)
    e, inl, nin = ransac_essential(r1, r2, valid, jax.random.PRNGKey(0),
                                   threshold=1e-6, nb_iters=128)
    assert int(nin) >= 95
    assert not np.asarray(inl)[:n_out].any()  # outliers rejected
    pose = decompose_essential(e, r1, r2, inl)
    # Translation is up to scale: compare directions & rotation.
    t_est = np.asarray(pose.t)
    t_true = np.asarray(rel_true.t)
    cos = abs(t_est @ t_true / (np.linalg.norm(t_est)
                                * np.linalg.norm(t_true)))
    assert cos > 0.999
    np.testing.assert_allclose(np.asarray(pose.r), np.asarray(rel_true.r),
                               atol=1e-3)


def _perturbed_problem(rng, noise_px=0.5, pose_err=0.02, pt_err=0.1):
    poses, pts, cam_idx, pt_idx, uv = _synthetic_scene(rng,
                                                       noise_px=noise_px)
    n = len(cam_idx)
    npad = 1 << int(np.ceil(np.log2(n)))
    pad = npad - n
    poses_init = poses + pose_err * rng.standard_normal(poses.shape
                                                        ).astype(np.float32)
    poses_init[0] = poses[0]  # gauge
    pts_init = pts + pt_err * rng.standard_normal(pts.shape
                                                  ).astype(np.float32)
    return BAProblem(
        poses=jnp.asarray(poses_init),
        points=jnp.asarray(pts_init),
        cam_idx=jnp.asarray(np.pad(cam_idx, (0, pad))),
        pt_idx=jnp.asarray(np.pad(pt_idx, (0, pad))),
        uv=jnp.asarray(np.pad(uv, ((0, pad), (0, 0)))),
        valid=jnp.asarray(np.arange(npad) < n),
        camera=CAM), poses, pts


def test_bundle_adjustment_converges():
    rng = np.random.default_rng(4)
    problem, poses_true, pts_true = _perturbed_problem(rng)
    result = bundle_adjust(problem, nb_iters=15, nb_cg_iters=25)
    assert float(result.final_cost) < 0.02 * float(result.initial_cost)
    # ~0.5px measurement noise floor: mean squared error ~< 1 px^2.
    assert float(result.final_cost) < 1.0


def test_distributed_ba_matches_single(small_image=None):
    rng = np.random.default_rng(5)
    problem, _, _ = _perturbed_problem(rng)
    mesh = make_mesh(8)
    dist_ba = make_distributed_ba(mesh, nb_iters=10, nb_cg_iters=20)
    r_dist = dist_ba(problem)
    r_single = bundle_adjust(problem, nb_iters=10, nb_cg_iters=20)
    assert float(r_dist.final_cost) < 0.05 * float(r_dist.initial_cost)
    # Same math, same data -> near-identical results.
    np.testing.assert_allclose(float(r_dist.final_cost),
                               float(r_single.final_cost), rtol=1e-2)
    np.testing.assert_allclose(np.asarray(r_dist.poses),
                               np.asarray(r_single.poses), atol=1e-3)


def test_pose_graph_closes_loop():
    rng = np.random.default_rng(6)
    n = 8
    # Ground-truth poses around a loop.
    poses_true = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        poses_true.append(np.array([0, 0, ang, np.cos(ang), np.sin(ang), 0],
                                   np.float32))
    poses_true = np.stack(poses_true)

    def rel(i, j):
        ti = SE3.from_tangent(jnp.asarray(poses_true[i]))
        tj = SE3.from_tangent(jnp.asarray(poses_true[j]))
        return np.asarray(ti.inverse().compose(tj).log())

    edges_i = np.array([i for i in range(n)], np.int32)
    edges_j = np.array([(i + 1) % n for i in range(n)], np.int32)
    meas = np.stack([rel(i, (i + 1) % n) for i in range(n)])
    # Perturbed initialization (first pose anchored).
    init = poses_true + 0.08 * rng.standard_normal(poses_true.shape
                                                   ).astype(np.float32)
    init[0] = poses_true[0]
    graph = PoseGraph(poses=jnp.asarray(init),
                      edge_i=jnp.asarray(edges_i),
                      edge_j=jnp.asarray(edges_j),
                      meas=jnp.asarray(meas),
                      weight=jnp.ones(n))
    before = float(pose_graph_cost(graph))
    out = optimize_pose_graph(graph, nb_iters=15)
    after = float(pose_graph_cost(out))
    assert after < 1e-6
    assert after < 1e-3 * before


def _sequence_features(nb_cams, nb_pts=150, seed=7):
    """Per-frame FEATURE_DTYPE arrays of the synthetic scene, with one
    unique, well-separated descriptor per 3D point (jittered per view)."""
    from vulkansift_tpu.types import FEATURE_DTYPE
    rng = np.random.default_rng(seed)
    poses_t, pts, cam_idx, pt_idx, uv = _synthetic_scene(
        rng, nb_cams=nb_cams, nb_pts=nb_pts, noise_px=0.3)
    descs = rng.integers(0, 256, (nb_pts, 128), dtype=np.uint8)
    feats = []
    for c in range(nb_cams):
        sel = cam_idx == c
        n = int(sel.sum())
        f = np.zeros(n, FEATURE_DTYPE)
        f["x"] = uv[sel, 0]
        f["y"] = uv[sel, 1]
        jitter = rng.integers(-2, 3, (n, 128))
        f["descriptor"] = np.clip(
            descs[pt_idx[sel]].astype(int) + jitter, 0, 255)
        feats.append(f)
    return poses_t, feats


@pytest.mark.heavy
def test_reconstruct_sequence_end_to_end():
    """Full driver: synthetic per-frame features with track-consistent
    descriptors -> matching -> RANSAC init -> triangulation -> BA."""
    from vulkansift_tpu.sfm import reconstruct_sequence

    poses_t, feats = _sequence_features(nb_cams=4)
    rec = reconstruct_sequence(feats, CAM, ratio=0.8, ransac_iters=128,
                               ba_iters=40, seed=0)
    assert rec.final_cost < 1.0  # ~noise floor in px^2
    assert rec.final_cost < 0.2 * max(rec.initial_cost, 1e-6) or \
        rec.initial_cost < 1.0
    # Rotation trajectory should match ground truth (monocular scale aside):
    # compare relative rotations between consecutive cameras.
    for i in range(3):
        r_est = np.asarray(
            SE3.from_tangent(jnp.asarray(rec.poses[i + 1])).r
            @ SE3.from_tangent(jnp.asarray(rec.poses[i])).r.T)
        r_true = np.asarray(
            SE3.from_tangent(jnp.asarray(poses_t[i + 1])).r
            @ SE3.from_tangent(jnp.asarray(poses_t[i])).r.T)
        ang = np.degrees(np.arccos(np.clip(
            (np.trace(r_est.T @ r_true) - 1) / 2, -1, 1)))
        assert ang < 1.0, f"pair {i}: {ang} deg rotation error"

    # Trajectory ATE after Sim(3) alignment (BASELINE north star:
    # "trajectory ATE within bound"). Scene translations are O(1) units;
    # require the aligned RMSE well under 5% of that.
    from vulkansift_tpu.sfm import absolute_trajectory_error
    ate = absolute_trajectory_error(rec.poses, poses_t)
    assert ate < 0.05, f"ATE {ate}"


@pytest.mark.heavy
@pytest.mark.xfail(strict=True, reason=(
    "known defect (ROADMAP R10): on the 6-camera arc the end pair's "
    "8-point essential matrix is ill-conditioned (narrow, shallow scene), "
    "its translation comes out flipped, and chaining carries that into "
    "every later pose; BA does not recover"))
def test_reconstruct_sequence_six_camera_arc():
    from vulkansift_tpu.sfm import (absolute_trajectory_error,
                                    reconstruct_sequence)
    poses_t, feats = _sequence_features(nb_cams=6, nb_pts=400, seed=5)
    rec = reconstruct_sequence(feats, CAM, ratio=0.8, ransac_iters=128,
                               ba_iters=40, seed=0)
    ate = absolute_trajectory_error(rec.poses, poses_t)
    assert rec.final_cost < 1.0 and ate < 0.05, (rec.final_cost, ate)


def test_umeyama_alignment_recovers_sim3():
    from vulkansift_tpu.sfm import umeyama_alignment
    rng = np.random.default_rng(11)
    src = rng.standard_normal((20, 3))
    ang = 0.7
    r_true = np.array([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    s_true, t_true = 2.5, np.array([1.0, -2.0, 0.5])
    dst = (s_true * (r_true @ src.T)).T + t_true
    s, r, t = umeyama_alignment(src, dst)
    assert abs(s - s_true) < 1e-9
    np.testing.assert_allclose(r, r_true, atol=1e-9)
    np.testing.assert_allclose(t, t_true, atol=1e-9)


def test_checkpoint_roundtrip(tmp_path):
    from vulkansift_tpu.sfm import (Reconstruction, load_reconstruction,
                                    save_reconstruction)
    rng = np.random.default_rng(8)
    rec = Reconstruction(poses=rng.random((4, 6)).astype(np.float32),
                         points=rng.random((50, 3)).astype(np.float32),
                         point_valid=rng.random(50) > 0.5,
                         initial_cost=10.0, final_cost=0.1)
    save_reconstruction(str(tmp_path / "ckpt"), rec)
    rec2 = load_reconstruction(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(rec2.poses, rec.poses)
    np.testing.assert_array_equal(rec2.points, rec.points)
    np.testing.assert_array_equal(rec2.point_valid, rec.point_valid)
    assert rec2.final_cost == rec.final_cost

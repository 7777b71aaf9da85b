"""Schur-complement bundle adjustment (single-device and mesh-distributed).

NEW design surface (the reference has no SfM; BASELINE.json configs #5).
Formulation:

* Observations are a flat padded array (cam_idx, pt_idx, uv, weight) —
  static shapes, masked validity. Jacobians are exact (jax.jacfwd of the
  reprojection residual, vmapped over observations — XLA fuses them into
  the same pass as the residuals).
* Levenberg-Marquardt normal equations are never materialized globally:
  the reduced camera system ``S = U - W V^{-1} W^T`` is applied
  MATRIX-FREE inside conjugate gradients: per-observation 6x3 blocks, 3x3
  landmark inverses, and two ``segment_sum`` scatters per application —
  all dense vector ops on the device.
* Distribution: observations shard over the mesh data axis with
  ``shard_map``; every segment_sum is followed by a ``psum``, so cameras
  and landmarks stay replicated while the O(nb_obs) work splits across
  devices — the Schur-complement-over-collectives design from SURVEY.md §7.

The Huber robust weight matches standard BA practice (reweighted at each
outer iteration).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .geometry import HIGHEST, Camera, SE3, reproject

# Full float32 contractions (see geometry.HIGHEST): TF32 would perturb the
# normal equations and the reported cost.
_einsum = functools.partial(jnp.einsum, precision=HIGHEST)


class BAProblem(NamedTuple):
    """Static-shape BA problem (padded; ``valid`` masks live observations)."""

    poses: jax.Array      # f32 (C, 6) camera tangents [w, t] (world->cam)
    points: jax.Array     # f32 (Pt, 3) landmarks
    cam_idx: jax.Array    # i32 (N,) observation -> camera
    pt_idx: jax.Array     # i32 (N,) observation -> landmark
    uv: jax.Array         # f32 (N, 2) pixel measurements
    valid: jax.Array      # bool (N,)
    camera: Camera        # shared intrinsics (scalars)


class BAResult(NamedTuple):
    poses: jax.Array
    points: jax.Array
    initial_cost: jax.Array  # mean squared reprojection error (valid obs)
    final_cost: jax.Array


def _residuals_and_jacobians(problem: BAProblem):
    """Per-observation residual (2,), J_pose (2, 6), J_point (2, 3)."""

    def one(pose_wt, point, uv):
        def f(pw, pt):
            return reproject(pw, pt, problem.camera) - uv
        r = f(pose_wt, point)
        jp = jax.jacfwd(f, argnums=0)(pose_wt, point)
        jx = jax.jacfwd(f, argnums=1)(pose_wt, point)
        return r, jp, jx

    poses_o = problem.poses[problem.cam_idx]
    points_o = problem.points[problem.pt_idx]
    return jax.vmap(one)(poses_o, points_o, problem.uv)


def _huber_weight(r2: jax.Array, delta: float) -> jax.Array:
    """IRLS weight for the Huber loss given squared residual norms."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-12))
    return jnp.where(r <= delta, 1.0, delta / r)


def _ba_step_terms(problem: BAProblem, huber_delta: float, psum=None):
    """All per-iteration quantities: blocks U, V, W-products and rhs.

    ``psum`` (optional) reduces segment sums across a mesh axis — the only
    hook distribution needs.
    """
    nc = problem.poses.shape[0]
    npt = problem.points.shape[0]
    r, jp, jx = _residuals_and_jacobians(problem)
    w = jnp.where(problem.valid,
                  _huber_weight(jnp.sum(r * r, -1), huber_delta), 0.0)
    jp_w = jp * w[:, None, None]
    jx_w = jx * w[:, None, None]

    # IRLS normal-equation blocks: H = sum w J^T J, g = -sum w J^T r
    # (exactly one weighted factor per product).
    utt = _einsum("nki,nkj->nij", jp_w, jp)        # (N, 6, 6)
    vtt = _einsum("nki,nkj->nij", jx_w, jx)        # (N, 3, 3)
    wtt = _einsum("nki,nkj->nij", jp_w, jx)        # (N, 6, 3)
    bc = -_einsum("nki,nk->ni", jp_w, r)           # (N, 6)
    bp = -_einsum("nki,nk->ni", jx_w, r)           # (N, 3)

    def seg_c(x):
        out = jax.ops.segment_sum(x, problem.cam_idx, num_segments=nc)
        return psum(out) if psum else out

    def seg_p(x):
        out = jax.ops.segment_sum(x, problem.pt_idx, num_segments=npt)
        return psum(out) if psum else out

    u = seg_c(utt)                                    # (C, 6, 6)
    v = seg_p(vtt)                                    # (Pt, 3, 3)
    g_c = seg_c(bc)                                   # (C, 6)
    g_p = seg_p(bp)                                   # (Pt, 3)
    cost_n = jnp.where(problem.valid, jnp.sum(r * r, -1), 0.0)
    cost = jnp.sum(cost_n)
    nvalid = jnp.sum(problem.valid)
    if psum:
        cost = psum(cost)
        nvalid = psum(nvalid)
    return dict(u=u, v=v, wtt=wtt, g_c=g_c, g_p=g_p,
                cost=cost / jnp.maximum(nvalid, 1), seg_c=seg_c, seg_p=seg_p)


def _solve_schur_cg(problem: BAProblem, terms, lam: jax.Array,
                    nb_cg_iters: int):
    """Matrix-free CG on the reduced camera system.

    S dx = g with S = U+λdiag - W (V+λdiag)^{-1} W^T, then landmark
    back-substitution. Returns (d_poses (C,6), d_points (Pt,3)).
    """
    u, v = terms["u"], terms["v"]
    wtt = terms["wtt"]
    seg_c, seg_p = terms["seg_c"], terms["seg_p"]
    cam_idx, pt_idx = problem.cam_idx, problem.pt_idx

    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    u_d = u + lam * eye6
    v_d = v + lam * eye3
    v_inv = jnp.linalg.inv(v_d + 1e-9 * eye3)

    def apply_s(x):  # x: (C, 6)
        y = _einsum("cij,cj->ci", u_d, x)
        wx = _einsum("nji,nj->ni", wtt, x[cam_idx])     # Wᵀx per obs (3,)
        tp = seg_p(wx)                                      # (Pt, 3)
        z = _einsum("pij,pj->pi", v_inv, tp)             # (Pt, 3)
        wz = _einsum("nij,nj->ni", wtt, z[pt_idx])       # (N, 6)
        y = y - seg_c(wz)
        return y

    # rhs: g_c - W V^{-1} g_p
    z0 = _einsum("pij,pj->pi", v_inv, terms["g_p"])
    rhs = terms["g_c"] - seg_c(
        _einsum("nij,nj->ni", wtt, z0[pt_idx]))

    # Jacobi-preconditioned CG.
    diag = jnp.maximum(jnp.diagonal(u_d, axis1=-2, axis2=-1), 1e-6)

    def prec(x):
        return x / diag

    x = jnp.zeros_like(rhs)
    r = rhs
    zp = prec(r)
    p = zp
    rz = jnp.sum(r * zp)

    def body(_, carry):
        x, r, p, rz = carry
        sp = apply_s(p)
        alpha = rz / jnp.maximum(jnp.sum(p * sp), 1e-20)
        x = x + alpha * p
        r = r - alpha * sp
        z = prec(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, nb_cg_iters, body, (x, r, p, rz))

    # Landmark back-substitution: dX = V^{-1} (g_p - Wᵀ dx).
    wx = _einsum("nji,nj->ni", wtt, x[cam_idx])
    tp = seg_p(wx)
    dpt = _einsum("pij,pj->pi", v_inv, terms["g_p"] - tp)
    return x, dpt


@functools.partial(jax.jit, static_argnames=(
    "nb_iters", "nb_cg_iters", "fix_first_pose"))
def bundle_adjust(problem: BAProblem, *, nb_iters: int = 10,
                  nb_cg_iters: int = 20, huber_delta: float = 3.0,
                  init_lambda: float = 1e-3,
                  fix_first_pose: bool = True) -> BAResult:
    """Levenberg-Marquardt BA with matrix-free Schur complement.

    The first camera is gauge-fixed (its update zeroed) by default.
    """

    def cost_of(poses, points):
        p2 = problem._replace(poses=poses, points=points)
        r, _, _ = _residuals_and_jacobians(p2)
        c = jnp.where(problem.valid, jnp.sum(r * r, -1), 0.0)
        return jnp.sum(c) / jnp.maximum(jnp.sum(problem.valid), 1)

    init_cost = cost_of(problem.poses, problem.points)

    def step(carry, _):
        poses, points, lam = carry
        p2 = problem._replace(poses=poses, points=points)
        terms = _ba_step_terms(p2, huber_delta)
        dx, dpt = _solve_schur_cg(p2, terms, lam, nb_cg_iters)
        if fix_first_pose:
            dx = dx.at[0].set(0.0)
        new_poses = poses + dx
        new_points = points + dpt
        new_cost = cost_of(new_poses, new_points)
        old_cost = terms["cost"]
        accept = new_cost < old_cost
        poses = jnp.where(accept, new_poses, poses)
        points = jnp.where(accept, new_points, points)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-8),
                        jnp.minimum(lam * 4.0, 1e4))
        return (poses, points, lam), new_cost

    (poses, points, _), _ = jax.lax.scan(
        step, (problem.poses, problem.points, jnp.float32(init_lambda)),
        None, length=nb_iters)
    return BAResult(poses=poses, points=points,
                    initial_cost=init_cost,
                    final_cost=cost_of(poses, points))


# ---------------------------------------------------------------------------
# Distributed (mesh) variant
# ---------------------------------------------------------------------------

def make_distributed_ba(mesh: Mesh, axis_name: str = "data", *,
                        nb_iters: int = 10, nb_cg_iters: int = 20,
                        huber_delta: float = 3.0,
                        fix_first_pose: bool = True):
    """Build a jitted multi-device BA: observations sharded over
    ``axis_name``, poses/landmarks replicated, segment sums reduced with
    psum (NCCL all-reduce on GPUs).

    Returned ``fn(problem) -> BAResult`` requires ``nb_obs`` divisible by the
    mesh axis size (pad with invalid observations).
    """

    def local_fn(poses, points, cam_idx, pt_idx, uv, valid,
                 fx, fy, cx, cy):
        cam = Camera(fx=fx, fy=fy, cx=cx, cy=cy)
        problem = BAProblem(poses=poses, points=points, cam_idx=cam_idx,
                            pt_idx=pt_idx, uv=uv, valid=valid, camera=cam)

        def psum(x):
            return jax.lax.psum(x, axis_name)

        def cost_of(ps, pts):
            p2 = problem._replace(poses=ps, points=pts)
            r, _, _ = _residuals_and_jacobians(p2)
            c = jnp.where(valid, jnp.sum(r * r, -1), 0.0)
            return psum(jnp.sum(c)) / jnp.maximum(psum(jnp.sum(valid)), 1)

        init_cost = cost_of(poses, points)

        def step(carry, _):
            ps, pts, lam = carry
            p2 = problem._replace(poses=ps, points=pts)
            terms = _ba_step_terms(p2, huber_delta, psum=psum)
            dx, dpt = _solve_schur_cg(p2, terms, lam, nb_cg_iters)
            if fix_first_pose:
                dx = dx.at[0].set(0.0)
            new_ps = ps + dx
            new_pts = pts + dpt
            new_cost = cost_of(new_ps, new_pts)
            accept = new_cost < terms["cost"]
            ps = jnp.where(accept, new_ps, ps)
            pts = jnp.where(accept, new_pts, pts)
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-8),
                            jnp.minimum(lam * 4.0, 1e4))
            return (ps, pts, lam), new_cost

        (ps, pts, _), _ = jax.lax.scan(
            step, (poses, points, jnp.float32(1e-3)), None,
            length=nb_iters)
        return ps, pts, init_cost, cost_of(ps, pts)

    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P(axis_name), P(axis_name), P(axis_name, None),
                  P(axis_name), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False)

    @jax.jit
    def run(problem: BAProblem) -> BAResult:
        poses, points, c0, c1 = sharded(
            problem.poses, problem.points, problem.cam_idx, problem.pt_idx,
            problem.uv, problem.valid,
            jnp.asarray(problem.camera.fx, jnp.float32),
            jnp.asarray(problem.camera.fy, jnp.float32),
            jnp.asarray(problem.camera.cx, jnp.float32),
            jnp.asarray(problem.camera.cy, jnp.float32))
        return BAResult(poses=poses, points=points,
                        initial_cost=c0, final_cost=c1)

    return run

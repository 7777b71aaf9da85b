"""SE(3)/SO(3) primitives, projection, triangulation, two-view geometry.

NEW design surface (no reference implementation — the reference is a
single-GPU SIFT library; BASELINE.json extends scope to an SfM back-end).
Everything is pure JAX with static shapes so it jits, vmaps, and shards.

Conventions:
* Rotations: axis-angle vectors ``w`` (3,) with ``R = exp([w]x)``;
  world-to-camera: ``x_cam = R @ x_world + t``.
* Pixels: pinhole ``(fx, fy, cx, cy)``; no distortion (rectified inputs).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-12
# Every float32 contraction in sfm/ asks for full float32 precision: on a
# GPU the default may run in TF32 (about three decimal digits), which would
# move reprojection residuals of sub-pixel size and the BA cost with them.
HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a @ b`` at full float32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def matvec(m: jax.Array, x: jax.Array) -> jax.Array:
    """Batched ``m @ x`` for (…, i, j) matrices and (…, j) vectors."""
    return jnp.einsum("...ij,...j->...i", m, x, precision=HIGHEST)


# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------

def hat(w: jax.Array) -> jax.Array:
    """(…, 3) -> (…, 3, 3) skew-symmetric cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], -1),
        jnp.stack([wz, z, -wx], -1),
        jnp.stack([-wy, wx, z], -1)], -2)


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle (…, 3) -> rotation matrix (…, 3, 3)."""
    theta2 = jnp.sum(w * w, -1, keepdims=True)[..., None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    # Taylor-safe coefficients sin(t)/t and (1-cos t)/t^2.
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS))
    k = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3), k.shape)
    return eye + a * k + b * matmul(k, k)


def log_so3(r: jax.Array) -> jax.Array:
    """Rotation matrix (…, 3, 3) -> axis-angle (…, 3).

    Differentiable at the identity (needed by the pose-graph jacobians):
    theta comes from atan2 of a safe vee-norm, and the singular branch of
    the scale is guarded with the double-where pattern so no NaN leaks
    into jacfwd tangents.
    """
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    vee = jnp.stack([r[..., 2, 1] - r[..., 1, 2],
                     r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], -1)
    sin_t = 0.5 * jnp.sqrt(jnp.sum(vee * vee, -1) + _EPS)
    cos_t = (trace - 1.0) * 0.5
    theta = jnp.arctan2(sin_t, cos_t)[..., None]
    small = theta < 1e-4
    sin_safe = jnp.where(small, 1.0, sin_t[..., None])
    scale = jnp.where(small, 0.5 + theta * theta / 12.0,
                      theta / (2.0 * sin_safe))
    return vee * scale


class SE3(NamedTuple):
    """Batchable rigid transform: x -> R @ x + t."""

    r: jax.Array  # (…, 3, 3)
    t: jax.Array  # (…, 3)

    @staticmethod
    def identity(batch=()):
        return SE3(jnp.broadcast_to(jnp.eye(3), batch + (3, 3)),
                   jnp.zeros(batch + (3,)))

    @staticmethod
    def from_tangent(wt: jax.Array) -> "SE3":
        """(…, 6) [w, t] -> SE3 (first-order parameterization: R=exp(w),
        translation stored directly — the standard BA parameterization)."""
        return SE3(exp_so3(wt[..., :3]), wt[..., 3:])

    def apply(self, x: jax.Array) -> jax.Array:
        return matvec(self.r, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: first other, then self."""
        return SE3(matmul(self.r, other.r), matvec(self.r, other.t) + self.t)

    def inverse(self) -> "SE3":
        rt = jnp.swapaxes(self.r, -1, -2)
        return SE3(rt, -matvec(rt, self.t))

    def log(self) -> jax.Array:
        """(…, 6) [log R, t] — consistent with from_tangent."""
        return jnp.concatenate([log_so3(self.r), self.t], -1)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

class Camera(NamedTuple):
    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array

    def project(self, x_cam: jax.Array) -> jax.Array:
        """Camera-frame points (…, 3) -> pixels (…, 2)."""
        z = jnp.maximum(x_cam[..., 2], 1e-9)
        return jnp.stack([self.fx * x_cam[..., 0] / z + self.cx,
                          self.fy * x_cam[..., 1] / z + self.cy], -1)

    def unproject(self, uv: jax.Array) -> jax.Array:
        """Pixels (…, 2) -> normalized rays (…, 3) with z=1."""
        return jnp.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy,
                          jnp.ones_like(uv[..., 0])], -1)


def reproject(pose_wt: jax.Array, point: jax.Array, cam: Camera) -> jax.Array:
    """Residual helper: project world point under pose tangent (6,)."""
    pose = SE3.from_tangent(pose_wt)
    return cam.project(pose.apply(point))


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------

def triangulate_linear(poses: SE3, rays: jax.Array,
                       mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Midpoint/linear triangulation of ONE track from N views.

    Args:
      poses: SE3 with leading dim N (world->camera).
      rays: (N, 3) normalized camera-frame rays (unprojected observations).
      mask: (N,) bool validity.

    Returns (X_world (3,), ok) minimizing sum of squared ray cross products
    (DLT on the two cross-product rows per view).
    """
    # Ray direction in world frame; camera center in world frame.
    rt = jnp.swapaxes(poses.r, -1, -2)
    d = matvec(rt, rays)
    c = -matvec(rt, poses.t)
    # For each view: (I - dd^T/|d|^2) (X - c) = 0
    dn = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), _EPS)
    p = (jnp.broadcast_to(jnp.eye(3), (d.shape[0], 3, 3))
         - dn[:, :, None] * dn[:, None, :])
    p = p * mask[:, None, None]
    a = jnp.sum(p, axis=0)
    b = jnp.sum(matvec(p, c), axis=0)
    # Solve 3x3 (regularized for rank-deficient masks).
    a = a + 1e-9 * jnp.eye(3)
    x = jnp.linalg.solve(a, b)
    ok = jnp.sum(mask) >= 2
    return x, ok


# ---------------------------------------------------------------------------
# Two-view geometry (essential matrix, RANSAC, pose recovery)
# ---------------------------------------------------------------------------

def essential_8pt(r1: jax.Array, r2: jax.Array) -> jax.Array:
    """Normalized 8-point essential matrix from >=8 ray pairs.

    Args:
      r1, r2: (N, 3) normalized rays (z=1) in each camera.

    Returns E (3, 3) with the rank-2 constraint enforced.
    """
    x1, y1 = r1[:, 0], r1[:, 1]
    x2, y2 = r2[:, 0], r2[:, 1]
    a = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                   x1, y1, jnp.ones_like(x1)], -1)
    # full_matrices=True: with exactly 8 rows the null vector is the 9th
    # right singular vector, which the thin SVD does not return.
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    e = vt[-1].reshape(3, 3)
    u, s, vt2 = jnp.linalg.svd(e)
    s_fixed = jnp.array([1.0, 1.0, 0.0]) * (s[0] + s[1]) * 0.5
    return matmul(u * s_fixed, vt2)


def sampson_error(e: jax.Array, r1: jax.Array, r2: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) error of ray pairs under E."""
    ex1 = matmul(r1, e.T)   # (N, 3) = E @ x1 per row
    etx2 = matmul(r2, e)    # (N, 3) = E^T @ x2
    x2ex1 = jnp.sum(r2 * ex1, -1)
    denom = ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
    return x2ex1 ** 2 / jnp.maximum(denom, _EPS)


@functools.partial(jax.jit, static_argnames=("nb_iters",))
def ransac_essential(rays1: jax.Array, rays2: jax.Array, valid: jax.Array,
                     key: jax.Array, *, threshold: float = 1e-5,
                     nb_iters: int = 256):
    """RANSAC essential-matrix estimation, vmapped over hypotheses.

    Args:
      rays1/rays2: (N, 3) normalized rays per correspondence (padded).
      valid: (N,) bool; invalid rows never count as inliers.
      threshold: Sampson error inlier threshold (normalized coords^2).

    Returns (E_best, inlier_mask, nb_inliers).
    """
    n = rays1.shape[0]
    nvalid = jnp.maximum(jnp.sum(valid), 1)

    def hypothesis(k):
        # Sample 8 valid indices (with replacement — cheap and unbiased
        # enough at RANSAC scale).
        u = jax.random.uniform(k, (8,))
        ranks = (u * nvalid).astype(jnp.int32)
        cs = jnp.cumsum(valid.astype(jnp.int32))
        idx = jnp.searchsorted(cs, ranks + 1)
        idx = jnp.clip(idx, 0, n - 1)
        e = essential_8pt(rays1[idx], rays2[idx])
        err = sampson_error(e, rays1, rays2)
        inl = (err < threshold) & valid
        return e, jnp.sum(inl)

    keys = jax.random.split(key, nb_iters)
    es, scores = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(scores)
    e_best = es[best]
    inl = (sampson_error(e_best, rays1, rays2) < threshold) & valid
    return e_best, inl, jnp.sum(inl)


def decompose_essential(e: jax.Array, rays1: jax.Array, rays2: jax.Array,
                        mask: jax.Array) -> SE3:
    """Recover the relative pose (cam1->cam2) from E via the cheirality
    test over the 4 candidate decompositions."""
    u, _, vt = jnp.linalg.svd(e)
    # Enforce proper rotations.
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r_a = matmul(matmul(u, w), vt)
    r_b = matmul(matmul(u, w.T), vt)
    t_u = u[:, 2]

    def count_front(r, t):
        pose2 = SE3(r, t)
        poses = SE3(jnp.stack([jnp.eye(3), r]), jnp.stack([jnp.zeros(3), t]))

        def tri(a, b, m):
            x, _ = triangulate_linear(poses, jnp.stack([a, b]),
                                      jnp.array([True, True]))
            z1 = x[2]
            z2 = pose2.apply(x)[2]
            return ((z1 > 0) & (z2 > 0) & m).astype(jnp.int32)

        return jnp.sum(jax.vmap(tri)(rays1, rays2, mask))

    cands = [(r_a, t_u), (r_a, -t_u), (r_b, t_u), (r_b, -t_u)]
    counts = jnp.stack([count_front(r, t) for r, t in cands])
    best = jnp.argmax(counts)
    rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return SE3(rs[best], ts[best])

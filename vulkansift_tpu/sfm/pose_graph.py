"""Pose-graph optimization on SE(3) (Gauss-Newton).

NEW design surface (no reference implementation). Nodes are camera poses,
edges are relative-pose measurements (e.g. from two-view geometry or
odometry). The residual of edge (i, j) with measurement Z_ij is

    r_ij = log( Z_ij^{-1} · T_i^{-1} · T_j )   in R^6,

linearized with exact jax jacobians and solved densely (pose graphs are
small — hundreds of nodes — so a dense (6N, 6N) solve is simpler and
fast enough compared with sparse factorization).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .geometry import SE3, matmul


class PoseGraph(NamedTuple):
    """Static-shape pose graph (padded edges masked by ``valid``)."""

    poses: jax.Array    # f32 (N, 6) pose tangents [w, t] (world->cam)
    edge_i: jax.Array   # i32 (E,)
    edge_j: jax.Array   # i32 (E,)
    meas: jax.Array     # f32 (E, 6) measured relative tangents: T_i^{-1} T_j
    weight: jax.Array   # f32 (E,) information weight (0 masks an edge)


def _edge_residual(pose_i: jax.Array, pose_j: jax.Array,
                   meas: jax.Array) -> jax.Array:
    ti = SE3.from_tangent(pose_i)
    tj = SE3.from_tangent(pose_j)
    z = SE3.from_tangent(meas)
    return z.inverse().compose(ti.inverse().compose(tj)).log()


@functools.partial(jax.jit, static_argnames=("nb_iters",))
def optimize_pose_graph(graph: PoseGraph, *, nb_iters: int = 20,
                        damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton with the first pose gauge-fixed."""
    n = graph.poses.shape[0]

    def step(poses, _):
        def res_fn(flat):
            ps = flat.reshape(n, 6)
            r = jax.vmap(_edge_residual)(
                ps[graph.edge_i], ps[graph.edge_j], graph.meas)
            return (r * jnp.sqrt(graph.weight)[:, None]).reshape(-1)

        flat = poses.reshape(-1)
        r = res_fn(flat)
        jmat = jax.jacfwd(res_fn)(flat)          # (6E, 6N) dense
        # Gauge fix: zero the first pose's columns.
        jmat = jmat.at[:, :6].set(0.0)
        h = matmul(jmat.T, jmat) + damping * jnp.eye(6 * n)
        g = matmul(jmat.T, r)
        dx = jnp.linalg.solve(h, -g)
        return (flat + dx).reshape(n, 6), jnp.sum(r * r)

    poses, costs = jax.lax.scan(step, graph.poses, None, length=nb_iters)
    return graph._replace(poses=poses)


def pose_graph_cost(graph: PoseGraph) -> jax.Array:
    r = jax.vmap(_edge_residual)(
        graph.poses[graph.edge_i], graph.poses[graph.edge_j], graph.meas)
    return jnp.sum(graph.weight[:, None] * r * r)

"""Batched SE(3) pose-graph optimization.

Replaces Optimizer::OptimizeEssentialGraph
(/root/reference/src/Optimizer.cc:1410 — g2o Sim3 vertices over the
covisibility spanning tree + loop edges). For stereo/RGB-D the reference
fixes scale=1 (FixScale=true), so the graph is SE(3) here; the Sim(3) drift
dimension matters only for monocular, which layers on later via lie.sim3.

Formulation: edges carry measured relatives Z_ij = T_i T_j^-1 (camera-from-
world convention, matching the reference's Tcw). Residual
r = log(Z_ij^-1 T_i T_j^-1); Jacobians wrt the left-multiplicative tangents
of both endpoints come from vmapped AD (exact, batched); the 6Kx6K normal
system is scatter-assembled and solved densely as matmuls. Fixed poses
(the loop keyframe, ref :1460) are masked.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray   # (K,3,3)
    t: jnp.ndarray   # (K,3)
    final_cost: jnp.ndarray


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rz, tz):
    """r = log(Z^-1 * exp(xi_i) T_i * (exp(xi_j) T_j)^-1)."""
    dRi, dti = lie.se3_exp(xi_i)
    dRj, dtj = lie.se3_exp(xi_j)
    Ri2, ti2 = lie.se3_compose(dRi, dti, Ri, ti)
    Rj2, tj2 = lie.se3_compose(dRj, dtj, Rj, tj)
    Rji, tji = lie.se3_inv(Rj2, tj2)
    Rrel, trel = lie.se3_compose(Ri2, ti2, Rji, tji)
    Rzi, tzi = lie.se3_inv(Rz, tz)
    Re, te = lie.se3_compose(Rzi, tzi, Rrel, trel)
    return lie.se3_log(Re, te)


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph(kf_R: jnp.ndarray, kf_t: jnp.ndarray,
                        fixed: jnp.ndarray,
                        e_i: jnp.ndarray, e_j: jnp.ndarray,
                        e_R: jnp.ndarray, e_t: jnp.ndarray,
                        e_w: jnp.ndarray, e_valid: jnp.ndarray,
                        n_iters: int = 12,
                        lam: float = 1e-6) -> PoseGraphResult:
    """Optimize K poses over E relative edges.

    Args:
      fixed: (K,) bool — poses excluded from updates (gauge / loop KF).
      e_i/e_j: (E,) endpoint indices; e_R/e_t: (E,3,3),(E,3) measured
      Z_ij = T_i T_j^-1; e_w: (E,) edge weight; e_valid: (E,) bool.
    """
    K = kf_R.shape[0]
    dt = kf_R.dtype
    zero6 = jnp.zeros(6, dt)

    res_fn = jax.vmap(_edge_residual,
                      in_axes=(None, None, 0, 0, 0, 0, 0, 0))
    jac_fn = jax.vmap(jax.jacrev(_edge_residual, argnums=(0, 1)),
                      in_axes=(None, None, 0, 0, 0, 0, 0, 0))

    def iteration(state, _):
        R_all, t_all = state
        Ri, ti = R_all[e_i], t_all[e_i]
        Rj, tj = R_all[e_j], t_all[e_j]
        r = res_fn(zero6, zero6, Ri, ti, Rj, tj, e_R, e_t)      # (E,6)
        Ji, Jj = jac_fn(zero6, zero6, Ri, ti, Rj, tj, e_R, e_t)  # (E,6,6)
        w = (e_w * e_valid)[:, None, None]
        Ji = Ji * jnp.where(fixed[e_i], 0.0, 1.0)[:, None, None]
        Jj = Jj * jnp.where(fixed[e_j], 0.0, 1.0)[:, None, None]

        H = jnp.zeros((K, K, 6, 6), dt)
        H = H.at[e_i, e_i].add(w * jnp.einsum("eki,ekj->eij", Ji, Ji))
        H = H.at[e_j, e_j].add(w * jnp.einsum("eki,ekj->eij", Jj, Jj))
        H = H.at[e_i, e_j].add(w * jnp.einsum("eki,ekj->eij", Ji, Jj))
        H = H.at[e_j, e_i].add(w * jnp.einsum("eki,ekj->eij", Jj, Ji))
        b = jnp.zeros((K, 6), dt)
        b = b.at[e_i].add(-jnp.einsum("eki,ek->ei", Ji * w, r))
        b = b.at[e_j].add(-jnp.einsum("eki,ek->ei", Jj * w, r))

        Hb = H.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
        # fixed poses: identity rows
        diag_fix = jnp.repeat(fixed, 6)
        Hb = Hb + jnp.diag(diag_fix.astype(dt) * 1e6 + lam) \
            + 1e-8 * jnp.eye(K * 6, dtype=dt)
        dx = jnp.linalg.solve(Hb, b.reshape(K * 6)).reshape(K, 6)
        dx = dx * jnp.where(fixed, 0.0, 1.0)[:, None]
        dR, dtv = lie.se3_exp(dx)
        R_new, t_new = lie.se3_compose(dR, dtv, R_all, t_all)
        R_new = lie.normalize_rotation(R_new)
        cost = jnp.sum(jnp.sum(r * r, -1) * e_w * e_valid)
        return (R_new, t_new), cost

    (R_f, t_f), costs = jax.lax.scan(iteration, (kf_R, kf_t), None,
                                     length=n_iters)
    return PoseGraphResult(R=R_f, t=t_f, final_cost=costs[-1])


def relative_pose(Ri, ti, Rj, tj):
    """Z_ij = T_i * T_j^-1 for edge construction."""
    Rji, tji = lie.se3_inv(Rj, tj)
    return lie.se3_compose(Ri, ti, Rji, tji)


# ---------------------------------------------------------------------------
# 4-DoF variant — the inertial essential graph (ref
# Optimizer::OptimizeEssentialGraph4DoF, /root/reference/src/Optimizer.cc:5174,
# vertices VertexPose4DoF: once the IMU has observed gravity, pitch and roll
# are globally observable, so loop correction must only redistribute yaw (about
# the gravity axis) + translation).
# ---------------------------------------------------------------------------


class Graph4DoFResult(NamedTuple):
    R: jnp.ndarray   # (K,3,3)
    t: jnp.ndarray   # (K,3)
    final_cost: jnp.ndarray


def _apply_4dof(x4, up, R, t):
    """World-frame 4-DoF update of a camera-from-world pose: T_wc' =
    DT * T_wc with DT = (exp(yaw*up), dt_world) — i.e. T_cw' = T_cw *
    DT^-1. `up` is the unit gravity-up axis in world coordinates."""
    Rz = lie.so3_exp(x4[3] * up)
    Rzi = Rz.T
    dti = -Rzi @ x4[:3]
    return R @ Rzi, R @ dti + t


def _edge_residual_4dof(x_i, x_j, up, Ri, ti, Rj, tj, Rz, tz):
    Ri2, ti2 = _apply_4dof(x_i, up, Ri, ti)
    Rj2, tj2 = _apply_4dof(x_j, up, Rj, tj)
    Rji, tji = lie.se3_inv(Rj2, tj2)
    Rrel, trel = lie.se3_compose(Ri2, ti2, Rji, tji)
    Rzi, tzi = lie.se3_inv(Rz, tz)
    Re, te = lie.se3_compose(Rzi, tzi, Rrel, trel)
    return lie.se3_log(Re, te)


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph_4dof(kf_R: jnp.ndarray, kf_t: jnp.ndarray,
                             up: jnp.ndarray, fixed: jnp.ndarray,
                             e_i: jnp.ndarray, e_j: jnp.ndarray,
                             e_R: jnp.ndarray, e_t: jnp.ndarray,
                             e_w: jnp.ndarray, e_valid: jnp.ndarray,
                             n_iters: int = 12,
                             lam: float = 1e-6) -> Graph4DoFResult:
    """4-DoF (yaw about `up` + translation) pose-graph optimization.

    Same edge structure as optimize_pose_graph; the residual is still the
    full se(3) log (6-dim) so pitch/roll disagreements contribute cost, but
    the update can only move yaw/translation — exactly the reference's
    VertexPose4DoF behavior."""
    K = kf_R.shape[0]
    dt = kf_R.dtype
    zero4 = jnp.zeros(4, dt)
    up = up / jnp.maximum(jnp.linalg.norm(up), 1e-9)

    res_fn = jax.vmap(_edge_residual_4dof,
                      in_axes=(None, None, None, 0, 0, 0, 0, 0, 0))
    jac_fn = jax.vmap(jax.jacrev(_edge_residual_4dof, argnums=(0, 1)),
                      in_axes=(None, None, None, 0, 0, 0, 0, 0, 0))

    def iteration(state, _):
        R_all, t_all = state
        args = (R_all[e_i], t_all[e_i], R_all[e_j], t_all[e_j], e_R, e_t)
        r = res_fn(zero4, zero4, up, *args)       # (E,6)
        Ji, Jj = jac_fn(zero4, zero4, up, *args)  # (E,6,4)
        w = (e_w * e_valid)[:, None, None]
        Ji = Ji * jnp.where(fixed[e_i], 0.0, 1.0)[:, None, None]
        Jj = Jj * jnp.where(fixed[e_j], 0.0, 1.0)[:, None, None]

        H = jnp.zeros((K, K, 4, 4), dt)
        H = H.at[e_i, e_i].add(w * jnp.einsum("eki,ekj->eij", Ji, Ji))
        H = H.at[e_j, e_j].add(w * jnp.einsum("eki,ekj->eij", Jj, Jj))
        H = H.at[e_i, e_j].add(w * jnp.einsum("eki,ekj->eij", Ji, Jj))
        H = H.at[e_j, e_i].add(w * jnp.einsum("eki,ekj->eij", Jj, Ji))
        b = jnp.zeros((K, 4), dt)
        b = b.at[e_i].add(-jnp.einsum("eki,ek->ei", Ji * w, r))
        b = b.at[e_j].add(-jnp.einsum("eki,ek->ei", Jj * w, r))

        Hb = H.transpose(0, 2, 1, 3).reshape(K * 4, K * 4)
        diag_fix = jnp.repeat(fixed, 4)
        Hb = Hb + jnp.diag(diag_fix.astype(dt) * 1e6 + lam) \
            + 1e-8 * jnp.eye(K * 4, dtype=dt)
        dx = jnp.linalg.solve(Hb, b.reshape(K * 4)).reshape(K, 4)
        dx = dx * jnp.where(fixed, 0.0, 1.0)[:, None]
        R_new, t_new = jax.vmap(_apply_4dof, in_axes=(0, None, 0, 0))(
            dx, up, R_all, t_all)
        R_new = lie.normalize_rotation(R_new)
        cost = jnp.sum(jnp.sum(r * r, -1) * e_w * e_valid)
        return (R_new, t_new), cost

    (R_f, t_f), costs = jax.lax.scan(iteration, (kf_R, kf_t), None,
                                     length=n_iters)
    return Graph4DoFResult(R=R_f, t=t_f, final_cost=costs[-1])


# ---------------------------------------------------------------------------
# Sim(3) variant — the monocular essential graph (ref
# OptimizeEssentialGraph with bFixScale=false, src/Optimizer.cc:1410:
# monocular loop closure must absorb scale drift, so vertices are 7-DoF).
# ---------------------------------------------------------------------------


class Sim3GraphResult(NamedTuple):
    s: jnp.ndarray   # (K,)
    R: jnp.ndarray   # (K,3,3)
    t: jnp.ndarray   # (K,3)
    final_cost: jnp.ndarray


def _edge_residual_sim3(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, sz, Rz, tz):
    """r = log(Z^-1 * exp(xi_i) S_i * (exp(xi_j) S_j)^-1) in sim(3)."""
    dsi, dRi, dti = lie.sim3_exp(xi_i)
    dsj, dRj, dtj = lie.sim3_exp(xi_j)
    si2, Ri2, ti2 = lie.sim3_compose(dsi, dRi, dti, si, Ri, ti)
    sj2, Rj2, tj2 = lie.sim3_compose(dsj, dRj, dtj, sj, Rj, tj)
    sji, Rji, tji = lie.sim3_inv(sj2, Rj2, tj2)
    srel, Rrel, trel = lie.sim3_compose(si2, Ri2, ti2, sji, Rji, tji)
    szi, Rzi, tzi = lie.sim3_inv(sz, Rz, tz)
    se, Re, te = lie.sim3_compose(szi, Rzi, tzi, srel, Rrel, trel)
    return lie.sim3_log(se, Re, te)


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph_sim3(kf_s: jnp.ndarray, kf_R: jnp.ndarray,
                             kf_t: jnp.ndarray, fixed: jnp.ndarray,
                             e_i: jnp.ndarray, e_j: jnp.ndarray,
                             e_s: jnp.ndarray, e_R: jnp.ndarray,
                             e_t: jnp.ndarray, e_w: jnp.ndarray,
                             e_valid: jnp.ndarray, n_iters: int = 12,
                             lam: float = 1e-6) -> Sim3GraphResult:
    """7-DoF pose-graph optimization over E relative Sim(3) edges.

    Same structure as optimize_pose_graph with a 7-dim tangent; edge
    measurements Z_ij = S_i S_j^-1 carry scale (1 for odometry edges built
    before drift, s_loop for the closing edge)."""
    K = kf_R.shape[0]
    dt = kf_R.dtype
    zero7 = jnp.zeros(7, dt)

    res_fn = jax.vmap(_edge_residual_sim3,
                      in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))
    jac_fn = jax.vmap(jax.jacrev(_edge_residual_sim3, argnums=(0, 1)),
                      in_axes=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))

    def iteration(state, _):
        s_all, R_all, t_all = state
        args = (s_all[e_i], R_all[e_i], t_all[e_i],
                s_all[e_j], R_all[e_j], t_all[e_j], e_s, e_R, e_t)
        r = res_fn(zero7, zero7, *args)        # (E,7)
        Ji, Jj = jac_fn(zero7, zero7, *args)   # (E,7,7)
        w = (e_w * e_valid)[:, None, None]
        Ji = Ji * jnp.where(fixed[e_i], 0.0, 1.0)[:, None, None]
        Jj = Jj * jnp.where(fixed[e_j], 0.0, 1.0)[:, None, None]

        H = jnp.zeros((K, K, 7, 7), dt)
        H = H.at[e_i, e_i].add(w * jnp.einsum("eki,ekj->eij", Ji, Ji))
        H = H.at[e_j, e_j].add(w * jnp.einsum("eki,ekj->eij", Jj, Jj))
        H = H.at[e_i, e_j].add(w * jnp.einsum("eki,ekj->eij", Ji, Jj))
        H = H.at[e_j, e_i].add(w * jnp.einsum("eki,ekj->eij", Jj, Ji))
        b = jnp.zeros((K, 7), dt)
        b = b.at[e_i].add(-jnp.einsum("eki,ek->ei", Ji * w, r))
        b = b.at[e_j].add(-jnp.einsum("eki,ek->ei", Jj * w, r))

        Hb = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
        diag_fix = jnp.repeat(fixed, 7)
        Hb = Hb + jnp.diag(diag_fix.astype(dt) * 1e6 + lam) \
            + 1e-8 * jnp.eye(K * 7, dtype=dt)
        dx = jnp.linalg.solve(Hb, b.reshape(K * 7)).reshape(K, 7)
        dx = dx * jnp.where(fixed, 0.0, 1.0)[:, None]
        ds, dR, dtv = lie.sim3_exp(dx)
        s_new, R_new, t_new = lie.sim3_compose(ds, dR, dtv,
                                               s_all, R_all, t_all)
        R_new = lie.normalize_rotation(R_new)
        cost = jnp.sum(jnp.sum(r * r, -1) * e_w * e_valid)
        return (s_new, R_new, t_new), cost

    (s_f, R_f, t_f), costs = jax.lax.scan(
        iteration, (kf_s, kf_R, kf_t), None, length=n_iters)
    return Sim3GraphResult(s=s_f, R=R_f, t=t_f, final_cost=costs[-1])

"""Motion-only pose optimization (batched Levenberg-Marquardt).

Replaces Optimizer::PoseOptimization (/root/reference/src/Optimizer.cc:759):
g2o SE3 vertex + mono/stereo unary edges, 4 rounds x 10 LM iterations with
Huber (delta^2 = 5.991 mono / 7.815 stereo) and chi2 outlier toggling
between rounds.

Formulation: all residuals at once. Each iteration builds the 6x6
normal equations by batched Jacobian contraction (einsum -> matmul), solves on
device, and applies a left-multiplicative update exp(xi) * T_cw. Outlier
state is a mask recomputed between rounds exactly like the reference's
4-round chi2 toggle. Everything is lax.fori_loop'd: one fused jit, zero
host round-trips.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import cameras, lie, robust

MONO_CHI2 = robust.CHI2_2DOF    # 5.991
STEREO_CHI2 = robust.CHI2_3DOF  # 7.815


class PoseOptResult(NamedTuple):
    R: jnp.ndarray        # (3,3) optimized world->camera rotation
    t: jnp.ndarray        # (3,)
    inlier: jnp.ndarray   # (N,) bool final inlier mask
    n_inliers: jnp.ndarray  # () int32
    chi2: jnp.ndarray     # () float32 robust total


def _residuals_jac(model, params, bf, R, t, X, uv, u_right, is_stereo):
    """Residuals (N,3) [du, dv, duR] + Jacobian (N,3,6) wrt [v,w] tangent.

    Stereo rows use uR_pred = u_pred - bf/z (ref EdgeStereoSE3 style);
    mono rows mask the third component.
    """
    Xc = lie.se3_apply(R, t, X)
    uv_pred = cameras.project(model, params, Xc)
    z = jnp.maximum(Xc[..., 2], 1e-6)
    ur_pred = uv_pred[..., 0] - bf / z
    r2 = uv - uv_pred
    r3 = jnp.where(is_stereo, u_right - ur_pred, 0.0)
    res = jnp.concatenate([r2, r3[..., None]], axis=-1)  # (N,3)

    Jproj = cameras.project_jac(model, params, Xc)       # (N,2,3)
    # d(uR)/dXc = d(u)/dXc + bf/z^2 * dz/dXc
    dur = Jproj[:, 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), bf / (z * z)], axis=-1)
    J3 = jnp.concatenate([Jproj, dur[:, None, :]], axis=1)  # (N,3,3)
    # dXc/dxi with left perturbation exp(xi) T: dXc/dv = I, dXc/dw = -hat(Xc)
    dXc = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=X.dtype), Xc.shape[:-1] + (3, 3)),
         -lie.hat(Xc)], axis=-1)                            # (N,3,6)
    J = -jnp.einsum("nij,njk->nik", J3, dXc)                # residual = obs-pred
    J = jnp.where(is_stereo[..., None, None],
                  J, J * jnp.asarray([1.0, 1.0, 0.0], dtype=J.dtype)[None, :, None])
    return res, J


@partial(jax.jit, static_argnames=("model", "n_rounds", "n_iters"))
def pose_optimize(model: int, params: jnp.ndarray, bf: jnp.ndarray,
                  R0: jnp.ndarray, t0: jnp.ndarray,
                  X: jnp.ndarray, uv: jnp.ndarray, u_right: jnp.ndarray,
                  sigma2: jnp.ndarray, mask: jnp.ndarray,
                  n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """LM motion-only BA.

    Args:
      X: (N,3) world points; uv: (N,2) observations; u_right: (N,) stereo u
         (<0 => mono observation); sigma2: (N,) per-octave measurement
         variance (scale^2); mask: (N,) valid observation.
    """
    dt = R0.dtype
    params = params.astype(dt)
    bf = jnp.asarray(bf, dtype=dt)
    t0 = t0.astype(dt)
    X = X.astype(dt)
    uv = uv.astype(dt)
    u_right = u_right.astype(dt)
    sigma2 = sigma2.astype(dt)
    is_stereo = u_right >= 0.0
    w_info = 1.0 / jnp.maximum(sigma2, 1e-12)

    def chi2_of(res):
        # per-edge chi2 with information weighting (2dof mono / 3dof stereo)
        return jnp.sum(res * res, axis=-1) * w_info

    hub_d2 = jnp.where(is_stereo, STEREO_CHI2, MONO_CHI2)

    def robust_cost(res, inlier):
        chi2 = chi2_of(res)
        w_rob = robust.huber_weight(chi2, hub_d2)
        return jnp.sum(jnp.minimum(chi2, hub_d2 * 10) * w_rob * inlier)

    def lm_round(carry, delta2_gate):
        R, t, inlier = carry

        def body(_, st):
            # carried-residual LM: `res` was evaluated at the CURRENT
            # accepted (R, t) — one residual evaluation per iteration
            # (the candidate's residuals become next iteration's `res` on
            # accept), half the evals of the classic eval-twice loop
            R, t, res, cost, lam = st
            _, J = _residuals_jac(model, params, bf, R, t, X, uv, u_right,
                                  is_stereo)
            chi2 = chi2_of(res)
            w_rob = robust.huber_weight(chi2, hub_d2)
            w = w_rob * w_info * inlier
            JW = J * w[:, None, None]
            H = jnp.einsum("nij,nik->jk", JW, J)
            g = -jnp.einsum("nij,ni->j", JW, res)  # J = dr/dxi => step -H^-1 J^T W r
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6, dtype=H.dtype)
            # closed-form block solve instead of linalg.solve's pivoted LU
            # (a serial chain for a 6x6)
            xi = lie.solve_psd6(Hd, g)
            Rn, tn = lie.se3_compose(*lie.se3_exp(xi), R, t)
            Rn = lie.normalize_rotation(Rn)
            # accept if robust cost decreased
            res_n, _ = _residuals_jac(model, params, bf, Rn, tn, X, uv,
                                      u_right, is_stereo)
            c_new = robust_cost(res_n, inlier)
            good = c_new < cost
            R = jnp.where(good, Rn, R)
            t = jnp.where(good, tn, t)
            res = jnp.where(good, res_n, res)
            cost = jnp.where(good, c_new, cost)
            lam = jnp.where(good, lam * 0.5, lam * 4.0)
            return R, t, res, cost, lam

        res0, _ = _residuals_jac(model, params, bf, R, t, X, uv, u_right,
                                 is_stereo)
        R, t, _, _, _ = jax.lax.fori_loop(
            0, n_iters, body,
            (R, t, res0, robust_cost(res0, inlier),
             jnp.asarray(1e-3, dtype=R.dtype)))
        # re-gate outliers for the next round (ref chi2 cut per round)
        res, _ = _residuals_jac(model, params, bf, R, t, X, uv, u_right, is_stereo)
        chi2 = chi2_of(res)
        gate = jnp.where(is_stereo, delta2_gate[1], delta2_gate[0])
        inlier = mask & (chi2 <= gate) & (lie.se3_apply(R, t, X)[..., 2] > 0)
        return (R, t, inlier), None

    inlier0 = mask
    carry = (R0, t0, inlier0)
    gates = jnp.asarray([[MONO_CHI2, STEREO_CHI2]] * n_rounds, dtype=R0.dtype)
    carry, _ = jax.lax.scan(lm_round, carry, gates)
    R, t, inlier = carry
    res, _ = _residuals_jac(model, params, bf, R, t, X, uv, u_right, is_stereo)
    chi2 = jnp.sum(chi2_of(res) * inlier)
    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=jnp.sum(inlier).astype(jnp.int32),
                         chi2=chi2)

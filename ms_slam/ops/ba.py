"""Batched Schur-complement bundle adjustment.

Replaces g2o's SparseOptimizer + BlockSolver_6_3 as used by
Optimizer::LocalBundleAdjustment (/root/reference/src/Optimizer.cc:1040) and
GlobalBundleAdjustemnt (:51): Levenberg-damped Gauss-Newton over SE(3) camera
blocks and 3D point blocks with Huber robustification and chi2 outlier
removal at the end (the reference's two-stage 5+5 iteration schedule).

Formulation (one fused jit, no host round-trips):
- every observation is a row in a static-capacity factor table
  (cam idx, point idx, uv, uR, sigma2, valid);
- per-iteration: batched residual/Jacobian -> segment-sum into per-camera
  6x6 blocks, per-point 3x3 blocks, and the camera-point coupling W
  scattered into a dense (P, C*6, 3) tensor (C is small for local BA);
- Schur: S = Hcc - sum_p W_p Hpp_p^-1 W_p^T, one dense solve on the reduced
  camera system (matmul einsums), then point back-substitution;
- fixed cameras (the reference's "fixed KFs" gauge anchors) simply have
  their Jacobian columns masked out.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import cameras, lie, robust


from .lie import inv3x3, solve3x3


class BAResult(NamedTuple):
    kf_R: jnp.ndarray
    kf_t: jnp.ndarray
    mp_pos: jnp.ndarray
    f_chi2: jnp.ndarray    # (F,) final per-factor chi2
    f_inlier: jnp.ndarray  # (F,) bool (chi2 gate at the reference cuts)


def _factor_res_jac(model, params, bf, R_all, t_all, P_all,
                    f_cam, f_pt, f_uv, f_ur, is_stereo):
    """Residual (F,3) and Jacobians wrt camera tangent (F,3,6) and point
    position (F,3,3)."""
    R = R_all[f_cam]
    t = t_all[f_cam]
    X = P_all[f_pt]
    Xc = lie.se3_apply(R, t, X)
    uv_pred = cameras.project(model, params, Xc)
    z = jnp.maximum(Xc[..., 2], 1e-6)
    ur_pred = uv_pred[..., 0] - bf / z
    r2 = f_uv - uv_pred
    r3 = jnp.where(is_stereo, f_ur - ur_pred, 0.0)
    res = jnp.concatenate([r2, r3[..., None]], axis=-1)

    Jproj = cameras.project_jac(model, params, Xc)  # (F,2,3)
    dur = Jproj[:, 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), bf / (z * z)], axis=-1)
    J3 = jnp.concatenate([Jproj, dur[:, None, :]], axis=1)  # (F,3,3) d(uvr)/dXc
    stereo_row = jnp.where(is_stereo[:, None, None],
                           jnp.ones((1, 3, 1), J3.dtype),
                           jnp.asarray([1.0, 1.0, 0.0], J3.dtype)[None, :, None])
    J3 = J3 * stereo_row
    # camera: left perturbation exp(xi) T => dXc/dv=I, dXc/dw=-hat(Xc)
    dXc_dxi = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape[:-1] + (3, 3)),
         -lie.hat(Xc)], axis=-1)                       # (F,3,6)
    Jc = -jnp.einsum("fij,fjk->fik", J3, dXc_dxi)      # dres/dxi
    Jp = -jnp.einsum("fij,fjk->fik", J3, R)            # dres/dXw
    return res, Jc, Jp, Xc[..., 2]


@partial(jax.jit, static_argnames=("model", "n_sweeps", "n_iters"))
def ba_alternate(model: int, params: jnp.ndarray, bf: jnp.ndarray,
                 kf_R: jnp.ndarray, kf_t: jnp.ndarray, cam_opt: jnp.ndarray,
                 mp_pos: jnp.ndarray, pt_opt: jnp.ndarray,
                 f_cam: jnp.ndarray, f_pt: jnp.ndarray, f_uv: jnp.ndarray,
                 f_ur: jnp.ndarray, f_sigma2: jnp.ndarray,
                 f_valid: jnp.ndarray,
                 n_sweeps: int = 3, n_iters: int = 2, lam: float = 1e-3):
    """Resection-intersection bundle adjustment: alternate point-only and
    camera-only Gauss-Newton passes. Each pass needs only block-diagonal
    Hessians (per-point 3x3 / per-camera 6x6 scatter-adds), so it scales to
    the FULL map — the global-BA stage after loop closure
    (ref Optimizer::GlobalBundleAdjustemnt, src/Optimizer.cc:51, where g2o
    runs 10 joint iterations; alternation trades per-iteration progress for
    O(map) memory and total parallelism)."""
    C = kf_R.shape[0]
    P = mp_pos.shape[0]
    dt = kf_R.dtype
    params = params.astype(dt)
    bf = jnp.asarray(bf, dt)
    is_stereo = f_ur >= 0.0
    w_info = jnp.where(f_valid, 1.0 / jnp.maximum(f_sigma2, 1e-12), 0.0)
    hub_d2 = jnp.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)

    def weights(res, z):
        chi2 = jnp.sum(res * res, axis=-1) * w_info
        return robust.huber_weight(chi2, hub_d2) * w_info * (z > 1e-2)

    def point_pass(state, _):
        R_all, t_all, P_all = state
        res, _, Jp, z = _factor_res_jac(model, params, bf, R_all, t_all,
                                        P_all, f_cam, f_pt, f_uv, f_ur,
                                        is_stereo)
        w = weights(res, z)
        Jp = jnp.where(pt_opt[f_pt][:, None, None], Jp, 0.0)
        JpW = Jp * w[:, None, None]
        Hpp = jnp.zeros((P, 3, 3), dt).at[f_pt].add(
            jnp.einsum("fij,fik->fjk", JpW, Jp))
        bp = jnp.zeros((P, 3), dt).at[f_pt].add(
            -jnp.einsum("fij,fi->fj", JpW, res))
        Hpp = Hpp + lam * jax.vmap(
            lambda h: jnp.diag(jnp.diag(h)))(Hpp) + 1e-8 * jnp.eye(3, dtype=dt)
        dxp = solve3x3(Hpp, bp) * pt_opt[:, None]
        return (R_all, t_all, P_all + dxp), None

    def cam_pass(state, _):
        R_all, t_all, P_all = state
        res, Jc, _, z = _factor_res_jac(model, params, bf, R_all, t_all,
                                        P_all, f_cam, f_pt, f_uv, f_ur,
                                        is_stereo)
        w = weights(res, z)
        Jc = jnp.where(cam_opt[f_cam][:, None, None], Jc, 0.0)
        JcW = Jc * w[:, None, None]
        Hcc = jnp.zeros((C, 6, 6), dt).at[f_cam].add(
            jnp.einsum("fij,fik->fjk", JcW, Jc))
        bc = jnp.zeros((C, 6), dt).at[f_cam].add(
            -jnp.einsum("fij,fi->fj", JcW, res))
        Hcc = Hcc + lam * jax.vmap(
            lambda h: jnp.diag(jnp.diag(h)))(Hcc) + 1e-8 * jnp.eye(6, dtype=dt)
        dxc = jnp.linalg.solve(Hcc, bc[..., None])[..., 0] * cam_opt[:, None]
        dR, dtc = lie.se3_exp(dxc)
        R_new, t_new = lie.se3_compose(dR, dtc, R_all, t_all)
        return (lie.normalize_rotation(R_new), t_new, P_all), None

    def sweep(state, _):
        state, _ = jax.lax.scan(point_pass, state, None, length=n_iters)
        state, _ = jax.lax.scan(cam_pass, state, None, length=n_iters)
        return state, None

    state, _ = jax.lax.scan(sweep, (kf_R, kf_t, mp_pos), None,
                            length=n_sweeps)
    return state


@partial(jax.jit, static_argnames=("model", "n_iters", "cam_blocked"))
def ba_solve(model: int, params: jnp.ndarray, bf: jnp.ndarray,
             kf_R: jnp.ndarray, kf_t: jnp.ndarray, cam_opt: jnp.ndarray,
             mp_pos: jnp.ndarray, pt_opt: jnp.ndarray,
             f_cam: jnp.ndarray, f_pt: jnp.ndarray, f_uv: jnp.ndarray,
             f_ur: jnp.ndarray, f_sigma2: jnp.ndarray, f_valid: jnp.ndarray,
             n_iters: int = 10, lam: float = 1e-4,
             cam_blocked: bool = False) -> BAResult:
    """Bundle adjust C cameras and P points over F factors.

    cam_opt: (C,) bool — False = fixed camera (gauge anchor).
    pt_opt:  (P,) bool — False = fixed point.
    cam_blocked: promise that the factor table is camera-block-ordered
    (f_cam == repeat(arange(C), F//C), as the (C,N) observation layout
    produces) AND that each (point, camera) pair appears at most once
    (true of any real observation table; duplicate entries a fuse-merge
    remap may leave in one row are deduplicated here, which the reference
    does too — MapPoint::Replace erases the duplicate observation). The
    point-block Hessian/coupling then assembles by an inverse-observation
    table + (P,C)-shaped gathers — a few MB of device-memory traffic per iteration
    instead of the (F,P) one-hot matmuls (268 MB/iteration at production
    shapes, which dominated the solve).
    """
    C = kf_R.shape[0]
    P = mp_pos.shape[0]
    F_ = f_cam.shape[0]
    dt = kf_R.dtype
    params = params.astype(dt)
    bf = jnp.asarray(bf, dt)
    is_stereo = f_ur >= 0.0
    w_info = jnp.where(f_valid, 1.0 / jnp.maximum(f_sigma2, 1e-12), 0.0)
    hub_d2 = jnp.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)

    if cam_blocked:
        # inverse observation table: factor row of point p in camera c
        # (F_ = "none"). Built once; static across iterations. A scatter-min
        # keeps the LOWEST factor index of duplicate (point, camera) factors
        # on every backend; a scatter-set's winner is implementation-defined
        # (run-dependent on the GPU).
        inv_f = jnp.full((P, C), F_, jnp.int32).at[
            jnp.where(f_valid, jnp.clip(f_pt, 0, P - 1), P),
            jnp.clip(f_cam, 0, C - 1)].min(
            jnp.arange(F_, dtype=jnp.int32), mode="drop")

        # a duplicate (point, camera) factor lost the inv_f write: zero its
        # weight everywhere (consistent linearization) and flag it as an
        # outlier so the caller erases the duplicate observation (the
        # reference's MapPoint::Replace erase)
        dup_keep = (inv_f[jnp.clip(f_pt, 0, P - 1),
                          jnp.clip(f_cam, 0, C - 1)]
                    == jnp.arange(F_, dtype=jnp.int32))
        w_info = jnp.where(dup_keep, w_info, 0.0)
        f_valid = f_valid & dup_keep

        if dt == jnp.float32:
            # per-camera one-hot (C, N, P) in bf16 (0/1 exact), built once:
            # point-block accumulation then runs as a batched bf16 matmul
            # (against the f64 path's inverse-table gather it is
            # unmeasured on the H100, ROADMAP S4). Values go in as an exact bf16 hi/lo split so the
            # f32-accumulated result keeps ~f32 precision — plain-bf16
            # one-hot accumulation was measured to thin the map via
            # chi2-outlier cascades (0.4% Hessian rounding)
            Nb = F_ // C
            oh3 = jax.nn.one_hot(
                jnp.where(f_valid, jnp.clip(f_pt, 0, P - 1),
                          P).reshape(C, Nb),
                P, dtype=jnp.bfloat16)                       # (C,Nb,P)

            def pt_accumulate(x_f):
                """Σ_f x[f] grouped by (point, camera): (F,k)->(P,C,k)."""
                k = x_f.shape[-1]
                v = x_f.reshape(C, Nb, k)
                # hi part via mantissa masking, NOT v.astype(bf16): XLA's
                # excess-precision elision folds convert(convert(v,bf16),
                # f32) back to v, which silently turns `lo` into zero and
                # degrades the whole accumulation to plain bf16 (measured
                # 0.2% error — enough to lose tracking e2e). The integer
                # mask cannot be folded; measured pair error ~1e-5.
                bits = jax.lax.bitcast_convert_type(v, jnp.uint32)
                hi32 = jax.lax.bitcast_convert_type(
                    bits & jnp.uint32(0xFFFF0000), dt)
                hi = hi32.astype(jnp.bfloat16)
                lo = (v - hi32).astype(jnp.bfloat16)
                acc = (jax.lax.dot_general(
                           oh3, hi, (((1,), (1,)), ((0,), (0,))),
                           preferred_element_type=dt)
                       + jax.lax.dot_general(
                           oh3, lo, (((1,), (1,)), ((0,), (0,))),
                           preferred_element_type=dt))       # (C,P,k)
                return acc.transpose(1, 0, 2)
        else:
            # f64 path (tests under jax_enable_x64): inverse-table gather
            def pt_accumulate(x_f):
                pad = jnp.concatenate(
                    [x_f, jnp.zeros((1,) + x_f.shape[1:], x_f.dtype)])
                return pad[inv_f]                            # (P,C,k)
    else:
        # fall back to one-hot matmul accumulation for arbitrary tables
        oh_p = jax.nn.one_hot(f_pt, P, dtype=dt)   # (F,P)
        oh_c = jax.nn.one_hot(f_cam, C, dtype=dt)  # (F,C)

        def oh_matmul(oh, x):
            return jax.lax.dot_general(
                oh.T, x.astype(dt), (((1,), (0,)), ((), ())),
                preferred_element_type=dt)

    def iteration(state, keep):
        R_all, t_all, P_all = state
        res, Jc, Jp, z = _factor_res_jac(model, params, bf, R_all, t_all,
                                         P_all, f_cam, f_pt, f_uv, f_ur,
                                         is_stereo)
        chi2 = jnp.sum(res * res, axis=-1) * w_info
        # deactivate behind-camera factors this iteration (g2o edges check
        # depth positivity; without this a clamped z ~ 1e-6 explodes the
        # normal equations)
        active = (z > 1e-2) & keep
        w = robust.huber_weight(chi2, hub_d2) * w_info * active
        # mask fixed cameras / points via Jacobian zeroing
        Jc = jnp.where(cam_opt[f_cam][:, None, None], Jc, 0.0)
        Jp = jnp.where(pt_opt[f_pt][:, None, None], Jp, 0.0)

        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]

        outer_c = jnp.einsum("fij,fik->fjk", JcW, Jc).reshape(F_, 36)
        gc = -jnp.einsum("fij,fi->fj", JcW, res)
        if cam_blocked:
            Hcc = outer_c.reshape(C, F_ // C, 36).sum(1).reshape(C, 6, 6)
            bc = gc.reshape(C, F_ // C, 6).sum(1)
        else:
            Hcc = oh_matmul(oh_c, outer_c).reshape(C, 6, 6)
            bc = jnp.zeros((C, 6), dt).at[f_cam].add(gc)
        outer_p = jnp.einsum("fij,fik->fjk", JpW, Jp).reshape(F_, 9)
        gp = -jnp.einsum("fij,fi->fj", JpW, res)
        # coupling W_(p,c); camera-major flattening matches the (C*6,)
        # layout of the reduced system
        Wcp = jnp.einsum("fij,fik->fjk", JcW, Jp)       # (F,6,3)
        if cam_blocked:
            # the three point-side accumulations share ONE (P,C,30)
            # accumulation — a few MB of traffic vs the (F,P) one-hot
            # matmuls this replaces
            acc = pt_accumulate(jnp.concatenate(
                [outer_p, gp, Wcp.reshape(F_, 18)], axis=1))  # (P,C,30)
            Hpp = acc[..., :9].sum(1).reshape(P, 3, 3)
            bp = acc[..., 9:12].sum(1)
            W = acc[..., 12:].reshape(P, C, 6, 3)
        else:
            Hpp = oh_matmul(oh_p, outer_p).reshape(P, 3, 3)
            bp = jnp.zeros((P, 3), dt).at[f_pt].add(gp)
            W = jnp.zeros((P, C, 6, 3), dt).at[f_pt, f_cam].add(Wcp)
        W = W.reshape(P, C * 6, 3)

        # damping + fixed-block regularization
        eyeC = jnp.eye(6, dtype=dt)
        Hcc = Hcc + (lam * jax.vmap(lambda h: jnp.diag(jnp.diag(h)))(Hcc)
                     + 1e-8 * eyeC)
        eyeP = jnp.eye(3, dtype=dt)
        Hpp = Hpp + (lam * jax.vmap(lambda h: jnp.diag(jnp.diag(h)))(Hpp)
                     + 1e-8 * eyeP)
        Hpp_inv = inv3x3(Hpp)

        # Schur reduce onto cameras: block-diagonal embed of Hcc
        Hcc_big = jnp.zeros((C * 6, C * 6), dt)
        Hcc_big = Hcc_big.at[
            (jnp.arange(C)[:, None, None] * 6 + jnp.arange(6)[None, :, None]),
            (jnp.arange(C)[:, None, None] * 6 + jnp.arange(6)[None, None, :]),
        ].set(Hcc)
        # S as one true 2-D matmul (84, 3P)x(3P, 84)
        Y = jnp.einsum("pax,pxy->pay", W, Hpp_inv)
        Yr = Y.transpose(1, 0, 2).reshape(C * 6, P * 3)
        Wr = W.transpose(1, 0, 2).reshape(C * 6, P * 3)
        S = Hcc_big - Yr @ Wr.T
        v = bc.reshape(C * 6) - Yr @ bp.reshape(P * 3)

        dxc = jnp.linalg.solve(S + 1e-8 * jnp.eye(C * 6, dtype=dt), v)
        dxp = jnp.einsum("pxy,py->px", Hpp_inv,
                         bp - jnp.einsum("pax,a->px", W, dxc))

        dxc = dxc.reshape(C, 6) * cam_opt[:, None]
        dxp = dxp * pt_opt[:, None]
        dR, dtc = lie.se3_exp(dxc)
        R_new, t_new = lie.se3_compose(dR, dtc, R_all, t_all)
        R_new = lie.normalize_rotation(R_new)
        P_new = P_all + dxp
        return (R_new, t_new, P_new), jnp.sum(chi2 * f_valid)

    # two-stage schedule like the reference (5 iters, drop chi2 outliers,
    # 5 more — src/Optimizer.cc LocalBundleAdjustment)
    state = (kf_R, kf_t, mp_pos)
    keep_all = jnp.ones_like(f_valid)
    state, _ = jax.lax.scan(
        lambda s, _: iteration(s, keep_all), state, None,
        length=max(n_iters // 2, 1))
    R_all, t_all, P_all = state
    res, _, _, z = _factor_res_jac(model, params, bf, R_all, t_all, P_all,
                                   f_cam, f_pt, f_uv, f_ur, is_stereo)
    mid_chi2 = jnp.sum(res * res, axis=-1) * w_info
    keep = (mid_chi2 <= 2.0 * hub_d2) & (z > 1e-2)
    state, _ = jax.lax.scan(
        lambda s, _: iteration(s, keep), state, None,
        length=max(n_iters - n_iters // 2, 1))
    R_all, t_all, P_all = state
    res, _, _, _ = _factor_res_jac(model, params, bf, R_all, t_all, P_all,
                                   f_cam, f_pt, f_uv, f_ur, is_stereo)
    chi2 = jnp.sum(res * res, axis=-1) * jnp.where(
        f_valid, 1.0 / jnp.maximum(f_sigma2, 1e-12), 0.0)
    Xc_z = lie.se3_apply(R_all[f_cam], t_all[f_cam], P_all[f_pt])[..., 2]
    inlier = f_valid & (chi2 <= hub_d2) & (Xc_z > 0)
    return BAResult(kf_R=R_all, kf_t=t_all, mp_pos=P_all,
                    f_chi2=chi2, f_inlier=inlier)

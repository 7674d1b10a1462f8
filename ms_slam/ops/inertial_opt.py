"""Visual-inertial state optimization kernels.

Covers the reference's inertial g2o graphs with AD-based Gauss-Newton:

- pose_vel_bias_optimize: the tracking-side motion-only optimization of
  [T_wb, v, bg, ba] with visual reprojection + preintegration factor against
  the (fixed) previous state + bias random walk
  (ref Optimizer::PoseInertialOptimizationLastKeyFrame / LastFrame,
  /root/reference/src/Optimizer.cc:4422/:4781, edges EdgeInertial,
  EdgeGyroRW/EdgeAccRW of src/G2oTypes.cc).
- inertial_init: the IMU initialization MAP estimate of gravity direction,
  shared biases (and optional scale) + per-keyframe velocities given camera
  poses and consecutive preintegrations
  (ref Optimizer::InertialOptimization, src/Optimizer.cc:3050, called from
  LocalMapping::InitializeIMU :1194 with priorG/priorA).

The state dimensions are tiny (15 or 9+3K), so jacfwd over the full
residual stack + dense normal equations is both simple and fast — the
batched visual block dominates and runs as matmuls.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from . import cameras, imu, lie, robust

G0 = imu.GRAVITY


class PVBResult(NamedTuple):
    R_wb: jnp.ndarray
    p_wb: jnp.ndarray
    v: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    inlier: jnp.ndarray
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("model", "n_rounds", "n_iters"))
def pose_vel_bias_optimize(
    model: int, params: jnp.ndarray, bf: jnp.ndarray,
    R_bc: jnp.ndarray, t_bc: jnp.ndarray,
    # previous (fixed) body state + preintegration since then
    R1: jnp.ndarray, p1: jnp.ndarray, v1: jnp.ndarray,
    bg1: jnp.ndarray, ba1: jnp.ndarray, preint: imu.PreintState,
    # current state initial guess
    R2: jnp.ndarray, p2: jnp.ndarray, v2: jnp.ndarray,
    # visual observations (body-2 frame)
    X: jnp.ndarray, uv: jnp.ndarray, u_right: jnp.ndarray,
    sigma2: jnp.ndarray, mask: jnp.ndarray,
    walk_info: jnp.ndarray,  # (6,) gyro/acc random-walk information diag
    n_rounds: int = 4, n_iters: int = 6, g: jnp.ndarray = None,
) -> PVBResult:
    """Optimize the current body state given the last state and visual
    matches. T_bc: camera-from-body extrinsics (ref IMU::Calib mTbc).
    g: world gravity vector (default canonical [0,0,-G])."""
    dt = R2.dtype
    is_stereo = u_right >= 0.0
    w_info = 1.0 / jnp.maximum(sigma2, 1e-12)
    L9 = imu.sqrt_information(preint)

    def unpack(x):
        # additive position / left-multiplicative rotation parameterization
        p = p2 + x[:3]
        R = lie.normalize_rotation(lie.so3_exp(x[3:6]) @ R2)
        v = v2 + x[6:9]
        bg = bg1 + x[9:12]
        ba = ba1 + x[12:15]
        return R, p, v, bg, ba

    def visual_res(R, p):
        # camera pose: T_cw = (T_wb T_bc)^-1
        R_wc = R @ R_bc
        t_wc = R @ t_bc + p
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc
        Xc = lie.se3_apply(R_cw, t_cw, X)
        uvp = cameras.project(model, params, Xc)
        z = jnp.maximum(Xc[..., 2], 1e-6)
        urp = uvp[..., 0] - bf / z
        r2 = uv - uvp
        r3 = jnp.where(is_stereo, u_right - urp, 0.0)
        return jnp.concatenate([r2, r3[..., None]], -1), Xc[..., 2]

    def full_res(x, vis_w):
        R, p, v, bg, ba = unpack(x)
        rv, _ = visual_res(R, p)
        rv = rv * jnp.sqrt(vis_w)[:, None]
        ri = imu.inertial_residual(preint, R1, v1, p1, R, v, p, bg, ba, g)
        ri_w = L9.T @ ri
        rb = jnp.concatenate([bg - bg1, ba - ba1]) * jnp.sqrt(walk_info)
        return jnp.concatenate([rv.reshape(-1), ri_w, rb])

    hub_d2 = jnp.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)

    def round_fn(carry, _):
        x, inlier = carry

        def gn(i, x):
            R, p, v, bg, ba = unpack(x)
            rv, z = visual_res(R, p)
            chi2 = jnp.sum(rv * rv, -1) * w_info
            w = robust.huber_weight(chi2, hub_d2) * w_info * inlier \
                * (z > 1e-2)
            r = full_res(x, w)
            J = jax.jacfwd(full_res)(x, w)
            H = J.T @ J + 1e-6 * jnp.eye(15, dtype=dt)
            g = -J.T @ r
            dx = jnp.linalg.solve(H, g)
            return x + dx

        x = jax.lax.fori_loop(0, n_iters, gn, x)
        R, p, _, _, _ = unpack(x)
        rv, z = visual_res(R, p)
        chi2 = jnp.sum(rv * rv, -1) * w_info
        inlier = mask & (chi2 <= hub_d2) & (z > 0)
        return (x, inlier), None

    x0 = jnp.zeros(15, dt)
    (x, inlier), _ = jax.lax.scan(round_fn, (x0, mask), None,
                                  length=n_rounds)
    R, p, v, bg, ba = unpack(x)
    return PVBResult(R_wb=R, p_wb=p, v=v, bg=bg, ba=ba, inlier=inlier,
                     n_inliers=jnp.sum(inlier).astype(jnp.int32))


class WindowRefineResult(NamedTuple):
    R_wb: jnp.ndarray    # (W,3,3)
    p_wb: jnp.ndarray    # (W,3)
    vels: jnp.ndarray    # (W,3)
    bg: jnp.ndarray
    ba: jnp.ndarray
    cost: jnp.ndarray


@partial(jax.jit, static_argnames=("model", "n_iters"))
def inertial_window_refine(
    model: int, params: jnp.ndarray, bf: jnp.ndarray,
    R_wb: jnp.ndarray, p_wb: jnp.ndarray, vels: jnp.ndarray,
    kf_mask: jnp.ndarray,
    preints: imu.PreintState,            # (W-1,) stacked, interval i->i+1
    preint_valid: jnp.ndarray,           # (W-1,)
    bg0: jnp.ndarray, ba0: jnp.ndarray, g: jnp.ndarray,
    X: jnp.ndarray, f_kf: jnp.ndarray, f_uv: jnp.ndarray,
    f_ur: jnp.ndarray, f_sigma2: jnp.ndarray, f_valid: jnp.ndarray,
    walk_info: jnp.ndarray, n_iters: int = 5,
    R_bc: jnp.ndarray = None, t_bc: jnp.ndarray = None,
) -> WindowRefineResult:
    """The inertial half of LocalInertialBA (ref Optimizer::LocalInertialBA,
    /root/reference/src/Optimizer.cc:2431): jointly refine the window
    keyframes' poses, velocities, and a shared bias against (fixed)
    landmarks + the preintegration chain. Landmark refinement is done by the
    preceding visual window BA; this pass adds the inertial constraints the
    visual solver cannot express. The oldest window keyframe is the gauge
    anchor (pose prior).

    State dim = 9W + 6 (W<=10), so jacfwd + one dense solve per iteration.
    f_kf indexes into the window (0..W-1). R_bc/t_bc: body-from-camera
    extrinsic (ref IMU::Calib mTbc); None = camera == body.
    """
    W = R_wb.shape[0]
    dt = R_wb.dtype
    if R_bc is None:
        R_bc = jnp.eye(3, dtype=dt)
    if t_bc is None:
        t_bc = jnp.zeros(3, dt)
    is_stereo = f_ur >= 0.0
    w_info = jnp.where(f_valid, 1.0 / jnp.maximum(f_sigma2, 1e-12), 0.0)
    hub_d2 = jnp.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)

    def unpack(x):
        d = x[:9 * W].reshape(W, 9)
        p = p_wb + d[:, :3]
        R = lie.normalize_rotation(lie.so3_exp(d[:, 3:6]) @ R_wb)
        v = vels + d[:, 6:9]
        bg = bg0 + x[9 * W:9 * W + 3]
        ba = ba0 + x[9 * W + 3:9 * W + 6]
        return R, p, v, bg, ba

    def visual_raw(x):
        R, p, v, bg, ba = unpack(x)
        # camera pose per factor: T_wc = T_wb * T_bc
        Rk = R[f_kf] @ R_bc
        pk = jnp.einsum("fij,j->fi", R[f_kf], t_bc) + p[f_kf]
        R_cw = jnp.swapaxes(Rk, -1, -2)
        t_cw = -jnp.einsum("fij,fj->fi", R_cw, pk)
        Xc = jnp.einsum("fij,fj->fi", R_cw, X) + t_cw
        uvp = cameras.project(model, params, Xc)
        z = jnp.maximum(Xc[..., 2], 1e-6)
        urp = uvp[..., 0] - bf / z
        r2 = f_uv - uvp
        r3 = jnp.where(is_stereo, f_ur - urp, 0.0)
        rv = jnp.concatenate([r2, r3[..., None]], -1)
        return rv, Xc[..., 2]

    def residuals(x, sw):
        # sw: per-factor sqrt-weights, CONSTANT wrt x (IRLS) — computing
        # them inside the differentiated path puts sqrt(0) tangents (NaN)
        # on every masked factor
        R, p, v, bg, ba = unpack(x)
        rv, _ = visual_raw(x)
        rv = rv * sw[:, None]

        # inertial chain
        def one(i):
            st = jax.tree.map(lambda a: a[i], preints)
            r = imu.inertial_residual(st, R[i], v[i], p[i],
                                      R[i + 1], v[i + 1], p[i + 1],
                                      bg, ba, g)
            L = imu.sqrt_information(st)
            ok = preint_valid[i] & kf_mask[i] & kf_mask[i + 1]
            return jnp.where(ok, L.T @ r, 0.0)

        ri = jax.vmap(one)(jnp.arange(W - 1)).reshape(-1)
        rb = jnp.concatenate([x[9 * W:9 * W + 3], x[9 * W + 3:]]) \
            * jnp.sqrt(walk_info)
        # gauge: strong prior on the first window keyframe's pose
        rg = x[:6] * 1e3
        return jnp.concatenate([rv.reshape(-1), ri, rb, rg])

    def weights(x):
        rv, z = visual_raw(x)
        chi2 = jnp.sum(rv * rv, -1) * w_info
        w = robust.huber_weight(chi2, hub_d2) * w_info * (z > 1e-2)
        return jax.lax.stop_gradient(jnp.sqrt(w))

    def gn(i, x):
        sw = weights(x)
        r = residuals(x, sw)
        J = jax.jacfwd(residuals)(x, sw)
        H = J.T @ J + 1e-6 * jnp.eye(x.shape[0], dtype=dt)
        return x + jnp.linalg.solve(H, -J.T @ r)

    x0 = jnp.zeros(9 * W + 6, dt)
    x = jax.lax.fori_loop(0, n_iters, gn, x0)
    R, p, v, bg, ba = unpack(x)
    r = residuals(x, weights(x))
    return WindowRefineResult(R_wb=R, p_wb=p, vels=v, bg=bg, ba=ba,
                              cost=jnp.sum(r * r))


class VIWindowResult(NamedTuple):
    R_wb: jnp.ndarray    # (W,3,3)
    p_wb: jnp.ndarray    # (W,3)
    vels: jnp.ndarray    # (W,3)
    bg: jnp.ndarray
    ba: jnp.ndarray
    mp_pos: jnp.ndarray  # (M,3) updated landmark pool
    g: jnp.ndarray       # (3,) refined world gravity vector
    cost: jnp.ndarray


@partial(jax.jit, static_argnames=("model", "n_iters"))
def vi_window_ba(
    model: int, params: jnp.ndarray, bf: jnp.ndarray,
    R_wb: jnp.ndarray, p_wb: jnp.ndarray, vels: jnp.ndarray,
    kf_mask: jnp.ndarray,
    preints: imu.PreintState,            # (W-1,) stacked, interval i->i+1
    preint_valid: jnp.ndarray,           # (W-1,)
    bg0: jnp.ndarray, ba0: jnp.ndarray, g: jnp.ndarray,
    # window visual factors (point indices into the mp pool)
    mp_pos: jnp.ndarray,                 # (M,3) landmark pool
    f_pt: jnp.ndarray, f_kf: jnp.ndarray, f_uv: jnp.ndarray,
    f_ur: jnp.ndarray, f_sigma2: jnp.ndarray, f_valid: jnp.ndarray,
    # anchor factors: observations of the same points from FIXED cameras
    # just outside the window (camera-frame poses, ref LocalInertialBA's
    # lFixedKeyFrames, src/Optimizer.cc:2550)
    a_Rcw: jnp.ndarray, a_tcw: jnp.ndarray,         # (Ac,3,3),(Ac,3)
    a_cam: jnp.ndarray, a_pt: jnp.ndarray, a_uv: jnp.ndarray,
    a_ur: jnp.ndarray, a_sigma2: jnp.ndarray, a_valid: jnp.ndarray,
    walk_info: jnp.ndarray,
    R_bc: jnp.ndarray = None, t_bc: jnp.ndarray = None,
    n_iters: int = 5,
) -> VIWindowResult:
    """Full visual-inertial local BA (ref Optimizer::LocalInertialBA,
    /root/reference/src/Optimizer.cc:2431): jointly refine the temporal
    window keyframes' poses/velocities + shared bias AND the observed
    landmarks, with fixed out-of-window observers anchoring shared points.
    Freeing the landmarks is what lets accelerometer-observed tilt
    corrections actually stick — with fixed landmarks the visual factors
    pin the window to the drifted map and pitch/roll drift accumulates
    (the reference runs this full VI BA on every keyframe once IMU is
    initialized, src/LocalMapping.cc:150-155).

    Solver: JOINT Gauss-Newton with Schur elimination of the landmarks —
    the (9W+6)-dim pose/velocity/bias block via jacfwd (it is tiny), the
    per-point 3x3 blocks and the (M, 9W+6, 3) coupling analytically, then
    one dense reduced solve per iteration. (A block-coordinate pose/point
    alternation was tried first and creeps along the strongly-coupled
    pose-landmark directions — tens of sweeps to converge; the joint
    step converges in ~5.)
    """
    W = R_wb.shape[0]
    dt = R_wb.dtype
    if R_bc is None:
        R_bc = jnp.eye(3, dtype=dt)
    if t_bc is None:
        t_bc = jnp.zeros(3, dt)
    M = mp_pos.shape[0]
    is_stereo = f_ur >= 0.0
    a_is_stereo = a_ur >= 0.0
    w_info = jnp.where(f_valid, 1.0 / jnp.maximum(f_sigma2, 1e-12), 0.0)
    a_w_info = jnp.where(a_valid, 1.0 / jnp.maximum(a_sigma2, 1e-12), 0.0)
    hub_d2 = jnp.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)
    a_hub_d2 = jnp.where(a_is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)

    def win_cams(x):
        d = x[:9 * W].reshape(W, 9)
        # HARD gauge: the oldest window keyframe's pose is fixed (its
        # velocity/bias stay free) — a soft prior lets the whole bundle
        # slide along the gauge null-mode, one step per BCD sweep
        d = d.at[0, :6].set(0.0)
        p = p_wb + d[:, :3]
        R = lie.normalize_rotation(lie.so3_exp(d[:, 3:6]) @ R_wb)
        v = vels + d[:, 6:9]
        bg = bg0 + x[9 * W:9 * W + 3]
        ba = ba0 + x[9 * W + 3:9 * W + 6]
        # camera pose per window KF: T_wc = T_wb * T_bc -> T_cw
        Rc = R @ R_bc
        pc = jnp.einsum("kij,j->ki", R, t_bc) + p
        R_cw = jnp.swapaxes(Rc, -1, -2)
        t_cw = -jnp.einsum("kij,kj->ki", R_cw, pc)
        return R, p, v, bg, ba, R_cw, t_cw

    def proj_res(R_cw_f, t_cw_f, X, uv, ur, stereo):
        Xc = jnp.einsum("fij,fj->fi", R_cw_f, X) + t_cw_f
        uvp = cameras.project(model, params, Xc)
        z = jnp.maximum(Xc[..., 2], 1e-6)
        urp = uvp[..., 0] - bf / z
        r2 = uv - uvp
        r3 = jnp.where(stereo, ur - urp, 0.0)
        return jnp.concatenate([r2, r3[..., None]], -1), Xc

    # state: 9 per window KF (dp, dtheta, dv) + 6 shared bias + 2 gravity
    # direction (ref VertexGDir in InertialOptimization,
    # src/Optimizer.cc:3050 — holding gravity fixed while the VI BA runs on
    # a tilted map locks the tilt in; making its direction a state lets the
    # accelerometer, not the stale estimate, set "down")
    D = 9 * W + 8
    sqrt_walk = jnp.sqrt(walk_info)
    # orthonormal basis of the plane perpendicular to the current gravity
    g_norm = g / jnp.maximum(jnp.linalg.norm(g), 1e-9)
    ref_ax = jnp.where(jnp.abs(g_norm[0]) < 0.9,
                       jnp.asarray([1.0, 0.0, 0.0], dt),
                       jnp.asarray([0.0, 1.0, 0.0], dt))
    e1 = jnp.cross(g_norm, ref_ax)
    e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-9)
    e2 = jnp.cross(g_norm, e1)

    def gravity_of(x):
        rv = x[9 * W + 6] * e1 + x[9 * W + 7] * e2
        return lie.so3_exp(rv) @ g

    def visual_raw(x, X):
        _, _, _, _, _, R_cw, t_cw = win_cams(x)
        return proj_res(R_cw[f_kf], t_cw[f_kf], X, f_uv, f_ur, is_stereo)

    def inertial_raw(x):
        R, p, v, bg, ba, _, _ = win_cams(x)
        g_cur = gravity_of(x)

        def one(i):
            st = jax.tree.map(lambda a: a[i], preints)
            r = imu.inertial_residual(st, R[i], v[i], p[i],
                                      R[i + 1], v[i + 1], p[i + 1],
                                      bg, ba, g_cur)
            L = imu.sqrt_information(st)
            ok = preint_valid[i] & kf_mask[i] & kf_mask[i + 1]
            return jnp.where(ok, L.T @ r, 0.0)

        return jax.vmap(one)(jnp.arange(W - 1))      # (W-1,9) whitened

    def stacked_res(x, X, sw, si):
        rv, _ = visual_raw(x, X)
        rv = rv * sw[:, None]
        ri = inertial_raw(x) * si[:, None]
        rb = x[9 * W:9 * W + 6] * sqrt_walk
        # weak prior on the gravity-direction tangent (sigma 0.05 rad per
        # call) — enough accel baseline overrides it instantly
        rgd = x[9 * W + 6:] * 20.0
        # Tikhonov on the hard-masked first-pose tangent keeps its Hessian
        # block nonsingular (the mask zeroes its Jacobian columns)
        rg = x[:6] * 1.0
        return jnp.concatenate([rv.reshape(-1), ri.reshape(-1), rb,
                                rgd, rg])

    def point_jac(Rf, Xc, stereo):
        """Analytic d(res)/dX_world: (F,3,3)."""
        z = Xc[..., 2]
        Jproj = cameras.project_jac(model, params, Xc)
        zc = jnp.maximum(z, 1e-6)
        dur = Jproj[:, 0, :] + jnp.stack(
            [jnp.zeros_like(zc), jnp.zeros_like(zc), bf / (zc * zc)], -1)
        J3 = jnp.concatenate([Jproj, dur[:, None, :]], 1)
        J3 = J3 * jnp.where(
            stereo[:, None, None], jnp.ones((1, 3, 1), dt),
            jnp.asarray([1.0, 1.0, 0.0], dt)[None, :, None])
        return -jnp.einsum("fij,fjk->fik", J3, Rf)

    # anchor factors never change (fixed cameras): fold their per-point
    # Hessian/gradient contribution ONCE per iteration
    def anchor_blocks(P_all):
        Xa = P_all[a_pt]
        Rf = a_Rcw[a_cam]
        rv, Xc = proj_res(Rf, a_tcw[a_cam], Xa, a_uv, a_ur, a_is_stereo)
        chi2 = jnp.sum(rv * rv, -1) * a_w_info
        w = robust.huber_weight(chi2, a_hub_d2) * a_w_info \
            * (Xc[..., 2] > 1e-2) * a_valid
        Jp = point_jac(Rf, Xc, a_is_stereo)
        JpW = Jp * w[:, None, None]
        Hpp = jnp.zeros((M, 3, 3), dt).at[a_pt].add(
            jnp.einsum("fij,fik->fjk", JpW, Jp))
        bp = jnp.zeros((M, 3), dt).at[a_pt].add(
            -jnp.einsum("fij,fi->fj", JpW, rv))
        return Hpp, bp

    touched = jnp.zeros((M,), bool).at[f_pt].max(f_valid)

    def gn(i, carry):
        x, P_all = carry
        X = P_all[f_pt]
        rv, Xc = visual_raw(x, X)
        chi2 = jnp.sum(rv * rv, -1) * w_info
        w = robust.huber_weight(chi2, hub_d2) * w_info \
            * (Xc[..., 2] > 1e-2)
        sw = jax.lax.stop_gradient(jnp.sqrt(w))
        # Huber on the whitened inertial chain (ref LocalInertialBA puts
        # RobustKernelHuber delta=sqrt(16.92) on EdgeInertial,
        # src/Optimizer.cc:2499-2501)
        ri = inertial_raw(x)
        chi2_i = jnp.sum(ri * ri, -1)
        si = jax.lax.stop_gradient(
            jnp.sqrt(robust.huber_weight(chi2_i, 16.92)))

        r = stacked_res(x, X, sw, si)
        Jx = jax.jacfwd(stacked_res)(x, X, sw, si)       # (R, D)
        Hxx = Jx.T @ Jx
        bx = -Jx.T @ r

        # point blocks + coupling (window factors; sw-whitened to match
        # the rv rows of stacked_res)
        Jp = point_jac(
            win_cams(x)[5][f_kf], Xc, is_stereo) * sw[:, None, None]
        F_ = f_pt.shape[0]
        Jv = Jx[:3 * F_].reshape(F_, 3, D)               # weighted rows
        Hpp, bp = anchor_blocks(P_all)
        Hpp = Hpp.at[f_pt].add(jnp.einsum("fij,fik->fjk", Jp, Jp))
        rvw = rv * sw[:, None]
        bp = bp.at[f_pt].add(-jnp.einsum("fij,fi->fj", Jp, rvw))
        Wc = jnp.zeros((M, D, 3), dt).at[f_pt].add(
            jnp.einsum("fiD,fij->fDj", Jv, Jp))

        # damping (Levenberg): g2o runs LM, not plain GN
        Hxx = Hxx + 1e-3 * jnp.diag(jnp.diag(Hxx)) \
            + 1e-6 * jnp.eye(D, dtype=dt)
        Hpp = Hpp + 1e-3 * jax.vmap(
            lambda h: jnp.diag(jnp.diag(h)))(Hpp) \
            + 1e-6 * jnp.eye(3, dtype=dt)
        Hpp_inv = lie.inv3x3(Hpp)

        # Schur reduce onto the pose/velocity/bias block (2-D matmuls)
        Y = jnp.einsum("pDx,pxy->pDy", Wc, Hpp_inv)      # (M,D,3)
        Yr = Y.transpose(1, 0, 2).reshape(D, M * 3)
        Wr = Wc.transpose(1, 0, 2).reshape(D, M * 3)
        S = Hxx - Yr @ Wr.T
        v = bx - Yr @ bp.reshape(M * 3)
        dx = jnp.linalg.solve(S + 1e-8 * jnp.eye(D, dtype=dt), v)
        dxp = jnp.einsum("pxy,py->px", Hpp_inv,
                         bp - jnp.einsum("pDx,D->px", Wc, dx))
        return x + dx, P_all + dxp * touched[:, None]

    x0 = jnp.zeros(D, dt)
    x, P_new = jax.lax.fori_loop(0, n_iters, gn, (x0, mp_pos))
    R, p, v, bg, ba, _, _ = win_cams(x)
    return VIWindowResult(R_wb=R, p_wb=p, vels=v, bg=bg, ba=ba,
                          mp_pos=P_new, g=gravity_of(x),
                          cost=jnp.zeros((), dt))


@partial(jax.jit, static_argnames=("model", "n_iters", "cg_iters"))
def vi_full_ba(
    model: int, params: jnp.ndarray, bf: jnp.ndarray,
    R_wb: jnp.ndarray, p_wb: jnp.ndarray, vels: jnp.ndarray,
    kf_mask: jnp.ndarray,
    preints: imu.PreintState,            # (W-1,) stacked, interval i->i+1
    preint_valid: jnp.ndarray,           # (W-1,)
    bg0: jnp.ndarray, ba0: jnp.ndarray, g: jnp.ndarray,
    mp_pos: jnp.ndarray,                 # (M,3) landmark pool
    f_pt: jnp.ndarray, f_kf: jnp.ndarray, f_uv: jnp.ndarray,
    f_ur: jnp.ndarray, f_sigma2: jnp.ndarray, f_valid: jnp.ndarray,
    walk_info: jnp.ndarray,
    R_bc: jnp.ndarray = None, t_bc: jnp.ndarray = None,
    n_iters: int = 4, cg_iters: int = 64,
) -> VIWindowResult:
    """JOINT whole-chain visual-inertial BA (ref Optimizer::FullInertialBA,
    /root/reference/src/Optimizer.cc:366, run after a loop correction via
    RunGlobalBundleAdjustment, src/LoopClosing.cc:2228-2230): one
    optimization over EVERY temporal keyframe of the active map — poses,
    velocities, shared bias, gravity direction, and all observed
    landmarks. This replaces an overlapping-window sweep, which propagates
    a loop correction only one window-overlap per pass, so the far end of
    the chain never feels the whole constraint set jointly.

    Solver: Schur complement on the landmarks with the reduced
    (9W+8)-dim camera system solved MATRIX-FREE by block-Jacobi
    preconditioned CG. The dense window solver (vi_window_ba)
    materializes an (M, 9W+6, 3) coupling tensor and jacfwd's the whole
    stacked residual against the full state — fine at W<=12, hopeless at
    chain scale. Here:
      - visual pose blocks are per-factor 6-dim jacfwds (vmapped),
      - the inertial chain + priors are one small dense jacfwd,
      - each CG matvec is two einsum/scatter passes over the factor
        table, so memory stays O(F + M + D^2).
    Gauge: the oldest chain keyframe's pose is hard-fixed (velocity and
    bias stay free), as in vi_window_ba.
    """
    W = R_wb.shape[0]
    dt = R_wb.dtype
    if R_bc is None:
        R_bc = jnp.eye(3, dtype=dt)
    if t_bc is None:
        t_bc = jnp.zeros(3, dt)
    M = mp_pos.shape[0]
    D = 9 * W + 8
    is_stereo = f_ur >= 0.0
    w_info = jnp.where(f_valid, 1.0 / jnp.maximum(f_sigma2, 1e-12), 0.0)
    hub_d2 = jnp.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)
    sqrt_walk = jnp.sqrt(walk_info)
    # the gauge keyframe contributes no pose Jacobian
    free_kf = (f_kf != 0) & f_valid

    def win_cams(x):
        d = x[:9 * W].reshape(W, 9)
        d = d.at[0, :6].set(0.0)                 # hard gauge
        p = p_wb + d[:, :3]
        R = lie.normalize_rotation(lie.so3_exp(d[:, 3:6]) @ R_wb)
        v = vels + d[:, 6:9]
        bg = bg0 + x[9 * W:9 * W + 3]
        ba = ba0 + x[9 * W + 3:9 * W + 6]
        Rc = R @ R_bc
        pc = jnp.einsum("kij,j->ki", R, t_bc) + p
        R_cw = jnp.swapaxes(Rc, -1, -2)
        t_cw = -jnp.einsum("kij,kj->ki", R_cw, pc)
        return R, p, v, bg, ba, R_cw, t_cw

    g_norm = g / jnp.maximum(jnp.linalg.norm(g), 1e-9)
    ref_ax = jnp.where(jnp.abs(g_norm[0]) < 0.9,
                       jnp.asarray([1.0, 0.0, 0.0], dt),
                       jnp.asarray([0.0, 1.0, 0.0], dt))
    e1 = jnp.cross(g_norm, ref_ax)
    e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-9)
    e2 = jnp.cross(g_norm, e1)

    def gravity_of(x):
        rv = x[9 * W + 6] * e1 + x[9 * W + 7] * e2
        return lie.so3_exp(rv) @ g

    def inertial_raw(x):
        R, p, v, bg, ba, _, _ = win_cams(x)
        g_cur = gravity_of(x)

        def one(i):
            st = jax.tree.map(lambda a: a[i], preints)
            r = imu.inertial_residual(st, R[i], v[i], p[i],
                                      R[i + 1], v[i + 1], p[i + 1],
                                      bg, ba, g_cur)
            L = imu.sqrt_information(st)
            ok = preint_valid[i] & kf_mask[i] & kf_mask[i + 1]
            return jnp.where(ok, L.T @ r, 0.0)

        return jax.vmap(one)(jnp.arange(W - 1))

    def inprior_res(x, si):
        ri = inertial_raw(x) * si[:, None]
        rb = x[9 * W:9 * W + 6] * sqrt_walk
        rgd = x[9 * W + 6:] * 20.0              # weak gravity-dir prior
        rg = x[:6] * 1.0                        # Tikhonov on gauge tangent
        return jnp.concatenate([ri.reshape(-1), rb, rgd, rg])

    # per-factor visual residual as a function of its OWN keyframe's
    # 6-dim pose tangent (velocity/bias don't enter the projection)
    def f_res6(d6, Rk, pk, X, uv, ur, stereo):
        p = pk + d6[:3]
        R = lie.so3_exp(d6[3:6]) @ Rk
        Rc = R @ R_bc
        pc = R @ t_bc + p
        Xc = Rc.T @ (X - pc)
        uvp = cameras.project(model, params, Xc[None])[0]
        z = jnp.maximum(Xc[2], 1e-6)
        urp = uvp[0] - bf / z
        r3 = jnp.where(stereo, ur - urp, 0.0)
        return jnp.concatenate([uv - uvp, r3[None]]), Xc

    f_jac6 = jax.vmap(jax.jacfwd(f_res6, argnums=0, has_aux=True),
                      in_axes=(None, 0, 0, 0, 0, 0, 0))

    def point_jac(Rf, Xc, stereo):
        z = Xc[..., 2]
        Jproj = cameras.project_jac(model, params, Xc)
        zc = jnp.maximum(z, 1e-6)
        dur = Jproj[:, 0, :] + jnp.stack(
            [jnp.zeros_like(zc), jnp.zeros_like(zc), bf / (zc * zc)], -1)
        J3 = jnp.concatenate([Jproj, dur[:, None, :]], 1)
        J3 = J3 * jnp.where(
            stereo[:, None, None], jnp.ones((1, 3, 1), dt),
            jnp.asarray([1.0, 1.0, 0.0], dt)[None, :, None])
        return -jnp.einsum("fij,fjk->fik", J3, Rf)

    idx6 = (9 * jnp.arange(W)[:, None]
            + jnp.arange(6)[None, :]).reshape(-1)      # pose cols in x

    def emb6(w6):                                      # (W,6) -> (D,)
        return jnp.zeros((D,), dt).at[idx6].add(w6.reshape(-1))

    def ext6(v):                                       # (D,) -> (W,6)
        return v[:9 * W].reshape(W, 9)[:, :6]

    touched = jnp.zeros((M,), bool).at[f_pt].max(f_valid)

    def gn(it, carry):
        x, P_all = carry
        _, _, _, _, _, R_cw, t_cw = win_cams(x)
        X = P_all[f_pt]
        # per-factor residuals + pose Jacobians at the current state
        d0 = jnp.zeros(6, dt)
        rv, Xc = jax.vmap(f_res6, in_axes=(None, 0, 0, 0, 0, 0, 0))(
            d0, R_wb_cur(x)[0][f_kf], R_wb_cur(x)[1][f_kf],
            X, f_uv, f_ur, is_stereo)
        J6, _ = f_jac6(d0, R_wb_cur(x)[0][f_kf], R_wb_cur(x)[1][f_kf],
                       X, f_uv, f_ur, is_stereo)
        chi2 = jnp.sum(rv * rv, -1) * w_info
        w = robust.huber_weight(chi2, hub_d2) * w_info * (Xc[..., 2] > 1e-2)
        sw = jax.lax.stop_gradient(jnp.sqrt(w))
        J6w = J6 * (sw * free_kf)[:, None, None]
        Jpw = point_jac(R_cw[f_kf], Xc, is_stereo) * sw[:, None, None]
        rvw = rv * sw[:, None]

        # inertial chain + priors: small dense jacfwd
        ri = inertial_raw(x)
        chi2_i = jnp.sum(ri * ri, -1)
        si = jax.lax.stop_gradient(
            jnp.sqrt(robust.huber_weight(chi2_i, 16.92)))
        r_in = inprior_res(x, si)
        J_in = jax.jacfwd(inprior_res)(x, si)          # (Rin, D)

        # camera-side Hessian: dense inertial part + visual block-diag
        Hxx = J_in.T @ J_in
        Hv = jnp.zeros((W, 6, 6), dt).at[f_kf].add(
            jnp.einsum("fij,fik->fjk", J6w, J6w))
        rows = (9 * jnp.arange(W)[:, None, None] + jnp.arange(6)[None, :, None])
        cols = (9 * jnp.arange(W)[:, None, None] + jnp.arange(6)[None, None, :])
        Hxx = Hxx.at[jnp.broadcast_to(rows, (W, 6, 6)),
                     jnp.broadcast_to(cols, (W, 6, 6))].add(Hv)
        bx = -(J_in.T @ r_in) - emb6(
            jnp.zeros((W, 6), dt).at[f_kf].add(
                jnp.einsum("fij,fi->fj", J6w, rvw)))

        # landmark blocks
        Hpp = jnp.zeros((M, 3, 3), dt).at[f_pt].add(
            jnp.einsum("fij,fik->fjk", Jpw, Jpw))
        bp = jnp.zeros((M, 3), dt).at[f_pt].add(
            -jnp.einsum("fij,fi->fj", Jpw, rvw))
        Hpp = Hpp + 1e-3 * jax.vmap(
            lambda h: jnp.diag(jnp.diag(h)))(Hpp) \
            + 1e-6 * jnp.eye(3, dtype=dt)
        Hpp_inv = lie.inv3x3(Hpp)
        Hxx = Hxx + 1e-3 * jnp.diag(jnp.diag(Hxx)) \
            + 1e-6 * jnp.eye(D, dtype=dt)

        def W_t_apply(v):
            """(D,) -> (M,3): W^T v = sum_f Jpw^T (J6w v_kf)."""
            v6 = ext6(v)[f_kf]
            y = jnp.einsum("fij,fj->fi", J6w, v6)
            return jnp.zeros((M, 3), dt).at[f_pt].add(
                jnp.einsum("fij,fi->fj", Jpw, y))

        def W_apply(zp):
            """(M,3) -> (D,): W z = sum_f J6w^T (Jpw z_pf)."""
            zf = jnp.einsum("fij,fj->fi", Jpw, zp[f_pt])
            return emb6(jnp.zeros((W, 6), dt).at[f_kf].add(
                jnp.einsum("fij,fi->fj", J6w, zf)))

        def S_apply(v):
            u = W_t_apply(v)
            q = jnp.einsum("pxy,py->px", Hpp_inv, u)
            return Hxx @ v - W_apply(q)

        b_red = bx - W_apply(jnp.einsum("pxy,py->px", Hpp_inv, bp))

        # block-Jacobi preconditioner from Hxx diagonal blocks
        blk9 = Hxx[:9 * W, :9 * W].reshape(W, 9, W, 9)
        blk9 = jax.vmap(lambda i: blk9[i, :, i, :])(jnp.arange(W))
        blk9_inv = jnp.linalg.inv(blk9)
        tail_inv = jnp.linalg.inv(Hxx[9 * W:, 9 * W:])

        def prec(r):
            r9 = jnp.einsum("wij,wj->wi", blk9_inv,
                            r[:9 * W].reshape(W, 9)).reshape(-1)
            return jnp.concatenate([r9, tail_inv @ r[9 * W:]])

        def cg_step(carry, _):
            xk, rk, zk, pk = carry
            Ap = S_apply(pk)
            denom = jnp.maximum(pk @ Ap, 1e-20)
            alpha = (rk @ zk) / denom
            xk2 = xk + alpha * pk
            rk2 = rk - alpha * Ap
            zk2 = prec(rk2)
            beta = (rk2 @ zk2) / jnp.maximum(rk @ zk, 1e-20)
            return (xk2, rk2, zk2, zk2 + beta * pk), None

        z0 = prec(b_red)
        (dx, _, _, _), _ = jax.lax.scan(
            cg_step, (jnp.zeros(D, dt), b_red, z0, z0), None,
            length=cg_iters)

        dxp = jnp.einsum("pxy,py->px", Hpp_inv, bp - W_t_apply(dx))
        return x + dx, P_all + dxp * touched[:, None]

    def R_wb_cur(x):
        d = x[:9 * W].reshape(W, 9)
        d = d.at[0, :6].set(0.0)
        p = p_wb + d[:, :3]
        R = lie.normalize_rotation(lie.so3_exp(d[:, 3:6]) @ R_wb)
        return R, p

    x0 = jnp.zeros(D, dt)
    x, P_new = jax.lax.fori_loop(0, n_iters, gn, (x0, mp_pos))
    R, p, v, bg, ba, _, _ = win_cams(x)
    return VIWindowResult(R_wb=R, p_wb=p, vels=v, bg=bg, ba=ba,
                          mp_pos=P_new, g=gravity_of(x),
                          cost=jnp.zeros((), dt))


def marginalize(H: jnp.ndarray, start: int, end: int) -> jnp.ndarray:
    """Schur-marginalize the variable block [start, end] (inclusive) out
    of an information matrix (ref Optimizer::Marginalize,
    /root/reference/src/Optimizer.cc:2975, used by the inertial
    initialization to fold old states' information into priors): the
    block's information is folded into the remaining variables through
    the SVD pseudo-inverse (rank-deficient marginal blocks get their
    singular values below 1e-6 zeroed, exactly as the reference does),
    and the marginalized rows/columns are returned zeroed in place.

    start/end are static Python ints; no reordering is materialized —
    static gathers replace the reference's double block-permutation."""
    n = H.shape[0]
    K = np.concatenate([np.arange(0, start),
                        np.arange(end + 1, n)]).astype(np.int32)
    B = np.arange(start, end + 1).astype(np.int32)
    Hkk = H[K][:, K]
    Hkb = H[K][:, B]
    Hbb = H[B][:, B]
    U, s, Vt = jnp.linalg.svd(Hbb, full_matrices=False)
    s_inv = jnp.where(s > 1e-6, 1.0 / jnp.maximum(s, 1e-12), 0.0)
    Hbb_pinv = (Vt.T * s_inv[None, :]) @ U.T
    Hkk_m = Hkk - Hkb @ Hbb_pinv @ Hkb.T
    res = jnp.zeros_like(H)
    return res.at[K[:, None], K[None, :]].set(Hkk_m)


class InertialInitResult(NamedTuple):
    R_wg: jnp.ndarray    # (3,3) gravity direction (g_world = R_wg [0,0,-G])
    bg: jnp.ndarray
    ba: jnp.ndarray
    scale: jnp.ndarray
    vels: jnp.ndarray    # (K,3) body velocities
    cost: jnp.ndarray


@partial(jax.jit, static_argnames=("n_iters", "with_scale"))
def inertial_init(R_wb: jnp.ndarray, p_wb: jnp.ndarray,
                  preints: imu.PreintState,  # stacked (K-1) pytree
                  prior_g: jnp.ndarray, prior_a: jnp.ndarray,
                  n_iters: int = 20, with_scale: bool = False
                  ) -> InertialInitResult:
    """Gravity/bias/scale MAP from keyframe poses + chained preintegrations.

    R_wb/p_wb: (K,...) body keyframe poses (visual, up-to-scale for mono).
    preints: preintegration between consecutive keyframes, fields stacked on
    a leading (K-1,) axis. prior_g/prior_a: bias priors (ref priorG=1e2,
    priorA=1e6-1e10 schedule, src/LocalMapping.cc:185-224).

    The nonlinear MAP is seeded by a CLOSED-FORM linear visual-inertial
    alignment: with rotations known, the ev/ep preintegration equations
    are LINEAR in (v_0..v_{K-1}, g_w, s) — one least-squares solve gives
    globally-consistent velocities, gravity direction, and metric scale.
    (The reference seeds only gravity, from dirG = -sum R*dV,
    src/LocalMapping.cc:1256; the joint linear solve also recovers the
    mono scale, where a GN started at s=1 with visual-scale velocities
    falls into the s->0 basin whenever the true scale correction is
    large.) Biases and the whitened MAP refinement stay nonlinear."""
    K = R_wb.shape[0]
    dtK = preints.dT
    dt = R_wb.dtype

    # ---- linear alignment: unknowns [v_0..v_{K-1} (3K), g (3), s?] ----
    T = dtK                                           # (K-1,)
    RdV = jnp.einsum("kij,kj->ki", R_wb[:-1], preints.dV)
    RdP = jnp.einsum("kij,kj->ki", R_wb[:-1], preints.dP)
    dp_vis = p_wb[1:] - p_wb[:-1]
    D_lin = 3 * K + 3 + (1 if with_scale else 0)
    E = 6 * (K - 1)
    A = jnp.zeros((E, D_lin), dt)
    b = jnp.zeros((E,), dt)
    i3 = jnp.eye(3, dtype=dt)
    idx = jnp.arange(K - 1)
    # ev rows: -v_i + v_{i+1} - T g = R_i dV_i
    r0 = 6 * idx
    for r in range(3):
        A = A.at[r0 + r, :].add(jnp.zeros((K - 1, D_lin), dt)
                                .at[idx, 3 * idx + r].add(-1.0)
                                .at[idx, 3 * idx + 3 + r].add(1.0)
                                .at[idx, 3 * K + r].add(-T))
        b = b.at[r0 + r].set(RdV[:, r])
    # ep rows: -T v_i - 0.5 T^2 g + s dp_i = R_i dP_i  (s folded to RHS
    # when fixed)
    r1 = 6 * idx + 3
    for r in range(3):
        row = jnp.zeros((K - 1, D_lin), dt) \
            .at[idx, 3 * idx + r].add(-T) \
            .at[idx, 3 * K + r].add(-0.5 * T * T)
        if with_scale:
            row = row.at[idx, 3 * K + 3].add(dp_vis[:, r])
            b = b.at[r1 + r].set(RdP[:, r])
        else:
            b = b.at[r1 + r].set(RdP[:, r] - dp_vis[:, r])
        A = A.at[r1 + r, :].add(row)
    sol = jnp.linalg.lstsq(A, b)[0]
    v_lin = sol[:3 * K].reshape(K, 3)
    g_lin = sol[3 * K:3 * K + 3]
    gn = g_lin / jnp.maximum(jnp.linalg.norm(g_lin), 1e-9)
    if with_scale:
        # Scale estimation is an errors-in-variables problem: both sides
        # of s*dp_vis = IMU-implied-displacement carry noise. The forward
        # regression (s as slope on the noisy visual deltas) is biased
        # LOW — observed to collapse s by 100x on weakly-excited
        # trajectories; the inverse regression (mu = 1/s as slope on the
        # IMU side, which carries the gravity-direction error) is biased
        # HIGH. The geometric mean of the two slopes is the classic
        # reduced-major-axis estimator and lands on the consistent value.
        # Chain velocities follow the preintegration exactly:
        # v_i = v_0 + sum(g T + R dV); displacement_i = v_i*T_i
        # + 0.5 g T_i^2 + R_i dP_i.
        g_fix = 9.81 * gn
        chain = jnp.concatenate([
            jnp.zeros((1, 3), dt),
            jnp.cumsum(g_fix[None, :] * T[:, None] + RdV, axis=0)])
        disp = chain[:-1] * T[:, None] + 0.5 * g_fix[None, :] \
            * (T * T)[:, None] + RdP                       # (K-1,3)
        # inverse: dp_vis = w0*T + mu*disp  (w0 = v0/s, mu = 1/s)
        A2 = jnp.zeros((3 * (K - 1), 4), dt)
        for r in range(3):
            A2 = A2.at[3 * idx + r, r].set(T)
            A2 = A2.at[3 * idx + r, 3].set(disp[:, r])
        sol2 = jnp.linalg.lstsq(A2, dp_vis.reshape(-1))[0]
        mu = sol2[3]
        s_inv = jnp.where(mu > 1e-4, 1.0 / jnp.maximum(mu, 1e-4),
                          jnp.abs(sol[3 * K + 3]))
        # forward: s*dp_vis - v0*T = disp
        A3 = jnp.zeros((3 * (K - 1), 4), dt)
        for r in range(3):
            A3 = A3.at[3 * idx + r, r].set(T)
            A3 = A3.at[3 * idx + r, 3].set(dp_vis[:, r])
        sol3 = jnp.linalg.lstsq(A3, disp.reshape(-1))[0]
        s_fwd = jnp.abs(sol3[3])
        s_lin = jnp.clip(jnp.sqrt(jnp.maximum(s_fwd * s_inv, 1e-6)),
                         1e-2, 1e3)
        # re-seed metric velocities consistently with the chain
        v_lin = sol2[None, :3] * s_lin + chain
    else:
        s_lin = jnp.ones((), dt)
    # gravity-direction seed: R_wg0 aligns [0,0,-1] to g_lin
    e3n = jnp.asarray([0.0, 0.0, -1.0], dt)
    ax = jnp.cross(e3n, gn)
    sin_a = jnp.linalg.norm(ax)
    cos_a = jnp.dot(e3n, gn)
    ang = jnp.arctan2(sin_a, cos_a)
    ax = jnp.where(sin_a > 1e-9, ax / jnp.maximum(sin_a, 1e-9),
                   jnp.asarray([1.0, 0.0, 0.0], dt))
    R_wg0 = lie.so3_exp(ax * ang)

    def x_unpack(x):
        rg = jnp.concatenate([x[:2], jnp.zeros(1, dt)])
        R_wg = R_wg0 @ lie.so3_exp(rg)
        bg = x[2:5]
        ba = x[5:8]
        s = s_lin * jnp.exp(x[8]) if with_scale else jnp.ones((), dt)
        vels = v_lin + x[9:].reshape(K, 3)
        return R_wg, bg, ba, s, vels

    def residuals(x):
        R_wg, bg, ba, s, vels = x_unpack(x)
        g = R_wg @ jnp.asarray([0.0, 0.0, -G0], dt)

        def one(i):
            st = jax.tree.map(lambda a: a[i], preints)
            T = st.dT
            dR = imu.delta_rotation(st, bg)
            dV = imu.delta_velocity(st, bg, ba)
            dP = imu.delta_position(st, bg, ba)
            er = lie.so3_log(dR.T @ R_wb[i].T @ R_wb[i + 1])
            ev = R_wb[i].T @ (vels[i + 1] - vels[i] - g * T) - dV
            ep = R_wb[i].T @ (s * (p_wb[i + 1] - p_wb[i]) - vels[i] * T
                              - 0.5 * g * T * T) - dP
            r = jnp.concatenate([er, ev, ep])
            # whiten with the preintegration information (EdgeInertialGS
            # carries C^-1; without it the bias priors dominate)
            L = imu.sqrt_information(st)
            return L.T @ r

        res = jax.vmap(one)(jnp.arange(K - 1)).reshape(-1)
        prior = jnp.concatenate([jnp.sqrt(prior_g) * bg,
                                 jnp.sqrt(prior_a) * ba])
        if with_scale:
            # pin log-scale to the unbiased inverse-regression estimate:
            # the whitened MAP treats the visual poses as noiseless, so
            # its scale gradient carries the same errors-in-variables
            # shrinkage the linear forward solve does — scale is decided
            # by the unbiased estimator, gravity/bias/velocities by the
            # MAP (ref ScaleRefinement re-fits s separately too,
            # src/LocalMapping.cc:231-241)
            prior = jnp.concatenate([prior, 1e4 * x[8:9]])
        return jnp.concatenate([res, prior])

    # the linear alignment already seeds velocities/gravity/scale; the GN
    # state starts at zero deltas around it
    x0 = jnp.zeros(9 + 3 * K, dt)

    def gn(i, x):
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = J.T @ J + 1e-6 * jnp.eye(x.shape[0], dtype=dt)
        return x + jnp.linalg.solve(H, -J.T @ r)

    x = jax.lax.fori_loop(0, n_iters, gn, x0)
    R_wg, bg, ba, s, vels = x_unpack(x)
    r = residuals(x)
    return InertialInitResult(R_wg=R_wg, bg=bg, ba=ba, scale=s, vels=vels,
                              cost=jnp.sum(r * r))

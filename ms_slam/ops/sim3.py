"""Batched Horn alignment + RANSAC for loop-closure geometric verification.

Replaces Sim3Solver (/root/reference/src/Sim3Solver.cc: RANSAC over 3-point
samples, Horn closed form via ComputeSim3, reprojection-gated inliers in
both cameras). Formulation: all RANSAC hypotheses are computed at once
(vmapped 3-point Horn), inliers counted by masked reprojection for every
hypothesis simultaneously, best hypothesis refined once on its inliers.
Scale is optional: fixed to 1 for stereo/RGB-D (bFixScale=true in the
reference) and free for monocular.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import cameras, hamming, lie


def horn(X: jnp.ndarray, Y: jnp.ndarray, w: jnp.ndarray,
         with_scale: bool = False):
    """Weighted closed-form alignment Y ~ s R X + t.

    X, Y: (...,N,3); w: (...,N) weights. Returns (s, R, t)."""
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    wn = w / wsum
    mx = jnp.sum(X * wn[..., None], axis=-2, keepdims=True)
    my = jnp.sum(Y * wn[..., None], axis=-2, keepdims=True)
    Xc = (X - mx) * jnp.sqrt(wn)[..., None]
    Yc = (Y - my) * jnp.sqrt(wn)[..., None]
    H = jnp.einsum("...ni,...nj->...ij", Yc, Xc)
    U, S, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None],
         det[..., None]], axis=-1)
    R = U @ (D[..., :, None] * Vt)
    if with_scale:
        num = jnp.sum(S * D, axis=-1)
        den = jnp.maximum(jnp.sum(Xc * Xc, axis=(-1, -2)), 1e-12)
        s = num / den
    else:
        s = jnp.ones(R.shape[:-2], R.dtype)
    t = my[..., 0, :] - s[..., None] * jnp.einsum("...ij,...j->...i",
                                                  R, mx[..., 0, :])
    return s, R, t


class Sim3RansacResult(NamedTuple):
    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray     # (N,) bool
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("model", "n_hyp", "with_scale"))
def sim3_ransac(model: int, params: jnp.ndarray,
                Xc1: jnp.ndarray, Xc2: jnp.ndarray,
                sigma2_1: jnp.ndarray, sigma2_2: jnp.ndarray,
                valid: jnp.ndarray, key: jnp.ndarray,
                n_hyp: int = 128, with_scale: bool = False,
                chi2_th: float = 9.21) -> Sim3RansacResult:
    """Estimate S12 mapping camera-2-frame points into camera-1's frame.

    Xc1/Xc2: (N,3) the same landmarks in each keyframe's camera frame
    (ref Sim3Solver ctor gathers camera-frame coords). Inliers are gated by
    reprojection in both cameras (ref CheckInliers, chi2 9.21 ~ 2dof 99%).
    """
    N = Xc1.shape[0]
    # random 3-point samples biased to valid entries
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 3), replace=True, p=p)
    Xs = Xc2[idx]                     # (H,3,3) from cam2
    Ys = Xc1[idx]                     # (H,3,3) to cam1
    w = jnp.ones((n_hyp, 3), Xc1.dtype)
    s, R, t = horn(Xs, Ys, w, with_scale)   # maps cam2 -> cam1

    # count reprojection inliers per hypothesis
    uv1 = cameras.project(model, params, Xc1)          # observed proxies
    uv2 = cameras.project(model, params, Xc2)

    def count(args):
        s_h, R_h, t_h = args
        X2in1 = s_h * (Xc2 @ R_h.T) + t_h
        e1 = jnp.sum((cameras.project(model, params, X2in1) - uv1) ** 2, -1) \
            / sigma2_1
        si = 1.0 / s_h
        X1in2 = si * ((Xc1 - t_h) @ R_h)
        e2 = jnp.sum((cameras.project(model, params, X1in2) - uv2) ** 2, -1) \
            / sigma2_2
        ok = valid & (e1 < chi2_th) & (e2 < chi2_th) \
            & (X2in1[:, 2] > 0) & (X1in2[:, 2] > 0)
        return ok

    ok_all = jax.vmap(lambda s_h, R_h, t_h: count((s_h, R_h, t_h)))(s, R, t)
    scores = jnp.sum(ok_all, axis=1)
    best = jnp.argmax(scores)
    inl = ok_all[best]
    # refine on the best hypothesis' inliers
    s_f, R_f, t_f = horn(Xc2, Xc1, inl.astype(Xc1.dtype), with_scale)
    inl_f = count((s_f, R_f, t_f))
    better = jnp.sum(inl_f) >= scores[best]
    s_o = jnp.where(better, s_f, s[best])
    R_o = jnp.where(better, R_f, R[best])
    t_o = jnp.where(better, t_f, t[best])
    inl_o = jnp.where(better, inl_f, inl)
    return Sim3RansacResult(s=s_o, R=R_o, t=t_o, inliers=inl_o,
                            n_inliers=jnp.sum(inl_o).astype(jnp.int32))


class Sim3RefineResult(NamedTuple):
    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def sim3_refine(model: int, params: jnp.ndarray,
                Xc1: jnp.ndarray, Xc2: jnp.ndarray,
                uv1: jnp.ndarray, uv2: jnp.ndarray,
                sigma2_1: jnp.ndarray, sigma2_2: jnp.ndarray,
                mask: jnp.ndarray,
                s0: jnp.ndarray, R0: jnp.ndarray, t0: jnp.ndarray,
                with_scale: bool = False, n_iters: int = 10,
                th2: float = 10.0) -> Sim3RefineResult:
    """Iterative Sim(3) Gauss-Newton refinement (ref Optimizer::OptimizeSim3,
    /root/reference/src/Optimizer.cc:1986: bidirectional reprojection edges
    EdgeSim3ProjectXYZ/EdgeInverseSim3ProjectXYZ with Huber delta sqrt(th2),
    th2 = 10). State: [omega(3), dt(3), dlog s] around (s0, R0, t0) mapping
    camera-2 coords into camera-1 coords. Huber-weighted IRLS with a final
    chi2 inlier count in both directions."""
    dt_ = Xc1.dtype
    D = 7 if with_scale else 6

    def unpack(x):
        R = lie.normalize_rotation(lie.so3_exp(x[:3]) @ R0)
        t = t0 + x[3:6]
        s = s0 * jnp.exp(x[6]) if with_scale else s0
        return s, R, t

    def raw_res(x):
        s, R, t = unpack(x)
        X2in1 = s * (Xc2 @ R.T) + t
        e1 = (cameras.project(model, params, X2in1) - uv1) \
            / jnp.sqrt(sigma2_1)[:, None]
        X1in2 = ((Xc1 - t) @ R) / s
        e2 = (cameras.project(model, params, X1in2) - uv2) \
            / jnp.sqrt(sigma2_2)[:, None]
        cheir = (X2in1[:, 2] > 0.05) & (X1in2[:, 2] > 0.05)
        return e1, e2, cheir

    def residuals(x, sw):
        e1, e2, _ = raw_res(x)
        return jnp.concatenate([(e1 * sw[:, 0:1]).reshape(-1),
                                (e2 * sw[:, 1:2]).reshape(-1)])

    def gn(i, x):
        e1, e2, cheir = raw_res(x)
        chi1 = jnp.sum(e1 * e1, -1)
        chi2c = jnp.sum(e2 * e2, -1)
        # Huber weights (IRLS), frozen wrt x in the differentiated path
        w1 = jnp.where(chi1 > th2, jnp.sqrt(th2 / jnp.maximum(chi1, 1e-9)),
                       1.0)
        w2 = jnp.where(chi2c > th2, jnp.sqrt(th2 / jnp.maximum(chi2c, 1e-9)),
                       1.0)
        m = (mask & cheir).astype(dt_)
        sw = jax.lax.stop_gradient(
            jnp.stack([w1 * m, w2 * m], -1))
        r = residuals(x, sw)
        J = jax.jacfwd(residuals)(x, sw)
        Hm = J.T @ J + 1e-6 * jnp.eye(D, dtype=dt_)
        return x + jnp.linalg.solve(Hm, -J.T @ r)

    x = jax.lax.fori_loop(0, n_iters, gn, jnp.zeros(D, dt_))
    s, R, t = unpack(x)
    e1, e2, cheir = raw_res(x)
    inl = mask & cheir & (jnp.sum(e1 * e1, -1) < th2) \
        & (jnp.sum(e2 * e2, -1) < th2)
    return Sim3RefineResult(s=s, R=R, t=t, inliers=inl,
                            n_inliers=jnp.sum(inl).astype(jnp.int32))


def sim3_refine_world(model: int, params: jnp.ndarray,
                      Xw: jnp.ndarray, uv: jnp.ndarray,
                      sigma2: jnp.ndarray, mask: jnp.ndarray,
                      s0: jnp.ndarray, R0: jnp.ndarray, t0: jnp.ndarray,
                      with_scale: bool = False, n_iters: int = 10,
                      th2: float = 10.0) -> Sim3RefineResult:
    """Forward-only Sim(3) refinement of S_cw (world -> camera) from
    landmark -> feature correspondences. The OptimizeSim3 analog used by
    temporal loop-hypothesis refinement (ref DetectAndReffineSim3FromLastKF,
    /root/reference/src/LoopClosing.cc:539-581), where the matched side
    contributes a landmark POOL (its covisible window's map points) rather
    than per-feature pairs — so only the EdgeSim3ProjectXYZ direction
    exists. Huber-weighted IRLS, state [omega(3), dt(3), dlog s]."""
    dt_ = Xw.dtype
    D = 7 if with_scale else 6

    def unpack(x):
        R = lie.normalize_rotation(lie.so3_exp(x[:3]) @ R0)
        t = t0 + x[3:6]
        s = s0 * jnp.exp(x[6]) if with_scale else s0
        return s, R, t

    def raw_res(x):
        s, R, t = unpack(x)
        Xc = s * (Xw @ R.T) + t
        e = (cameras.project(model, params, Xc) - uv) \
            / jnp.sqrt(sigma2)[:, None]
        return e, Xc[:, 2] > 0.05

    def residuals(x, sw):
        e, _ = raw_res(x)
        return (e * sw[:, None]).reshape(-1)

    def gn(i, x):
        e, cheir = raw_res(x)
        chi = jnp.sum(e * e, -1)
        w = jnp.where(chi > th2, jnp.sqrt(th2 / jnp.maximum(chi, 1e-9)), 1.0)
        sw = jax.lax.stop_gradient(w * (mask & cheir).astype(dt_))
        r = residuals(x, sw)
        J = jax.jacfwd(residuals)(x, sw)
        Hm = J.T @ J + 1e-6 * jnp.eye(D, dtype=dt_)
        return x + jnp.linalg.solve(Hm, -J.T @ r)

    x = jax.lax.fori_loop(0, n_iters, gn, jnp.zeros(D, dt_))
    s, R, t = unpack(x)
    e, cheir = raw_res(x)
    inl = mask & cheir & (jnp.sum(e * e, -1) < th2)
    return Sim3RefineResult(s=s, R=R, t=t, inliers=inl,
                            n_inliers=jnp.sum(inl).astype(jnp.int32))


def sim3_guided_match(model: int, params: jnp.ndarray,
                      s: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray,
                      Xc2: jnp.ndarray, valid2: jnp.ndarray,
                      desc2: jnp.ndarray,
                      xy1: jnp.ndarray, octave1: jnp.ndarray,
                      desc1: jnp.ndarray, valid1: jnp.ndarray,
                      img_w: float, img_h: float,
                      th_radius: float = 7.5,
                      scale_factor: float = 1.2,
                      max_dist: int = 100) -> jnp.ndarray:
    """Sim3-guided projection search one way (ref
    ORBmatcher::SearchByProjection(KF, Scw, ...) src/ORBmatcher.cc:532 and
    SearchBySim3 :1718): project keyframe-2 landmarks into keyframe-1's
    image under S12 and match descriptors within a scale-aware radius.
    Distances up to TH_HIGH qualify — this is what harvests viewpoint-
    changed matches the mutual TH_LOW/ratio matcher drops.

    Returns (N2,) best keyframe-1 feature index per keyframe-2 feature
    (-1 if none)."""
    X2in1 = s * (Xc2 @ R.T) + t
    uv = cameras.project(model, params, X2in1)
    vis = valid2 & (X2in1[:, 2] > 0.05) \
        & (uv[:, 0] >= 0) & (uv[:, 0] < img_w) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
    radius = th_radius * scale_factor ** octave1.astype(jnp.float32)
    d = hamming.hamming_matrix(desc2, desc1)            # (N2,N1)
    du = jnp.abs(uv[:, 0:1] - xy1[None, :, 0])
    dv = jnp.abs(uv[:, 1:2] - xy1[None, :, 1])
    near = (du <= radius[None, :]) & (dv <= radius[None, :])
    ok = near & vis[:, None] & valid1[None, :]
    BIG = jnp.asarray(1 << 15, d.dtype)
    d = jnp.where(ok, d, BIG)
    best1 = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best1[:, None], 1)[:, 0]
    return jnp.where(best_d <= max_dist, best1, -1).astype(jnp.int32)

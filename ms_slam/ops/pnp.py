"""Prior-free PnP RANSAC for relocalization.

Replaces the reference's MLPnPsolver (/root/reference/src/MLPnPsolver.cpp,
used at src/Tracking.cc:3688-3713): estimate a camera pose from 2D-3D
matches with NO pose prior — required when the true pose is far from every
stored keyframe pose. Formulation: a fixed budget of 6-point DLT
hypotheses solved as one batched eigendecomposition (the per-hypothesis
12x12 normal matrix), orthonormalized by Procrustes, scored by batched
reprojection chi2 — no data-dependent iteration (SURVEY §7 "RANSAC /
data-dependent iteration" mitigation).

The reference uses a 6-point minimal set too (MLPnP minSet=6,
SURVEY Appendix A "Relocalization"); DLT + orthonormalization is the
classic linear P6P, and the caller refines with pose_optimize afterwards
exactly like the reference refines with PoseOptimization.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import cameras, robust

CHI2_GATE = robust.CHI2_2DOF  # 5.991 (ref MLPnP RANSAC chi2)


class PnPResult(NamedTuple):
    R: jnp.ndarray         # (3,3) world->camera
    t: jnp.ndarray         # (3,)
    inlier: jnp.ndarray    # (N,)
    n_inliers: jnp.ndarray
    ok: jnp.ndarray        # () bool — enough inliers to trust


@partial(jax.jit, static_argnames=("model", "n_hyp", "min_inliers"))
def pnp_ransac(model: int, params: jnp.ndarray,
               X: jnp.ndarray, uv: jnp.ndarray, sigma2: jnp.ndarray,
               valid: jnp.ndarray, key: jnp.ndarray,
               n_hyp: int = 256, min_inliers: int = 10) -> PnPResult:
    """Estimate T_cw from N putative 2D-3D matches.

    X: (N,3) world points; uv: (N,2) pixels; sigma2: per-match measurement
    variance; valid: (N,) putative-match mask.
    """
    N = X.shape[0]
    dt = X.dtype
    # normalized image coordinates (pinhole/KB8 via unproject)
    xn = cameras.unproject(model, params, uv)       # (N,3) rays, z=1 scaled
    xn = xn / jnp.maximum(xn[..., 2:3], 1e-9)

    p = valid.astype(dt)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 6), replace=True, p=p)

    Xs = X[idx]                                     # (H,6,3)
    xs = xn[idx][..., :2]                           # (H,6,2)

    # conditioning: center + scale the 3D points per hypothesis
    c = jnp.mean(Xs, axis=1, keepdims=True)
    s = jnp.mean(jnp.linalg.norm(Xs - c, axis=-1), axis=1) + 1e-9
    Xc = (Xs - c) / s[:, None, None]

    # DLT rows: for P = [R|t] (3x4), x ~ P [X;1]
    #   u*(p3.Xh) - (p1.Xh) = 0 ;  v*(p3.Xh) - (p2.Xh) = 0
    ones = jnp.ones(Xc.shape[:2] + (1,), dt)
    Xh = jnp.concatenate([Xc, ones], axis=-1)       # (H,6,4)
    z4 = jnp.zeros_like(Xh)
    u = xs[..., 0:1]
    v = xs[..., 1:2]
    rows_u = jnp.concatenate([-Xh, z4, u * Xh], axis=-1)   # (H,6,12)
    rows_v = jnp.concatenate([z4, -Xh, v * Xh], axis=-1)
    A = jnp.concatenate([rows_u, rows_v], axis=1)   # (H,12,12)

    # min right-singular vector via eigh of A^T A (batched)
    AtA = jnp.einsum("hij,hik->hjk", A, A)
    w, V = jnp.linalg.eigh(AtA)
    pvec = V[..., 0]                                # (H,12) smallest eig
    P = pvec.reshape(-1, 3, 4)

    # Procrustes orthonormalization of M = P[:, :3]
    M = P[:, :, :3]
    Um, Sm, Vmt = jnp.linalg.svd(M)
    detUV = jnp.linalg.det(jnp.einsum("hij,hjk->hik", Um, Vmt))
    D = jnp.stack([jnp.ones_like(detUV), jnp.ones_like(detUV), detUV], -1)
    R = jnp.einsum("hij,hj,hjk->hik", Um, D, Vmt)   # (H,3,3) det=+1
    scale = jnp.mean(Sm, axis=-1) * jnp.sign(detUV)  # include reflection fix
    t = P[:, :, 3] / jnp.where(jnp.abs(scale) > 1e-12, scale, 1e-12)[:, None]

    # cheirality: majority of sample points must be in front; else flip
    Xcam = jnp.einsum("hij,hnj->hni", R, Xc) + t[:, None, :]
    neg = jnp.sum(Xcam[..., 2] < 0, axis=1) > 3
    R = jnp.where(neg[:, None, None], -R, R)
    t = jnp.where(neg[:, None], -t, t)
    # R must stay a rotation after the sign flip (det flips for odd dim):
    # re-orthonormalize the flipped ones by negating one column pair is
    # wrong — instead flip via diag(1,1,-1) conjugation-free fix:
    detR = jnp.linalg.det(R)
    R = jnp.where((detR < 0)[:, None, None], -R, R)

    # undo conditioning: X_cam = R (X - c)/s + t  =>  T_cw on raw X:
    #   R_raw = R, t_raw = s*t' ... with X_cam_raw = s * X_cam_cond
    #   (scale the translation back and the whole pose is metric again)
    t_raw = s[:, None] * t - jnp.einsum("hij,hj->hi", R, c[:, 0, :])

    # score every hypothesis on all matches
    def score(Rh, th):
        Xc_all = jnp.einsum("ij,nj->ni", Rh, X) + th
        uvp = cameras.project(model, params, Xc_all)
        chi2 = jnp.sum((uv - uvp) ** 2, -1) / jnp.maximum(sigma2, 1e-9)
        inl = valid & (chi2 < CHI2_GATE) & (Xc_all[..., 2] > 0.05)
        return jnp.sum(inl)

    n_in = jax.vmap(score)(R, t_raw)
    best = jnp.argmax(n_in)
    Rb, tb = R[best], t_raw[best]
    Xc_all = jnp.einsum("ij,nj->ni", Rb, X) + tb
    uvp = cameras.project(model, params, Xc_all)
    chi2 = jnp.sum((uv - uvp) ** 2, -1) / jnp.maximum(sigma2, 1e-9)
    inlier = valid & (chi2 < CHI2_GATE) & (Xc_all[..., 2] > 0.05)
    n = jnp.sum(inlier).astype(jnp.int32)
    return PnPResult(R=Rb.astype(dt), t=tb.astype(dt), inlier=inlier,
                     n_inliers=n, ok=n >= min_inliers)

"""Monocular two-view reconstruction (map initialization).

Replaces TwoViewReconstruction (/root/reference/src/TwoViewReconstruction.cc:
parallel homography/fundamental RANSAC + model selection + motion hypothesis
decomposition + cheirality-checked triangulation, called from
Pinhole::ReconstructWithTwoViews).

Formulation: all RANSAC hypotheses at once — vmapped 8-point essential
AND 8-point homography estimation on unprojected bearings (camera-model
agnostic), symmetric transfer scoring of every hypothesis against every
match in one pass, reference-style truncated-score model selection
(SH/(SH+SF), ref TwoViewReconstruction::Reconstruct picks H when the ratio
exceeds 0.5), then the 4-way (R,t) decomposition of the best E or the
8-way Faugeras decomposition of the best H, resolved by batched cheirality
counting over all candidates in one pass (ref ReconstructF/ReconstructH,
include/TwoViewReconstruction.h:57-60). The homography path is what keeps
planar / low-parallax scenes from degenerating — exactly the regime where
the essential matrix is ambiguous.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import cameras, lie, triangulate


class TwoViewResult(NamedTuple):
    ok: jnp.ndarray        # () bool
    R: jnp.ndarray         # (3,3) cam2-from-cam1
    t: jnp.ndarray         # (3,) unit norm
    X1: jnp.ndarray        # (N,3) points in cam1 frame
    inlier: jnp.ndarray    # (N,) bool (triangulated + cheirality-clean)
    n_good: jnp.ndarray


def _essential_8pt(x1, x2, w=None):
    """x1,x2: (S,3) bearings (z=1). Returns E (3,3). w: optional (S,)
    row weights (inlier refit: outlier rows zeroed out)."""
    a = jnp.stack([
        x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0] * x1[:, 2],
        x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1] * x1[:, 2],
        x2[:, 2] * x1[:, 0], x2[:, 2] * x1[:, 1], x2[:, 2] * x1[:, 2],
    ], axis=-1)                                   # (S,9), rows a_i . e = 0
    if w is not None:
        a = a * w[:, None]
    _, _, Vt = jnp.linalg.svd(a, full_matrices=True)
    E = Vt[-1].reshape(3, 3)
    # project onto the essential manifold: singular values (1,1,0)
    U, S, Vt2 = jnp.linalg.svd(E)
    E = U @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], E.dtype)) @ Vt2
    return E


def _epi_errs2(E, x1, x2, f2):
    """Squared point-to-epipolar-line distances in each image (px^2):
    returns (d_in_2, d_in_1) — the two directions scored separately like
    the reference's CheckFundamental."""
    l2 = x1 @ E.T                                  # epipolar lines in cam 2
    l1 = x2 @ E
    num = jnp.einsum("nj,nj->n", x2, l2) ** 2
    d2 = num / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    d1 = num / (l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    return d2 * f2 * f2, d1 * f2 * f2


def _homography_dlt(x1, x2, w=None):
    """x1,x2: (S,3) bearings (z=1). H with x2 ~ H x1 via DLT. w: optional
    (S,) row weights (inlier refit)."""
    z = jnp.zeros_like(x1)
    r1 = jnp.concatenate([z, -x1, x2[:, 1:2] * x1], -1)       # (S,9)
    r2 = jnp.concatenate([x1, z, -x2[:, 0:1] * x1], -1)
    if w is not None:
        r1 = r1 * w[:, None]
        r2 = r2 * w[:, None]
    a = jnp.concatenate([r1, r2], 0)                          # (2S,9)
    _, _, Vt = jnp.linalg.svd(a, full_matrices=True)
    return Vt[-1].reshape(3, 3)


def _h_errs(H, x1, x2, f2):
    """Squared symmetric homography transfer distances (px^2): (d12, d21)."""
    Hi = lie.inv3x3(H)
    y2 = x1 @ H.T
    y1 = x2 @ Hi.T
    y2 = y2 / jnp.where(jnp.abs(y2[:, 2:3]) > 1e-9, y2[:, 2:3], 1e-9)
    y1 = y1 / jnp.where(jnp.abs(y1[:, 2:3]) > 1e-9, y1[:, 2:3], 1e-9)
    d21 = jnp.sum((y2[:, :2] - x2[:, :2]) ** 2, -1)
    d12 = jnp.sum((y1[:, :2] - x1[:, :2]) ** 2, -1)
    return d12 * f2 * f2, d21 * f2 * f2


def _decompose_homography(H):
    """Faugeras SVD decomposition of a calibrated homography into 8 motion
    hypotheses (R, t, n) (ref TwoViewReconstruction::ReconstructH — the
    d' = +/-d2 cases with the four sign combinations each).

    Returns (8,3,3) rotations and (8,3) unit translations."""
    dt = H.dtype
    U, S, Vt = jnp.linalg.svd(H)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = S[0], S[1], S[2]
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    e1 = jnp.asarray([1.0, 1.0, -1.0, -1.0], dt)
    e3 = jnp.asarray([1.0, -1.0, 1.0, -1.0], dt)

    # case d' = +d2: rotation about y by theta
    st_den = jnp.maximum((d1 + d3) * d2, 1e-12)
    sin_t = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / st_den
    cos_t = (d2 * d2 + d1 * d3) / st_den

    def case_pos(i):
        stheta = e1[i] * e3[i] * sin_t
        Rp = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                          [0.0, 0.0, 1.0]], dt)
        Rp = Rp.at[0, 0].set(cos_t).at[0, 2].set(-stheta) \
               .at[2, 0].set(stheta).at[2, 2].set(cos_t)
        tp = (d1 - d3) * jnp.asarray(
            [e1[i] * aux1, 0.0, -e3[i] * aux3], dt)
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # case d' = -d2: rotation about y by phi composed with diag(1,-1,-1)
    sp_den = jnp.maximum((d1 - d3) * d2, 1e-12)
    sin_p = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / sp_den
    cos_p = (d1 * d3 - d2 * d2) / sp_den

    def case_neg(i):
        sphi = e1[i] * e3[i] * sin_p
        Rp = jnp.asarray([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                          [0.0, 0.0, -1.0]], dt)
        Rp = Rp.at[0, 0].set(cos_p).at[0, 2].set(sphi) \
               .at[2, 0].set(sphi).at[2, 2].set(-cos_p)
        tp = (d1 + d3) * jnp.asarray(
            [e1[i] * aux1, 0.0, e3[i] * aux3], dt)
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    idx = jnp.arange(4)
    Rp_, tp_ = jax.vmap(case_pos)(idx)
    Rn_, tn_ = jax.vmap(case_neg)(idx)
    return (jnp.concatenate([Rp_, Rn_], 0),
            jnp.concatenate([tp_, tn_], 0))


@partial(jax.jit, static_argnames=("model", "n_hyp"))
def reconstruct(model: int, params: jnp.ndarray,
                xy1: jnp.ndarray, xy2: jnp.ndarray, valid: jnp.ndarray,
                key: jnp.ndarray, n_hyp: int = 256,
                th_px2: float = 4.0, min_parallax_cos: float = 0.99995):
    """Estimate relative pose + structure from matched features.

    xy1/xy2: (N,2) matched pixel coords (pairs aligned); valid: (N,).
    """
    N = xy1.shape[0]
    x1 = cameras.unproject(model, params, xy1)
    x2 = cameras.unproject(model, params, xy2)
    f = params[0]

    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 8), replace=True, p=p)

    # --- fundamental/essential hypotheses, truncated-score like the
    # reference's CheckFundamental (gate 3.841 per direction, score cap
    # 5.991, src/TwoViewReconstruction.cc CheckFundamental)
    Es = jax.vmap(lambda i: _essential_8pt(x1[i], x2[i]))(idx)

    def f_score(E):
        e2, e1 = _epi_errs2(E, x1, x2, f)
        sc = jnp.sum(jnp.where((e2 < 3.841) & valid, 5.991 - e2, 0.0)
                     + jnp.where((e1 < 3.841) & valid, 5.991 - e1, 0.0))
        inl_ = (e2 < 3.841) & (e1 < 3.841) & valid
        return sc, inl_

    f_sc, f_inl_all = jax.vmap(f_score)(Es)
    best = jnp.argmax(f_sc)
    # refit on all inliers of the best hypothesis (the 8-sample estimate
    # carries degrees of error; one masked-row SVD removes most of it)
    E = _essential_8pt(x1, x2, f_inl_all[best].astype(x1.dtype))
    SF, e_inl = f_score(E)

    # --- homography hypotheses, truncated-score like CheckHomography
    # (th 5.991 per direction)
    Hs = jax.vmap(lambda i: _homography_dlt(x1[i], x2[i]))(idx)

    def h_score(Hh):
        d12, d21 = _h_errs(Hh, x1, x2, f)
        sc = jnp.sum(jnp.where((d12 < 5.991) & valid, 5.991 - d12, 0.0)
                     + jnp.where((d21 < 5.991) & valid, 5.991 - d21, 0.0))
        inl_ = (d12 < 5.991) & (d21 < 5.991) & valid
        return sc, inl_

    h_sc, h_inl_all = jax.vmap(h_score)(Hs)
    h_best = jnp.argmax(h_sc)
    Hm = _homography_dlt(x1, x2, h_inl_all[h_best].astype(x1.dtype))
    SH, h_inl = h_score(Hm)

    # model selection (ref Reconstruct: RH = SH/(SH+SF), H when RH > 0.5)
    use_H = SH / jnp.maximum(SH + SF, 1e-9) > 0.5

    # decompose E: 4 hypotheses (R1,t),(R1,-t),(R2,t),(R2,-t)
    U, _, Vt = jnp.linalg.svd(E)
    d = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    U = U * jnp.where(d < 0, -1.0, 1.0)
    Wm = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     E.dtype)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    tu = U[:, 2]
    tu = tu / (jnp.linalg.norm(tu) + 1e-12)
    Rs_e = jnp.stack([R1, R1, R2, R2])
    ts_e = jnp.stack([tu, -tu, tu, -tu])

    # decompose H: 8 Faugeras hypotheses
    Rs_h, ts_h = _decompose_homography(Hm)
    R_cand = jnp.concatenate([Rs_e, Rs_h], 0)              # (12,3,3)
    t_cand = jnp.concatenate([ts_e, ts_h], 0)              # (12,3)
    is_h = jnp.concatenate([jnp.zeros(4, bool), jnp.ones(8, bool)])
    # each family's candidates are checked against ITS model's inliers
    # (ref ReconstructF/ReconstructH each use their own vbMatchesInliers)
    inl_cand = jnp.where(is_h[:, None], h_inl[None, :], e_inl[None, :])

    def check(R, t, m_inl):
        P1 = jnp.broadcast_to(
            jnp.concatenate([jnp.eye(3, dtype=E.dtype),
                             jnp.zeros((3, 1), E.dtype)], 1), (N, 3, 4))
        P2 = jnp.broadcast_to(
            jnp.concatenate([R, t[:, None]], 1), (N, 3, 4))
        X = triangulate.triangulate_dlt(x1, x2, P1, P2)
        z1 = X[:, 2]
        Xc2 = lie.se3_apply(R, t, X)
        z2 = Xc2[:, 2]
        # reprojection gates both views (ref CheckRT 4*sigma^2 gate;
        # a model inlier can still triangulate badly under a wrong
        # motion hypothesis)
        r1 = X[:, :2] / jnp.maximum(z1[:, None], 1e-9) - x1[:, :2]
        r2 = Xc2[:, :2] / jnp.maximum(z2[:, None], 1e-9) - x2[:, :2]
        rep_ok = (jnp.sum(r1 * r1, -1) * f * f < 4.0) \
            & (jnp.sum(r2 * r2, -1) * f * f < 4.0)
        # parallax: rays from both camera centers
        o2 = -R.T @ t
        v1 = X
        v2 = X - o2
        cosp = jnp.sum(v1 * v2, -1) / (
            jnp.linalg.norm(v1, axis=-1) * jnp.linalg.norm(v2, axis=-1)
            + 1e-12)
        good = m_inl & (z1 > 0) & (z2 > 0) & rep_ok
        parallax_ok = good & (cosp < min_parallax_cos)
        return jnp.sum(good), jnp.sum(parallax_ok), X, good & (
            cosp < 0.99999)

    counts, npar, Xs, goods = jax.vmap(check)(R_cand, t_cand, inl_cand)

    def family_pick(fam):
        c = jnp.where(is_h == fam, counts, -1)
        bi = jnp.argmax(c)
        n_best = c[bi]
        # duplicate candidates (degenerate decompositions collapse sign
        # branches into numerically identical (R,t)) must not defeat the
        # dominance check
        dup = (jnp.sum((R_cand - R_cand[bi]) ** 2, (-2, -1)) < 1e-6) \
            & (jnp.abs(jnp.einsum("cj,j->c", t_cand, t_cand[bi])) > 0.9999)
        second = jnp.max(jnp.where(dup, -1, c))
        n_model = jnp.sum(jnp.where(fam, h_inl, e_inl))
        ok_ = (n_best >= 50) & (n_best > 0.75 * n_model) \
            & (second < 0.8 * n_best) & (npar[bi] > 30)
        return bi, ok_

    bi_f, ok_f = family_pick(False)
    bi_h, ok_h = family_pick(True)
    # prefer the score-selected family; fall back to the other family only
    # when the selected one fails its gates (the reference would return
    # false and retry next frame — the fallback closes exactly the
    # planar-scene RH~0.5 coin-flip gap)
    pick_h = jnp.where(use_H, ok_h | ~ok_f, ok_h & ~ok_f)
    bi = jnp.where(pick_h, bi_h, bi_f)
    ok = jnp.where(pick_h, ok_h, ok_f)
    R_o, t_o, X_o, g_o = R_cand[bi], t_cand[bi], Xs[bi], goods[bi]
    n_best = counts[bi]
    return TwoViewResult(ok=ok, R=R_o, t=t_o, X1=X_o, inlier=g_o,
                         n_good=n_best)

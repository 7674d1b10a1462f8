"""Projection-guided and epipolar descriptor matching.

Replaces the grid-accelerated per-feature searches of ORBmatcher
(/root/reference/src/ORBmatcher.cc): SearchByProjection (track local map :43,
 last frame :1941), SearchForTriangulation (:1168) and the two Fuse variants
(:1404). There is no feature grid: every candidate pair's Hamming
distance comes from one matmul and the geometric gates are masks on that
matrix. Constants follow the reference (TH_HIGH=100, TH_LOW=50, nn-ratio;
SURVEY Appendix A).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import cameras, hamming, lie

TH_HIGH = 100
TH_LOW = 50
BIG = 1_000_000
HISTO_LENGTH = 30   # rotation-histogram bins (ref ORBmatcher.cc:37)


def rotation_consistency(idx_b: jnp.ndarray, angle_a: jnp.ndarray,
                         angle_b: jnp.ndarray,
                         n_bins: int = HISTO_LENGTH) -> jnp.ndarray:
    """Global in-plane-rotation consistency filter (ref ORBmatcher's
    rotHist + ComputeThreeMaxima, src/ORBmatcher.cc:233-414 and every other
    Search*): vote each match's keypoint-angle difference into n_bins,
    keep only matches in the top-3 bins (bins 2/3 dropped when under 10%
    of the max). Batched: one scatter-add histogram + top_k, no loops.

    idx_b: (Na,) match of a-feature -> b index, -1 = none. angle_a/angle_b
    in radians. Returns idx_b with inconsistent matches reset to -1."""
    valid = idx_b >= 0
    two_pi = 2.0 * jnp.pi
    rot = jnp.mod(angle_a - angle_b[jnp.clip(idx_b, 0)], two_pi)
    b = jnp.floor(rot * (n_bins / two_pi)).astype(jnp.int32) % n_bins
    counts = jnp.zeros((n_bins,), jnp.int32).at[
        jnp.where(valid, b, n_bins)].add(1, mode="drop")
    top_v, top_i = jax.lax.top_k(counts, 3)
    keep_bin = top_v >= jnp.maximum(
        (0.1 * top_v[0]).astype(top_v.dtype), 1)
    bin_ok = jnp.zeros((n_bins,), bool).at[top_i].max(keep_bin)
    return jnp.where(valid & bin_ok[b], idx_b, -1)


class ProjMatches(NamedTuple):
    mp_slot: jnp.ndarray   # (N,) index into the local-point buffer, -1 none
    n_matches: jnp.ndarray
    visible: jnp.ndarray   # (L,) bool: point passed the frustum test


def predict_octave(dist: jnp.ndarray, max_dist: jnp.ndarray,
                   scale_factor: float, n_levels: int) -> jnp.ndarray:
    """MapPoint::PredictScale (ref src/MapPoint.cc): level from distance."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-6), 1e-6)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


def search_by_projection(
    model: int, params: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray,
    img_w: int, img_h: int,
    pt_pos: jnp.ndarray, pt_normal: jnp.ndarray, pt_min_dist: jnp.ndarray,
    pt_max_dist: jnp.ndarray, pt_desc: jnp.ndarray, pt_valid: jnp.ndarray,
    f_xy: jnp.ndarray, f_octave: jnp.ndarray, f_desc: jnp.ndarray,
    f_valid: jnp.ndarray,
    th_radius: float, nn_ratio: float, scale_factor: float, n_levels: int,
    check_view_angle: bool = True,
    pt_angle: jnp.ndarray | None = None,
    f_angle: jnp.ndarray | None = None,
) -> ProjMatches:
    """Projection-guided association (ref ORBmatcher::SearchByProjection:43
    for track-local-map — no rotation histogram there — and :1941 for the
    last-frame motion-model variant, which HAS the histogram; pass
    pt_angle/f_angle only for the latter) + Frame::isInFrustum gating from
    Tracking::SearchLocalPoints.

    Returns per-feature local-point assignment (mutual-best, radius-, octave-
    and ratio-gated).
    """
    scales = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)

    Xc = lie.se3_apply(R, t, pt_pos)
    z = Xc[..., 2]
    uv = cameras.project(model, params, Xc)
    cam_center = -R.T @ t
    vec = pt_pos - cam_center
    dist = jnp.linalg.norm(vec, axis=-1)
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < img_w)
              & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
    in_range = (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    visible = pt_valid & (z > 0.2) & in_img & in_range
    if check_view_angle:
        cosv = jnp.sum(vec * pt_normal, axis=-1) / jnp.maximum(dist, 1e-6)
        visible &= cosv >= 0.5

    pred_oct = predict_octave(dist, pt_max_dist, scale_factor, n_levels)
    radius = th_radius * scales[pred_oct]            # (L,)

    d = hamming.hamming_matrix(pt_desc, f_desc)      # (L,N)
    du = jnp.abs(uv[:, 0:1] - f_xy[None, :, 0])
    dv = jnp.abs(uv[:, 1:2] - f_xy[None, :, 1])
    near = (du <= radius[:, None]) & (dv <= radius[:, None])
    oct_ok = ((f_octave[None, :] >= pred_oct[:, None] - 1)
              & (f_octave[None, :] <= pred_oct[:, None]))
    ok = near & oct_ok & visible[:, None] & f_valid[None, :]
    d = jnp.where(ok, d, BIG)

    # best + second-best feature per point (for the nn-ratio test);
    # two masked min/argmin passes instead of a top_k row sort
    best_f = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best_f[:, None], 1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_f].set(BIG)
    second_d = jnp.min(d2, axis=1)
    pt_good = (best_d <= TH_HIGH) & (best_d <= nn_ratio * second_d)

    # mutual best: the chosen feature's best point must be this point
    best_p_of_f = jnp.argmin(d, axis=0)              # (N,)
    L = pt_pos.shape[0]
    mutual = best_p_of_f[best_f] == jnp.arange(L)
    pt_good &= mutual

    # scatter point->feature assignment
    N = f_xy.shape[0]
    tgt = jnp.where(pt_good, best_f, N)
    mp_slot = jnp.full((N,), -1, jnp.int32).at[tgt].set(
        jnp.arange(L, dtype=jnp.int32), mode="drop")
    if pt_angle is not None and f_angle is not None:
        # orientation consistency vote over the final assignment (ref
        # rotation-histogram check in SearchByProjection, ORBmatcher.cc)
        mp_slot = rotation_consistency(
            mp_slot, f_angle, pt_angle)
    return ProjMatches(mp_slot=mp_slot,
                       n_matches=jnp.sum(mp_slot >= 0).astype(jnp.int32),
                       visible=visible)


class BowLikeMatches(NamedTuple):
    idx_b: jnp.ndarray     # (Na,) index into B's features, -1 none
    n_matches: jnp.ndarray


def mutual_match(desc_a: jnp.ndarray, valid_a: jnp.ndarray,
                 desc_b: jnp.ndarray, valid_b: jnp.ndarray,
                 max_dist: int = TH_LOW, nn_ratio: float = 0.7,
                 extra_mask: jnp.ndarray | None = None,
                 angle_a: jnp.ndarray | None = None,
                 angle_b: jnp.ndarray | None = None) -> BowLikeMatches:
    """Frame<->keyframe descriptor matching (stands in for SearchByBoW,
    ref ORBmatcher.cc:223/872 — the BoW FeatureVector there only restricts
    candidates for speed; here a full masked matrix is one matmul).

    extra_mask: optional (Na,Nb) additional gate (e.g. epipolar constraint).
    """
    d = hamming.hamming_matrix(desc_a, desc_b)
    ok = valid_a[:, None] & valid_b[None, :]
    if extra_mask is not None:
        ok &= extra_mask
    d = jnp.where(ok, d, BIG)
    best_b = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best_b[:, None], 1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_b].set(BIG)
    second_d = jnp.min(d2, axis=1)
    good = (best_d <= max_dist) & (best_d <= nn_ratio * second_d)
    best_a_of_b = jnp.argmin(d, axis=0)
    mutual = best_a_of_b[best_b] == jnp.arange(desc_a.shape[0])
    good &= mutual
    idx_b = jnp.where(good, best_b, -1).astype(jnp.int32)
    if angle_a is not None and angle_b is not None:
        # orientation consistency (ref SearchByBoW rotation histogram)
        idx_b = rotation_consistency(idx_b, angle_a, angle_b)
    return BowLikeMatches(idx_b=idx_b,
                          n_matches=jnp.sum(idx_b >= 0).astype(jnp.int32))


def epipolar_mask(model: int, params: jnp.ndarray,
                  R12: jnp.ndarray, t12: jnp.ndarray,
                  xy1: jnp.ndarray, xy2: jnp.ndarray,
                  sigma2_2: jnp.ndarray, thresh: float = 3.84) -> jnp.ndarray:
    """(N1,N2) mask: feature pairs consistent with the epipolar geometry of
    T12 (camera-2-from-camera-1), chi2-gated point-to-line distance in image
    2 (ref ORBmatcher::SearchForTriangulation epipolar check via
    GeometricCamera::epipolarConstrain)."""
    # Essential matrix E = [t]x R (for rays: x2^T E x1 = 0 with x in cam
    # coords); for pixels use F = K2^-T E K1^-1. We work with unprojected
    # rays so any camera model is supported.
    r1 = cameras.unproject(model, params, xy1)   # (N1,3)
    r2 = cameras.unproject(model, params, xy2)   # (N2,3)
    E = lie.hat(t12) @ R12
    l2 = r1 @ E.T                                 # (N1,3): epipolar line in cam2
    # point-line distance in normalized coords, scaled by focal length to be
    # approximately pixels
    num = jnp.abs(jnp.einsum("mj,nj->mn", l2, r2))
    den = jnp.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None] + 1e-9
    f = params[0]
    d_px = num / den * f
    return (d_px * d_px) <= thresh * sigma2_2[None, :]

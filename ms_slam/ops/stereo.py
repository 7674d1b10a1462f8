"""Batched rectified stereo matching.

Replaces Frame::ComputeStereoMatches (/root/reference/src/Frame.cc:743-):
per-row candidate search + best descriptor match + SAD subpixel refine +
median outlier sweep. Here the whole frame is matched at once:

- all-pairs Hamming matrix (matmul) masked by row band, octave compatibility
  and disparity bounds, then a masked argmin per left feature;
- subpixel: 11px horizontal SAD correlation swept +-5px with parabola fit,
  batched gathers on the pyramid level images;
- the reference's 1.5*1.48*median SAD sweep becomes a masked median gate.

Constants follow the reference: descriptor gate (TH_HIGH+TH_LOW)/2 = 75
(SURVEY Appendix A), band radius 2*scale[octave].
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import hamming
from .orb import Features, OrbConfig

DESC_GATE = 75
SAD_W = 5          # half-width of SAD patch (11px row window)
SAD_SEARCH = 5     # +-5 px sweep (ref Frame.cc subpixel L)


class StereoMatch(NamedTuple):
    u_right: jnp.ndarray  # (N,) float32, -1 where unmatched
    depth: jnp.ndarray    # (N,) float32, -1 where unmatched
    valid: jnp.ndarray    # (N,) bool


def match_stereo_stack(feats_l: Features, feats_r: Features,
                       stack_l: jnp.ndarray, stack_r: jnp.ndarray,
                       bf: float, min_z: float, cfg: OrbConfig
                       ) -> StereoMatch:
    """match_stereo on padded level stacks: the SAD refinement becomes one
    windowed gather per keypoint over its own level image (instead of 8
    masked per-level passes)."""
    N = feats_l.xy.shape[0]
    scales = jnp.asarray(cfg.level_scales(), dtype=jnp.float32)

    dist = hamming.hamming_matrix(feats_l.desc, feats_r.desc)  # (N,M)
    yl = feats_l.xy[:, 1][:, None]
    yr = feats_r.xy[:, 1][None, :]
    band = 2.0 * scales[feats_l.octave][:, None]
    row_ok = jnp.abs(yl - yr) <= band
    oct_ok = jnp.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    xl = feats_l.xy[:, 0][:, None]
    xr = feats_r.xy[:, 0][None, :]
    disp = xl - xr
    max_disp = bf / min_z
    disp_ok = (disp > 0.1) & (disp < max_disp)
    ok = row_ok & oct_ok & disp_ok & feats_l.valid[:, None] \
        & feats_r.valid[None, :]
    dist = jnp.where(ok, dist, 10_000)
    best = jnp.argmin(dist, axis=1)
    best_d = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    matched = best_d <= DESC_GATE

    # subpixel SAD on the keypoint's own level, single gather pass
    _, h, w = stack_l.shape
    lv = feats_l.octave
    inv_s = 1.0 / scales[lv]
    ul = feats_l.xy[:, 0] * inv_s
    vl = feats_l.xy[:, 1] * inv_s
    ur0 = feats_r.xy[best, 0] * inv_s
    yi = jnp.clip(jnp.round(vl).astype(jnp.int32), SAD_W, h - SAD_W - 1)
    xi = jnp.clip(jnp.round(ul).astype(jnp.int32), SAD_W + SAD_SEARCH,
                  w - SAD_W - SAD_SEARCH - 1)
    xri = jnp.clip(jnp.round(ur0).astype(jnp.int32), SAD_W + SAD_SEARCH,
                   w - SAD_W - SAD_SEARCH - 1)
    offs = jnp.arange(-SAD_W, SAD_W + 1)
    # flat 1-D gathers over the level stack
    base_l = lv * (h * w) + yi * w
    lp = stack_l.reshape(-1)[(base_l + xi)[:, None] + offs[None, :]]
    lp = lp - jnp.mean(lp, axis=1, keepdims=True)
    # right window covering all sweeps: (N, 2*(W+S)+1)
    woffs = jnp.arange(-(SAD_W + SAD_SEARCH), SAD_W + SAD_SEARCH + 1)
    rwin = stack_r.reshape(-1)[(base_l + xri)[:, None] + woffs[None, :]]
    sweeps = []
    for s in range(2 * SAD_SEARCH + 1):
        rp = jax.lax.dynamic_slice_in_dim(rwin, s, 2 * SAD_W + 1, axis=1)
        rp = rp - jnp.mean(rp, axis=1, keepdims=True)
        sweeps.append(jnp.sum(jnp.abs(lp - rp), axis=1))
    sad = jnp.stack(sweeps, axis=1)
    k = jnp.argmin(sad, axis=1)
    kc = jnp.clip(k, 1, 2 * SAD_SEARCH - 1)
    s_m1 = jnp.take_along_axis(sad, (kc - 1)[:, None], 1)[:, 0]
    s_0 = jnp.take_along_axis(sad, kc[:, None], 1)[:, 0]
    s_p1 = jnp.take_along_axis(sad, (kc + 1)[:, None], 1)[:, 0]
    denom = s_m1 + s_p1 - 2 * s_0
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      0.5 * (s_m1 - s_p1) / jnp.maximum(denom, 1e-6), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    off = (kc.astype(jnp.float32) - SAD_SEARCH + delta
           + xri.astype(jnp.float32) - ur0)
    ur_refined = (ur0 + off) * scales[lv]
    disparity = feats_l.xy[:, 0] - ur_refined
    matched = matched & (disparity > 0.01) & (disparity < max_disp)
    med = jnp.median(jnp.where(matched, s_0, jnp.nan))
    med = jnp.nan_to_num(med, nan=jnp.inf)
    matched = matched & (s_0 <= 1.5 * 1.48 * med)
    depth = jnp.where(matched, bf / jnp.maximum(disparity, 1e-6), -1.0)
    u_right = jnp.where(matched, ur_refined, -1.0)
    return StereoMatch(u_right=u_right, depth=depth, valid=matched)


def match_stereo_canvas(feats_l: Features, feats_r: Features,
                        canvas_l: jnp.ndarray, canvas_r: jnp.ndarray,
                        w: int, bf: float, min_z: float, cfg: OrbConfig
                        ) -> StereoMatch:
    """match_stereo on canvas-packed pyramids (see orb.canvas_layout): the
    SAD refinement gathers from the keypoint's level region of the packed
    plane."""
    from .orb import canvas_layout
    h, Wc = canvas_l.shape
    offs, _, shapes = canvas_layout(h, w, cfg)
    scales = jnp.asarray(cfg.level_scales(), dtype=jnp.float32)

    dist = hamming.hamming_matrix(feats_l.desc, feats_r.desc)  # (N,M)
    yl = feats_l.xy[:, 1][:, None]
    yr = feats_r.xy[:, 1][None, :]
    band = 2.0 * scales[feats_l.octave][:, None]
    row_ok = jnp.abs(yl - yr) <= band
    oct_ok = jnp.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    xl = feats_l.xy[:, 0][:, None]
    xr = feats_r.xy[:, 0][None, :]
    disp = xl - xr
    max_disp = bf / min_z
    disp_ok = (disp > 0.1) & (disp < max_disp)
    ok = row_ok & oct_ok & disp_ok & feats_l.valid[:, None] \
        & feats_r.valid[None, :]
    dist = jnp.where(ok, dist, 10_000)
    best = jnp.argmin(dist, axis=1)
    best_d = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    matched = best_d <= DESC_GATE

    lv = feats_l.octave
    inv_s = 1.0 / scales[lv]
    ul = feats_l.xy[:, 0] * inv_s
    vl = feats_l.xy[:, 1] * inv_s
    ur0 = feats_r.xy[best, 0] * inv_s
    lh = jnp.asarray([s[0] for s in shapes], jnp.int32)[lv]
    lw = jnp.asarray([s[1] for s in shapes], jnp.int32)[lv]
    off = jnp.asarray(offs, jnp.int32)[lv]
    yi = jnp.clip(jnp.round(vl).astype(jnp.int32), SAD_W, lh - SAD_W - 1)
    xi = jnp.clip(jnp.round(ul).astype(jnp.int32), SAD_W + SAD_SEARCH,
                  lw - SAD_W - SAD_SEARCH - 1)
    xri = jnp.clip(jnp.round(ur0).astype(jnp.int32), SAD_W + SAD_SEARCH,
                   lw - SAD_W - SAD_SEARCH - 1)
    offs1 = jnp.arange(-SAD_W, SAD_W + 1)
    base = yi * Wc + off
    lp = canvas_l.reshape(-1)[(base + xi)[:, None] + offs1[None, :]]
    lp = lp - jnp.mean(lp, axis=1, keepdims=True)
    woffs = jnp.arange(-(SAD_W + SAD_SEARCH), SAD_W + SAD_SEARCH + 1)
    rwin = canvas_r.reshape(-1)[(base + xri)[:, None] + woffs[None, :]]
    sweeps = []
    for s in range(2 * SAD_SEARCH + 1):
        rp = jax.lax.dynamic_slice_in_dim(rwin, s, 2 * SAD_W + 1, axis=1)
        rp = rp - jnp.mean(rp, axis=1, keepdims=True)
        sweeps.append(jnp.sum(jnp.abs(lp - rp), axis=1))
    sad = jnp.stack(sweeps, axis=1)
    k = jnp.argmin(sad, axis=1)
    kc = jnp.clip(k, 1, 2 * SAD_SEARCH - 1)
    s_m1 = jnp.take_along_axis(sad, (kc - 1)[:, None], 1)[:, 0]
    s_0 = jnp.take_along_axis(sad, kc[:, None], 1)[:, 0]
    s_p1 = jnp.take_along_axis(sad, (kc + 1)[:, None], 1)[:, 0]
    denom = s_m1 + s_p1 - 2 * s_0
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      0.5 * (s_m1 - s_p1) / jnp.maximum(denom, 1e-6), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    off_px = (kc.astype(jnp.float32) - SAD_SEARCH + delta
              + xri.astype(jnp.float32) - ur0)
    ur_refined = (ur0 + off_px) * scales[lv]
    disparity = feats_l.xy[:, 0] - ur_refined
    matched = matched & (disparity > 0.01) & (disparity < max_disp)
    med = jnp.median(jnp.where(matched, s_0, jnp.nan))
    med = jnp.nan_to_num(med, nan=jnp.inf)
    matched = matched & (s_0 <= 1.5 * 1.48 * med)
    depth = jnp.where(matched, bf / jnp.maximum(disparity, 1e-6), -1.0)
    u_right = jnp.where(matched, ur_refined, -1.0)
    return StereoMatch(u_right=u_right, depth=depth, valid=matched)


def match_stereo(feats_l: Features, feats_r: Features,
                 level_imgs_l, level_imgs_r,
                 bf: float, min_z: float, cfg: OrbConfig) -> StereoMatch:
    """Match left features to right features on rectified pair.

    Args:
      level_imgs_l/r: pyramid lists (for SAD refinement).
      bf: baseline * fx (ref mbf). min_z: minimum depth => max disparity.
    """
    N = feats_l.xy.shape[0]
    scales = jnp.asarray(cfg.level_scales(), dtype=jnp.float32)

    dist = hamming.hamming_matrix(feats_l.desc, feats_r.desc)  # (N,M)

    yl = feats_l.xy[:, 1][:, None]
    yr = feats_r.xy[:, 1][None, :]
    band = 2.0 * scales[feats_l.octave][:, None]
    row_ok = jnp.abs(yl - yr) <= band

    oct_ok = jnp.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1

    xl = feats_l.xy[:, 0][:, None]
    xr = feats_r.xy[:, 0][None, :]
    disp = xl - xr
    max_disp = bf / min_z
    disp_ok = (disp > 0.1) & (disp < max_disp)

    ok = row_ok & oct_ok & disp_ok & feats_l.valid[:, None] & feats_r.valid[None, :]
    dist = jnp.where(ok, dist, 10_000)

    best = jnp.argmin(dist, axis=1)
    best_d = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    matched = best_d <= DESC_GATE

    # --- subpixel SAD refine on the left keypoint's pyramid level ---
    octv = feats_l.octave
    inv_s = 1.0 / scales[octv]
    # coords on the level
    ul = feats_l.xy[:, 0] * inv_s
    vl = feats_l.xy[:, 1] * inv_s
    ur0 = feats_r.xy[best, 0] * inv_s

    # gather per-level rows: process each level's keypoints against its image
    best_off = jnp.zeros((N,), dtype=jnp.float32)
    sad_best = jnp.full((N,), jnp.inf, dtype=jnp.float32)
    for l, (iml, imr) in enumerate(zip(level_imgs_l, level_imgs_r)):
        h, w = iml.shape
        yi = jnp.clip(jnp.round(vl).astype(jnp.int32), SAD_W, h - SAD_W - 1)
        xi = jnp.clip(jnp.round(ul).astype(jnp.int32), SAD_W + SAD_SEARCH,
                      w - SAD_W - SAD_SEARCH - 1)
        xri = jnp.clip(jnp.round(ur0).astype(jnp.int32), SAD_W + SAD_SEARCH,
                       w - SAD_W - SAD_SEARCH - 1)
        offs = jnp.arange(-SAD_W, SAD_W + 1)
        # left patch row (N,11)
        lp = iml[yi[:, None], xi[:, None] + offs[None, :]]
        lp = lp - jnp.mean(lp, axis=1, keepdims=True)
        sweeps = []
        for s in range(-SAD_SEARCH, SAD_SEARCH + 1):
            rp = imr[yi[:, None], xri[:, None] + s + offs[None, :]]
            rp = rp - jnp.mean(rp, axis=1, keepdims=True)
            sweeps.append(jnp.sum(jnp.abs(lp - rp), axis=1))
        sad = jnp.stack(sweeps, axis=1)  # (N, 11)
        k = jnp.argmin(sad, axis=1)
        kc = jnp.clip(k, 1, 2 * SAD_SEARCH - 1)
        s_m1 = jnp.take_along_axis(sad, (kc - 1)[:, None], 1)[:, 0]
        s_0 = jnp.take_along_axis(sad, kc[:, None], 1)[:, 0]
        s_p1 = jnp.take_along_axis(sad, (kc + 1)[:, None], 1)[:, 0]
        denom = s_m1 + s_p1 - 2 * s_0
        delta = jnp.where(jnp.abs(denom) > 1e-6,
                          0.5 * (s_m1 - s_p1) / jnp.maximum(denom, 1e-6), 0.0)
        delta = jnp.clip(delta, -1.0, 1.0)
        off_l = (kc.astype(jnp.float32) - SAD_SEARCH + delta
                 + xri.astype(jnp.float32) - ur0)
        this = octv == l
        best_off = jnp.where(this, off_l, best_off)
        sad_best = jnp.where(this, s_0, sad_best)

    ur_refined = (ur0 + best_off) * scales[octv]
    disparity = feats_l.xy[:, 0] - ur_refined
    matched = matched & (disparity > 0.01) & (disparity < max_disp)

    # median SAD sweep (ref: discard matches with SAD > 1.5*1.48*median)
    med = jnp.median(jnp.where(matched, sad_best, jnp.nan))
    med = jnp.nan_to_num(med, nan=jnp.inf)
    matched = matched & (sad_best <= 1.5 * 1.48 * med)

    depth = jnp.where(matched, bf / jnp.maximum(disparity, 1e-6), -1.0)
    u_right = jnp.where(matched, ur_refined, -1.0)
    return StereoMatch(u_right=u_right, depth=depth, valid=matched)

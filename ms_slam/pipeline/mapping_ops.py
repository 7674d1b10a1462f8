"""Jitted structural map operations used by the local-mapping stage.

Covers the per-keyframe work of LocalMapping::Run
(/root/reference/src/LocalMapping.cc): keyframe insertion with stereo
map-point spawning (ref Tracking::CreateNewKeyFrame close-point creation,
src/Tracking.cc:3224-3308), triangulation of new points against covisible
keyframes (CreateNewMapPoints :414), duplicate fusion (SearchInNeighbors
:735), local bundle adjustment (Optimizer::LocalBundleAdjustment) and
map-point culling (MapPointCulling :370) — all as pure MapState->MapState
jits with static capacities.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import map_state as M
from ..ops import ba, cameras, hamming, lie, matching, triangulate
from .frontend import Calib, FrameData
from ..ops.orb import OrbConfig


def _scale2(orb_cfg: OrbConfig):
    return jnp.asarray([s * s for s in orb_cfg.level_scales()], jnp.float32)


# ---------------------------------------------------------------------------
# Keyframe creation
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("calib",))
def create_keyframe(ms: M.MapState, calib: Calib, slot: jnp.ndarray,
                    frame: FrameData, R: jnp.ndarray, t: jnp.ndarray,
                    matched_mp: jnp.ndarray, kf_ord: jnp.ndarray,
                    frame_id: jnp.ndarray, depth_max: jnp.ndarray):
    """Insert a keyframe; spawn map points for stereo features without a
    map-point match, up to depth_max (th_depth normally; unbounded at map
    initialization, ref Tracking::StereoInitialization unprojects every
    depth, src/Tracking.cc:2321-). New points draw recycled slots from the
    pool free-list (alloc_map_slots). Returns (ms, n_new)."""
    f = frame.feats
    params = calib.params_array()
    close = (frame.depth > 0) & (frame.depth <= depth_max)
    new_mask = f.valid & close & (matched_mp < 0)
    M_cap = ms.mp_pos.shape[0]
    slots, ok = M.alloc_map_slots(ms, new_mask)
    obs = jnp.where(matched_mp >= 0, matched_mp,
                    jnp.where(slots < M_cap, slots, -1)).astype(jnp.int32)

    # unproject stereo features to world
    ray = cameras.unproject(calib.model, params, f.xy)
    Xc = ray * frame.depth[:, None]
    Rwc = R.T
    Ow = -Rwc @ t
    Xw = jnp.einsum("ij,nj->ni", Rwc, Xc) + Ow

    dist = jnp.linalg.norm(Xw - Ow, axis=-1)
    normal = (Xw - Ow) / jnp.maximum(dist, 1e-9)[:, None]
    # scale range (ref MapPoint ctor: maxDist = dist*scale^level)
    sf = 1.2
    n_lv = 8
    level_scale = sf ** f.octave.astype(jnp.float32)
    max_dist = dist * level_scale
    min_dist = max_dist / (sf ** (n_lv - 1))

    ms = M.insert_keyframe(ms, slot, R, t, f.xy, f.octave, f.desc,
                           frame.u_right, frame.depth, f.valid, obs, frame_id,
                           kf_ord=kf_ord, angle=f.angle)
    ms = M.add_map_points(ms, slots, ok,
                          Xw, f.desc, normal, min_dist, max_dist,
                          jnp.broadcast_to(slot, new_mask.shape),
                          jnp.broadcast_to(kf_ord, new_mask.shape),
                          angle=f.angle)
    n_new = jnp.sum(ok).astype(jnp.int32)
    return ms, n_new


# ---------------------------------------------------------------------------
# Triangulation against one covisible neighbor
# ---------------------------------------------------------------------------

def _tri_candidates(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                    kf_a: jnp.ndarray, kf_b: jnp.ndarray):
    """Side-effect-free half of triangulation against ONE neighbor: returns
    (good (N,), Xw (N,3), ib (N,)) — vmappable over neighbors so all the
    epipolar/Hamming matmuls run as one batched matmul instead of as a
    sequential scan (the allocation/write half is done once by the
    caller)."""
    params = calib.params_array()
    Ra, ta = ms.kf_R[kf_a], ms.kf_t[kf_a]
    Rb, tb = ms.kf_R[kf_b], ms.kf_t[kf_b]
    Rab = Rb @ Ra.T
    tab = tb - Rab @ ta
    baseline = jnp.linalg.norm(tab)
    b_ok = baseline > calib.bf / calib.params[0]

    free_a = ms.kp_valid[kf_a] & (ms.obs_mp[kf_a] < 0)
    free_b = ms.kp_valid[kf_b] & (ms.obs_mp[kf_b] < 0)
    s2 = _scale2(orb_cfg)
    sig_b = s2[ms.kp_octave[kf_b]]
    epi = matching.epipolar_mask(calib.model, params, Rab, tab,
                                 ms.kp_xy[kf_a], ms.kp_xy[kf_b], sig_b)
    mm = matching.mutual_match(ms.kp_desc[kf_a], free_a,
                               ms.kp_desc[kf_b], free_b,
                               max_dist=matching.TH_LOW, nn_ratio=0.6,
                               extra_mask=epi,
                               angle_a=ms.kp_angle[kf_a],
                               angle_b=ms.kp_angle[kf_b])
    has = (mm.idx_b >= 0) & b_ok
    ib = jnp.clip(mm.idx_b, 0)

    xn_a = cameras.unproject(calib.model, params, ms.kp_xy[kf_a])
    xn_b = cameras.unproject(calib.model, params, ms.kp_xy[kf_b])[ib]
    N = xn_a.shape[0]
    Pa = jnp.broadcast_to(jnp.concatenate([Ra, ta[:, None]], 1), (N, 3, 4))
    Pb = jnp.broadcast_to(jnp.concatenate([Rb, tb[:, None]], 1), (N, 3, 4))
    Xw = triangulate.triangulate_dlt(xn_a, xn_b, Pa, Pb)

    Xca = lie.se3_apply(Ra, ta, Xw)
    Xcb = lie.se3_apply(Rb, tb, Xw)
    Oa = -Ra.T @ ta
    Ob = -Rb.T @ tb
    va = Xw - Oa
    vb = Xw - Ob
    cos_par = (jnp.sum(va * vb, -1)
               / jnp.maximum(jnp.linalg.norm(va, axis=-1)
                             * jnp.linalg.norm(vb, axis=-1), 1e-9))
    uva = cameras.project(calib.model, params, Xca)
    uvb = cameras.project(calib.model, params, Xcb)
    ea = jnp.sum((uva - ms.kp_xy[kf_a]) ** 2, -1) / s2[ms.kp_octave[kf_a]]
    eb = jnp.sum((uvb - ms.kp_xy[kf_b][ib]) ** 2, -1) / sig_b[ib]
    good = (has & (Xca[:, 2] > 0) & (Xcb[:, 2] > 0)
            & (cos_par < 0.9998) & (cos_par > 0)
            & (ea < 5.991) & (eb < 5.991))
    return good, Xw, ib


def _triangulate_batch(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                       kf_a: jnp.ndarray, nb_idx: jnp.ndarray,
                       nb_ok: jnp.ndarray, kf_ord: jnp.ndarray):
    """Triangulate kf_a against ALL neighbors at once (ref
    LocalMapping::CreateNewMapPoints loops covisible neighbors,
    src/LocalMapping.cc:414; here the per-neighbor matching batches into
    one set of batched matmuls). Each kf_a feature takes its first neighbor
    with a passing candidate; allocation + observation writes happen once.
    Returns (ms, n_new)."""
    goods, Xws, ibs = jax.vmap(
        lambda b: _tri_candidates(ms, calib, orb_cfg, kf_a, b))(nb_idx)
    goods = goods & nb_ok[:, None]                     # (T,N)
    T, N = goods.shape
    # first passing neighbor per feature
    pick = jnp.argmax(goods, axis=0)                   # (N,)
    sel = jnp.any(goods, axis=0)
    rows = jnp.arange(N)
    Xw = Xws[pick, rows]
    ib = ibs[pick, rows]
    nbr = nb_idx[pick]

    M_cap = ms.mp_pos.shape[0]
    slots, ok = M.alloc_map_slots(ms, sel)

    Ra, ta = ms.kf_R[kf_a], ms.kf_t[kf_a]
    Oa = -Ra.T @ ta
    va = Xw - Oa
    dist = jnp.linalg.norm(va, axis=-1)
    normal = va / jnp.maximum(dist, 1e-9)[:, None]
    level_scale = 1.2 ** ms.kp_octave[kf_a].astype(jnp.float32)
    max_dist = dist * level_scale
    min_dist = max_dist / (1.2 ** 7)

    ms = M.add_map_points(ms, slots, ok, Xw,
                          ms.kp_desc[kf_a], normal, min_dist, max_dist,
                          jnp.broadcast_to(kf_a, sel.shape),
                          jnp.broadcast_to(kf_ord, sel.shape),
                          angle=ms.kp_angle[kf_a])
    slot_or_neg = jnp.where(ok, slots, -1).astype(jnp.int32)
    obs_a = jnp.where(slot_or_neg >= 0, slot_or_neg, ms.obs_mp[kf_a])
    ms = ms._replace(obs_mp=ms.obs_mp.at[kf_a].set(obs_a))
    # write the matched feature slot in each chosen neighbor (2-D scatter)
    Kc = ms.obs_mp.shape[0]
    r_sel = jnp.where(slot_or_neg >= 0, nbr, Kc)
    c_sel = jnp.where(slot_or_neg >= 0, ib, ms.obs_mp.shape[1])
    ms = ms._replace(obs_mp=ms.obs_mp.at[r_sel, c_sel].set(
        slot_or_neg, mode="drop"))
    n_new = jnp.sum(sel & (slots < M_cap)).astype(jnp.int32)
    return ms, n_new


def _triangulate_impl(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                      kf_a: jnp.ndarray, kf_b: jnp.ndarray,
                      kf_ord: jnp.ndarray):
    """Create new map points by epipolar-matched triangulation between two
    keyframes (ref LocalMapping::CreateNewMapPoints /
    ORBmatcher::SearchForTriangulation). Returns (ms, n_new)."""
    params = calib.params_array()
    Ra, ta = ms.kf_R[kf_a], ms.kf_t[kf_a]
    Rb, tb = ms.kf_R[kf_b], ms.kf_t[kf_b]
    # relative: cam_b <- cam_a
    Rab = Rb @ Ra.T
    tab = tb - Rab @ ta

    # baseline must exceed stereo baseline (ref LocalMapping.cc:449)
    baseline = jnp.linalg.norm(tab)
    b_ok = baseline > calib.bf / calib.params[0]

    free_a = ms.kp_valid[kf_a] & (ms.obs_mp[kf_a] < 0)
    free_b = ms.kp_valid[kf_b] & (ms.obs_mp[kf_b] < 0)
    s2 = _scale2(orb_cfg)
    sig_b = s2[ms.kp_octave[kf_b]]
    epi = matching.epipolar_mask(calib.model, params, Rab, tab,
                                 ms.kp_xy[kf_a], ms.kp_xy[kf_b], sig_b)
    mm = matching.mutual_match(ms.kp_desc[kf_a], free_a,
                               ms.kp_desc[kf_b], free_b,
                               max_dist=matching.TH_LOW, nn_ratio=0.6,
                               extra_mask=epi,
                               angle_a=ms.kp_angle[kf_a],
                               angle_b=ms.kp_angle[kf_b])
    has = (mm.idx_b >= 0) & b_ok
    ib = jnp.clip(mm.idx_b, 0)

    xn_a = cameras.unproject(calib.model, params, ms.kp_xy[kf_a])
    xn_b_all = cameras.unproject(calib.model, params, ms.kp_xy[kf_b])
    xn_b = xn_b_all[ib]
    N = xn_a.shape[0]
    Pa = jnp.broadcast_to(jnp.concatenate([Ra, ta[:, None]], 1), (N, 3, 4))
    Pb = jnp.broadcast_to(jnp.concatenate([Rb, tb[:, None]], 1), (N, 3, 4))
    Xw = triangulate.triangulate_dlt(xn_a, xn_b, Pa, Pb)

    # cheirality + parallax + reprojection gates
    Xca = lie.se3_apply(Ra, ta, Xw)
    Xcb = lie.se3_apply(Rb, tb, Xw)
    Oa = -Ra.T @ ta
    Ob = -Rb.T @ tb
    va = Xw - Oa
    vb = Xw - Ob
    cos_par = (jnp.sum(va * vb, -1)
               / jnp.maximum(jnp.linalg.norm(va, axis=-1)
                             * jnp.linalg.norm(vb, axis=-1), 1e-9))
    uva = cameras.project(calib.model, params, Xca)
    uvb = cameras.project(calib.model, params, Xcb)
    ea = jnp.sum((uva - ms.kp_xy[kf_a]) ** 2, -1) / s2[ms.kp_octave[kf_a]]
    eb = jnp.sum((uvb - ms.kp_xy[kf_b][ib]) ** 2, -1) / sig_b[ib]
    good = (has & (Xca[:, 2] > 0) & (Xcb[:, 2] > 0)
            & (cos_par < 0.9998) & (cos_par > 0)
            & (ea < 5.991) & (eb < 5.991))

    # allocate from the pool free-list
    M_cap = ms.mp_pos.shape[0]
    slots, ok = M.alloc_map_slots(ms, good)

    dist = jnp.linalg.norm(va, axis=-1)
    normal = va / jnp.maximum(dist, 1e-9)[:, None]
    level_scale = 1.2 ** ms.kp_octave[kf_a].astype(jnp.float32)
    max_dist = dist * level_scale
    min_dist = max_dist / (1.2 ** 7)

    ms = M.add_map_points(ms, slots, ok, Xw,
                          ms.kp_desc[kf_a], normal, min_dist, max_dist,
                          jnp.broadcast_to(kf_a, good.shape),
                          jnp.broadcast_to(kf_ord, good.shape),
                          angle=ms.kp_angle[kf_a])
    # write observations in both keyframes
    slot_or_neg = jnp.where(ok, slots, -1).astype(jnp.int32)
    obs_a = jnp.where(slot_or_neg >= 0, slot_or_neg, ms.obs_mp[kf_a])
    ms = ms._replace(obs_mp=ms.obs_mp.at[kf_a].set(obs_a))
    tgt_b = jnp.where(slot_or_neg >= 0, ib, ms.obs_mp.shape[1])
    row_b = ms.obs_mp[kf_b].at[tgt_b].set(slot_or_neg, mode="drop")
    ms = ms._replace(obs_mp=ms.obs_mp.at[kf_b].set(row_b))
    n_new = jnp.sum(good & (slots < M_cap)).astype(jnp.int32)
    return ms, n_new


triangulate_with = partial(jax.jit, static_argnames=("calib", "orb_cfg"))(
    _triangulate_impl)


# ---------------------------------------------------------------------------
# Fusion of duplicate points into a target keyframe
# ---------------------------------------------------------------------------

def _fuse_impl(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
               kf_t: jnp.ndarray, cand_idx: jnp.ndarray,
               cand_valid: jnp.ndarray, n_obs: jnp.ndarray = None):
    """Project candidate map points into keyframe kf_t; matched features
    either gain the observation or trigger a duplicate merge keeping the
    better-observed point (ref ORBmatcher::Fuse, src/ORBmatcher.cc:1404,
    and MapPoint::Replace).

    n_obs: optional precomputed (M,) observation counts — the full-table
    count sweep is a scatter over the whole observation table, so callers
    that already have a current table pass it in."""
    params = calib.params_array()
    pm = matching.search_by_projection(
        calib.model, params, ms.kf_R[kf_t], ms.kf_t[kf_t],
        calib.width, calib.height,
        ms.mp_pos[cand_idx], ms.mp_normal[cand_idx],
        ms.mp_min_dist[cand_idx], ms.mp_max_dist[cand_idx],
        ms.mp_desc[cand_idx], cand_valid & ms.mp_valid[cand_idx],
        ms.kp_xy[kf_t], ms.kp_octave[kf_t], ms.kp_desc[kf_t],
        ms.kp_valid[kf_t],
        th_radius=3.0, nn_ratio=1.0,
        scale_factor=orb_cfg.scale_factor, n_levels=orb_cfg.n_levels)
    cand_of_feat = jnp.where(pm.mp_slot >= 0,
                             cand_idx[jnp.clip(pm.mp_slot, 0)], -1)
    cur = ms.obs_mp[kf_t]
    if n_obs is None:
        n_obs = M.mp_obs_count(ms)

    # features with no point: add observation
    add = (cand_of_feat >= 0) & (cur < 0)
    new_row = jnp.where(add, cand_of_feat, cur)

    # features with a different point: merge (loser -> winner everywhere)
    conflict = (cand_of_feat >= 0) & (cur >= 0) & (cand_of_feat != cur)
    cand_obs = n_obs[jnp.clip(cand_of_feat, 0)]
    cur_obs = n_obs[jnp.clip(cur, 0)]
    winner = jnp.where(cand_obs >= cur_obs, cand_of_feat, cur)
    loser = jnp.where(cand_obs >= cur_obs, cur, cand_of_feat)
    Mc = ms.mp_pos.shape[0]
    remap = jnp.arange(Mc, dtype=jnp.int32)
    remap = remap.at[jnp.where(conflict, loser, Mc)].set(
        jnp.where(conflict, winner, 0), mode="drop")
    # kill losers (with reuse quarantine) and rewrite every observation
    # through the remap
    loser_sl = jnp.where(conflict, loser, Mc)
    mp_valid = ms.mp_valid.at[loser_sl].set(False, mode="drop")
    mp_quar = ms.mp_quarantine.at[loser_sl].set(2, mode="drop")
    obs_all = ms.obs_mp.at[kf_t].set(new_row)
    obs_all = jnp.where(obs_all >= 0, remap[jnp.clip(obs_all, 0)], obs_all)
    return ms._replace(obs_mp=obs_all, mp_valid=mp_valid,
                       mp_quarantine=mp_quar)


fuse_into = partial(jax.jit, static_argnames=("calib", "orb_cfg"))(_fuse_impl)


# ---------------------------------------------------------------------------
# Local bundle adjustment over a covisibility window
# ---------------------------------------------------------------------------

class LocalBAOut(NamedTuple):
    ms: M.MapState
    n_factors: jnp.ndarray
    n_outliers: jnp.ndarray


def _local_ba_impl(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                   win_idx: jnp.ndarray, win_mask: jnp.ndarray,
                   fix_idx: jnp.ndarray, fix_mask: jnp.ndarray,
                   n_fixed: int, pt_cap: int, n_iters: int = 8) -> LocalBAOut:
    """Window BA: optimize win keyframes + their points, anchored by fixed
    keyframes (ref Optimizer::LocalBundleAdjustment, src/Optimizer.cc:1040).

    win_idx: (Wk,) keyframe slots (padded; win_mask marks real ones).
    fix_idx: (n_fixed,) anchor keyframe slots.
    """
    params = calib.params_array()
    Wk = win_idx.shape[0]
    cams = jnp.concatenate([win_idx, fix_idx])           # (C,)
    cam_mask = jnp.concatenate([win_mask, fix_mask])
    cam_opt = jnp.concatenate(
        [win_mask, jnp.zeros((n_fixed,), bool)])

    # points seen from the window
    pmask = M.local_map_mask(ms, win_idx, win_mask)
    pt_idx, pt_valid = M.gather_local_points(ms, pmask, pt_cap)
    Mc = ms.mp_pos.shape[0]
    inv = jnp.full((Mc + 1,), -1, jnp.int32).at[
        jnp.where(pt_valid, pt_idx, Mc)].set(
        jnp.arange(pt_cap, dtype=jnp.int32), mode="drop")

    # factor table = flattened (C, N) observations restricted to the point set
    obs = ms.obs_mp[cams]                                 # (C,N)
    f_pt_dense = inv[jnp.clip(obs, 0, Mc)]
    f_valid = (obs >= 0) & (f_pt_dense >= 0) & cam_mask[:, None] \
        & ms.kp_valid[cams]
    C = cams.shape[0]
    N = obs.shape[1]
    f_cam = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[:, None], (C, N))
    s2 = _scale2(orb_cfg)
    f_sigma2 = s2[ms.kp_octave[cams]]

    res = ba.ba_solve(
        calib.model, params, jnp.asarray(calib.bf),
        ms.kf_R[cams], ms.kf_t[cams], cam_opt,
        ms.mp_pos[pt_idx], pt_valid,
        f_cam.reshape(-1), jnp.clip(f_pt_dense, 0).reshape(-1),
        ms.kp_xy[cams].reshape(C * N, 2),
        ms.kp_uright[cams].reshape(-1),
        f_sigma2.reshape(-1), f_valid.reshape(-1),
        n_iters=n_iters, cam_blocked=True)

    # write back optimized cameras and points
    wb = jnp.where(win_mask, win_idx, ms.kf_R.shape[0])
    kf_R = ms.kf_R.at[wb].set(res.kf_R[:Wk], mode="drop")
    kf_t = ms.kf_t.at[wb].set(res.kf_t[:Wk], mode="drop")
    pb = jnp.where(pt_valid, pt_idx, Mc)
    mp_pos = ms.mp_pos.at[pb].set(res.mp_pos, mode="drop")

    # erase outlier observations (ref Optimizer.cc post-BA erase)
    outlier = f_valid.reshape(C, N) & ~res.f_inlier.reshape(C, N)
    obs_new = jnp.where(outlier, -1, ms.obs_mp[cams])
    obs_all = ms.obs_mp.at[jnp.where(cam_mask, cams, ms.obs_mp.shape[0])].set(
        obs_new, mode="drop")
    ms = ms._replace(kf_R=kf_R, kf_t=kf_t, mp_pos=mp_pos, obs_mp=obs_all)
    return LocalBAOut(ms=ms,
                      n_factors=jnp.sum(f_valid).astype(jnp.int32),
                      n_outliers=jnp.sum(outlier).astype(jnp.int32))


local_ba = partial(jax.jit, static_argnames=("calib", "orb_cfg", "n_fixed",
                                             "pt_cap", "n_iters"))(
    _local_ba_impl)


# ---------------------------------------------------------------------------
# Fused per-keyframe mapping step (triangulate + fuse + window BA + cull)
# ---------------------------------------------------------------------------

class MappingStepOut(NamedTuple):
    ms: M.MapState
    info: jnp.ndarray
    """(4 + 2*Wk,) int32: [n_new_mp, n_factors, n_ba_outliers, n_culled,
    window slots (-1 padded, Wk), culled KF slots (-1 padded, Wk)] — one
    fetch per keyframe."""
    n_obs: jnp.ndarray = None
    """(M,) int32 per-point observation counts, current as of the end of
    the step — handed back so tracking reuses it instead of re-running
    the full-table count sweep per keyframe."""
    obs_mask: jnp.ndarray = None
    """(M, ceil(K/32)) uint32 per-point observer bitmask (see
    map_state.observer_mask) — tracking's local-keyframe vote reads this
    cached mask instead of sweeping the observation table per frame."""


@partial(jax.jit, static_argnames=("calib", "orb_cfg", "n_tri", "window_kf",
                                   "n_fixed", "pt_cap", "ba_iters", "do_ba",
                                   "red_th"),
         donate_argnames=("ms",))
def mapping_step(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                 kf_slot: jnp.ndarray, kf_ord: jnp.ndarray,
                 n_tri: int, window_kf: int, n_fixed: int, pt_cap: int,
                 ba_iters: int, do_ba: bool = True,
                 cullable: jnp.ndarray = None,
                 red_th: float = 0.9) -> MappingStepOut:
    """The whole LocalMapping iteration as one device call (ref
    LocalMapping::Run body, src/LocalMapping.cc:68-: triangulation against
    covisible neighbors, duplicate fusion, windowed BA, point culling) —
    replacing ~10 separate dispatches + host round trips per keyframe.
    kf_ord: monotonically increasing keyframe ordinal (for culling age;
    slot ids are recycled and no longer temporal).

    cullable: optional (K,) bool — keyframes the host permits culling (the
    inertial protections of ref LocalMapping::KeyFrameCulling
    src/LocalMapping.cc:1040-1062: keep the last Nd temporal keyframes and
    any whose removal would open a preintegration gap beyond 0.5s/3s).
    red_th: redundancy bar — 0.9 visual / 0.5 stereo-inertial (ref
    src/LocalMapping.cc:935-941)."""
    kf_ord = jnp.asarray(kf_ord, jnp.int32)
    # age the slot-reuse quarantine (one tick per mapping iteration)
    ms = ms._replace(mp_quarantine=jnp.maximum(ms.mp_quarantine - 1, 0))
    # covisibility once: neighbors for triangulation AND the BA window
    counts = M.covisibility_counts(ms, kf_slot)
    top_w, top_i = jax.lax.top_k(counts, window_kf - 1 + n_fixed)

    # --- triangulation against the best n_tri neighbors (batched: all
    # neighbors' epipolar/Hamming matmuls run as one batched matmul) ---
    nb_ok = top_w[:n_tri] >= 10
    ms, n_tri_new = _triangulate_batch(ms, calib, orb_cfg, kf_slot,
                                       top_i[:n_tri], nb_ok, kf_ord)

    # --- fuse neighbor landmarks into the new keyframe ---
    # (count sweep #1 of 2: each is a full-table scatter, so the step
    # computes exactly two — post-triangulation here for
    # the fuse winner rule, and the post-BA per-octave sweep below that
    # cull / redundancy / the returned tracking table all share)
    n_obs_tri = M.mp_obs_count(ms)
    nmask = jnp.zeros((ms.kf_valid.shape[0],), bool).at[
        jnp.where(top_w[:n_tri] > 0, top_i[:n_tri],
                  ms.kf_valid.shape[0])].set(True, mode="drop")
    cand_mask = M.local_map_mask(ms, jnp.arange(ms.kf_valid.shape[0]), nmask)
    c_idx, c_valid = M.gather_local_points(ms, cand_mask, pt_cap)
    ms = _fuse_impl(ms, calib, orb_cfg, kf_slot, c_idx, c_valid,
                    n_obs=n_obs_tri)

    # --- BA window + fixed anchors (gauge handled by masking) ---
    win_idx = jnp.concatenate([kf_slot[None], top_i[:window_kf - 1]])
    win_mask = jnp.concatenate([jnp.ones((1,), bool),
                                top_w[:window_kf - 1] > 0])
    fix_idx = top_i[window_kf - 1:window_kf - 1 + n_fixed]
    fix_mask = top_w[window_kf - 1:window_kf - 1 + n_fixed] > 0
    # if no anchors: demote the oldest (min slot id) window keyframe
    no_anchor = ~jnp.any(fix_mask)
    oldest_pos = jnp.argmin(jnp.where(win_mask, win_idx, 1 << 30))
    demote = no_anchor & (jnp.sum(win_mask) > 1)
    win_mask = win_mask.at[oldest_pos].set(
        win_mask[oldest_pos] & ~demote)
    fix_idx = fix_idx.at[0].set(
        jnp.where(demote, win_idx[oldest_pos], fix_idx[0]))
    fix_mask = fix_mask.at[0].set(fix_mask[0] | demote)

    # do_ba=False: the caller replaces the visual window BA with the
    # visual-inertial one (ref LocalMapping.cc:150-155 runs EITHER
    # LocalInertialBA OR LocalBundleAdjustment, never both — two
    # optimizers with different gauges fight each other)
    if do_ba:
        outba = _local_ba_impl(ms, calib, orb_cfg, win_idx, win_mask,
                               fix_idx, fix_mask, n_fixed, pt_cap, ba_iters)
        ms = outba.ms
        ba_factors, ba_outliers = outba.n_factors, outba.n_outliers
    else:
        ba_factors = jnp.zeros((), jnp.int32)
        ba_outliers = jnp.zeros((), jnp.int32)

    # --- point culling (count sweep #2, shared: the per-octave table's
    # last column is the total observation count; live points' counts are
    # unchanged by the cull itself, so redundancy below reads the same
    # table exactly) ---
    n_levels = orb_cfg.n_levels
    cum_oct = obs_count_by_octave(ms, n_levels)
    ms, n_culled, n_obs_all = _cull_impl(ms, kf_ord,
                                         cum_oct[:, n_levels - 1])

    # --- keyframe culling (ref LocalMapping::KeyFrameCulling :925):
    # window keyframes (not the new one, not slot 0) whose tracked points
    # are overwhelmingly observed by >=3 OTHER keyframes at the same or
    # finer scale (scaleLeveli <= scaleLevel+1) are redundant; the scale
    # condition protects keyframes that uniquely see fine detail ---

    def redundancy(k):
        obs = ms.obs_mp[k]
        has = (obs >= 0) & ms.kp_valid[k]
        # non-monocular: only close stereo points count toward redundancy
        # (ref KeyFrameCulling skips GetDepth(i) > mThDepth or < 0,
        # src/LocalMapping.cc:983-987) — far points are cheap to keep and
        # culling on them starves wide-baseline geometry
        if (calib.bf or 0.0) > 0.0:
            has &= (ms.kp_depth[k] > 0) & (ms.kp_depth[k] <= calib.th_depth)
        o = jnp.clip(ms.kp_octave[k], 0, n_levels - 1)
        n_other = cum_oct[jnp.clip(obs, 0),
                          jnp.minimum(o + 1, n_levels - 1)] - 1
        red = has & (n_other >= 3)
        tot = jnp.sum(has)
        return jnp.where(tot > 0, jnp.sum(red) / jnp.maximum(tot, 1), 0.0), \
            tot

    red_ratio, red_total = jax.vmap(redundancy)(win_idx)
    cull_ok = (jnp.ones_like(win_mask) if cullable is None
               else cullable[win_idx])
    kf_kill = (win_mask & (win_idx != kf_slot) & (win_idx != 0)
               & (red_ratio > red_th) & (red_total > 50) & cull_ok)
    kill_mask = jnp.zeros((ms.kf_valid.shape[0],), bool).at[
        jnp.where(kf_kill, win_idx, ms.kf_valid.shape[0])].set(
        True, mode="drop")
    # maintain the shared count table through keyframe deletion (subtract
    # the killed rows — a ~12K delta scatter, not another full sweep)
    Mc = ms.mp_pos.shape[0]
    rows = ms.obs_mp[win_idx]
    dec_ok = (rows >= 0) & kf_kill[:, None]
    n_obs_all = n_obs_all.at[jnp.where(dec_ok, rows, Mc)].add(
        -1, mode="drop")
    ms = M.delete_keyframes(ms, kill_mask)
    win_mask = win_mask & ~kf_kill

    info = jnp.concatenate([
        jnp.stack([n_tri_new, ba_factors, ba_outliers,
                   n_culled]).astype(jnp.int32),
        jnp.where(win_mask, win_idx, -1).astype(jnp.int32),
        # culled keyframe slots (feeds the host KF free-list)
        jnp.where(kf_kill, win_idx, -1).astype(jnp.int32)])
    return MappingStepOut(ms=ms, info=info, n_obs=n_obs_all,
                          obs_mask=M.observer_mask(ms))


class KeyframeStepOut(NamedTuple):
    ms: M.MapState
    info: jnp.ndarray
    """(18 + 2*Wk,) float32: [n_new_stereo, n_new_tri, n_factors,
    n_ba_outliers, n_culled, n_obs_kf, R_kf row-major (9), t_kf (3),
    window slots (-1 padded, Wk), culled KF slots (-1 padded, Wk)] — ONE
    fetch for the entire keyframe path."""
    n_obs: jnp.ndarray = None
    """(M,) int32 per-point observation counts (device handle, never
    fetched): tracking's keyframe-decision table, refreshed here for free
    instead of by a separate full-table sweep per keyframe."""
    obs_mask: jnp.ndarray = None
    """(M, ceil(K/32)) uint32 observer bitmask for tracking (device
    handle, never fetched)."""


@partial(jax.jit, static_argnames=("calib", "orb_cfg", "n_tri", "window_kf",
                                   "n_fixed", "pt_cap", "ba_iters", "do_ba",
                                   "red_th"),
         donate_argnames=("ms",))
def keyframe_step(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                  slot: jnp.ndarray, frame: FrameData, R: jnp.ndarray,
                  t: jnp.ndarray, matched_mp: jnp.ndarray,
                  kf_ord: jnp.ndarray, frame_id: jnp.ndarray,
                  depth_max: jnp.ndarray,
                  n_tri: int, window_kf: int, n_fixed: int, pt_cap: int,
                  ba_iters: int, do_ba: bool = True,
                  cullable: jnp.ndarray = None,
                  red_th: float = 0.9) -> KeyframeStepOut:
    """Keyframe insertion + the whole local-mapping iteration in one device
    call (create_keyframe then mapping_step), returning every scalar the
    host schedule needs — including the BA-refined keyframe pose — in a
    single packed array (one blocking fetch instead of six)."""
    kf_ord = jnp.asarray(kf_ord, jnp.int32)
    ms, n_stereo = create_keyframe(ms, calib, slot, frame, R, t, matched_mp,
                                   kf_ord, frame_id, depth_max)
    out = mapping_step(ms, calib, orb_cfg, slot, kf_ord,
                       n_tri=n_tri, window_kf=window_kf, n_fixed=n_fixed,
                       pt_cap=pt_cap, ba_iters=ba_iters, do_ba=do_ba,
                       cullable=cullable, red_th=red_th)
    ms = out.ms
    # reference-matches count for the keyframe decision: only points with
    # >= 3 observations count (ref KeyFrame::TrackedMapPoints(minObs=3) via
    # Tracking::NeedNewKeyFrame, src/Tracking.cc:3071-3075) — counting raw
    # observations (mostly 1-obs spawns) makes every frame "weak" and spams
    # keyframes. Reuses the step's maintained count table (sweep-free).
    n_obs_all = out.n_obs
    row = ms.obs_mp[slot]
    n_obs = jnp.sum((row >= 0)
                    & (n_obs_all[jnp.clip(row, 0)] >= 3)).astype(jnp.int32)
    info = jnp.concatenate([
        jnp.stack([n_stereo, out.info[0], out.info[1], out.info[2],
                   out.info[3], n_obs]).astype(jnp.float32),
        ms.kf_R[slot].reshape(9).astype(jnp.float32),
        ms.kf_t[slot].astype(jnp.float32),
        out.info[4:].astype(jnp.float32)])
    return KeyframeStepOut(ms=ms, info=info, n_obs=out.n_obs,
                           obs_mask=out.obs_mask)


@partial(jax.jit, static_argnames=("calib", "orb_cfg", "n_sweeps"),
         donate_argnames=("ms",))
def global_ba(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
              fixed_kf: jnp.ndarray, n_sweeps: int = 3) -> M.MapState:
    """Whole-map refinement after loop closure / merge (ref
    Optimizer::GlobalBundleAdjustemnt via RunGlobalBundleAdjustment,
    src/LoopClosing.cc:2212): alternating resection-intersection over the
    full factor table (every observation of every valid keyframe), anchor
    keyframe fixed."""
    params = calib.params_array()
    K, N = ms.obs_mp.shape
    obs = ms.obs_mp
    f_valid = (obs >= 0) & ms.kf_valid[:, None] & ms.kp_valid
    f_cam = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[:, None], (K, N))
    s2 = _scale2(orb_cfg)
    cam_opt = ms.kf_valid & (jnp.arange(K) != fixed_kf)
    R_n, t_n, P_n = ba.ba_alternate(
        calib.model, params, jnp.asarray(calib.bf),
        ms.kf_R, ms.kf_t, cam_opt,
        ms.mp_pos, ms.mp_valid,
        f_cam.reshape(-1), jnp.clip(obs, 0).reshape(-1),
        ms.kp_xy.reshape(K * N, 2), ms.kp_uright.reshape(-1),
        s2[ms.kp_octave].reshape(-1), f_valid.reshape(-1),
        n_sweeps=n_sweeps)
    return ms._replace(kf_R=R_n, kf_t=t_n, mp_pos=P_n)


# ---------------------------------------------------------------------------
# Map point culling
# ---------------------------------------------------------------------------

def _cull_impl(ms: M.MapState, current_kf_ord: jnp.ndarray,
               n_obs: jnp.ndarray = None):
    """Functional MapPointCulling (ref src/LocalMapping.cc:370): the
    reference only tests points still in mlpRecentAddedMapPoints — a point
    that survives ~3 keyframes leaves the list and persists forever (its
    later deletion is the sparsifier's job, the whole premise of MS-SLAM).
    So the found/visible and min-observation tests apply ONLY to young
    points; mature points are culled only when they lose every observation
    (the shared_ptr-free analog). Ages are measured in keyframes inserted
    since creation (ordinals, not pool slots — slots are recycled)."""
    age = current_kf_ord - ms.mp_first_ord
    if n_obs is None:
        n_obs = M.mp_obs_count(ms)
    ratio = ms.mp_found.astype(jnp.float32) / jnp.maximum(
        ms.mp_visible.astype(jnp.float32), 1.0)
    young = age <= 3
    kill = ms.mp_valid & (
        (young & (ratio < 0.25))
        | (young & (age >= 2) & (n_obs <= 2))
        | (n_obs == 0))
    return (M.delete_map_points(ms, kill),
            jnp.sum(kill).astype(jnp.int32),
            jnp.where(kill, 0, n_obs))


def cull_map_points(ms: M.MapState, current_kf_ord: jnp.ndarray):
    ms, n_culled, _ = jax.jit(_cull_impl)(ms, current_kf_ord)
    return ms, n_culled


# ---------------------------------------------------------------------------
# Keyframe culling
# ---------------------------------------------------------------------------

def obs_count_by_octave(ms: M.MapState, n_levels: int = 8):
    """(Mc, L) cumulative observation counts: entry [p, o] = number of
    observations of point p (across all valid keyframes) at octave <= o.
    One scatter-add over the whole observation table — the batched analog
    of the per-point observer scan in LocalMapping::KeyFrameCulling."""
    Mc = ms.mp_pos.shape[0]
    obs = ms.obs_mp
    ok = (obs >= 0) & ms.kp_valid & ms.kf_valid[:, None]
    oct_ = jnp.clip(ms.kp_octave, 0, n_levels - 1)
    counts = jnp.zeros((Mc + 1, n_levels), jnp.int32).at[
        jnp.where(ok, obs, Mc), oct_].add(1, mode="drop")
    return jnp.cumsum(counts[:Mc], axis=1)


@partial(jax.jit, static_argnames=("n_levels",))
def keyframe_redundancy(ms: M.MapState, kf: jnp.ndarray,
                        n_levels: int = 8):
    """Fraction of a keyframe's tracked points seen by >=3 OTHER keyframes
    at the same or finer scale — within one coarser level, ref
    LocalMapping::KeyFrameCulling's `scaleLeveli <= scaleLevel+1` check
    (/root/reference/src/LocalMapping.cc:925-). The scale condition keeps
    keyframes that uniquely observe fine detail."""
    cum = obs_count_by_octave(ms, n_levels)
    obs = ms.obs_mp[kf]
    has = (obs >= 0) & ms.kp_valid[kf]
    o = jnp.clip(ms.kp_octave[kf], 0, n_levels - 1)
    # own observation is always at octave <= o+1: subtract it
    n_other = cum[jnp.clip(obs, 0),
                  jnp.minimum(o + 1, n_levels - 1)] - 1
    redundant = has & (n_other >= 3)
    total = jnp.sum(has)
    return jnp.where(total > 0,
                     jnp.sum(redundant) / jnp.maximum(total, 1), 0.0), total

"""Jitted tracking-step kernels.

The compute half of Tracking::Track (/root/reference/src/Tracking.cc:1783):
motion-model / local-map association + motion-only pose optimization fused
into single device calls. The host-side Tracker (tracking.py) owns the state
machine and keyframe policy; everything here is pure.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import map_state as M
from ..ops import lie, matching, pose_opt
from .frontend import Calib, FrameData
from ..ops.orb import OrbConfig


class TrackOut(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    matched_mp: jnp.ndarray   # (N,) per-feature map point idx (-1 none),
                              # inliers only
    n_matched: jnp.ndarray    # matches fed to the optimizer
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("calib", "orb_cfg", "rotation_gate",
                                   "opt_rounds", "opt_iters"))
def track_points(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                 frame: FrameData, R0: jnp.ndarray, t0: jnp.ndarray,
                 pt_idx: jnp.ndarray, pt_valid: jnp.ndarray,
                 th_radius: jnp.ndarray, nn_ratio: jnp.ndarray,
                 rotation_gate: bool = True,
                 opt_rounds: int = 4, opt_iters: int = 10) -> TrackOut:
    """Project the given candidate map points into the frame, associate, and
    optimize the pose (ref SearchByProjection + PoseOptimization).

    pt_idx/pt_valid: fixed-capacity candidate buffer (local map or last
    frame's points). rotation_gate: apply the rotation-histogram check —
    the reference uses it in the last-frame/reloc variants
    (ORBmatcher.cc:1941/:2154) but NOT in track-local-map (:43); the
    point-side angle is refreshed on every successful track (see
    update_point_stats) so the deltas stay clustered under roll.
    """
    params = calib.params_array()
    f = frame.feats
    pm = matching.search_by_projection(
        calib.model, params, R0, t0, calib.width, calib.height,
        ms.mp_pos[pt_idx], ms.mp_normal[pt_idx],
        ms.mp_min_dist[pt_idx], ms.mp_max_dist[pt_idx],
        ms.mp_desc[pt_idx], pt_valid & ms.mp_valid[pt_idx],
        f.xy, f.octave, f.desc, f.valid,
        th_radius=th_radius, nn_ratio=nn_ratio,
        scale_factor=orb_cfg.scale_factor, n_levels=orb_cfg.n_levels,
        pt_angle=ms.mp_angle[pt_idx] if rotation_gate else None,
        f_angle=f.angle if rotation_gate else None)

    mp_of_feat = jnp.where(pm.mp_slot >= 0,
                           pt_idx[jnp.clip(pm.mp_slot, 0)], -1).astype(jnp.int32)
    has = mp_of_feat >= 0
    X = ms.mp_pos[jnp.clip(mp_of_feat, 0)]
    res = pose_opt.pose_optimize(
        calib.model, params, jnp.asarray(calib.bf), R0, t0,
        X, f.xy, frame.u_right, frame.sigma2, has,
        n_rounds=opt_rounds, n_iters=opt_iters)
    matched = jnp.where(res.inlier, mp_of_feat, -1)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=pm.n_matches,
                    n_inliers=res.n_inliers)


@partial(jax.jit, static_argnames=("calib",))
def track_by_pnp(ms: M.MapState, calib: Calib, frame: FrameData,
                 kf: jnp.ndarray, key: jnp.ndarray) -> TrackOut:
    """Prior-free relocalization against one candidate keyframe: appearance
    matching -> batched PnP RANSAC -> motion-only pose optimization (ref
    Tracking::Relocalization, src/Tracking.cc:3688-3713: SearchByBoW +
    MLPnPsolver::iterate + PoseOptimization). No pose prior — works however
    far the true pose is from any stored keyframe pose."""
    from ..ops import pnp
    params = calib.params_array()
    f = frame.feats
    kf_has = ms.kp_valid[kf] & (ms.obs_mp[kf] >= 0)
    mm = matching.mutual_match(f.desc, f.valid, ms.kp_desc[kf], kf_has,
                               max_dist=matching.TH_LOW, nn_ratio=0.75,
                               angle_a=f.angle, angle_b=ms.kp_angle[kf])
    has = mm.idx_b >= 0
    mp = jnp.where(has, ms.obs_mp[kf][jnp.clip(mm.idx_b, 0)], -1)
    has &= mp >= 0
    X = ms.mp_pos[jnp.clip(mp, 0)]
    res_pnp = pnp.pnp_ransac(calib.model, params, X, f.xy, frame.sigma2,
                             has, key, n_hyp=256, min_inliers=10)
    # refine from the PnP pose; fall back to the candidate keyframe's own
    # pose when PnP fails (degenerate geometry)
    R0 = jnp.where(res_pnp.ok, res_pnp.R, ms.kf_R[kf])
    t0 = jnp.where(res_pnp.ok, res_pnp.t, ms.kf_t[kf])
    res = pose_opt.pose_optimize(
        calib.model, params, jnp.asarray(calib.bf), R0, t0,
        X, f.xy, frame.u_right, frame.sigma2, has)
    matched = jnp.where(res.inlier, mp, -1).astype(jnp.int32)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=mm.n_matches, n_inliers=res.n_inliers)


@partial(jax.jit, static_argnames=("calib",))
def track_by_appearance(ms: M.MapState, calib: Calib, frame: FrameData,
                        kf: jnp.ndarray, R0: jnp.ndarray,
                        t0: jnp.ndarray) -> TrackOut:
    """Appearance-only association against one keyframe's landmarks + pose
    optimization (ref Tracking::TrackReferenceKeyFrame, src/Tracking.cc:2703
    — SearchByBoW has no spatial gate, which is what makes it robust to
    large motion; also the per-candidate step of Relocalization :3641)."""
    params = calib.params_array()
    f = frame.feats
    kf_has = ms.kp_valid[kf] & (ms.obs_mp[kf] >= 0)
    mm = matching.mutual_match(f.desc, f.valid, ms.kp_desc[kf], kf_has,
                               max_dist=matching.TH_LOW, nn_ratio=0.7,
                               angle_a=f.angle, angle_b=ms.kp_angle[kf])
    has = mm.idx_b >= 0
    mp = jnp.where(has, ms.obs_mp[kf][jnp.clip(mm.idx_b, 0)], -1)
    has &= mp >= 0
    X = ms.mp_pos[jnp.clip(mp, 0)]
    res = pose_opt.pose_optimize(
        calib.model, params, jnp.asarray(calib.bf), R0, t0,
        X, f.xy, frame.u_right, frame.sigma2, has)
    matched = jnp.where(res.inlier, mp, -1).astype(jnp.int32)
    return TrackOut(R=res.R, t=res.t, matched_mp=matched,
                    n_matched=mm.n_matches, n_inliers=res.n_inliers)


class TrackFullOut(NamedTuple):
    ms: M.MapState
    R: jnp.ndarray
    t: jnp.ndarray
    matched_mp: jnp.ndarray
    stats: jnp.ndarray
    """(33,) float32 ((42,) inertial): [R row-major (9), t (3),
    motion_inliers, used_wide, used_fallback, local_inliers,
    n_close_tracked, n_close_untracked, best_local_kf, n_local_candidates,
    n_ref_matches, ref-KF R row-major (9), ref-KF t (3) | inertial: v (3),
    bg (3), ba (3)] — the ref pose rides along so a reference-keyframe
    switch costs no extra device->host round trip (ref
    Tracking::mpReferenceKF update)."""
    v: jnp.ndarray = None     # (3,) body velocity (inertial kernel only)
    bias: jnp.ndarray = None  # (6,) [bg, ba] (inertial kernel only)


def _predict_const_velocity(R_last, t_last, R_last2, t_last2, has_vel):
    """Constant-velocity prediction computed on device so the track step can
    be dispatched without fetching the previous pose (ref the mVelocity
    motion model, src/Tracking.cc:2833): T0 = (T_last T_last2^-1) T_last."""
    R_vel = R_last @ R_last2.T
    t_vel = t_last - R_vel @ t_last2
    R0 = jnp.where(has_vel, R_vel @ R_last, R_last)
    t0 = jnp.where(has_vel, R_vel @ t_last + t_vel, t_last)
    return R0, t0


def _track_core(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                frame: FrameData, R0, t0, R_last, t_last,
                last_matched, ref_kf, local_cap: int,
                n_obs_all=None, obs_mask=None):
    """Shared association cascade: motion-model matching (+ widened retry +
    appearance fallback via lax.cond), then local-map tracking. Returns
    (ms, out4, stats_i, local buffers) — the per-frame tracking compute of
    Tracking::Track (src/Tracking.cc:1783) minus the final pose write."""
    pt_idx = jnp.clip(last_matched, 0)
    pt_valid = last_matched >= 0

    # the motion-model stage only needs a coarse pose: its job is inlier
    # gating + a projection center for the local-map search, and the final
    # pose is re-polished by the local-map stage below. 2x5 LM iterations
    # (vs the reference's uniform 4x10, Optimizer.cc:759) converge from a
    # constant-velocity init in practice; the chi2 re-gate between rounds
    # is preserved. The budget's cost and accuracy on the H100 are
    # unmeasured (ROADMAP C7, B1).
    out1 = track_points(ms, calib, orb_cfg, frame, R0, t0, pt_idx, pt_valid,
                        jnp.asarray(7.0), jnp.asarray(0.9),
                        opt_rounds=2, opt_iters=5)
    need_wide = out1.n_inliers < 20
    out2 = jax.lax.cond(
        need_wide,
        lambda: track_points(ms, calib, orb_cfg, frame, R0, t0, pt_idx,
                             pt_valid, jnp.asarray(14.0), jnp.asarray(0.9),
                             opt_rounds=2, opt_iters=5),
        lambda: out1)
    need_fb = out2.n_inliers < 10
    out3 = jax.lax.cond(
        need_fb,
        lambda: track_by_appearance(ms, calib, frame, ref_kf, R_last, t_last),
        lambda: out2)

    lk_idx, lk_mask = local_keyframes(ms, out3.matched_mp, k=10,
                                      obs_mask=obs_mask)
    lmask = M.local_map_mask(ms, lk_idx, lk_mask)
    l_idx, l_valid = M.gather_local_points(ms, lmask, local_cap)
    # final polish keeps the reference's full 4x10 budget — this pose is
    # the system output and the observation-graph gate; cutting it loses
    # marginal inliers that the loop/inertial paths need
    out4 = track_points(ms, calib, orb_cfg, frame, out3.R, out3.t,
                        l_idx, l_valid, jnp.asarray(1.0), jnp.asarray(0.8),
                        rotation_gate=False, opt_rounds=4, opt_iters=10)
    ms = update_point_stats(ms, l_idx, l_valid, out4.matched_mp,
                            f_angle=frame.feats.angle)
    n_ct, n_cu = count_trackable_close(calib, frame, out4.matched_mp)
    # reference-keyframe matches for the keyframe decision, evaluated at
    # DECISION time like the reference (KeyFrame::TrackedMapPoints(minObs=3)
    # on mpReferenceKF = best covisible KF, src/Tracking.cc:3071-3075)
    best_kf = lk_idx[0]
    if n_obs_all is None:
        # fallback: recompute in-kernel (a 262k scatter-add); the system
        # passes a cached table refreshed at keyframe rate instead — the
        # observation graph only changes there
        n_obs_all = M.mp_obs_count(ms)
    ref_row = ms.obs_mp[best_kf]
    n_ref = jnp.sum((ref_row >= 0)
                    & (n_obs_all[jnp.clip(ref_row, 0)] >= 3)
                    & ms.kp_valid[best_kf]).astype(jnp.int32)
    stats_i = jnp.stack([
        out3.n_inliers, need_wide.astype(jnp.int32), need_fb.astype(jnp.int32),
        out4.n_inliers, n_ct, n_cu, lk_idx[0],
        jnp.sum(l_valid).astype(jnp.int32), n_ref]).astype(jnp.int32)
    return ms, out4, stats_i, best_kf


def _pack_stats(ms, R, t, stats_i, best_kf, extra=()):
    # pose + stats packed into one array => a single host fetch per frame
    return jnp.concatenate([
        R.reshape(9).astype(jnp.float32),
        t.astype(jnp.float32),
        stats_i.astype(jnp.float32),
        ms.kf_R[best_kf].reshape(9).astype(jnp.float32),
        ms.kf_t[best_kf].astype(jnp.float32),
        *[e.astype(jnp.float32) for e in extra]])


@partial(jax.jit, static_argnames=("calib", "orb_cfg", "local_cap"),
         donate_argnames=("ms",))
def track_full(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
               frame: FrameData, R_last: jnp.ndarray, t_last: jnp.ndarray,
               R_last2: jnp.ndarray, t_last2: jnp.ndarray,
               has_vel: jnp.ndarray,
               last_matched: jnp.ndarray, ref_kf: jnp.ndarray,
               local_cap: int, n_obs_all: jnp.ndarray = None,
               obs_mask: jnp.ndarray = None) -> TrackFullOut:
    """The entire per-frame tracking compute as one fused device call:
    constant-velocity prediction, motion-model association (+ widened retry
    + appearance fallback, both as lax.cond so the hot path costs nothing
    extra), local-map tracking, point-statistics update, and
    keyframe-decision counters. Every input the kernel needs from the
    previous frame (poses, matches) is a device array, so frame N+1 can be
    DISPATCHED before frame N's stats are fetched — the blocking fetch
    comes off the throughput path entirely (the reference gets the same
    overlap from its thread pipeline, src/System.cc:134-186)."""
    R0, t0 = _predict_const_velocity(R_last, t_last, R_last2, t_last2,
                                     has_vel)
    ms, out4, stats_i, best_kf = _track_core(
        ms, calib, orb_cfg, frame, R0, t0, R_last, t_last, last_matched,
        ref_kf, local_cap, n_obs_all, obs_mask)
    packed = _pack_stats(ms, out4.R, out4.t, stats_i, best_kf)
    return TrackFullOut(ms=ms, R=out4.R, t=out4.t,
                        matched_mp=out4.matched_mp, stats=packed)


@partial(jax.jit, static_argnames=("calib", "orb_cfg", "local_cap"),
         donate_argnames=("ms",))
def track_full_imu(ms: M.MapState, calib: Calib, orb_cfg: OrbConfig,
                   frame: FrameData, R_last: jnp.ndarray, t_last: jnp.ndarray,
                   v_last: jnp.ndarray, bias: jnp.ndarray,
                   imu_rows: jnp.ndarray, imu_valid: jnp.ndarray,
                   gravity: jnp.ndarray, noise: jnp.ndarray,
                   R_bc: jnp.ndarray, t_bc: jnp.ndarray,
                   last_matched: jnp.ndarray, ref_kf: jnp.ndarray,
                   local_cap: int,
                   n_obs_all: jnp.ndarray = None,
                   obs_mask: jnp.ndarray = None) -> TrackFullOut:
    """Inertial tracking step, fused: preintegrate the frame's IMU rows,
    predict the pose from the last body state (ref Tracking::PredictStateIMU,
    src/Tracking.cc:1727), run the association cascade, then refine
    [pose, velocity, bias] jointly against reprojection + the preintegration
    factor (ref Optimizer::PoseInertialOptimizationLastFrame,
    src/Optimizer.cc:4781, called from Tracking.cc:2913-2921). One dispatch,
    one packed fetch; the body state chains on device between frames.

    imu_rows: (cap,7) padded [dt, ax..az, gx..gz]; noise: (4,) continuous
    densities [gyro, acc, gyro_walk, acc_walk]; R_bc/t_bc: T_bc extrinsic."""
    from ..ops import imu as imu_ops
    from ..ops import inertial_opt

    preint = imu_ops.integrate(bias, imu_rows, imu_valid,
                               noise[0], noise[1], noise[2], noise[3])

    # previous body state from the last camera pose: T_wb = T_wc * T_cb
    R_wc1 = R_last.T
    p_wc1 = -R_wc1 @ t_last
    R_cb = R_bc.T
    p_cb = -R_cb @ t_bc
    R_wb1 = R_wc1 @ R_cb
    p_wb1 = R_wc1 @ p_cb + p_wc1

    # IMU state prediction across the interval
    dT = preint.dT
    R_wb2 = lie.normalize_rotation(R_wb1 @ preint.dR)
    v2 = v_last + gravity * dT + R_wb1 @ preint.dV
    p_wb2 = (p_wb1 + v_last * dT + 0.5 * gravity * dT * dT
             + R_wb1 @ preint.dP)
    # predicted camera pose: T_cw = (T_wb T_bc)^-1
    R_wc2 = R_wb2 @ R_bc
    t_wc2 = R_wb2 @ t_bc + p_wb2
    R0 = R_wc2.T
    t0 = -R0 @ t_wc2

    ms, out4, stats_i, best_kf = _track_core(
        ms, calib, orb_cfg, frame, R0, t0, R_last, t_last, last_matched,
        ref_kf, local_cap, n_obs_all, obs_mask)

    # joint [T_wb, v, bg, ba] refinement seeded at the visual solution
    R_wc4 = out4.R.T
    p_wc4 = -R_wc4 @ out4.t
    R_wb4 = R_wc4 @ R_cb
    p_wb4 = R_wc4 @ p_cb + p_wc4
    has = out4.matched_mp >= 0
    X = ms.mp_pos[jnp.clip(out4.matched_mp, 0)]
    pvb = inertial_opt.pose_vel_bias_optimize(
        calib.model, calib.params_array(), jnp.asarray(calib.bf),
        R_bc, t_bc,
        R_wb1, p_wb1, v_last, bias[:3], bias[3:], preint,
        R_wb4, p_wb4, v2,
        X, frame.feats.xy, frame.u_right, frame.sigma2, has,
        walk_info=jnp.full(6, 1e4, R_wb4.dtype), g=gravity)
    # accept the joint solution when it keeps at least as many inliers
    use = (pvb.n_inliers >= out4.n_inliers) & (preint.dT > 0)
    R_wcn = pvb.R_wb @ R_bc
    t_wcn = pvb.R_wb @ t_bc + pvb.p_wb
    R_n = jnp.where(use, R_wcn.T, out4.R)
    t_n = jnp.where(use, -R_wcn.T @ t_wcn, out4.t)
    v_n = jnp.where(use, pvb.v, v2)
    bias_n = jnp.where(use, jnp.concatenate([pvb.bg, pvb.ba]), bias)
    matched = jnp.where(use, jnp.where(pvb.inlier, out4.matched_mp, -1),
                        out4.matched_mp)
    n_inl = jnp.where(use, pvb.n_inliers, out4.n_inliers)
    stats_i = stats_i.at[3].set(n_inl)

    packed = _pack_stats(ms, R_n, t_n, stats_i, best_kf,
                         extra=(v_n, bias_n))
    return TrackFullOut(ms=ms, R=R_n, t=t_n, matched_mp=matched,
                        stats=packed, v=v_n, bias=bias_n)


@partial(jax.jit, static_argnames=("k",))
def local_keyframes(ms: M.MapState, matched_mp: jnp.ndarray, k: int,
                    obs_mask: jnp.ndarray = None):
    """Local keyframe set for local-map tracking: keyframes sharing the most
    observations with the current frame's matches, by vote (ref
    Tracking::UpdateLocalKeyFrames, src/Tracking.cc:3431).

    obs_mask: optional cached per-point observer bitmask (M, ceil(K/32))
    from map_state.observer_mask — votes then cost one 2048-row gather +
    bit-unpack sum instead of a 262K-element sweep of the observation
    table. The mask is exact between keyframe steps:
    tracking never mutates the observation graph.

    Returns (idx (k,), mask (k,))."""
    Mc = ms.mp_pos.shape[0]
    K = ms.kf_valid.shape[0]
    if obs_mask is not None:
        rows = jnp.where((matched_mp >= 0)[:, None],
                         obs_mask[jnp.clip(matched_mp, 0)], 0)   # (N,Wd)
        bits = (rows[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
        votes = jnp.sum(bits.reshape(rows.shape[0], -1).astype(jnp.int32),
                        axis=0)[:K]
        votes = jnp.where(ms.kf_valid, votes, 0)
    else:
        tbl = M.member_table(matched_mp, Mc)
        obs = ms.obs_mp
        hit = tbl[jnp.clip(obs, 0, Mc)] & (obs >= 0) & ms.kf_valid[:, None]
        votes = jnp.sum(hit, axis=1)
    w, idx = jax.lax.top_k(votes, k)
    return idx, w > 0


@jax.jit
def update_point_stats(ms: M.MapState, pt_idx: jnp.ndarray,
                       visible: jnp.ndarray, matched_mp: jnp.ndarray,
                       f_angle: jnp.ndarray = None):
    """IncreaseVisible for frustum-passing candidates, IncreaseFound for
    tracked inliers (ref Tracking::SearchLocalPoints/TrackLocalMap).
    f_angle: per-feature orientations — matched points take the newest
    observation's angle so the rotation-histogram delta in the
    motion-model matcher stays clustered under accumulated roll."""
    ms = M.update_mp_stats(ms, pt_idx, visible, jnp.zeros_like(visible))
    found_idx = jnp.where(matched_mp >= 0, matched_mp, ms.mp_pos.shape[0])
    ms = ms._replace(mp_found=ms.mp_found.at[found_idx].add(1, mode="drop"))
    if f_angle is not None:
        ms = ms._replace(mp_angle=ms.mp_angle.at[found_idx].set(
            f_angle, mode="drop"))
    return ms


@partial(jax.jit, static_argnames=("calib",))
def count_trackable_close(calib: Calib, frame: FrameData,
                          matched_mp: jnp.ndarray):
    """Keyframe-decision counters (ref Tracking::NeedNewKeyFrame
    close-point condition, src/Tracking.cc:3100-3125): tracked close points
    and untracked-but-triangulable close points."""
    close = (frame.depth > 0) & (frame.depth <= calib.th_depth) \
        & frame.feats.valid
    tracked = close & (matched_mp >= 0)
    untracked = close & (matched_mp < 0)
    return jnp.sum(tracked).astype(jnp.int32), \
        jnp.sum(untracked).astype(jnp.int32)

"""Loop closing stage: sparsified-only place recognition, geometric
verification, SE(3) loop correction and essential-graph optimization.

Host orchestration mirroring LoopClosing::Run
(/root/reference/src/LoopClosing.cc): sparsified keyframes are the only ones
entering the BoW database (InsertSparsifiedKeyFrame/DeleteOutdatedInfo
:306-326); per new keyframe, candidates come from the database
(KeyFrameDatabase::DetectNBestCandidates :600 — sparsified, non-covisible),
are verified by descriptor matching + RANSAC alignment (Sim3Solver ->
ops/sim3.py), and a loop is confirmed after 3 consecutive verified
keyframes (:399). Correction (CorrectLoop :924) rigidly moves the current
covisible window + its points, fuses duplicates, then optimizes the
essential graph (Optimizer::OptimizeEssentialGraph -> ops/pose_graph.py)
with the matched keyframe fixed, and finally re-anchors every map point by
its reference keyframe's pose change. Global BA refinement is planned work
(ref RunGlobalBundleAdjustment :2212).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models import map_state as M
from ..models.vocab import KeyFrameDatabase
from ..ops import lie, matching, pose_graph, sim3
from .frontend import Calib

MIN_RANSAC_INLIERS = 20
CONSECUTIVE_NEEDED = 3
# essential-graph extra-edge covisibility threshold (ref minFeat=100,
# Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:1410 — calibrated
# for 2000-feature frames; SystemConfig.loop_covis_min scales it for
# smaller feature budgets)
COVIS_EDGE_MIN = 100
# inertial yaw-only loop gating: once gravity is observed (VIBA2 done) a
# valid loop correction can only be yaw drift about gravity + translation
# (ref LoopClosing.cc:243-256: |pitch|,|roll| < 0.008 rad, |yaw| < 0.349)
INERTIAL_PITCHROLL_TOL = 0.008
INERTIAL_YAW_TOL = 0.349


def _verify_pair_impl(ms: M.MapState, calib: Calib, kf_a: jnp.ndarray,
                      kf_b: jnp.ndarray, key: jnp.ndarray,
                      with_scale: bool = False):
    """Descriptor-match two keyframes, RANSAC-align their shared landmark
    geometry, then run the reference's full verification cascade: Sim3-
    guided projection search in BOTH directions to harvest matches beyond
    the mutual-descriptor set (ref ORBmatcher::SearchBySim3,
    src/ORBmatcher.cc:1718; SearchByProjection(Scw) :532) and an iterative
    Sim3 Gauss-Newton refinement (ref Optimizer::OptimizeSim3,
    src/Optimizer.cc:1986, th2=10). Returns (n_inliers, s, R, t) with
    (s,R,t) mapping keyframe-b camera coords into keyframe-a camera coords
    (scale free for monocular, ref Sim3Solver bFixScale)."""
    params = calib.params_array()
    va = ms.kp_valid[kf_a] & (ms.obs_mp[kf_a] >= 0)
    vb = ms.kp_valid[kf_b] & (ms.obs_mp[kf_b] >= 0)
    mm = matching.mutual_match(ms.kp_desc[kf_a], va, ms.kp_desc[kf_b], vb,
                               max_dist=matching.TH_LOW, nn_ratio=0.75,
                               angle_a=ms.kp_angle[kf_a],
                               angle_b=ms.kp_angle[kf_b])
    has = mm.idx_b >= 0
    ib = jnp.clip(mm.idx_b, 0)
    mp_a = ms.obs_mp[kf_a]
    mp_b = ms.obs_mp[kf_b][ib]
    ok = has & (mp_a >= 0) & (mp_b >= 0)
    # per-feature landmark coords in each keyframe's camera frame
    Xa = ms.mp_pos[jnp.clip(mp_a, 0)]
    Xb_all = ms.mp_pos[jnp.clip(ms.obs_mp[kf_b], 0)]
    Xc_a_all = lie.se3_apply(ms.kf_R[kf_a], ms.kf_t[kf_a], Xa)
    Xc_b_all = lie.se3_apply(ms.kf_R[kf_b], ms.kf_t[kf_b], Xb_all)
    Xc_b = Xc_b_all[ib]
    s2a = (1.2 ** ms.kp_octave[kf_a].astype(jnp.float32)) ** 2
    s2b_all = (1.2 ** ms.kp_octave[kf_b].astype(jnp.float32)) ** 2
    res = sim3.sim3_ransac(calib.model, params, Xc_a_all, Xc_b, s2a,
                           s2b_all[ib], ok, key, n_hyp=128,
                           with_scale=with_scale)

    # --- Sim3-guided projection harvest (both directions + agreement,
    # ref SearchBySim3's two-way check) -------------------------------
    w_img = jnp.asarray(calib.width, jnp.float32)
    h_img = jnp.asarray(calib.height, jnp.float32)
    g_b2a = sim3.sim3_guided_match(
        calib.model, params, res.s, res.R, res.t,
        Xc_b_all, vb, ms.kp_desc[kf_b],
        ms.kp_xy[kf_a], ms.kp_octave[kf_a], ms.kp_desc[kf_a], va,
        w_img, h_img)
    si, Ri, ti = lie.sim3_inv(res.s, res.R, res.t)
    g_a2b = sim3.sim3_guided_match(
        calib.model, params, si, Ri, ti,
        Xc_a_all, va, ms.kp_desc[kf_a],
        ms.kp_xy[kf_b], ms.kp_octave[kf_b], ms.kp_desc[kf_b], vb,
        w_img, h_img)
    Na = va.shape[0]
    Nb = vb.shape[0]
    agree = (g_b2a >= 0) \
        & (g_a2b[jnp.clip(g_b2a, 0)] == jnp.arange(Nb))
    tgt = jnp.where(agree, g_b2a, Na)
    guided_j = jnp.full((Na + 1,), -1, jnp.int32).at[tgt].set(
        jnp.arange(Nb, dtype=jnp.int32), mode="drop")[:Na]
    # union: mutual matches take precedence, guided fills the rest
    j_comb = jnp.where(ok, mm.idx_b, guided_j)
    corr = j_comb >= 0
    jc = jnp.clip(j_comb, 0)

    # --- iterative Sim3 refinement on the combined set (OptimizeSim3)
    ref = sim3.sim3_refine(
        calib.model, params,
        Xc_a_all, Xc_b_all[jc],
        ms.kp_xy[kf_a], ms.kp_xy[kf_b][jc],
        s2a, s2b_all[jc], corr,
        res.s, res.R, res.t, with_scale=with_scale, n_iters=10)
    # fall back to the RANSAC estimate if refinement diverged
    better = ref.n_inliers >= res.n_inliers
    n_out = jnp.maximum(ref.n_inliers, res.n_inliers)
    s_o = jnp.where(better, ref.s, res.s)
    R_o = jnp.where(better, ref.R, res.R)
    t_o = jnp.where(better, ref.t, res.t)
    return n_out, s_o, R_o, t_o


_verify_pair = partial(jax.jit, static_argnames=("calib", "with_scale"))(
    _verify_pair_impl)


@partial(jax.jit, static_argnames=("calib", "with_scale", "k_cands"))
def detect_and_verify(ms: M.MapState, calib: Calib, slot: jnp.ndarray,
                      present: jnp.ndarray, has_row: jnp.ndarray,
                      rows: jnp.ndarray, key: jnp.ndarray,
                      min_score: jnp.ndarray, with_scale: bool,
                      k_cands: int = 3):
    """The whole per-keyframe place-recognition step as ONE device call
    (ref LoopClosing::NewDetectCommonRegions, src/LoopClosing.cc:330 +
    KeyFrameDatabase::DetectNBestCandidates :600): tf-idf BoW scoring over
    the sparsified database — one (K,V)@(V,) matvec using the query
    keyframe's own stored BoW row, cost independent of the database size —
    covisibility exclusion, top-k candidate selection, and geometric
    Sim3/SE3 RANSAC + guided-projection + OptimizeSim3 verification of
    each; the host fetches one packed array per keyframe instead of doing
    3-6 separate round trips. The heavyweight exact-descriptor rescoring
    happens implicitly inside verification (mutual + guided matching).

    Returns (packed (k,15), group (K,)): per candidate
    [cand_slot, score, n_inl, s, t(3), R(9)]; group = covisibility mask of
    the best verified candidate (for the consecutive-verification rule)."""
    from ..models.vocab import tfidf_scores
    covis = M.covisibility_counts(ms, slot)
    not_self = jnp.arange(ms.kf_valid.shape[0]) != slot
    mask = present & ms.kf_valid & (covis == 0) & not_self & has_row
    # score EVERYTHING once; covisible neighbors give the adaptive floor
    # (ref LoopClosing computes minScore as the lowest BoW similarity to a
    # covisible keyframe, src/LoopClosing.cc:330 + DetectNBestCandidates
    # :600 — a candidate that looks less like "here" than the worst
    # covisible view is noise, and skipping its RANSAC verification keeps
    # place recognition off the device's critical path)
    all_mask = ms.kf_valid & not_self & has_row
    scores_all = tfidf_scores(rows, present, rows[slot])
    scores_all = jnp.where(all_mask, scores_all, -1.0)
    nb_mask = all_mask & (covis > 0)
    nb_min = jnp.min(jnp.where(nb_mask, scores_all, jnp.inf))
    thr = jnp.maximum(min_score,
                      jnp.where(jnp.isfinite(nb_min), 0.75 * nb_min,
                                min_score))
    scores = jnp.where(mask, scores_all, -jnp.inf)
    top_s, top_i = jax.lax.top_k(scores, k_cands)

    def verify(i):
        c = top_i[i]
        worth = top_s[i] > thr
        n_inl, s, R, t = jax.lax.cond(
            worth,
            lambda: _verify_pair_impl(ms, calib, slot, c,
                                      jax.random.fold_in(key, i),
                                      with_scale=with_scale),
            lambda: (jnp.zeros((), jnp.int32),
                     jnp.ones((), jnp.float32),
                     jnp.eye(3, dtype=jnp.float32),
                     jnp.zeros(3, jnp.float32)))
        return jnp.concatenate([
            jnp.stack([c.astype(jnp.float32), top_s[i],
                       n_inl.astype(jnp.float32), s]),
            t, R.reshape(9)])

    packed = jax.lax.map(verify, jnp.arange(k_cands))
    best = jnp.argmax(packed[:, 2])
    group = M.covisibility_counts(ms, top_i[best]) > 0
    group = group.at[top_i[best]].set(True)
    return packed, group


@partial(jax.jit, static_argnames=("calib", "with_scale", "pt_cap"))
def refine_hypothesis(ms: M.MapState, calib: Calib, cur: jnp.ndarray,
                      match: jnp.ndarray, last_cur: jnp.ndarray,
                      s_lw: jnp.ndarray, R_lw: jnp.ndarray,
                      t_lw: jnp.ndarray, with_scale: bool, pt_cap: int):
    """Temporal loop-hypothesis refinement, one device call (ref
    LoopClosing::DetectAndReffineSim3FromLastKF, src/LoopClosing.cc:539-581
    via NewDetectCommonRegions :377-424): once a candidate verified, the
    NEXT keyframe transports the held Sim3 S_lw (world -> last-current
    camera) through the odometry increment — S_cw = T_c_lc * S_lw — and
    re-verifies against the SAME matched keyframe instead of re-querying
    the database:

      1. project the matched KF's covisible-window landmark pool into the
         current frame under S_cw, harvest descriptor matches
         (FindMatchesByProjection analog, :868);
      2. refine S_cw on the harvested set (OptimizeSim3, 10 iters);
      3. re-harvest under the refined transform.

    Returns packed (16,): [n_proj, n_opt_inliers, n_reharvest, s, t(3),
    R(9)] — the host applies the reference's 30/50/100 acceptance ladder
    (scaled to the feature budget). Unlike the reference we compose the
    REFINED transform into the re-harvest and the held hypothesis (the
    reference re-harvests with the pre-refinement rotation/translation at
    scale 1 — keeping the refined estimate is strictly tighter)."""
    params = calib.params_array()
    K = ms.kf_valid.shape[0]
    # transported hypothesis: S_cw = T_cw_est * T_lw_est^-1 * S_lw
    R_c, t_c = ms.kf_R[cur], ms.kf_t[cur]
    R_l, t_l = ms.kf_R[last_cur], ms.kf_t[last_cur]
    R_cl = R_c @ R_l.T
    t_cl = t_c - R_cl @ t_l
    R_cw = R_cl @ R_lw
    t_cw = R_cl @ t_lw + t_cl
    s_cw = s_lw

    # matched-side landmark pool: the matched KF's covisible window (ref
    # FindMatchesByProjection gathers the matched KF + up to 5 covisibles)
    covis = M.covisibility_counts(ms, match)
    msel = (covis > 0).at[match].set(True)
    pmask = M.local_map_mask(ms, jnp.arange(K), msel)
    pt_idx, pt_valid = M.gather_local_points(ms, pmask, pt_cap)
    Xw = ms.mp_pos[jnp.clip(pt_idx, 0)]
    desc_m = ms.mp_desc[jnp.clip(pt_idx, 0)]

    xy_c = ms.kp_xy[cur]
    oct_c = ms.kp_octave[cur]
    desc_c = ms.kp_desc[cur]
    va = ms.kp_valid[cur]
    w_img = jnp.asarray(calib.width, jnp.float32)
    h_img = jnp.asarray(calib.height, jnp.float32)
    Nc = va.shape[0]

    def harvest(s, R, t):
        g = sim3.sim3_guided_match(calib.model, params, s, R, t,
                                   Xw, pt_valid, desc_m,
                                   xy_c, oct_c, desc_c, va, w_img, h_img)
        # count distinct matched current-frame features
        hit = jnp.zeros((Nc + 1,), bool).at[
            jnp.where(g >= 0, g, Nc)].set(True)[:Nc]
        return g, jnp.sum(hit).astype(jnp.int32)

    g1, n1 = harvest(s_cw, R_cw, t_cw)
    corr = g1 >= 0
    gc = jnp.clip(g1, 0)
    sigma2 = (1.2 ** oct_c[gc].astype(jnp.float32)) ** 2
    ref = sim3.sim3_refine_world(
        calib.model, params, Xw, xy_c[gc], sigma2, corr,
        s_cw, R_cw, t_cw, with_scale=with_scale, n_iters=10)
    _, n2 = harvest(ref.s, ref.R, ref.t)
    return jnp.concatenate([
        jnp.stack([n1.astype(jnp.float32), ref.n_inliers.astype(jnp.float32),
                   n2.astype(jnp.float32), ref.s]),
        ref.t, ref.R.reshape(9)])


@jax.jit
def _apply_window_correction(ms: M.MapState, win_mask_k: jnp.ndarray,
                             sc: jnp.ndarray, Rc: jnp.ndarray,
                             tc: jnp.ndarray, cur: jnp.ndarray):
    """Similarity-move the keyframes in win_mask_k and their points:
    S_new_i = T_old_i * T_old_cur^-1 * S_corr_cur (relative poses to the
    current keyframe preserved), stored as SE(3) with t/s (ref CorrectLoop's
    CorrectedSim3 propagation + the eigt*=1/s conversion); points
    X' = S_corr^-1 * T_old_cur * X. sc=1 for stereo/RGB-D."""
    R_cur, t_cur = ms.kf_R[cur], ms.kf_t[cur]
    Ri, ti = lie.se3_inv(R_cur, t_cur)
    # delta = T_old_cur^-1 * S_corr  (sim3 with scale sc)
    Rd = Ri @ Rc
    td = jnp.einsum("ij,j->i", Ri, tc) + ti
    R_new = ms.kf_R @ Rd
    t_new = (jnp.einsum("kij,j->ki", ms.kf_R, td) + ms.kf_t) / sc
    kf_R = jnp.where(win_mask_k[:, None, None], R_new, ms.kf_R)
    kf_t = jnp.where(win_mask_k[:, None], t_new, ms.kf_t)

    # world-side point correction for points observed by the window:
    # X' = S_corr^-1 (T_old_cur X)
    pmask = M.local_map_mask(
        ms, jnp.arange(ms.kf_valid.shape[0]), win_mask_k)
    sci, Rci, tci = lie.sim3_inv(sc, Rc, tc)
    sw, Rw, tw = lie.sim3_compose(sci, Rci, tci, jnp.ones((), sc.dtype),
                                  R_cur, t_cur)
    moved = lie.sim3_apply(sw, Rw, tw, ms.mp_pos)
    mp_pos = jnp.where(pmask[:, None], moved, ms.mp_pos)
    return ms._replace(kf_R=kf_R, kf_t=kf_t, mp_pos=mp_pos)


@jax.jit
def _apply_sim3_graph(ms: M.MapState, old_R: jnp.ndarray,
                      old_t: jnp.ndarray, s_new: jnp.ndarray,
                      R_new: jnp.ndarray, t_new: jnp.ndarray):
    """Write back a 7-DoF essential-graph result: keyframe poses stored as
    SE(3) with t/s (ref OptimizeEssentialGraph's eigt*=1/s), points moved
    by their reference keyframe's Sim(3) change X' = S_new^-1(T_old X)."""
    ref = jnp.clip(ms.mp_first_kf, 0, ms.kf_valid.shape[0] - 1)
    X_cam = lie.se3_apply(old_R[ref], old_t[ref], ms.mp_pos)
    si, Ri, ti = lie.sim3_inv(s_new[ref], R_new[ref], t_new[ref])
    X_n = lie.sim3_apply(si, Ri, ti, X_cam)
    ok = ms.mp_valid & ms.kf_valid[ref]
    mp_pos = jnp.where(ok[:, None], X_n, ms.mp_pos)
    return ms._replace(kf_R=R_new, kf_t=t_new / s_new[:, None],
                       mp_pos=mp_pos)


@jax.jit
def _reanchor_points(ms: M.MapState, old_R: jnp.ndarray, old_t: jnp.ndarray):
    """After pose-graph optimization, move every point by its reference
    keyframe's pose change: X' = T_new_ref^-1 * T_old_ref * X (ref
    OptimizeEssentialGraph's point correction via mnCorrectedReference)."""
    ref = jnp.clip(ms.mp_first_kf, 0, ms.kf_valid.shape[0] - 1)
    Ro, to = old_R[ref], old_t[ref]
    Rn, tn = ms.kf_R[ref], ms.kf_t[ref]
    Rni, tni = lie.se3_inv(Rn, tn)
    X_cam = lie.se3_apply(Ro, to, ms.mp_pos)
    X_new = lie.se3_apply(Rni, tni, X_cam)
    ok = ms.mp_valid & ms.kf_valid[ref]
    return ms._replace(mp_pos=jnp.where(ok[:, None], X_new, ms.mp_pos))


class LoopCloser:
    """Host-side stage state (the LoopClosing 'thread')."""

    def __init__(self, system, n_words: int = 2048):
        self.sys = system
        # monocular maps drift in scale -> Sim(3) verification and 7-DoF
        # essential graph (ref bFixScale=false for MONOCULAR/IMU-less)
        self.mono = (system.calib.bf or 0.0) <= 0.0
        # the sparsified-KF database is shared System state (reloc uses it
        # too); a standalone one only exists for direct construction in
        # tests
        self.db = system.kf_db if system.kf_db is not None else \
            KeyFrameDatabase(n_words=n_words, max_kf=system.cfg.map.max_kf)
        self.key = jax.random.PRNGKey(7)
        self._ba_mesh = self._dist_ba_mesh(system.cfg.dist_ba_devices)
        self.stats = {"queries": 0, "verified": 0, "loops": 0, "refines": 0}
        self.loop_edges: list[tuple[int, int]] = []
        # active place hypothesis (ref mnLoopNumCoincidences machinery,
        # LoopClosing.cc:377-424): matched KF, the keyframe the held Sim3
        # is anchored to, S_lw = (s, R, t) world -> last-current camera,
        # and the coincidence / not-found counters
        self._hyp: dict | None = None
        # acceptance ladder for hypothesis refinement (ref 30/50/100 at
        # 2000 features, DetectAndReffineSim3FromLastKF) scaled to budget
        f = system.cfg.orb.n_features / 2000.0
        self.th_proj = max(int(round(30 * f)), 10)
        self.th_opt = max(int(round(50 * f)), 14)
        self.th_rep = max(int(round(100 * f)), 22)

    # -- detection per new keyframe -------------------------------------
    # (the sparsified-KF database feed happens in Sparsifier._sparsify via
    # System.kf_db.add — the analog of LoopClosing::DeleteOutdatedInfo ->
    # KeyFrameDatabase::add, src/LoopClosing.cc:318-326)
    _pending = None

    @staticmethod
    def _dist_ba_mesh(n_dist: int):
        """Device mesh for the sharded global BA (None: single-device
        solve). Asking for more devices than JAX sees is an error."""
        if n_dist <= 1:
            return None
        if n_dist > len(jax.devices()):
            raise ValueError(
                f"SystemConfig.dist_ba_devices={n_dist}, but JAX sees only "
                f"{len(jax.devices())} device(s)")
        from ..parallel import dist_ba
        return dist_ba.make_mesh(n_dist)

    def insert_keyframe(self, slot: int):
        """Dispatch this keyframe's place-recognition work; the result is
        FETCHED at the next keyframe (or flush) — the reference runs
        detection on its own thread for the same reason (LoopClosing::Run),
        a synchronous device_get per query would stall the camera-rate
        path until the query finished.

        With an active hypothesis the dispatch is a REFINEMENT against the
        held matched keyframe (ref NewDetectCommonRegions
        :377: `if(mnLoopNumCoincidences > 0)` runs
        DetectAndReffineSim3FromLastKF instead of the database query);
        otherwise it is the tf-idf database query + Sim3 verification."""
        self.flush()                    # integrate the previous dispatch
        if self._pending is not None:   # refine-failure fallback query
            self.flush()
        sys = self.sys
        h = self._hyp
        if h is not None:
            if (h["match"] in sys.kf_order
                    and h["last_cur"] in sys.kf_order):
                self.stats["refines"] += 1
                s0, R0, t0 = h["S_lw"]
                packed = refine_hypothesis(
                    sys.ms, sys.calib, jnp.asarray(slot),
                    jnp.asarray(h["match"]), jnp.asarray(h["last_cur"]),
                    jnp.asarray(s0, jnp.float32),
                    jnp.asarray(R0, jnp.float32),
                    jnp.asarray(t0, jnp.float32),
                    with_scale=self.mono,
                    pt_cap=sys.cfg.map.local_mp_cap)
                try:
                    packed.copy_to_host_async()
                except Exception:
                    pass
                self._pending = ("refine", slot, packed)
                return
            self._hyp = None            # endpoint culled — drop it
        self._dispatch_query(slot)

    def _dispatch_query(self, slot: int):
        sys = self.sys
        if not self.db.present.any():
            return
        if not self.db._trained:
            self.db._train_now()
        self.stats["queries"] += 1
        self.key, sub = jax.random.split(self.key)
        packed, group_m = detect_and_verify(
            sys.ms, sys.calib, jnp.asarray(slot),
            jnp.asarray(self.db.present), jnp.asarray(self.db.has_row),
            self.db.rows, sub,
            jnp.asarray(0.05, jnp.float32), with_scale=self.mono)
        for h in (packed, group_m):
            try:
                h.copy_to_host_async()
            except Exception:
                pass
        self._pending = ("query", slot, packed)

    def flush(self):
        """Complete a dispatched detection (one deferred fetch)."""
        if self._pending is None:
            return
        if self._pending[0] == "refine":
            self._flush_refine()
        else:
            self._flush_query()

    def _kf_pose_np(self, k: int):
        ms = self.sys.ms
        pk = np.asarray(jnp.concatenate([ms.kf_R[k].reshape(9),
                                         ms.kf_t[k]]))
        return pk[:9].reshape(3, 3), pk[9:]

    def _flush_query(self):
        _, slot, packed = self._pending
        self._pending = None
        packed = np.asarray(jax.device_get(packed))
        row = packed[int(np.argmax(packed[:, 2]))]
        c, n_inl = int(row[0]), int(row[2])
        if n_inl < MIN_RANSAC_INLIERS or c not in self.sys.kf_order \
                or slot not in self.sys.kf_order:
            return
        self.stats["verified"] += 1
        s_cm = float(row[3])
        R_cm = row[7:16].reshape(3, 3)
        t_cm = row[4:7]
        # anchor the hypothesis in world coords: S_cw = S_cm * T_mw
        Rm, tm = self._kf_pose_np(c)
        R_cw = R_cm @ Rm
        t_cw = s_cm * (R_cm @ tm) + t_cm
        self._hyp = {"match": c, "last_cur": slot,
                     "S_lw": (s_cm, R_cw, t_cw),
                     "n_coin": 1, "n_notfound": 0}
        if CONSECUTIVE_NEEDED <= 1:
            self._confirm(slot)

    def _flush_refine(self):
        _, slot, packed = self._pending
        self._pending = None
        p = np.asarray(jax.device_get(packed))
        n_proj, n_opt, n_rep = int(p[0]), int(p[1]), int(p[2])
        h = self._hyp
        if h is None or slot not in self.sys.kf_order:
            return
        ok = (n_proj >= self.th_proj and n_opt > self.th_opt
              and n_rep >= self.th_rep)
        if ok:
            h["n_coin"] += 1
            h["n_notfound"] = 0
            h["last_cur"] = slot
            h["S_lw"] = (float(p[3]), p[7:16].reshape(3, 3), p[4:7])
            self.stats["verified"] += 1
            if h["n_coin"] >= CONSECUTIVE_NEEDED:
                self._confirm(slot)
        else:
            # ref :410-421: two consecutive refinement misses drop the
            # hypothesis; either way the reference falls through to a
            # database query in the same iteration — dispatch it now, the
            # caller's flush integrates it
            h["n_notfound"] += 1
            if h["n_notfound"] >= 2:
                self._hyp = None
            self._dispatch_query(slot)

    def _confirm(self, slot: int):
        h = self._hyp
        self._hyp = None
        match = h["match"]
        if slot not in self.sys.kf_order or match not in self.sys.kf_order:
            return
        # back to relative form for the correction: S_cm = S_cw * T_wm
        s_cw, R_cw, t_cw = h["S_lw"]
        Rm, tm = self._kf_pose_np(match)
        R_cm = R_cw @ Rm.T
        t_cm = t_cw - s_cw * (R_cm @ tm)
        if self.sys.kf_maps[match] != self.sys.kf_maps[slot]:
            # cross-map merges get the gravity-consistency gate too (ref
            # applies the pitch/roll check in common-region detection for
            # loop AND merge candidates, LoopClosing.cc:243-256); widened
            # 2x — merge hypotheses span maps whose relative tilt is less
            # refined
            if self._inertial_gate_ok(slot, match, R_cm, tol_scale=2.0):
                self._merge_maps(slot, match, s_cw, R_cm, t_cm)
        elif self._inertial_gate_ok(slot, match, R_cm):
            self._correct_loop(slot, match, s_cw, R_cm, t_cm)

    def _inertial_ready(self) -> bool:
        sys = self.sys
        return (getattr(sys.cfg, "use_imu", False)
                and getattr(sys, "imu_initialized", False)
                and getattr(sys, "_imu_stage", 0) >= 2)

    def _inertial_gate_ok(self, cur: int, match: int, R_cm,
                          tol_scale: float = 1.0) -> bool:
        """Yaw-only loop gating in inertial mode (ref LoopClosing.cc:243-256):
        gravity is observable once VIBA2 has run, so the world-frame rotation
        of the correction — R_old_wc(cur) @ R_new_cw(cur) with
        R_new_cw = R_cm @ R_mw — must be almost purely about the gravity
        axis (|pitch|,|roll| < 0.008 rad, |yaw| < 0.349 rad)."""
        if not self._inertial_ready():
            return True
        sys = self.sys
        ms = sys.ms
        pk = np.asarray(jnp.concatenate([
            ms.kf_R[cur].reshape(9), ms.kf_R[match].reshape(9)]))
        R_old = pk[:9].reshape(3, 3)
        R_m = pk[9:].reshape(3, 3)
        R_new = np.asarray(R_cm) @ R_m
        dRw = R_old.T @ R_new
        # log map (numpy, tiny)
        cos_t = np.clip((np.trace(dRw) - 1.0) * 0.5, -1.0, 1.0)
        theta = float(np.arccos(cos_t))
        if theta < 1e-9:
            return True
        ax = np.array([dRw[2, 1] - dRw[1, 2], dRw[0, 2] - dRw[2, 0],
                       dRw[1, 0] - dRw[0, 1]])
        ax = ax / max(np.linalg.norm(ax), 1e-12)
        phi = theta * ax
        g = np.asarray(sys.gravity, np.float64)
        up = -g / max(np.linalg.norm(g), 1e-9)
        yaw = float(np.dot(phi, up))
        perp = float(np.linalg.norm(phi - yaw * up))
        # tolerances configurable: the reference's 0.008 rad pitch/roll
        # assumes its 2000-feature continuous VI refinement keeps gravity
        # that tight; smaller budgets need a wider band
        pr_tol = tol_scale * getattr(sys.cfg, "loop_pitchroll_tol",
                                     INERTIAL_PITCHROLL_TOL)
        yaw_tol = tol_scale * getattr(sys.cfg, "loop_yaw_tol",
                                      INERTIAL_YAW_TOL)
        self.stats["gate_pitchroll"] = perp
        self.stats["gate_yaw"] = yaw
        ok = perp < pr_tol and abs(yaw) < yaw_tol
        if not ok:
            self.stats["yaw_rejected"] = self.stats.get("yaw_rejected", 0) + 1
        return ok

    # -- correction ------------------------------------------------------
    def _correct_loop(self, cur: int, match: int, s_cm, R_cm, t_cm):
        """s_cm/R_cm/t_cm map match-KF camera coords -> current-KF camera
        coords. Corrected S_cw(cur) = S_cm * T_mw (ref CorrectLoop mScw)."""
        sys = self.sys
        ms = sys.ms
        self.stats["loops"] += 1
        # current covisible window (plus current)
        covis = np.array(M.covisibility_counts(ms, jnp.asarray(cur)))
        win = covis > 0
        win[cur] = True
        self._rigid_correct(cur, match, s_cm, R_cm, t_cm, win)
        self._fuse_and_optimize(cur, match)

    def _merge_maps(self, cur: int, match: int, s_cm, R_cm, t_cm):
        """Weld the active map onto the matched keyframe's map (ref
        LoopClosing::MergeLocal, src/LoopClosing.cc:1171): rigidly move
        EVERY keyframe+point of the active map into the old map's frame,
        relabel, fuse, and optimize the joint essential graph."""
        sys = self.sys
        self.stats["merges"] = self.stats.get("merges", 0) + 1
        active = sys.kf_maps[cur]
        target = sys.kf_maps[match]
        win = np.asarray(
            [i < len(sys.kf_maps) and sys.kf_maps[i] == active
             for i in range(sys.ms.kf_valid.shape[0])])
        self._rigid_correct(cur, match, s_cm, R_cm, t_cm, win)
        for i, m in enumerate(sys.kf_maps):
            if m == active:
                sys.kf_maps[i] = target
        sys.active_map = target
        self._fuse_and_optimize(cur, match, weld=True)

    def _rigid_correct(self, cur, match, s_cm, R_cm, t_cm, win):
        """Corrected S_cw(cur) = S_cm * T_mw (scale s_cm, =1 unless mono)."""
        sys = self.sys
        ms = sys.ms
        Rm, tm = np.asarray(ms.kf_R[match]), np.asarray(ms.kf_t[match])
        Rc = R_cm @ Rm
        tc = s_cm * (R_cm @ tm) + t_cm
        sys.ms = _apply_window_correction(
            ms, jnp.asarray(win), jnp.asarray(s_cm, jnp.float32),
            jnp.asarray(Rc, jnp.float32),
            jnp.asarray(tc, jnp.float32), jnp.asarray(cur))

    def _weld_ba(self, cur: int, match: int):
        """Seam-local welding BA (ref MergeLocal's local BA around the
        weld with fixed scaffolding keyframes from the target map,
        src/LoopClosing.cc:1171): refine the moved side's seam window and
        its points against the target side, so a coarse merge Sim3 is
        absorbed locally instead of having to be soaked up by the
        essential graph and global BA."""
        from . import mapping_ops as mo
        sys = self.sys
        ms = sys.ms
        Wk = Fk = 8
        pk = np.asarray(jnp.stack([
            M.covisibility_counts(ms, jnp.asarray(cur)),
            M.covisibility_counts(ms, jnp.asarray(match))]))
        kf_valid = np.asarray(ms.kf_valid)
        covis_c = np.where(kf_valid, pk[0], 0)
        covis_m = np.where(kf_valid, pk[1], 0)
        win = [cur] + [int(i) for i in np.argsort(-covis_c)
                       if covis_c[i] > 0 and i != cur][:Wk - 1]
        wset = set(win)
        fix = [match] + [int(i) for i in np.argsort(-covis_m)
                         if covis_m[i] > 0 and i != match
                         and i not in wset][:Fk - 1]
        win_idx = np.zeros(Wk, np.int32)
        win_mask = np.zeros(Wk, bool)
        win_idx[:len(win)] = win
        win_mask[:len(win)] = True
        fix_idx = np.zeros(Fk, np.int32)
        fix_mask = np.zeros(Fk, bool)
        fix_idx[:len(fix)] = fix
        fix_mask[:len(fix)] = True
        out = mo.local_ba(ms, sys.calib, sys.orb,
                          jnp.asarray(win_idx), jnp.asarray(win_mask),
                          jnp.asarray(fix_idx), jnp.asarray(fix_mask),
                          n_fixed=Fk, pt_cap=sys.cfg.map.local_mp_cap,
                          n_iters=10)
        sys.ms = out.ms
        sys._obs_dirty = True

    def _fuse_and_optimize(self, cur: int, match: int, weld: bool = False):
        sys = self.sys
        # re-point stale point->reference-keyframe links before the graph
        # moves points by their reference's pose delta (slots recycle)
        sys.ms = ms = M.refresh_mp_refs(sys.ms)

        # fuse matched-side landmarks into the current keyframe (ref
        # SearchAndFuse, src/LoopClosing.cc:2059; the reference projects
        # into every CorrectedSim3 keyframe — a window-wide variant was
        # measured WORSE here: fusing duplicates into mid-drift neighbors
        # before the graph runs creates wrong associations that the global
        # BA then optimizes toward, reference-scale ATE 2.5% vs 0.75% of
        # path with current-keyframe-only fusion)
        from . import mapping_ops as mo
        mgroup = np.array(M.covisibility_counts(ms, jnp.asarray(match)))
        msel = mgroup > 0
        msel[match] = True
        cand_mask = M.local_map_mask(
            ms, jnp.arange(ms.kf_valid.shape[0]), jnp.asarray(msel))
        c_idx, c_valid = M.gather_local_points(
            ms, cand_mask, sys.cfg.map.local_mp_cap)
        sys._obs_dirty = True
        sys.ms = ms = mo.fuse_into(ms, sys.calib, sys.orb,
                                   jnp.asarray(cur), c_idx, c_valid)
        if weld:
            # map merge: seam-local BA before the graph (ref MergeLocal)
            self._weld_ba(cur, match)
            ms = sys.ms

        # essential graph: temporal chain (spanning-tree analog, via
        # kf_order since pool slots are recycled) + strong covisibility
        # edges (weight >= 100, ref OptimizeEssentialGraph minFeat=100,
        # src/Optimizer.cc:1410) + the loop edge
        old_R = ms.kf_R
        old_t = ms.kf_t
        K = ms.kf_valid.shape[0]
        kf_valid = np.asarray(ms.kf_valid)
        covm = np.array(M.covisibility_matrix(ms))
        e_i, e_j, e_w = [], [], []
        valid_list = [k for k in sys.kf_order if kf_valid[k]]
        for a, b in zip(valid_list[1:], valid_list[:-1]):
            e_i.append(a)
            e_j.append(b)
            e_w.append(10.0)                      # spanning-tree analog
        covis_min = getattr(sys.cfg, "loop_covis_min", COVIS_EDGE_MIN)
        ii, jj = np.where(np.triu(covm, 1) >= covis_min)
        for a, b in zip(ii, jj):
            e_i.append(int(a))
            e_j.append(int(b))
            e_w.append(1.0)
        e_i.append(cur)
        e_j.append(match)
        e_w.append(20.0)                          # the loop edge
        # pad the edge tables to a power-of-two bucket: exact-length edge
        # arrays made every correction recompile all three pose-graph
        # programs (multi-second stall each) — bucketed shapes compile once
        n_live = len(e_i)
        E = max(256, 1 << (n_live - 1).bit_length())
        pad = E - n_live
        e_i += [0] * pad
        e_j += [0] * pad
        e_w += [0.0] * pad
        e_mask = np.zeros(E, bool)
        e_mask[:n_live] = True
        ei_d = jnp.asarray(e_i, jnp.int32)
        ej_d = jnp.asarray(e_j, jnp.int32)
        # all edge measurements in ONE batched device call (was a Python
        # loop with one dispatch per edge)
        eR, et = jax.vmap(pose_graph.relative_pose)(
            old_R[ei_d], old_t[ei_d], old_R[ej_d], old_t[ej_d])
        fixed = np.zeros(K, bool)
        fixed[match] = True
        fixed[~kf_valid] = True
        if self.mono:
            # 7-DoF graph absorbs monocular scale drift
            # (ref OptimizeEssentialGraph bFixScale=false)
            res7 = pose_graph.optimize_pose_graph_sim3(
                jnp.ones(K, ms.kf_t.dtype), ms.kf_R, ms.kf_t,
                jnp.asarray(fixed),
                jnp.asarray(e_i, dtype=jnp.int32),
                jnp.asarray(e_j, dtype=jnp.int32),
                jnp.ones(E, ms.kf_t.dtype), jnp.asarray(eR),
                jnp.asarray(et),
                jnp.asarray(e_w, dtype=jnp.float32), jnp.asarray(e_mask),
                n_iters=10)
            sys.ms = _apply_sim3_graph(ms, old_R, old_t,
                                       res7.s, res7.R, res7.t)
        elif self._inertial_ready():
            # gravity observed -> the graph may only redistribute yaw +
            # translation (ref OptimizeEssentialGraph4DoF,
            # src/Optimizer.cc:5174)
            g = np.asarray(sys.gravity, np.float32)
            up = -g / max(np.linalg.norm(g), 1e-9)
            res4 = pose_graph.optimize_pose_graph_4dof(
                ms.kf_R, ms.kf_t, jnp.asarray(up), jnp.asarray(fixed),
                jnp.asarray(e_i, dtype=jnp.int32),
                jnp.asarray(e_j, dtype=jnp.int32),
                jnp.asarray(eR), jnp.asarray(et),
                jnp.asarray(e_w, dtype=jnp.float32), jnp.asarray(e_mask),
                n_iters=10)
            ms = ms._replace(kf_R=res4.R, kf_t=res4.t)
            sys.ms = _reanchor_points(ms, old_R, old_t)
        else:
            res = pose_graph.optimize_pose_graph(
                ms.kf_R, ms.kf_t, jnp.asarray(fixed),
                jnp.asarray(e_i, dtype=jnp.int32),
                jnp.asarray(e_j, dtype=jnp.int32),
                jnp.asarray(eR), jnp.asarray(et),
                jnp.asarray(e_w, dtype=jnp.float32), jnp.asarray(e_mask),
                n_iters=10)
            ms = ms._replace(kf_R=res.R, kf_t=res.t)
            sys.ms = _reanchor_points(ms, old_R, old_t)
        # global refinement (ref RunGlobalBundleAdjustment): alternating
        # whole-map BA anchored at the matched keyframe; in inertial mode
        # follow with FullInertialBA (poses+velocities+biases against the
        # preintegration chain, ref Optimizer::FullInertialBA
        # src/Optimizer.cc:366 via LoopClosing.cc:2228-2230)
        from . import mapping_ops as mo
        if self._ba_mesh is not None:
            from ..parallel import dist_ba
            sys.ms = dist_ba.dist_global_ba(sys.ms, sys.calib, sys.orb,
                                            match, self._ba_mesh,
                                            n_iters=8)
        else:
            sys.ms = mo.global_ba(sys.ms, sys.calib, sys.orb,
                                  jnp.asarray(match), n_sweeps=2)
        if self._inertial_ready():
            sys._full_inertial_ba()
        self.loop_edges.append((cur, match))
        # tracking must re-localize against the corrected map: drop the
        # velocity model, reseed the device pose chain, and re-run any
        # in-flight frames that tracked against the pre-correction map
        sys.vel = None
        sys._has_vel = False
        sys._Rt_dev = None
        sys._Rt_dev2 = None
        sys.last_R = np.asarray(sys.ms.kf_R[cur])
        sys.last_t = np.asarray(sys.ms.kf_t[cur])
        sys._refresh_ref_pose()
        sys._redispatch_inflight()

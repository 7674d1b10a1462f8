"""System facade: the public API and the deterministic pipeline schedule.

Replaces the reference's System + thread topology
(/root/reference/src/System.cc:41-190 spawns LocalMapping, LoopClosing,
MapSparsification threads; Tracking runs on the caller). This build uses
an explicitly staged host loop instead: every call to `track_stereo` runs
the jitted frontend + tracking kernels, and keyframe insertion runs the
local-mapping stage synchronously (a deterministic interleave — SURVEY §7
"thread semantics -> deterministic schedule"). Math lives on device; the
host only reads a handful of scalars per frame for control flow.

Public surface mirrors System (include/System.h:110-121):
  track_stereo(imL, imR, t) -> Tcw (4,4) numpy
  shutdown(), save_trajectory_kitti/tum(path),
  map_points_in_map() / compressed_map_points_in_map()
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import map_state as M
from ..ops import lie
from ..ops.orb import OrbConfig
from . import mapping_ops as mo
from . import tracking_ops as to
from .frontend import Calib, FrameData, process_stereo

OK, NOT_INITIALIZED, RECENTLY_LOST, LOST = "OK", "NOT_INIT", "RECENTLY_LOST", "LOST"


@partial(jax.jit, donate_argnames=("ms",))
def _delete_one_kf(ms: M.MapState, slot: jnp.ndarray) -> M.MapState:
    mask = jnp.zeros((ms.kf_valid.shape[0],), bool).at[slot].set(True)
    return M.delete_keyframes(ms, mask)


@jax.jit
def _mp_obs_count_jit(ms: M.MapState) -> jnp.ndarray:
    return M.mp_obs_count(ms)


@jax.jit
def _observer_mask_jit(ms: M.MapState) -> jnp.ndarray:
    return M.observer_mask(ms)


def matching_TH_LOW():
    from ..ops.matching import TH_LOW
    return TH_LOW


@dataclass
class SystemConfig:
    calib: Calib = None
    orb: OrbConfig = None
    map: M.MapConfig = None
    # keyframe policy (ref Tracking::NeedNewKeyFrame constants)
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 10
    ref_ratio: float = 0.75
    min_init_depth_points: int = 200
    # local mapping
    n_triangulate_neighbors: int = 4
    n_fixed_cams: int = 4
    ba_iters: int = 8
    # sparsification (ref Sparsification.* yaml keys)
    sparsify: bool = False
    sparsify_n: int = 75
    sparsify_lambda: float = 500.0
    sparsify_grid_lambda: float = 10.0
    sparsify_window: int = 10
    sparsify_queue_min: int = 4
    nonlocal_kf: int = 8
    # loop closing
    loop_closing: bool = False
    # essential-graph extra-edge covisibility threshold (ref minFeat=100
    # at 2000 features/frame; scale down for smaller feature budgets)
    loop_covis_min: int = 100
    # inertial yaw-only loop gate tolerances (ref LoopClosing.cc:243-256:
    # pitch/roll 0.008 rad, yaw 0.349 rad — calibrated for 2000-feature
    # continuous VI refinement; widen for smaller feature budgets)
    loop_pitchroll_tol: float = 0.008
    loop_yaw_tol: float = 0.349
    # shard post-loop global BA over this many devices (0/1 = local solve;
    # the scale-out path, SURVEY §7 Phase 5 — factor table split over the
    # mesh, Schur reduction via a psum collective). More devices than
    # exist is an error, not a silent single-device solve.
    dist_ba_devices: int = 0
    # inertial mode (stereo-inertial): IMU-aided prediction + staged
    # gravity/bias initialization (ref LocalMapping::InitializeIMU schedule)
    use_imu: bool = False
    imu_init_kfs: int = 8
    imu_init_time: float = 1.0
    # inertial keyframe-culling protection: keep the last Nd temporal
    # keyframes un-cullable (ref KeyFrameCulling Nd=21,
    # src/LocalMapping.cc:931; smaller default for small feature budgets)
    imu_protect_nd: int = 10
    # continuous-time IMU noise densities (ref IMU.NoiseGyro/NoiseAcc/
    # GyroWalk/AccWalk yaml keys, Settings::readIMU src/Settings.cc)
    imu_noise_gyro: float = 1e-3
    imu_noise_acc: float = 1e-2
    imu_gyro_walk: float = 1e-6
    imu_acc_walk: float = 1e-4
    # body-from-camera extrinsic (ref IMU.T_b_c1); None = identity
    Tbc: object = None
    # localization-only mode (ref System::ActivateLocalizationMode,
    # src/System.cc:219-257): track against the frozen map, no new KFs
    localization_only: bool = False
    # FrameDrawer analog (ref src/FrameDrawer.cc): dump a keypoint/track
    # overlay PNG every N completed frames (0 = off — keeps the hot path
    # fetch-free)
    frame_draw_every: int = 0
    frame_draw_dir: str = "frames"
    # RECENTLY_LOST grace window before declaring LOST (ref
    # time_recently_lost, src/Tracking.cc:1947-2018: IMU-predicted poses +
    # relocalization retries for ~5s)
    t_recently_lost: float = 5.0


@dataclass
class TrajectoryEntry:
    frame_id: int
    timestamp: float
    ref_kf: int            # -1: T_cr is absolute (world) already
    T_cr: np.ndarray       # frame pose relative to reference keyframe
    lost: bool


@dataclass
class InFlight:
    """A dispatched-but-not-fetched tracking step (the software pipeline
    slot replacing the reference's Tracking-thread/LocalMapping-thread
    overlap)."""
    frame_id: int
    timestamp: float
    frame: FrameData
    out: "to.TrackFullOut"
    imu_used: bool


class System:
    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        self.calib = cfg.calib
        self.orb = cfg.orb
        self.ms = M.empty_map(cfg.map)
        # cached per-point observation counts (device): the obs graph only
        # changes at keyframe rate, so track_full reads this table instead
        # of re-scattering 262k obs entries every frame
        self._n_obs_dev = None
        self._obs_mask_dev = None
        self._obs_dirty = True
        self.n_kf = 0            # keyframe-pool high-water mark
        self.kf_ord = 0          # total keyframes ever created (monotonic)
        self.kf_free: list[int] = []   # recycled keyframe slots
        self.kf_order: list[int] = []  # slots in temporal creation order
        self.n_mp = 0            # total map points ever created (stats)
        self.state = NOT_INITIALIZED
        self.frame_id = -1
        self.last_R = np.eye(3, dtype=np.float32)
        self.last_t = np.zeros(3, dtype=np.float32)
        self._ref_pose_np = (np.eye(3, dtype=np.float32),
                             np.zeros(3, dtype=np.float32))
        self.vel: Optional[np.ndarray] = None   # 4x4 relative motion
        self.last_matched = None                # (N,) device
        self.ref_kf = 0
        self.last_kf_frame = 0
        self.n_inliers_ref = 0
        self.trajectory: list[TrajectoryEntry] = []
        self.timing: dict[str, list] = {}
        self._draw_images: dict[int, np.ndarray] = {}
        # --- software pipeline (depth 2): device-resident tracking chain.
        # Frame N+1's track is dispatched from these handles BEFORE frame
        # N's stats are fetched, so a blocking fetch never sits on the
        # throughput path (ref: the Tracking thread runs concurrently with
        # LocalMapping, src/System.cc:134-186). The depth and fetch batch
        # were sized for a slow host link and are unmeasured on the H100
        # (ROADMAP C1).
        self._inflight: deque[InFlight] = deque()
        import os
        self._pipeline_depth = int(os.environ.get("MSSLAM_PIPELINE_DEPTH",
                                                  "2"))
        # frames completed per blocking fetch (host decisions lag <= 3
        # frames at depth 4, within the reference's own thread-pipeline
        # lag)
        self._fetch_batch = int(os.environ.get(
            "MSSLAM_FETCH_BATCH", str(max(1, self._pipeline_depth - 2))))
        self._Rt_dev = None          # (R,t) device handles, last tracked pose
        self._Rt_dev2 = None         # previous pose (velocity model)
        self._has_vel = False
        self._v_dev = None           # device body velocity (inertial chain)
        self._bias_dev = None        # device [bg, ba]
        self._lost_ts: Optional[float] = None
        self._prev_completed_ts: Optional[float] = None
        # multi-map atlas (ref Atlas, include/Atlas.h:58-114): map labels
        # live host-side; the observation graph keeps maps disjoint on
        # device. A fresh map starts after irrecoverable loss
        # (Tracking::CreateMapInAtlas, src/Tracking.cc:2646).
        self.active_map = 0
        self.kf_maps: list[int] = []       # map id per keyframe slot
        self._lost_frames = 0
        # inertial host state (ref Tracking IMU members)
        self.Tbc = (np.eye(4, dtype=np.float64) if cfg.Tbc is None
                    else np.asarray(cfg.Tbc, np.float64).reshape(4, 4))
        self.Tcb = np.linalg.inv(self.Tbc)
        self.imu_initialized = False
        self.gravity = None                     # (3,) world gravity accel
        self.imu_bias = np.zeros(6, np.float32)  # [bg, ba]
        self.vel_w = np.zeros(3, np.float32)     # body velocity (world)
        self.kf_velocities = np.zeros((cfg.map.max_kf, 3), np.float32)
        self._imu_frame_rows = None
        self._kf_imu_segments: list = []         # raw rows per KF interval
        self._imu_accum: list = []               # rows since last keyframe
        self._kf_times: list = []
        self._last_ts = None
        # sparsification bookkeeping (host): queue of non-local KF slots
        self.sparsify_queue: list[int] = []
        self._sparsifier = None
        self._loop_closer = None
        # the sparsified-keyframe database is SYSTEM state (ref: the KFDB
        # belongs to System, src/System.cc:118) — relocalization must work
        # with loop closing disabled (VERDICT r1 item 4)
        self.kf_db = None
        if cfg.sparsify or cfg.loop_closing:
            from ..models.vocab import KeyFrameDatabase
            self.kf_db = KeyFrameDatabase(max_kf=cfg.map.max_kf)
        if cfg.sparsify:
            from .sparsification import Sparsifier
            self._sparsifier = Sparsifier(self)
        if cfg.loop_closing:
            from .loop_closing import LoopCloser
            self._loop_closer = LoopCloser(self)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    _prefetched_frame = None

    def track_stereo(self, img_l, img_r, timestamp: float,
                     next_images=None) -> np.ndarray:
        """Process one rectified stereo pair; returns estimated Tcw (4,4)
        (ref System::TrackStereo, src/System.cc:192).

        next_images: optional (img_l, img_r) of the NEXT frame — its
        host-side staging + upload + frontend dispatch run on a
        background thread while this frame completes (the reference gets
        the same overlap from its thread pipeline)."""
        self.frame_id += 1
        t0 = time.perf_counter()
        if self.cfg.frame_draw_every:
            self._draw_images[self.frame_id] = np.asarray(img_l)
        if self._prefetched_frame is not None:
            fut = self._prefetched_frame
            self._prefetched_frame = None
            if hasattr(fut, "result"):
                try:
                    frame = fut.result()
                except Exception as e:
                    # annotate which frame's background prefetch failed —
                    # the exception surfaces one frame after the dispatch
                    raise RuntimeError(
                        f"background frontend prefetch for frame "
                        f"{self.frame_id} failed") from e
            else:
                frame = fut
        else:
            frame = self._dispatch_frontend(img_l, img_r)
        self._tic(t0, "frontend")
        self._next_images = next_images
        out = self._advance(frame, timestamp)
        self._next_images = None
        return out

    @staticmethod
    def _as_uint8(img):
        a = np.asarray(img)
        if a.dtype == np.uint8:
            return a            # no per-frame clip/astype copies (2-CPU host)
        return np.clip(a, 0, 255).astype(np.uint8)

    def _dispatch_frontend(self, img_l, img_r):
        from .frontend import process_stereo_fisheye, process_stereo_stacked
        stacked = np.stack([self._as_uint8(img_l), self._as_uint8(img_r)])
        if self.calib.is_fisheye_stereo:
            # unrectified KB8 pair (ref Frame fisheye ctor): lapping-area
            # matching + two-view triangulation instead of row-aligned
            # rectified stereo
            return process_stereo_fisheye(jnp.asarray(stacked),
                                          self.calib, self.orb)
        return process_stereo_stacked(jnp.asarray(stacked),
                                      self.calib, self.orb)

    _next_images = None
    _prefetch_pool = None

    def _prefetch_next(self):
        """Called between the track dispatch and its fetch. The staging +
        device_put of ~1MB of image runs on a single worker thread so it
        overlaps the in-flight step — jit dispatch is thread-safe and the
        frontend has no data dependence on the in-flight track step."""
        if self._next_images is not None and self._prefetched_frame is None:
            if os.environ.get("MSSLAM_SYNC_PREFETCH"):
                self._prefetched_frame = self._dispatch_frontend(
                    *self._next_images)
                return
            if self._prefetch_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="msslam-prefetch")
            self._prefetched_frame = self._prefetch_pool.submit(
                self._dispatch_frontend, *self._next_images)

    def track_stereo_imu(self, img_l, img_r, timestamp: float,
                         imu_rows) -> np.ndarray:
        """Stereo-inertial step (ref System::TrackStereo with vImuMeas,
        src/System.cc:259-261): imu_rows (M,7) = [dt, ax, ay, az, gx, gy,
        gz] measurements since the previous frame."""
        imu_rows = np.asarray(imu_rows, np.float32).reshape(-1, 7)
        self._imu_frame_rows = imu_rows
        # rows tagged with the frame they precede: keyframe creation is
        # deferred one frame by the pipeline, so the per-keyframe segment
        # split must not swallow the next frame's measurements
        self._imu_accum.append((self.frame_id + 1, imu_rows))
        self._last_ts = timestamp
        return self.track_stereo(img_l, img_r, timestamp)

    def track_monocular_imu(self, img, timestamp: float,
                            imu_rows) -> np.ndarray:
        """Mono-inertial step (ref System::TrackMonocular with vImuMeas,
        src/System.cc:344): the IMU makes the monocular map METRIC — the
        initialization estimates a scale (ref InertialOptimization's
        VertexScale, src/Optimizer.cc:3050) and ScaleRefinement re-fits it
        every ~10s until 75s (ref LocalMapping.cc:231-241)."""
        imu_rows = np.asarray(imu_rows, np.float32).reshape(-1, 7)
        self._imu_frame_rows = imu_rows
        self._imu_accum.append((self.frame_id + 1, imu_rows))
        self._last_ts = timestamp
        return self.track_monocular(img, timestamp)

    def track_rgbd(self, img, depth, timestamp: float) -> np.ndarray:
        """Process one registered RGB-D frame (ref System::TrackRGBD,
        src/System.cc:273); depth in meters."""
        from .frontend import process_rgbd
        self.frame_id += 1
        t0 = time.perf_counter()
        img = self._as_uint8(img)
        frame = process_rgbd(jnp.asarray(img),
                             jnp.asarray(depth, jnp.float32),
                             self.calib, self.orb)
        self._tic(t0, "frontend")
        return self._advance(frame, timestamp)

    def track_monocular(self, img, timestamp: float) -> np.ndarray:
        """Process one monocular frame (ref System::TrackMonocular,
        src/System.cc:344). Map scale is arbitrary (normalized to median
        scene depth 1 at initialization)."""
        from .frontend import process_mono
        self.frame_id += 1
        t0 = time.perf_counter()
        img = self._as_uint8(img)
        frame = process_mono(jnp.asarray(img), self.calib, self.orb)
        self._tic(t0, "frontend")
        return self._advance(frame, timestamp,
                             init_fn=self._monocular_initialization)

    def _advance(self, frame: FrameData, timestamp: float,
                 init_fn=None) -> np.ndarray:
        """Per-frame state machine. In the OK state the tracking step is
        dispatched immediately (all its inputs are device handles) and the
        PREVIOUS frame's results are fetched afterwards — by then its stats
        have been streaming back while this frame computed, so the fetch is
        nearly free. Loss states run synchronously (they are rare and need
        host decisions per frame)."""
        t0 = time.perf_counter()
        if self.state == NOT_INITIALIZED:
            self._flush_pipeline()
            (init_fn or self._stereo_initialization)(frame, timestamp)
            self._imu_frame_rows = None
            self._tic(t0, "track")
            return self.current_pose()
        if self.state in (RECENTLY_LOST, LOST):
            self._flush_pipeline()
            self._track_lost(frame, timestamp)
            self._tic(t0, "track")
            return self.current_pose()
        self._dispatch_track(frame, timestamp)
        self._tic(t0, "track_dispatch")
        t1 = time.perf_counter()
        self._prefetch_next()           # next frontend rides the same gap
        self._tic(t1, "prefetch_dispatch")
        t2 = time.perf_counter()
        while len(self._inflight) > self._pipeline_depth - 1:
            # completing several frames per fetch amortizes the fixed
            # cost of a blocking device_get over n frames
            n = min(self._fetch_batch, len(self._inflight))
            if n > 1:
                self._complete_batch(n)
            else:
                self._complete_one()
        self._tic(t2, "complete")
        self._tic(t0, "track")
        return self._predicted_pose()

    # ------------------------------------------------------------------
    # monocular initialization (ref Tracking::MonocularInitialization
    # :2435 + CreateInitialMapMonocular :2511)
    # ------------------------------------------------------------------

    _mono_init_frame = None
    _mono_init_ts = None

    def _monocular_initialization(self, frame: FrameData, timestamp: float):
        from ..ops import matching as mops
        from ..ops import twoview
        import jax

        n_valid = int(jnp.sum(frame.feats.valid))
        if self._mono_init_frame is None:
            if n_valid > 100:
                self._mono_init_frame = frame
                self._mono_init_ts = timestamp
                self._mono_init_fid = self.frame_id
            self._record(timestamp, lost=True)
            return
        f0 = self._mono_init_frame
        mm = mops.mutual_match(f0.feats.desc, f0.feats.valid,
                               frame.feats.desc, frame.feats.valid,
                               max_dist=matching_TH_LOW(), nn_ratio=0.9)
        if int(mm.n_matches) < 100:
            self._mono_init_frame = frame if n_valid > 100 else None
            self._mono_init_ts = timestamp
            self._mono_init_fid = self.frame_id
            self._record(timestamp, lost=True)
            return
        has = mm.idx_b >= 0
        xy2 = frame.feats.xy[jnp.clip(mm.idx_b, 0)]
        res = twoview.reconstruct(
            self.calib.model, self.calib.params_array(),
            f0.feats.xy, xy2, has, jax.random.PRNGKey(3))
        if not bool(res.ok):
            self._record(timestamp, lost=True)
            return

        # normalize scale: median depth -> 1 (ref CreateInitialMapMonocular
        # invMedianDepth scaling)
        inl = np.asarray(res.inlier)
        X = np.array(res.X1)
        med = np.median(X[inl, 2]) if inl.any() else 1.0
        X /= med
        t1 = np.asarray(res.t) / med

        n_feat = self.cfg.map.n_feat
        # draw fresh point slots from the pool free-list (an Atlas reset may
        # leave the old map's points live in lower slots)
        free = np.where(~np.asarray(self.ms.mp_valid))[0]
        inl_pos = np.where(inl)[0][:len(free)]
        inl = np.zeros_like(inl)
        inl[inl_pos] = True
        n_new = int(inl.sum())
        slots = np.full(n_feat, -1, np.int32)
        slots[inl_pos] = free[:n_new]
        obs0 = slots
        obs1 = np.full(n_feat, -1, np.int32)
        ib = np.asarray(mm.idx_b)
        obs1[ib[inl_pos]] = slots[inl_pos]

        kf0 = self._alloc_kf_slot()
        kf1 = self._alloc_kf_slot()
        if kf0 is None or kf1 is None:
            self._record(timestamp, lost=True)
            return
        eye = jnp.eye(3, dtype=jnp.float32)
        zero = jnp.zeros(3, jnp.float32)
        for slot, fr, R_, t_, obs in (
                (kf0, f0, eye, zero, obs0),
                (kf1, frame, jnp.asarray(res.R, jnp.float32),
                 jnp.asarray(t1, jnp.float32), obs1)):
            self.ms = M.insert_keyframe(
                self.ms, jnp.asarray(slot), R_, t_, fr.feats.xy,
                fr.feats.octave, fr.feats.desc, fr.u_right, fr.depth,
                fr.feats.valid, jnp.asarray(obs),
                jnp.asarray(getattr(self, "_mono_init_fid",
                                    self.frame_id - 1)
                            if slot == kf0 else self.frame_id),
                kf_ord=jnp.asarray(
                    self.kf_ord + (0 if slot == kf0 else 1)),
                angle=fr.feats.angle)
        # map points: descriptors from frame0's features, normals toward cam0
        sel = np.where(inl)[0]
        pos = X[sel]
        dist = np.linalg.norm(pos, axis=1)
        normal = pos / np.maximum(dist, 1e-9)[:, None]
        oct0 = np.asarray(f0.feats.octave)[sel]
        maxd = dist * (self.orb.scale_factor ** oct0)
        mind = maxd / (self.orb.scale_factor ** (self.orb.n_levels - 1))
        self.ms = M.add_map_points(
            self.ms, jnp.asarray(slots[sel]), jnp.ones(n_new, bool),
            jnp.asarray(pos, jnp.float32), f0.feats.desc[jnp.asarray(sel)],
            jnp.asarray(normal, jnp.float32), jnp.asarray(mind, jnp.float32),
            jnp.asarray(maxd, jnp.float32),
            jnp.full(n_new, kf0, jnp.int32),
            # creation ordinal = the SECOND init keyframe's, so the age-based
            # young-point cull (2<=age<=3 & n_obs<=2) does not fire during
            # the init map's own local-mapping pass
            jnp.full(n_new, self.kf_ord + 1, jnp.int32),
            angle=f0.feats.angle[jnp.asarray(sel)])
        self.kf_ord += 2
        self.kf_order += [kf0, kf1]
        if self.kf_db is not None:
            self.kf_db.set_row(kf0, f0.feats.desc, f0.feats.valid)
            self.kf_db.set_row(kf1, frame.feats.desc, frame.feats.valid)
        if self.cfg.use_imu:
            # keep the per-KF IMU bookkeeping aligned. The kf0->kf1
            # interval's real IMU rows are recovered from the accumulator
            # (rows tagged (fid0, fid1] span exactly the init baseline);
            # rows from before f0 are dropped, rows after kf1 stay queued
            # for the next keyframe's segment — without this split the
            # first post-init segment held ALL rows since frame 0 while
            # its pose interval spanned one keyframe gap, corrupting the
            # preintegration chain that feeds inertial_init (ref
            # Tracking::PreintegrateIMU keeps per-frame alignment,
            # src/Tracking.cc:1613).
            fid0 = getattr(self, "_mono_init_fid", self.frame_id - 1)
            seg01 = [r for f, r in self._imu_accum
                     if fid0 < f <= self.frame_id]
            self._imu_accum = [(f, r) for f, r in self._imu_accum
                               if f > self.frame_id]
            self._kf_times += [self._mono_init_ts
                               if self._mono_init_ts is not None
                               else timestamp - 1.0 / max(self.calib.fps,
                                                          1.0),
                               timestamp]
            self._kf_imu_segments += [np.zeros((0, 7), np.float32),
                                      np.concatenate(seg01) if seg01
                                      else np.zeros((0, 7), np.float32)]
        self.n_mp += n_new
        self.ref_kf = kf1
        self.last_kf_frame = self.frame_id
        self.last_R = np.asarray(res.R, dtype=np.float32)
        self.last_t = np.asarray(t1, dtype=np.float32)
        self.last_matched = self.ms.obs_mp[kf1]
        self.n_inliers_ref = n_new
        self.state = OK
        self._obs_dirty = True
        self._mono_init_frame = None
        self._Rt_dev = None
        self._Rt_dev2 = None
        self._has_vel = False
        self.vel = None
        self._lost_ts = None
        self._local_mapping(kf1)
        self._refresh_ref_pose()
        self.last_R, self.last_t = self._ref_pose_np
        self._record(timestamp, lost=False)

    def current_pose(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = np.asarray(self.last_R)
        T[:3, 3] = np.asarray(self.last_t)
        return T

    def map_points_in_map(self) -> int:
        return int(jnp.sum(self.ms.mp_valid))

    def compressed_map_points_in_map(self) -> int:
        return int(jnp.sum(self.ms.mp_valid & self.ms.mp_sparsified))

    def keyframes_in_map(self) -> int:
        return int(jnp.sum(self.ms.kf_valid))

    def memory_stats(self) -> dict:
        """Live map memory accounting — the MS-SLAM headline metric
        (ref README.md:29 '>70% memory reduction'; measured there via RSS,
        here exactly: bytes of live keyframe features + live map points
        versus what the same map would hold without sparsification).

        Per live feature: xy(8) + octave(4) + desc(32) + uRight(4) +
        depth(4) + obs(4) = 56 B. Per live point: pos(12) + desc(32) +
        normal(12) + dists(8) + stats(16) = 80 B (mirrors the reference's
        KeyFrame/MapPoint payloads)."""
        self._flush_pipeline()
        ms = self.ms
        kf_valid = np.asarray(ms.kf_valid)
        kp_live = int(np.asarray(
            jnp.sum(ms.kp_valid & kf_valid[:, None])))
        mp_live = self.map_points_in_map()
        killed = self._sparsifier.stats["killed"] if self._sparsifier else 0
        slots_freed = (self._sparsifier.stats.get("slots_freed", 0)
                       if self._sparsifier else 0)
        feat_b, mp_b = 56, 80
        # what the selector removed — MEASURED: the deleted points plus the
        # exact number of feature slots the window compaction freed
        # (counted by sparsify_window, not modeled)
        live = kp_live * feat_b + mp_live * mp_b
        without = live + killed * mp_b + slots_freed * feat_b
        return {
            "live_bytes": live,
            "without_sparsification_bytes": without,
            "reduction": 1.0 - live / max(without, 1),
            "kp_live": kp_live,
            "mp_live": mp_live,
            "mp_selector_killed": killed,
            "mp_compressed": self.compressed_map_points_in_map(),
        }

    def print_time_stats(self, file=None):
        """Per-stage timing summary (ref the REGISTER_TIMES instrumentation,
        include/Tracking.h:187-201 + Tracking::PrintTimeStats,
        src/Tracking.cc:263 — there compile-gated, here always available)."""
        import sys as _sys
        file = file or _sys.stderr
        print("stage              n      mean      median     p95    total",
              file=file)
        for k, v in sorted(self.timing.items()):
            a = np.asarray(v)
            if not len(a):
                continue
            print(f"{k:<16} {len(a):>4} {a.mean()*1e3:8.2f}ms "
                  f"{np.median(a)*1e3:8.2f}ms {np.percentile(a, 95)*1e3:7.1f}"
                  f"ms {a.sum():7.2f}s", file=file)

    # -- localization-only mode (ref System::ActivateLocalizationMode /
    # DeactivateLocalizationMode, src/System.cc:219-257: tracking continues
    # against the frozen map; local mapping is paused) -------------------

    def activate_localization_mode(self):
        self.cfg.localization_only = True

    def deactivate_localization_mode(self):
        self.cfg.localization_only = False

    def shutdown(self):
        """Flush the pipeline and pending sparsification work (ref
        ShutdownMapCompressing, src/System.cc:460: sparsify all remaining
        keyframes on shutdown)."""
        self._flush_pipeline()
        if self._sparsifier is not None:
            self._sparsifier.finish()
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=False, cancel_futures=True)
            self._prefetch_pool = None
            self._prefetched_frame = None

    # ------------------------------------------------------------------
    # trajectory export (ref System::SaveTrajectoryKITTI :890 / TUM :516)
    # ------------------------------------------------------------------

    def _frame_pose(self, e: TrajectoryEntry) -> np.ndarray:
        if e.ref_kf < 0:       # absolute entry (reference slot was recycled)
            return e.T_cr
        R_ref = np.asarray(self.ms.kf_R[e.ref_kf])
        t_ref = np.asarray(self.ms.kf_t[e.ref_kf])
        T_rw = np.eye(4)
        T_rw[:3, :3] = R_ref
        T_rw[:3, 3] = t_ref
        return e.T_cr @ T_rw

    def poses_wc(self):
        """List of (timestamp, Twc 4x4) for all tracked frames."""
        self._flush_pipeline()
        out = []
        for e in self.trajectory:
            if e.lost:
                continue
            T_cw = self._frame_pose(e)
            out.append((e.timestamp, np.linalg.inv(T_cw)))
        return out

    def save_trajectory_kitti(self, path: str):
        with open(path, "w") as f:
            for _, Twc in self.poses_wc():
                row = Twc[:3].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in row) + "\n")

    def _keyframe_traj_rows(self):
        """(ts, twc(3,), q_wxyz(4,)) per valid keyframe."""
        from ..ops.lie import rot_to_quat
        self._flush_pipeline()
        kf_valid = np.asarray(self.ms.kf_valid)
        R = np.asarray(self.ms.kf_R)
        t = np.asarray(self.ms.kf_t)
        frame_ids = np.asarray(self.ms.kf_frame_id)
        ts_by_frame = {e.frame_id: e.timestamp for e in self.trajectory}
        rows = []
        for k in np.where(kf_valid)[0]:
            Rwc = R[k].T
            twc = -Rwc @ t[k]
            q = np.asarray(rot_to_quat(jnp.asarray(Rwc)))
            rows.append((ts_by_frame.get(int(frame_ids[k]), 0.0), twc, q))
        return rows

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only trajectory (ref System::SaveKeyFrameTrajectoryTUM/
        EuRoC, src/System.cc:762-)."""
        with open(path, "w") as f:
            for ts, twc, q in self._keyframe_traj_rows():
                f.write(f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_euroc(self, path: str):
        """EuRoC-format trajectory: TUM layout with nanosecond timestamps
        (ref System::SaveTrajectoryEuRoC, src/System.cc:615: ts*1e9)."""
        from ..ops.lie import rot_to_quat
        with open(path, "w") as f:
            for ts, Twc in self.poses_wc():
                q = np.asarray(rot_to_quat(jnp.asarray(Twc[:3, :3])))
                t = Twc[:3, 3]
                f.write(f"{ts * 1e9:.0f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                        f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")

    def save_keyframe_trajectory_euroc(self, path: str):
        """Keyframe-only EuRoC trajectory (ref SaveKeyFrameTrajectoryEuRoC,
        src/System.cc:829)."""
        with open(path, "w") as f:
            for ts, twc, q in self._keyframe_traj_rows():
                f.write(f"{ts * 1e9:.0f} "
                        f"{twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_trajectory_tum(self, path: str):
        from ..ops.lie import rot_to_quat
        with open(path, "w") as f:
            for ts, Twc in self.poses_wc():
                q = np.asarray(rot_to_quat(jnp.asarray(Twc[:3, :3])))
                t = Twc[:3, 3]
                # TUM: tx ty tz qx qy qz qw
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _tic(self, t0, key):
        self.timing.setdefault(key, []).append(time.perf_counter() - t0)

    def _stereo_initialization(self, frame: FrameData, timestamp: float):
        """Ref Tracking::StereoInitialization (src/Tracking.cc:2321): need
        enough stereo-depth features, create the origin keyframe, unproject
        every depth point."""
        n_depth = int(jnp.sum((frame.depth > 0) & frame.feats.valid))
        if n_depth < self.cfg.min_init_depth_points:
            return
        R = jnp.eye(3, dtype=jnp.float32)
        t = jnp.zeros(3, dtype=jnp.float32)
        no_match = jnp.full((self.cfg.map.n_feat,), -1, jnp.int32)
        kf_slot = self._alloc_kf_slot()
        if kf_slot is None:
            return
        self.ms, n_new = mo.create_keyframe(
            self.ms, self.calib, jnp.asarray(kf_slot), frame, R, t,
            no_match, jnp.asarray(self.kf_ord), jnp.asarray(self.frame_id),
            jnp.asarray(1e9))
        self.kf_ord += 1
        self.kf_order.append(kf_slot)
        self.n_mp += int(n_new)
        self.ref_kf = kf_slot
        self.last_kf_frame = self.frame_id
        if self.kf_db is not None:
            self.kf_db.set_row(kf_slot, frame.feats.desc, frame.feats.valid)
        self.last_R = np.eye(3, dtype=np.float32)
        self.last_t = np.zeros(3, dtype=np.float32)
        self._ref_pose_np = (self.last_R, self.last_t)
        self.last_matched = self.ms.obs_mp[kf_slot]
        self.n_inliers_ref = n_depth
        self.state = OK
        self._obs_dirty = True
        self._Rt_dev = None
        self._Rt_dev2 = None
        self._has_vel = False
        self.vel = None
        self._lost_ts = None
        if self.cfg.use_imu:
            self._imu_accum = []
            self._kf_times.append(timestamp)
            # invariant: _kf_imu_segments[j] = IMU rows between kf_order
            # [j-1] and [j]; the first keyframe has no predecessor
            self._kf_imu_segments.append(np.zeros((0, 7), np.float32))
        self._record(timestamp, lost=False)

    # ------------------------------------------------------------------
    # pipelined tracking: dispatch / complete
    # ------------------------------------------------------------------

    IMU_ROW_CAP = 64

    def _dispatch_track(self, frame: FrameData, timestamp: float):
        """Enqueue the whole tracking step for this frame on device. Every
        input is either a host constant or a device handle from the previous
        step — no fetch needed, so the device pipeline never drains."""
        cfg = self.cfg
        last_matched = self.last_matched
        if last_matched is None:
            last_matched = jnp.full((cfg.map.n_feat,), -1, jnp.int32)
        if (self._obs_dirty or self._n_obs_dev is None
                or os.environ.get("MSSLAM_OBS_EVERY_FRAME")):
            self._n_obs_dev = _mp_obs_count_jit(self.ms)
            self._obs_mask_dev = _observer_mask_jit(self.ms)
            self._obs_dirty = False
        if self._Rt_dev is None:
            self._Rt_dev = (jnp.asarray(self.last_R, jnp.float32),
                            jnp.asarray(self.last_t, jnp.float32))
        R_last, t_last = self._Rt_dev

        rows = self._imu_frame_rows
        imu_used = (self.imu_initialized and rows is not None and len(rows))
        if imu_used:
            rows_p, valid = self._pad_imu_rows(rows)
            if self._v_dev is None:
                self._v_dev = jnp.asarray(self.vel_w, jnp.float32)
            if self._bias_dev is None:
                self._bias_dev = jnp.asarray(self.imu_bias, jnp.float32)
            noise = jnp.asarray([cfg.imu_noise_gyro, cfg.imu_noise_acc,
                                 cfg.imu_gyro_walk, cfg.imu_acc_walk],
                                jnp.float32)
            out = to.track_full_imu(
                self.ms, self.calib, self.orb, frame, R_last, t_last,
                self._v_dev, self._bias_dev,
                jnp.asarray(rows_p), jnp.asarray(valid),
                jnp.asarray(self.gravity, jnp.float32), noise,
                jnp.asarray(self.Tbc[:3, :3], jnp.float32),
                jnp.asarray(self.Tbc[:3, 3], jnp.float32),
                last_matched, self._dev_scalar("ref_kf", self.ref_kf),
                cfg.map.local_mp_cap, self._n_obs_dev,
                self._obs_mask_dev)
            self._v_dev, self._bias_dev = out.v, out.bias
        else:
            R_l2, t_l2 = (self._Rt_dev2 if self._Rt_dev2 is not None
                          else (R_last, t_last))
            out = to.track_full(
                self.ms, self.calib, self.orb, frame, R_last, t_last,
                R_l2, t_l2, self._dev_scalar("has_vel", self._has_vel),
                last_matched, self._dev_scalar("ref_kf", self.ref_kf),
                cfg.map.local_mp_cap, self._n_obs_dev,
                self._obs_mask_dev)
        self.ms = out.ms                # input ms was donated
        try:
            out.stats.copy_to_host_async()
        except Exception:
            pass
        self._inflight.append(InFlight(
            frame_id=self.frame_id, timestamp=timestamp, frame=frame,
            out=out, imu_used=bool(imu_used)))
        self._Rt_dev2 = (R_last, t_last)
        self._Rt_dev = (out.R, out.t)
        self._has_vel = True
        self.last_matched = out.matched_mp
        self._imu_frame_rows = None

    @classmethod
    def _pad_imu_rows(cls, rows: np.ndarray):
        """Pad (or pairwise-merge overlong) IMU batches to a fixed shape so
        the inertial track kernel compiles once."""
        cap = cls.IMU_ROW_CAP
        while len(rows) > cap:
            # merge adjacent pairs: dt adds, measurements dt-average
            n = len(rows) // 2 * 2
            a, b = rows[:n:2], rows[1:n:2]
            dt = a[:, :1] + b[:, :1]
            m = (a[:, 1:] * a[:, :1] + b[:, 1:] * b[:, :1]) / np.maximum(
                dt, 1e-9)
            merged = np.concatenate([dt, m], axis=1)
            rows = (np.concatenate([merged, rows[n:]])
                    if n < len(rows) else merged)
        out = np.zeros((cap, 7), np.float32)
        out[:len(rows)] = rows
        valid = np.zeros(cap, bool)
        valid[:len(rows)] = True
        return out, valid

    def _complete_batch(self, n: int):
        """Complete n in-flight frames with ONE blocking device_get (a
        fetch's fixed cost is divided by n)."""
        fls = [self._inflight.popleft() for _ in range(n)]
        tf = time.perf_counter()
        handles = [fl.out.stats for fl in fls]
        pend = self._pending_kf_info
        if pend is not None:
            handles.append(pend[1])
        fetched = jax.device_get(tuple(handles))
        if pend is not None:
            self._pending_kf_info = None
            self._integrate_kf_info(pend[0], np.asarray(fetched[-1]))
            fetched = fetched[:n]
        self._tic(tf, "stats_fetch")
        for i, (fl, pk) in enumerate(zip(fls, fetched)):
            gen = self._state_gen
            if self.state == OK:
                self._complete_one(fl=fl, packed=np.asarray(pk))
            else:
                # an earlier frame of this batch lost tracking: the rest
                # go through the loss path (same as _on_track_failure does
                # for still-in-flight frames)
                self._track_lost(fl.frame, fl.timestamp,
                                 frame_id=fl.frame_id)
            if self._state_gen != gen and i + 1 < len(fls):
                # a state-invalidating event fired while completing this
                # frame (map rescale, relocalization, loop correction):
                # the remaining popped frames' fetched stats are stale —
                # re-dispatch them (merged in order with anything
                # _redispatch_inflight already re-queued) instead of
                # integrating pre-event poses into the trajectory
                rest = fls[i + 1:] + list(self._inflight)
                rest.sort(key=lambda s: s.frame_id)
                self._inflight.clear()
                saved_fid = self.frame_id
                for s in rest:
                    self.frame_id = s.frame_id
                    self._imu_frame_rows = None
                    self._dispatch_track(s.frame, s.timestamp)
                self.frame_id = saved_fid
                break

    def _complete_one(self, fl: Optional[InFlight] = None,
                      packed: Optional[np.ndarray] = None):
        """Fetch + integrate the oldest in-flight frame: state machine,
        pose bookkeeping, keyframe decision (the host half of
        Tracking::Track)."""
        if fl is None:
            fl = self._inflight.popleft()
        cfg = self.cfg
        if packed is None:
            tf = time.perf_counter()
            if self._pending_kf_info is not None:
                # previous keyframe's deferred info rides the round trip
                packed, info = jax.device_get(
                    (fl.out.stats, self._pending_kf_info[1]))
                self._integrate_kf_info(self._pending_kf_info[0],
                                        np.asarray(info))
                self._pending_kf_info = None
                packed = np.asarray(packed)
            else:
                packed = np.asarray(fl.out.stats)  # one per-frame fetch
            self._tic(tf, "stats_fetch")
        R_np = packed[:9].reshape(3, 3).astype(np.float32)
        t_np = packed[9:12].astype(np.float32)
        (n_pre, _used_wide, _used_fb, n_inliers,
         n_close, n_close_untracked, best_kf, _n_cand, n_ref) = (
            int(v) for v in packed[12:21])

        if n_pre < 10 or n_inliers < 15:
            self._on_track_failure(fl)
            return

        self.state = OK
        self._lost_frames = 0
        self._lost_ts = None
        # reference matches for the keyframe decision, evaluated per frame
        # like the reference (src/Tracking.cc:3071-3075)
        if n_ref > 0:
            self.n_inliers_ref = n_ref
        # pose + velocity update (host-side numpy, no device fetches)
        T_last = self.current_pose()
        T_now = np.eye(4)
        T_now[:3, :3] = R_np
        T_now[:3, 3] = t_np
        self.vel = T_now @ np.linalg.inv(T_last)
        self.last_R = R_np
        self.last_t = t_np
        if fl.imu_used:
            self.vel_w = packed[33:36].astype(np.float32)
            self.imu_bias = packed[36:42].astype(np.float32)
        elif self.cfg.use_imu:
            dt = (fl.timestamp - self._prev_completed_ts
                  if self._prev_completed_ts is not None else 0.0)
            if dt > 0:
                c_now = -R_np.T @ t_np
                c_last = -T_last[:3, :3].T @ T_last[:3, 3]
                self.vel_w = ((c_now - c_last) / dt).astype(np.float32)
        if int(best_kf) != self.ref_kf:
            self.ref_kf = int(best_kf)
            # ref pose rides along in the stats pack — no extra fetch
            self._ref_pose_np = (
                packed[21:30].reshape(3, 3).astype(np.float32),
                packed[30:33].astype(np.float32))

        # --- keyframe decision (ref NeedNewKeyFrame, src/Tracking.cc:3040) ---
        need_close = (n_close < 100) and (n_close_untracked > 70)
        c1a = fl.frame_id >= self.last_kf_frame + cfg.max_frames_between_kf
        c1b = fl.frame_id >= self.last_kf_frame + cfg.min_frames_between_kf
        c2 = (n_inliers < self.n_inliers_ref * cfg.ref_ratio) or need_close
        # inertial temporal rule: a keyframe at least every 0.25s before IMU
        # init / 0.5s after (ref src/Tracking.cc:3131-3138; the staged
        # initialization needs a dense early keyframe chain)
        c_imu = False
        if cfg.use_imu and self._kf_times:
            dt_kf = fl.timestamp - self._kf_times[-1]
            c_imu = dt_kf >= (0.25 if not self.imu_initialized else 0.5)
        if ((c1a or (c1b and c2) or c_imu) and n_inliers > 15
                and not cfg.localization_only):
            self._create_keyframe(fl.frame, fl.out, R_np, t_np, fl=fl)
        self._maybe_draw_frame(fl)
        self._record(fl.timestamp, lost=False, frame_id=fl.frame_id)
        self._prev_completed_ts = fl.timestamp

    def _maybe_draw_frame(self, fl: "InFlight"):
        """FrameDrawer analog (ref src/FrameDrawer.cc::Update+DrawFrame):
        every cfg.frame_draw_every completed frames, dump the keypoint/
        track-state overlay PNG. Off the hot path — only fetches feature
        arrays on drawn frames."""
        every = self.cfg.frame_draw_every
        if not every:
            return
        img = self._draw_images.pop(fl.frame_id, None)
        if img is None or fl.frame_id % every:
            return
        import os
        from ..utils import viewer
        os.makedirs(self.cfg.frame_draw_dir, exist_ok=True)
        xy, valid, matched = jax.device_get(
            (fl.frame.feats.xy, fl.frame.feats.valid, fl.out.matched_mp))
        viewer.draw_frame(
            img, np.asarray(xy), np.asarray(valid),
            np.asarray(matched) >= 0,
            os.path.join(self.cfg.frame_draw_dir,
                         f"frame_{fl.frame_id:06d}.png"),
            state=str(self.state))

    def _on_track_failure(self, fl: InFlight):
        """Tracking failed for frame fl: relocalize now, or enter the
        RECENTLY_LOST grace window (ref src/Tracking.cc:1947-2018)."""
        self._draw_images.pop(fl.frame_id, None)
        self.vel = None
        self._has_vel = False
        rl = self._relocalize(fl.frame)
        if rl is not None:
            self._lost_frames = 0
            self._lost_ts = None
            self.state = OK
            self.last_R = np.asarray(rl.R, dtype=np.float32)
            self.last_t = np.asarray(rl.t, dtype=np.float32)
            self._Rt_dev = (rl.R, rl.t)
            self._Rt_dev2 = None
            self.last_matched = rl.matched_mp
            self._refresh_ref_pose()
            self._record(fl.timestamp, lost=False, frame_id=fl.frame_id)
            self._prev_completed_ts = fl.timestamp
            self._redispatch_inflight()
            return
        if self.n_kf > 10:
            # grace window: keep extrapolating + retrying reloc
            self.state = RECENTLY_LOST
            if self._lost_ts is None:
                self._lost_ts = fl.timestamp
        else:
            self.state = LOST
            self._lost_frames += 1
        self._record(fl.timestamp, lost=True, frame_id=fl.frame_id)
        self._extrapolate_pose()
        # newer in-flight frames were tracked from a bad pose: reprocess
        # them through the loss path
        stale = list(self._inflight)
        self._inflight.clear()
        for s in stale:
            self._track_lost(s.frame, s.timestamp, frame_id=s.frame_id)

    def _track_lost(self, frame: FrameData, timestamp: float,
                    frame_id: Optional[int] = None):
        """Synchronous per-frame handling in RECENTLY_LOST / LOST states
        (ref Tracking.cc:1991-2018: predict state, retry relocalization,
        give up into a fresh Atlas map when irrecoverable)."""
        fid = self.frame_id if frame_id is None else frame_id
        self._draw_images.pop(fid, None)
        rl = self._relocalize(frame)
        if rl is not None:
            self.state = OK
            self._lost_frames = 0
            self._lost_ts = None
            self.vel = None
            self._has_vel = False
            self.last_R = np.asarray(rl.R, dtype=np.float32)
            self.last_t = np.asarray(rl.t, dtype=np.float32)
            self._Rt_dev = (rl.R, rl.t)
            self._Rt_dev2 = None
            self.last_matched = rl.matched_mp
            self._refresh_ref_pose()
            self._record(timestamp, lost=False, frame_id=fid)
            self._prev_completed_ts = timestamp
            self._imu_frame_rows = None
            return
        if self.state == RECENTLY_LOST:
            self._extrapolate_pose()
            if (self._lost_ts is not None
                    and timestamp - self._lost_ts > self.cfg.t_recently_lost):
                self.state = LOST
        if self.state == LOST:
            self._lost_frames += 1
            # irrecoverable: start a fresh map in the atlas (ref
            # Tracking::CreateMapInAtlas) once enough frames failed
            if (self._lost_frames > int(2 * self.calib.fps)
                    and self.n_kf >= 5
                    and (self.cfg.map.max_kf - self.n_kf
                         + len(self.kf_free)) >= 8):
                self.active_map += 1
                self.state = NOT_INITIALIZED
                self.last_matched = None
                self._Rt_dev = None
                self._lost_frames = 0
                self._lost_ts = None
        self._record(timestamp, lost=True, frame_id=fid)
        self._imu_frame_rows = None

    def _extrapolate_pose(self):
        """Carry the pose forward through a blackout: IMU propagation when
        initialized (ref PredictStateIMU in RECENTLY_LOST), else constant
        velocity, else hold."""
        rows = self._imu_frame_rows
        if (self.imu_initialized and rows is not None and len(rows)):
            T_pred, v_pred = self._predict_imu(self.current_pose())
            self.last_R = T_pred[:3, :3].astype(np.float32)
            self.last_t = T_pred[:3, 3].astype(np.float32)
            self.vel_w = np.asarray(v_pred, np.float32)
            self._v_dev = None
        elif self.vel is not None:
            T = self.vel @ self.current_pose()
            self.last_R = T[:3, :3].astype(np.float32)
            self.last_t = T[:3, 3].astype(np.float32)
        self._Rt_dev = None

    _state_gen = 0

    def _redispatch_inflight(self):
        """Re-run newer in-flight frames after an event that invalidated
        their inputs (relocalization, loop correction, map switch). Their
        device stat updates are benign; the track just reruns from the
        corrected pose. The generation bump lets _complete_batch detect
        the event for frames it had already popped."""
        self._state_gen += 1
        stale = list(self._inflight)
        self._inflight.clear()
        saved_fid = self.frame_id
        for s in stale:
            self.frame_id = s.frame_id
            self._imu_frame_rows = None      # conservative: visual redispatch
            self._dispatch_track(s.frame, s.timestamp)
        self.frame_id = saved_fid

    def _flush_pipeline(self):
        """Complete every in-flight frame (blocking)."""
        while self._inflight:
            self._complete_one()
        self._flush_pending_info()
        if self._loop_closer is not None:
            self._loop_closer.flush()

    _dev_scalar_cache: dict = None

    def _dev_scalar(self, key: str, value):
        """Device handle for a host scalar, re-uploaded only when the value
        changes, so per-frame flags like has_vel / ref_kf are not
        re-uploaded each frame (a small host->device transfer per frame;
        its cost on the H100 is unmeasured, ROADMAP C1)."""
        if self._dev_scalar_cache is None:
            self._dev_scalar_cache = {}
        hit = self._dev_scalar_cache.get(key)
        if hit is not None and hit[0] == value:
            return hit[1]
        dev = jnp.asarray(value)
        self._dev_scalar_cache[key] = (value, dev)
        return dev

    def _predicted_pose(self) -> np.ndarray:
        """Best host-side estimate for the newest dispatched frame (its
        fetched pose lands at the next call; recorded trajectory uses the
        true pose)."""
        T_last = self.current_pose()
        if self.vel is not None and self._has_vel:
            return self.vel @ T_last
        return T_last

    _pending_kf_info = None

    def _alloc_kf_slot(self) -> Optional[int]:
        """Keyframe slot allocator: recycled slots first (culled keyframes
        free their pool rows — the KeyFrame::SetBadFlag memory-release
        analog, ref src/KeyFrame.cc), else extend the high-water mark; at
        pool capacity, evict the oldest evictable keyframe (the reference
        heap-allocates without bound — a fixed pool needs graceful
        degradation to survive arbitrarily long sequences)."""
        if not self.kf_free and self.n_kf >= self.cfg.map.max_kf:
            self._evict_oldest_kf()
        if self.kf_free:
            slot = self.kf_free.pop()
            self._on_kf_slot_reuse(slot)
            self.kf_maps[slot] = self.active_map
            return slot
        if self.n_kf >= self.cfg.map.max_kf:
            return None
        slot = self.n_kf
        self.n_kf += 1
        self.kf_maps.append(self.active_map)
        return slot

    def _evict_oldest_kf(self):
        """Capacity-pressure eviction: drop the temporally oldest keyframe
        that is not in the recent window and not the tracking reference
        (trajectory entries re-anchor to its temporal parent first)."""
        keep = set(self.kf_order[-(self.cfg.map.window_kf + 2):])
        keep.add(self.ref_kf)
        for s in list(self.kf_order):
            if s in keep:
                continue
            self.ms = _delete_one_kf(self.ms, jnp.asarray(s))
            self._obs_dirty = True
            self._free_keyframes([s])
            if self.kf_db is not None:
                self.kf_db.erase(s)
            return

    def _on_kf_slot_reuse(self, slot: int):
        """Before overwriting a recycled keyframe slot: convert trajectory
        entries referenced to it into absolute poses (the reference instead
        walks the spanning tree through culled keyframes at save time,
        src/System.cc:559-568), and drop stale stage bookkeeping."""
        if any(e.ref_kf == slot for e in self.trajectory):
            packed = np.asarray(jnp.concatenate([
                self.ms.kf_R[slot].reshape(9), self.ms.kf_t[slot]]))
            T_rw = np.eye(4)
            T_rw[:3, :3] = packed[:9].reshape(3, 3)
            T_rw[:3, 3] = packed[9:12]
            for e in self.trajectory:
                if e.ref_kf == slot:
                    e.T_cr = e.T_cr @ T_rw
                    e.ref_kf = -1
        if self._sparsifier is not None:
            self._sparsifier.forget(slot)
        if self.kf_db is not None:
            self.kf_db.erase(slot)

    def _create_keyframe(self, frame: FrameData, out, R_np=None, t_np=None,
                         fl: Optional[InFlight] = None):
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            return
        frame_id = fl.frame_id if fl is not None else self.frame_id
        kf_ts = fl.timestamp if fl is not None else (self._last_ts or 0.0)
        t0 = time.perf_counter()
        # NOTE design deviation from the reference: LocalMapping.cc:150-155
        # runs EITHER LocalInertialBA OR LocalBundleAdjustment; here the
        # visual Schur window BA always runs (it is the stronger landmark
        # optimizer — joint Schur vs the VI pass's block-coordinate
        # descent) and the VI window BA refines poses/velocities/biases +
        # landmarks on top of it. Measured on the synthetic arc + orbit
        # worlds this composition dominates either solver alone.
        cullable, red_th = self._cull_policy()
        ko = mo.keyframe_step(
            self.ms, self.calib, self.orb, jnp.asarray(slot), frame,
            out.R, out.t, out.matched_mp, jnp.asarray(self.kf_ord),
            jnp.asarray(frame_id), jnp.asarray(self.calib.th_depth),
            n_tri=cfg.n_triangulate_neighbors, window_kf=cfg.map.window_kf,
            n_fixed=cfg.n_fixed_cams, pt_cap=cfg.map.local_mp_cap,
            ba_iters=cfg.ba_iters,
            cullable=cullable, red_th=red_th)
        self.ms = ko.ms
        # keyframe_step maintains the per-point observation-count table and
        # hands it back as a device array — tracking reuses it directly
        # instead of re-running the full-table sweep (obs-graph
        # mutations outside the keyframe path still set _obs_dirty)
        self._n_obs_dev = ko.n_obs
        self._obs_mask_dev = ko.obs_mask
        self._obs_dirty = False
        self.kf_ord += 1
        self.kf_order.append(slot)
        self.ref_kf = slot
        self.last_kf_frame = frame_id
        # the keyframe's observation row (matches + newly spawned stereo
        # points) becomes the motion-model candidate set for the next
        # dispatched frame (ref Tracking::UpdateLastFrame VO points)
        self.last_matched = self.ms.obs_mp[slot]
        if self.kf_db is not None:
            # BoW row at creation (ref LocalMapping::ProcessNewKeyFrame
            # ComputeBoW) — the loop query's covisible floor and the
            # tf-idf retrieval read stored rows, never re-encode
            self.kf_db.set_row(slot, frame.feats.desc, frame.feats.valid)
        if R_np is not None:
            # the keyframe's dispatch-time pose IS the tracked pose; the
            # BA-refined pose arrives with the deferred info next frame
            # (the reference likewise records frame poses relative to the
            # ref KF's pose at tracking time, src/Tracking.cc:2285-2306)
            self._ref_pose_np = (R_np, t_np)
            self._flush_pending_info()
            self._pending_kf_info = (slot, ko.info)
        else:
            # synchronous path (initialization)
            self._integrate_kf_info(slot, np.asarray(ko.info))
        self._tic(t0, "keyframe_step")
        if self.cfg.use_imu:
            # split accumulated IMU rows at this keyframe's frame id (rows
            # for newer, still-in-flight frames stay queued)
            take = [r for f, r in self._imu_accum if f <= frame_id]
            self._imu_accum = [(f, r) for f, r in self._imu_accum
                               if f > frame_id]
            rows = (np.concatenate(take) if take
                    else np.zeros((0, 7), np.float32))
            self._kf_imu_segments.append(rows)
            self._kf_times.append(kf_ts)
            self.kf_velocities[slot] = self.vel_w
            self._try_imu_init()
            # VI local BA on EVERY keyframe once the IMU is initialized
            # (ref LocalMapping.cc:150-155) — continuous gravity
            # observation is what keeps pitch/roll drift bounded enough for
            # the yaw-only loop gate (LoopClosing.cc:243-256)
            if self.imu_initialized:
                self._inertial_window_ba(slot)

    def _integrate_kf_info(self, slot: int, info: np.ndarray):
        """Apply a keyframe step's packed scalars to the host schedule
        (counters, BA-refined ref pose, KF free-list, sparsifier +
        loop-closer feeds)."""
        Wk = self.cfg.map.window_kf
        self.n_mp += int(info[0]) + int(info[1])
        self.n_inliers_ref = int(info[5])
        if self.ref_kf == slot:
            self._ref_pose_np = (info[6:15].reshape(3, 3).astype(np.float32),
                                 info[15:18].astype(np.float32))
        window = [int(v) for v in info[18:18 + Wk] if v >= 0]
        culled = [int(v) for v in info[18 + Wk:18 + 2 * Wk] if v >= 0]
        self._free_keyframes(culled)
        if self._sparsifier is not None:
            self._sparsifier.observe_window(window)
        if self._loop_closer is not None:
            self._loop_closer.insert_keyframe(slot)

    def _free_keyframes(self, culled: list[int]):
        """Feed culled keyframe slots to the free-list (host half of
        KeyFrame::SetBadFlag). Trajectory entries referencing the culled
        keyframe re-anchor to its temporal parent so later loop corrections
        still reach them (ref: the spanning-tree walk through bad KFs at
        save time, src/System.cc:559-568). In inertial mode the culled
        keyframe's two IMU intervals merge into one (ref
        Preintegrated::MergePrevious via KeyFrameCulling,
        src/LocalMapping.cc:1030-)."""
        for c in culled:
            if c in self.kf_free:
                continue
            self.kf_free.append(c)
            if c in self.kf_order:
                i = self.kf_order.index(c)
                parent = (self.kf_order[i - 1] if i > 0 else
                          (self.kf_order[i + 1]
                           if i + 1 < len(self.kf_order) else None))
                if (parent is not None
                        and any(e.ref_kf == c for e in self.trajectory)):
                    pk = np.asarray(jnp.concatenate([
                        self.ms.kf_R[c].reshape(9), self.ms.kf_t[c],
                        self.ms.kf_R[parent].reshape(9),
                        self.ms.kf_t[parent]]))
                    T_cw = np.eye(4)
                    T_cw[:3, :3] = pk[:9].reshape(3, 3)
                    T_cw[:3, 3] = pk[9:12]
                    T_pw = np.eye(4)
                    T_pw[:3, :3] = pk[12:21].reshape(3, 3)
                    T_pw[:3, 3] = pk[21:24]
                    T_cp = T_cw @ np.linalg.inv(T_pw)
                    for e in self.trajectory:
                        if e.ref_kf == c:
                            e.T_cr = e.T_cr @ T_cp
                            e.ref_kf = parent
                if self.ref_kf == c and parent is not None:
                    self.ref_kf = parent
                    self._refresh_ref_pose()
                self.kf_order.pop(i)
                if self.cfg.use_imu:
                    # segments[j] = IMU rows between kf_order[j-1] and [j];
                    # removing keyframe i merges intervals (i-1,i)+(i,i+1)
                    if i < len(self._kf_imu_segments):
                        seg_in = self._kf_imu_segments.pop(i)
                        if i == 0:
                            # the new first keyframe has no predecessor
                            if self._kf_imu_segments:
                                self._kf_imu_segments[0] = np.zeros(
                                    (0, 7), np.float32)
                        elif i < len(self._kf_imu_segments):
                            self._kf_imu_segments[i] = np.concatenate(
                                [seg_in, self._kf_imu_segments[i]])
                    if i < len(self._kf_times):
                        self._kf_times.pop(i)
            if self._sparsifier is not None:
                self._sparsifier.forget(c)

    def _flush_pending_info(self):
        if self._pending_kf_info is not None:
            slot, info = self._pending_kf_info
            self._pending_kf_info = None
            self._integrate_kf_info(slot, np.asarray(info))

    _reloc_key = None

    def _relocalize(self, frame: FrameData):
        """Relocalization (ref Tracking::Relocalization,
        src/Tracking.cc:3641): candidates from the sparsified keyframe
        database (the DB only ever contains sparsified keyframes,
        src/LoopClosing.cc:325; falls back to a brute sweep over all valid
        keyframes when sparsification is off) -> appearance matching ->
        prior-free PnP RANSAC (MLPnP analog, ops/pnp.py) -> pose
        optimization -> widening projection refinement."""
        f = frame.feats
        if self.kf_db is not None and self.kf_db.present.any():
            # tf-idf matvec shortlist + exact rescoring of the shortlist
            # only (query cost independent of database size)
            cands, _ = self.kf_db.query_rescored(
                self.ms.kp_desc, self.ms.kp_valid, f.desc, f.valid, k=5)
        elif self.n_kf > 0:
            # no database: brute appearance sweep over all valid keyframes
            from ..models.vocab import place_scores
            mask = np.asarray(self.ms.kf_valid)
            if not mask.any():
                return None
            scores = np.asarray(place_scores(
                self.ms.kp_desc, self.ms.kp_valid, jnp.asarray(mask),
                f.desc, f.valid))
            order = np.argsort(-scores)[:5]
            cands = [int(i) for i in order if scores[i] > 0.05]
        else:
            return None
        if self._reloc_key is None:
            self._reloc_key = jax.random.PRNGKey(0xE10C)
        best = None
        for c in cands:
            self._reloc_key, sub = jax.random.split(self._reloc_key)
            out = to.track_by_pnp(self.ms, self.calib, frame,
                                  jnp.asarray(c), sub)
            n = int(out.n_inliers)
            if n >= 15 and (best is None or n > best[0]):
                best = (n, c, out)
        if best is None:
            return None
        _, c, out = best
        # refine: the reference's widening-then-narrowing projection
        # cascade (src/Tracking.cc:3741-3800) — first a coarse radius-10
        # harvest around the PnP pose, re-optimize, then a narrow radius-3
        # pass with a tighter descriptor ratio around the refined pose
        ref = to.track_points(
            self.ms, self.calib, self.orb, frame, out.R, out.t,
            jnp.clip(self.ms.obs_mp[c], 0), self.ms.obs_mp[c] >= 0,
            jnp.asarray(10.0), jnp.asarray(0.9))
        if int(ref.n_inliers) >= int(out.n_inliers):
            out = ref
            ref2 = to.track_points(
                self.ms, self.calib, self.orb, frame, out.R, out.t,
                jnp.clip(self.ms.obs_mp[c], 0), self.ms.obs_mp[c] >= 0,
                jnp.asarray(3.0), jnp.asarray(0.75))
            if int(ref2.n_inliers) >= int(out.n_inliers):
                out = ref2
        self.ref_kf = c
        # cross-map hit: tracking continues in the matched keyframe's map,
        # so the Atlas active-map label must follow (ref scopes candidates
        # per map — DetectRelocalizationCandidates(F, pMap),
        # include/KeyFrameDatabase.h:79 — and never relocalizes across
        # maps; we allow it but keep kf_maps/active_map coherent so the
        # inertial chain and a later merge reason over a correct boundary)
        if c < len(self.kf_maps) and self.kf_maps[c] != self.active_map:
            self.active_map = self.kf_maps[c]
        self.vel = None
        return out

    # ------------------------------------------------------------------
    # local mapping stage (ref LocalMapping::Run body)
    # ------------------------------------------------------------------

    def _cull_policy(self):
        """Inertial keyframe-culling protections (ref
        LocalMapping::KeyFrameCulling, src/LocalMapping.cc:935-941 +
        :1040-1062): redundancy bar 0.5 in stereo-inertial (0.9 visual /
        mono-inertial); a keyframe may only be culled when the whole map
        holds more than Nd keyframes, it is older than the last 2, it has
        temporal neighbors, and removing it keeps the merged
        preintegration gap under 0.5s (3s once the IMU is initialized and
        it is outside the Nd-keyframe optimizable window)."""
        cfg = self.cfg
        if not cfg.use_imu:
            return None, 0.9
        K = cfg.map.max_kf
        cullable = np.zeros(K, bool)
        n = len(self.kf_order)
        nd = cfg.imu_protect_nd
        if n > nd:
            t = self._kf_times
            for j in range(1, min(n - 2, len(t) - 1)):
                gap = t[j + 1] - t[j - 1]
                older = j < n - nd
                if (self.imu_initialized and older and gap < 3.0) \
                        or gap < 0.5:
                    cullable[self.kf_order[j]] = True
        red_th = 0.5 if (self.calib.bf or 0.0) > 0.0 else 0.9
        return jnp.asarray(cullable), red_th

    def _local_mapping(self, kf_slot: int):
        cfg = self.cfg
        Wk = cfg.map.window_kf
        t0 = time.perf_counter()
        cullable, red_th = self._cull_policy()
        out = mo.mapping_step(
            self.ms, self.calib, self.orb, jnp.asarray(kf_slot),
            jnp.asarray(self.kf_ord),
            n_tri=cfg.n_triangulate_neighbors,
            window_kf=cfg.map.window_kf, n_fixed=cfg.n_fixed_cams,
            pt_cap=cfg.map.local_mp_cap, ba_iters=cfg.ba_iters,
            cullable=cullable, red_th=red_th)
        self.ms = out.ms
        # mapping_step creates/fuses/culls map points — take its maintained
        # obs-count table here, local to the mutation, rather than relying
        # on callers to refresh it
        self._n_obs_dev = out.n_obs
        self._obs_mask_dev = out.obs_mask
        self._obs_dirty = False
        info = np.asarray(out.info)   # the one per-keyframe fetch
        self.n_mp += int(info[0])
        window = [int(v) for v in info[4:4 + Wk] if v >= 0]
        culled = [int(v) for v in info[4 + Wk:4 + 2 * Wk] if v >= 0]
        self._free_keyframes(culled)
        self._tic(t0, "mapping_step")

        # sparsification feed: miss-counter update (ref
        # KeyFrame::UpdateCountInLocalMapping + LocalMapping.cc:252-274)
        if self._sparsifier is not None:
            self._sparsifier.observe_window(window)
        if self._loop_closer is not None:
            self._loop_closer.insert_keyframe(kf_slot)

    # ------------------------------------------------------------------
    # inertial helpers (host-side; prediction math is tiny)
    # ------------------------------------------------------------------

    def _last_frame_dt(self) -> float:
        if len(self.trajectory) >= 1 and self._last_ts is not None:
            return max(self._last_ts - self.trajectory[-1].timestamp, 0.0)
        return 0.0

    @staticmethod
    def _integrate_np(rows, bg, ba):
        """Plain numpy preintegration (prediction only, no covariance)."""
        from scipy.spatial.transform import Rotation
        dR = np.eye(3)
        dV = np.zeros(3)
        dP = np.zeros(3)
        dT = 0.0
        for r in rows:
            dt = float(r[0])
            acc = r[1:4] - ba
            gyr = r[4:7] - bg
            a_w = dR @ acc
            dP = dP + dV * dt + 0.5 * a_w * dt * dt
            dV = dV + a_w * dt
            dR = dR @ Rotation.from_rotvec(gyr * dt).as_matrix()
            dT += dt
        return dR, dV, dP, dT

    def _predict_imu(self, T_last):
        """Propagate the last body state across the frame interval
        (ref Tracking::PredictStateIMU, src/Tracking.cc:1727; body pose via
        the IMU.T_b_c1 extrinsic)."""
        bg, ba = self.imu_bias[:3], self.imu_bias[3:]
        dR, dV, dP, dT = self._integrate_np(self._imu_frame_rows, bg, ba)
        T_wb = np.linalg.inv(T_last) @ self.Tcb
        R_wb, p_wb = T_wb[:3, :3], T_wb[:3, 3]
        g = self.gravity
        R2 = R_wb @ dR
        v2 = self.vel_w + g * dT + R_wb @ dV
        p2 = p_wb + self.vel_w * dT + 0.5 * g * dT * dT + R_wb @ dP
        T_wb2 = np.eye(4)
        T_wb2[:3, :3] = R2
        T_wb2[:3, 3] = p2
        T_pred = np.linalg.inv(T_wb2 @ self.Tbc)
        return T_pred.astype(np.float64), v2

    def _try_imu_init(self):
        """Staged IMU initialization (ref LocalMapping::InitializeIMU,
        src/LocalMapping.cc:1194: needs enough keyframes and baseline
        time; gravity+bias MAP via ops/inertial_opt.inertial_init)."""
        import jax
        from ..ops import imu as imu_ops
        from ..ops import inertial_opt
        cfg = self.cfg
        n_int = len(self.kf_order) - 1      # real preintegration intervals
        if not cfg.use_imu or n_int < cfg.imu_init_kfs + 1:
            return
        elapsed = self._kf_times[-1] - self._kf_times[0]
        if elapsed < cfg.imu_init_time:
            return
        # staged refinement: initial MAP, then VIBA1/VIBA2-style re-estimates
        # at 5s / 15s (ref LocalMapping.cc:201-228) PLUS a cheap
        # gravity/bias re-estimate every ~1s of new baseline until 15s (ref
        # ScaleRefinement cadence, LocalMapping.cc:231-241): the continuous
        # VI window BA holds gravity FIXED, so an early rough gravity must
        # be refreshed as baseline accumulates or it tilts every window
        stage = getattr(self, "_imu_stage", 0)
        thresholds = [cfg.imu_init_time, 5.0, 15.0]
        due_stage = stage < len(thresholds) and elapsed >= thresholds[stage]
        last_g = getattr(self, "_last_gravity_refit", -1e9)
        due_refresh = (stage >= 1 and elapsed < 15.0
                       and elapsed - last_g >= 1.0)
        # mono-inertial: keep re-fitting the metric scale every ~10s until
        # 75s (ref LocalMapping::ScaleRefinement, LocalMapping.cc:231-241)
        mono = (self.calib.bf or 0.0) <= 0.0
        due_scale = (mono and stage >= 1 and elapsed < 75.0
                     and elapsed - last_g >= 10.0)
        if not (due_stage or due_refresh or due_scale):
            return
        # NOTE: stage/refit markers are only advanced AFTER a successful
        # solve — bumping them on an early bail-out (no usable segment run
        # yet) would skip the staged refinement entirely
        # trailing run of non-empty segments (segment j = interval
        # (j-1, j); segment 0, mono-init segments, and IMU-blackout
        # intervals are empty and cannot enter the unmasked init chain)
        n = len(self.kf_order)
        a = max(1, n - 20)
        for j in range(n - 1, a - 1, -1):
            if len(self._kf_imu_segments[j]) == 0:
                a = j + 1
                break
        if a >= n:
            return
        segs = self._kf_imu_segments[a:]
        K = len(segs) + 1
        if K < 3:
            return
        ord_slots = np.asarray(self.kf_order[a - 1:], np.int32)
        cap = max(int(max(len(seg) for seg in segs)), 8)
        meas = np.zeros((K - 1, cap, 7), np.float32)
        valid = np.zeros((K - 1, cap), bool)
        for i, seg in enumerate(segs):
            meas[i, :len(seg)] = seg
            valid[i, :len(seg)] = True
        sts = jax.vmap(
            lambda m, v: imu_ops.integrate(
                jnp.zeros(6), m, v, jnp.asarray(cfg.imu_noise_gyro),
                jnp.asarray(cfg.imu_noise_acc),
                jnp.asarray(cfg.imu_gyro_walk),
                jnp.asarray(cfg.imu_acc_walk)))(
            jnp.asarray(meas), jnp.asarray(valid))
        kf_R_cw = np.asarray(self.ms.kf_R[ord_slots])
        kf_t_cw = np.asarray(self.ms.kf_t[ord_slots])
        R_wc = kf_R_cw.transpose(0, 2, 1)
        p_wc = -np.einsum("kij,kj->ki", R_wc, kf_t_cw)
        # body pose: T_wb = T_wc * T_cb (IMU.T_b_c1 extrinsic)
        Rcb, pcb = self.Tcb[:3, :3], self.Tcb[:3, 3]
        R_wb = R_wc @ Rcb
        p_wb = np.einsum("kij,j->ki", R_wc, pcb) + p_wc
        res = inertial_opt.inertial_init(
            jnp.asarray(R_wb), jnp.asarray(p_wb), sts,
            prior_g=jnp.asarray(1e2), prior_a=jnp.asarray(1e5),
            with_scale=mono)
        g_est = np.asarray(res.R_wg) @ np.array([0.0, 0.0, -9.81])
        if not np.all(np.isfinite(g_est)):
            return
        if mono:
            s = float(res.scale)
            # reference rejects degenerate solves (scale<0.1,
            # src/LocalMapping.cc InitializeIMU) and only touches the map
            # when the correction is meaningful (ScaleRefinement applies
            # when |s-1| > 0.002)
            if not np.isfinite(s) or s < 0.1:
                return
            if abs(s - 1.0) > 2e-3:
                self._apply_map_scale(s)
        if due_stage:
            self._imu_stage = stage + 1
        self._last_gravity_refit = elapsed
        self.gravity = g_est.astype(np.float32)
        self.imu_bias = np.concatenate(
            [np.asarray(res.bg), np.asarray(res.ba)]).astype(np.float32)
        self.vel_w = np.asarray(res.vels[-1]).astype(np.float32)
        self.imu_initialized = True
        # reseed the on-device inertial chain from the refined estimates
        self._v_dev = None
        self._bias_dev = None

    def _apply_map_scale(self, s: float):
        """Rescale the whole world by s (mono-inertial metric correction,
        ref Map::ApplyScaledRotation called from InitializeIMU /
        ScaleRefinement with R=I): positions, camera translations,
        velocities, and the recorded trajectory all scale; rotations and
        gravity (metric) do not."""
        s = float(s)
        ms = self.ms
        self.ms = ms._replace(
            mp_pos=ms.mp_pos * s,
            kf_t=ms.kf_t * s,
            mp_min_dist=ms.mp_min_dist * s,
            mp_max_dist=ms.mp_max_dist * s,
            kp_depth=jnp.where(ms.kp_depth > 0, ms.kp_depth * s,
                               ms.kp_depth))
        self.kf_velocities = self.kf_velocities * s
        if self.vel_w is not None:
            self.vel_w = (np.asarray(self.vel_w) * s).astype(np.float32)
        self.last_t = (np.asarray(self.last_t) * s).astype(np.float32)
        if self.vel is not None:
            self.vel = np.asarray(self.vel).copy()
            self.vel[:3, 3] *= s
        R_ref, t_ref = self._ref_pose_np
        self._ref_pose_np = (R_ref, (np.asarray(t_ref) * s
                                     ).astype(np.float32))
        for e in self.trajectory:
            e.T_cr[:3, 3] *= s
        # on-device pose/velocity handles are stale at the old scale
        self._Rt_dev = None
        self._Rt_dev2 = None
        self._v_dev = None
        # in-flight frames were tracked against the OLD-scale map; rerun
        # them from the rescaled state or their completions read garbage
        self._redispatch_inflight()

    def _full_inertial_ba(self):
        """FullInertialBA analog (ref Optimizer::FullInertialBA,
        src/Optimizer.cc:366, run after loop correction in IMU mode via
        RunGlobalBundleAdjustment, src/LoopClosing.cc:2228-2230): ONE
        joint optimization over the active map's whole temporal chain —
        poses, velocities, shared bias, gravity direction, and landmarks,
        matching the reference's single g2o graph. The chain length is
        bucketed to a power of two (pad keyframes masked out) so repeated
        corrections reuse the compiled Schur-CG program
        (ops/inertial_opt.vi_full_ba)."""
        import jax
        from ..ops import imu as imu_ops
        from ..ops import inertial_opt
        n = len(self.kf_order)
        if n < 3:
            return
        # active-map suffix: the temporal/preintegration chain breaks at a
        # map switch, so older-map keyframes are excluded
        start0 = 0
        for i in range(n - 1, -1, -1):
            if self.kf_maps[self.kf_order[i]] != self.active_map:
                start0 = i + 1
                break
        chain = n - start0
        if chain < 3:
            return
        Wb = max(8, 1 << (chain - 1).bit_length())
        slots = self.kf_order[start0:]
        Kc = self.ms.kf_valid.shape[0]
        # pad rows scatter out-of-bounds (mode="drop") so duplicate slot
        # writes can never clobber a real row with a stale pose
        sl_np = np.concatenate([np.asarray(slots, np.int32),
                                np.full(Wb - chain, Kc, np.int32)])
        pad_mask = np.zeros(Wb, bool)
        pad_mask[:chain] = True
        segs = self._kf_imu_segments[start0 + 1:start0 + chain]
        cap = max(max((len(x) for x in segs), default=1), 1)
        cap = 1 << (cap - 1).bit_length()
        meas = np.zeros((Wb - 1, cap, 7), np.float32)
        valid = np.zeros((Wb - 1, cap), bool)
        pv = np.zeros(Wb - 1, bool)
        for i, seg in enumerate(segs):
            meas[i, :len(seg)] = seg
            valid[i, :len(seg)] = True
            pv[i] = len(seg) > 0
        bias = jnp.asarray(self.imu_bias)
        cfg = self.cfg
        sts = jax.vmap(
            lambda m, v: imu_ops.integrate(
                bias, m, v, jnp.asarray(cfg.imu_noise_gyro),
                jnp.asarray(cfg.imu_noise_acc),
                jnp.asarray(cfg.imu_gyro_walk),
                jnp.asarray(cfg.imu_acc_walk)))(
            jnp.asarray(meas), jnp.asarray(valid))
        sl = jnp.asarray(np.minimum(sl_np, Kc - 1))
        R_cw = self.ms.kf_R[sl]
        t_cw = self.ms.kf_t[sl]
        R_wc = jnp.swapaxes(R_cw, -1, -2)
        p_wc = -jnp.einsum("kij,kj->ki", R_wc, t_cw)
        Rcb = jnp.asarray(self.Tcb[:3, :3], R_cw.dtype)
        pcb = jnp.asarray(self.Tcb[:3, 3], R_cw.dtype)
        R_wb = R_wc @ Rcb
        p_wb = jnp.einsum("kij,j->ki", R_wc, pcb) + p_wc
        kf_mask = self.ms.kf_valid[sl] & jnp.asarray(pad_mask)
        obs = self.ms.obs_mp[sl]                      # (Wb,N)
        f_valid = (obs >= 0) & self.ms.kp_valid[sl] & kf_mask[:, None]
        Wn = obs.shape[1]
        f_kf = jnp.broadcast_to(
            jnp.arange(Wb, dtype=jnp.int32)[:, None], (Wb, Wn)).reshape(-1)
        s2 = jnp.asarray(
            [sc * sc for sc in self.orb.level_scales()], jnp.float32)
        vels = self.kf_velocities[np.minimum(sl_np, Kc - 1)]
        res = inertial_opt.vi_full_ba(
            self.calib.model, self.calib.params_array(),
            jnp.asarray(self.calib.bf),
            R_wb, p_wb, jnp.asarray(vels), kf_mask,
            sts, jnp.asarray(pv),
            jnp.asarray(self.imu_bias[:3]), jnp.asarray(self.imu_bias[3:]),
            jnp.asarray(self.gravity),
            self.ms.mp_pos,
            jnp.clip(obs, 0).reshape(-1), f_kf,
            self.ms.kp_xy[sl].reshape(-1, 2),
            self.ms.kp_uright[sl].reshape(-1),
            s2[self.ms.kp_octave[sl]].reshape(-1), f_valid.reshape(-1),
            walk_info=jnp.full(6, 1e8),
            R_bc=jnp.asarray(self.Tbc[:3, :3], R_cw.dtype),
            t_bc=jnp.asarray(self.Tbc[:3, 3], R_cw.dtype))
        ok_pack = np.asarray(jnp.stack([
            jnp.all(jnp.isfinite(res.R_wb)), jnp.all(jnp.isfinite(res.p_wb)),
            jnp.all(jnp.isfinite(res.vels)), jnp.all(jnp.isfinite(res.g)),
            jnp.all(jnp.isfinite(res.bg)), jnp.all(jnp.isfinite(res.ba)),
            jnp.all(jnp.isfinite(res.mp_pos))]))
        if not ok_pack.all():
            return
        self.ms = self.ms._replace(mp_pos=res.mp_pos)
        Rbc = jnp.asarray(self.Tbc[:3, :3], R_cw.dtype)
        pbc = jnp.asarray(self.Tbc[:3, 3], R_cw.dtype)
        R_wc_new = res.R_wb @ Rbc
        p_wc_new = jnp.einsum("kij,j->ki", res.R_wb, pbc) + res.p_wb
        R_cw_new = jnp.swapaxes(R_wc_new, -1, -2)
        t_cw_new = -jnp.einsum("kij,kj->ki", R_cw_new, p_wc_new)
        sl_scatter = jnp.asarray(sl_np)
        self.ms = self.ms._replace(
            kf_R=self.ms.kf_R.at[sl_scatter].set(
                jnp.where(kf_mask[:, None, None], R_cw_new,
                          self.ms.kf_R[sl]), mode="drop"),
            kf_t=self.ms.kf_t.at[sl_scatter].set(
                jnp.where(kf_mask[:, None], t_cw_new,
                          self.ms.kf_t[sl]), mode="drop"))
        self.kf_velocities[slots] = np.asarray(res.vels[:chain])
        self.imu_bias = np.concatenate(
            [np.asarray(res.bg), np.asarray(res.ba)]).astype(np.float32)
        self.gravity = np.asarray(res.g).astype(np.float32)
        self.vel_w = self.kf_velocities[slots[-1]]
        self._v_dev = None
        self._bias_dev = None

    def _inertial_window_ba(self, new_slot: int, W: int | None = None,
                            start: int | None = None):
        """Visual-inertial local BA over the temporal window (ref
        Optimizer::LocalInertialBA via LocalMapping, src/Optimizer.cc:2431):
        jointly refine W keyframes' poses/velocities + shared biases AND
        their observed landmarks against the preintegration chain, with
        up-to-n_fixed older keyframes as fixed anchors
        (ref lFixedKeyFrames, src/Optimizer.cc:2550).

        start: index into kf_order of the window's first keyframe
        (default: the trailing window ending at the newest keyframe)."""
        import jax
        from ..ops import imu as imu_ops
        from ..ops import inertial_opt
        W = min(6 if W is None else W, len(self.kf_order))
        if start is None:
            start = len(self.kf_order) - W
        slots = self.kf_order[start:start + W]  # temporal, newest last
        segs = self._kf_imu_segments[start + 1:start + W]
        cap = max(max((len(x) for x in segs), default=1), 1)
        # bucket the IMU-row capacity to limit recompilation
        cap = 1 << (cap - 1).bit_length()
        meas = np.zeros((W - 1, cap, 7), np.float32)
        valid = np.zeros((W - 1, cap), bool)
        pv = np.zeros(W - 1, bool)
        for i, seg in enumerate(segs):
            meas[i, :len(seg)] = seg
            valid[i, :len(seg)] = True
            pv[i] = len(seg) > 0
        bias = jnp.asarray(self.imu_bias)
        cfg = self.cfg
        sts = jax.vmap(
            lambda m, v: imu_ops.integrate(
                bias, m, v, jnp.asarray(cfg.imu_noise_gyro),
                jnp.asarray(cfg.imu_noise_acc),
                jnp.asarray(cfg.imu_gyro_walk),
                jnp.asarray(cfg.imu_acc_walk)))(
            jnp.asarray(meas), jnp.asarray(valid))
        sl = jnp.asarray(slots)
        R_cw = self.ms.kf_R[sl]
        t_cw = self.ms.kf_t[sl]
        R_wc = jnp.swapaxes(R_cw, -1, -2)
        p_wc = -jnp.einsum("kij,kj->ki", R_wc, t_cw)
        # body pose: T_wb = T_wc * T_cb (IMU.T_b_c1 extrinsic)
        Rcb = jnp.asarray(self.Tcb[:3, :3], R_cw.dtype)
        pcb = jnp.asarray(self.Tcb[:3, 3], R_cw.dtype)
        R_wb = R_wc @ Rcb
        p_wb = jnp.einsum("kij,j->ki", R_wc, pcb) + p_wc
        kf_mask = self.ms.kf_valid[sl]
        # factor table: window observations, landmarks free
        obs = self.ms.obs_mp[sl]                      # (W,N)
        f_valid = (obs >= 0) & self.ms.kp_valid[sl] & kf_mask[:, None]
        Wn = obs.shape[1]
        f_kf = jnp.broadcast_to(
            jnp.arange(W, dtype=jnp.int32)[:, None], (W, Wn)).reshape(-1)
        s2 = jnp.asarray(
            [sc * sc for sc in self.orb.level_scales()], jnp.float32)
        # fixed anchors: EVERY other valid keyframe observing window points
        # (ref LocalInertialBA's lFixedKeyFrames = all observers of local
        # points outside the window, src/Optimizer.cc:2550) — without the
        # full anchor set the landmark pass deforms long-lived points
        Kc = self.ms.kf_valid.shape[0]
        wmask = np.zeros(Kc, bool)
        wmask[np.asarray(slots)] = True
        a_obs = self.ms.obs_mp
        a_valid = (a_obs >= 0) & self.ms.kp_valid \
            & self.ms.kf_valid[:, None] & jnp.asarray(~wmask)[:, None]
        a_cam = jnp.broadcast_to(
            jnp.arange(Kc, dtype=jnp.int32)[:, None], (Kc, Wn)).reshape(-1)
        res = inertial_opt.vi_window_ba(
            self.calib.model, self.calib.params_array(),
            jnp.asarray(self.calib.bf),
            R_wb, p_wb, jnp.asarray(self.kf_velocities[slots]), kf_mask,
            sts, jnp.asarray(pv),
            jnp.asarray(self.imu_bias[:3]), jnp.asarray(self.imu_bias[3:]),
            jnp.asarray(self.gravity),
            self.ms.mp_pos,
            jnp.clip(obs, 0).reshape(-1), f_kf,
            self.ms.kp_xy[sl].reshape(-1, 2),
            self.ms.kp_uright[sl].reshape(-1),
            s2[self.ms.kp_octave[sl]].reshape(-1), f_valid.reshape(-1),
            self.ms.kf_R, self.ms.kf_t,
            a_cam, jnp.clip(a_obs, 0).reshape(-1),
            self.ms.kp_xy.reshape(-1, 2),
            self.ms.kp_uright.reshape(-1),
            s2[self.ms.kp_octave].reshape(-1), a_valid.reshape(-1),
            # bias random-walk: tight per-call (sigma ~1e-4) — the biases
            # are shared per window and should track slow real walks, not
            # absorb visual-map drift (measured: loose walk info lets the
            # optimizer park 0.06 rad/s of phantom gyro bias)
            walk_info=jnp.full(6, 1e8),
            R_bc=jnp.asarray(self.Tbc[:3, :3], R_cw.dtype),
            t_bc=jnp.asarray(self.Tbc[:3, 3], R_cw.dtype))
        # a degenerate window (e.g. right after a mono scale jump) can
        # blow up the solve; skip the writeback rather than poison the map
        ok_pack = np.asarray(jnp.stack([
            jnp.all(jnp.isfinite(res.R_wb)), jnp.all(jnp.isfinite(res.p_wb)),
            jnp.all(jnp.isfinite(res.vels)), jnp.all(jnp.isfinite(res.g)),
            jnp.all(jnp.isfinite(res.bg)), jnp.all(jnp.isfinite(res.ba)),
            jnp.all(jnp.isfinite(res.mp_pos))]))
        if not ok_pack.all():
            return
        self.ms = self.ms._replace(mp_pos=res.mp_pos)
        # write back: T_cw = (T_wb * T_bc)^-1
        Rbc = jnp.asarray(self.Tbc[:3, :3], R_cw.dtype)
        pbc = jnp.asarray(self.Tbc[:3, 3], R_cw.dtype)
        R_wc_new = res.R_wb @ Rbc
        p_wc_new = jnp.einsum("kij,j->ki", res.R_wb, pbc) + res.p_wb
        R_cw_new = jnp.swapaxes(R_wc_new, -1, -2)
        t_cw_new = -jnp.einsum("kij,kj->ki", R_cw_new, p_wc_new)
        self.ms = self.ms._replace(
            kf_R=self.ms.kf_R.at[sl].set(
                jnp.where(kf_mask[:, None, None], R_cw_new, self.ms.kf_R[sl])),
            kf_t=self.ms.kf_t.at[sl].set(
                jnp.where(kf_mask[:, None], t_cw_new, self.ms.kf_t[sl])))
        self.kf_velocities[slots] = np.asarray(res.vels)
        self.imu_bias = np.concatenate(
            [np.asarray(res.bg), np.asarray(res.ba)]).astype(np.float32)
        self.gravity = np.asarray(res.g).astype(np.float32)
        if slots and slots[-1] == self.kf_order[-1]:
            self.vel_w = self.kf_velocities[slots[-1]]
        self._v_dev = None
        self._bias_dev = None

    def _refresh_ref_pose(self):
        packed = np.asarray(jnp.concatenate([
            self.ms.kf_R[self.ref_kf].reshape(9),
            self.ms.kf_t[self.ref_kf]]))
        self._ref_pose_np = (packed[:9].reshape(3, 3).astype(np.float32),
                             packed[9:12].astype(np.float32))

    def _record(self, timestamp, lost: bool, frame_id: Optional[int] = None):
        T_cw = self.current_pose()
        R_ref, t_ref = self._ref_pose_np
        T_rw = np.eye(4)
        T_rw[:3, :3] = R_ref
        T_rw[:3, 3] = t_ref
        self.trajectory.append(TrajectoryEntry(
            frame_id=self.frame_id if frame_id is None else frame_id,
            timestamp=timestamp, ref_kf=self.ref_kf,
            T_cr=T_cw @ np.linalg.inv(T_rw), lost=lost))

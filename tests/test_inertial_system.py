"""Stereo-inertial system: IMU initialization fires, gravity is recovered,
and tracking with IMU prediction survives the sequence."""
import numpy as np
import pytest

from ms_slam.models.map_state import MapConfig
from ms_slam.ops.orb import OrbConfig
from ms_slam.pipeline.frontend import Calib
from ms_slam.pipeline.system import System, SystemConfig
from ms_slam.utils import synth
from ms_slam.utils.evaluate import ate_rmse

H, W, FX, BL = 240, 320, 260.0, 0.15
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


@pytest.mark.slow
def test_stereo_inertial(rng):
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6),
        min_init_depth_points=100, max_frames_between_kf=3,
        use_imu=True, imu_init_kfs=6, imu_init_time=0.5)
    slam = System(cfg)

    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    n_frames = 65
    poses = synth.make_trajectory(n_frames, "arc")
    frame_dt = 0.1
    imu = synth.make_imu(poses, frame_dt, imu_rate=200)

    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        if i == 0:
            slam.track_stereo(im_l, im_r, 0.0)
        else:
            slam.track_stereo_imu(im_l, im_r, frame_dt * i, imu[i - 1])

    slam._flush_pipeline()
    assert slam.state == "OK"
    assert slam.imu_initialized, (len(slam._kf_imu_segments))
    # past 5s the VIBA1 refinement fired and the inertial window BA engaged
    assert slam._imu_stage >= 2, slam._imu_stage
    # gravity should point along +y (camera-down world), magnitude ~9.81
    g = slam.gravity
    assert abs(np.linalg.norm(g) - 9.81) < 0.5, g
    cos = g[1] / np.linalg.norm(g)
    assert cos > 0.95, g

    # recorded trajectory (what the reference saves + scores)
    gt_by_ts = {round(frame_dt * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est_xyz = np.stack([T[:3, 3] for _, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz)
    assert rmse < 0.025 * path, (rmse, path)


@pytest.mark.slow
def test_inertial_blackout_bridged(rng):
    """VERDICT r1 item 3 done-criterion: an 8-frame visual blackout (blank
    images) after IMU initialization must be bridged by IMU-predicted poses
    in the RECENTLY_LOST grace window (ref Tracking.cc:1947-2018 +
    PredictStateIMU :1727) — tracking recovers on the SAME map, no Atlas
    reset."""
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6),
        min_init_depth_points=100, max_frames_between_kf=3,
        use_imu=True, imu_init_kfs=6, imu_init_time=0.5)
    slam = System(cfg)
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    n_frames = 70
    poses = synth.make_trajectory(n_frames, "arc")
    frame_dt = 0.1
    imu = synth.make_imu(poses, frame_dt, imu_rate=200)
    blank = np.zeros((H, W), np.uint8)

    saw_lost = False
    for i, T_wc in enumerate(poses):
        if 45 <= i < 53:
            im_l, im_r = blank, blank
        else:
            im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        if i == 0:
            slam.track_stereo(im_l, im_r, 0.0)
        else:
            slam.track_stereo_imu(im_l, im_r, frame_dt * i, imu[i - 1])
        if slam.state == "RECENTLY_LOST":
            saw_lost = True

    slam._flush_pipeline()
    assert slam.imu_initialized
    assert saw_lost                      # the blackout was actually felt
    assert slam.state == "OK"            # ...and bridged
    assert slam.active_map == 0          # no Atlas reset: same map
    # trajectory still sane on the visible frames
    gt_by_ts = {round(frame_dt * i, 6): T for i, T in enumerate(poses)}
    rows = [(ts, T) for ts, T in slam.poses_wc()
            if not (4.5 - 1e-6 <= ts < 5.3 + 1e-6)]
    est_xyz = np.stack([T[:3, 3] for ts, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz)
    assert rmse < 0.06 * path, (rmse, path)


@pytest.mark.slow
def test_inertial_loop_closure_preserves_gravity(rng):
    """VERDICT r1 item 6 done-criterion: an inertial loop closure must go
    through the yaw-gate + 4-DoF essential graph (ref
    OptimizeEssentialGraph4DoF, src/Optimizer.cc:5174 + the yaw-only gating
    LoopClosing.cc:243-256) and preserve the gravity direction after
    correction."""
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 45, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=96, max_mp=12288, n_feat=512,
                      local_mp_cap=2048, window_kf=6,
                      grid_w=16, grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=3,
        sparsify=True, sparsify_n=40, sparsify_window=4,
        sparsify_queue_min=2, nonlocal_kf=3,
        loop_closing=True, loop_covis_min=30,
        loop_pitchroll_tol=0.05,     # 512-feat synthetic: wider band
        use_imu=True, imu_init_kfs=6, imu_init_time=0.5)
    slam = System(cfg)
    world = synth.BoxWorld(rng, half=7.0)
    frame_dt = 0.1
    poses = synth.make_trajectory(80, "orbit")
    poses = poses + poses[:20]           # second lap -> revisit
    imu_lap = synth.make_imu(poses[:80], frame_dt, imu_rate=200)
    imu = list(imu_lap) + list(synth.make_imu(poses[79:], frame_dt,
                                              imu_rate=200))
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        if i == 0:
            slam.track_stereo(im_l, im_r, 0.0)
        else:
            slam.track_stereo_imu(im_l, im_r, frame_dt * i, imu[i - 1])
    slam._flush_pipeline()
    assert slam.state == "OK"
    assert slam.imu_initialized and slam._imu_stage >= 2
    lc = slam._loop_closer
    assert lc.stats["queries"] > 0
    # the loop either closed through the gated 4-DoF path, or every
    # candidate was yaw-rejected — on this yaw-drift-only synthetic orbit a
    # verified loop must NOT be rejected by the gate
    assert lc.stats["loops"] >= 1, lc.stats
    # gravity direction survives the correction: world-down stays +y
    g = slam.gravity
    assert abs(np.linalg.norm(g) - 9.81) < 0.6, g
    assert g[1] / np.linalg.norm(g) > 0.9, g


@pytest.mark.slow
def test_mono_inertial_metric_scale(rng):
    """Mono-inertial (ref mono+IMU mode + LocalMapping::ScaleRefinement,
    src/LocalMapping.cc:231-241): the IMU's metric scale must be estimated
    at initialization (VertexScale in InertialOptimization,
    src/Optimizer.cc:3050) and applied to the monocular map — the recorded
    trajectory becomes METRIC, not just up-to-scale."""
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=0.0,
                  width=W, height=H, th_depth=0.0, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6),
        max_frames_between_kf=3,
        use_imu=True, imu_init_kfs=6, imu_init_time=1.0)
    slam = System(cfg)
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    n_frames = 70
    # metric scale needs accelerometer excitation: the reference refuses
    # inertial init below 0.5 m/s^2 acceleration variation
    # (src/Tracking.cc:2333-2337); the excited arc provides ~3-5 m/s^2
    poses = synth.make_trajectory(n_frames, "arc_excited")
    frame_dt = 0.1
    imu = synth.make_imu(poses, frame_dt, imu_rate=200)
    for i, T_wc in enumerate(poses):
        img = world.render(K, T_wc, H, W)
        if i == 0:
            slam.track_monocular(img, 0.0)
        else:
            slam.track_monocular_imu(img, frame_dt * i, imu[i - 1])
    slam._flush_pipeline()
    assert slam.state == "OK", slam.state
    assert slam.imu_initialized
    # gravity metric and upright
    g = slam.gravity
    assert abs(np.linalg.norm(g) - 9.81) < 0.6, g
    assert g[1] / np.linalg.norm(g) > 0.9, g

    gt_by_ts = {round(frame_dt * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est_xyz = np.stack([T[:3, 3] for _, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    # METRIC scale: the Horn alignment scale between the estimate and the
    # metric ground truth must be ~1 — the reference's own evaluation
    # reports exactly this quantity (evaluate_ate_scale.py's 'scale'
    # output; raw path-length ratios are biased upward by per-frame
    # jitter and are not a scale instrument)
    from ms_slam.utils.evaluate import horn_align
    _, _, s_al, _ = horn_align(est_xyz.T, gt_xyz.T, True)
    assert abs(s_al - 1.0) < 0.2, s_al
    half = len(rows) // 2
    s_half = horn_align(est_xyz[half:].T, gt_xyz[half:].T, True)[2]
    assert abs(s_half - 1.0) < 0.2, s_half
    # and the shape is right (scale-free ATE)
    path = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz, with_scale=True)
    assert rmse < 0.12 * path, (rmse, path)

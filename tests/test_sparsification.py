"""Sparsification end-to-end: the Phase-2 gate (SURVEY §7) scaled down —
run the synthetic sequence with the sparsifier on, check that the map
shrinks substantially while tracking survives and coverage holds."""
import numpy as np
import pytest

from ms_slam.models.map_state import MapConfig
from ms_slam.ops.orb import OrbConfig
from ms_slam.pipeline.frontend import Calib
from ms_slam.pipeline.system import System, SystemConfig
from ms_slam.utils import synth
from ms_slam.utils.evaluate import ate_rmse

H, W = 240, 320
FX = 260.0
BASELINE = 0.15
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def build_system(sparsify: bool):
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2),
                  bf=FX * BASELINE, width=W, height=H,
                  th_depth=BASELINE * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib,
        orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6,
                      grid_w=16, grid_h=12),
        min_init_depth_points=100,
        max_frames_between_kf=4,
        sparsify=sparsify,
        sparsify_n=40,
        sparsify_window=4,
        sparsify_queue_min=2,
        nonlocal_kf=3,
    )
    return System(cfg)


@pytest.mark.slow
def test_sparsified_tracking(rng):
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    n_frames = 40
    poses = synth.make_trajectory(n_frames, "arc")
    slam = build_system(sparsify=True)

    est = []
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BASELINE, H, W)
        T_cw = slam.track_stereo(im_l, im_r, timestamp=0.1 * i)
        est.append(np.linalg.inv(T_cw))

    assert slam.state == "OK"
    sp = slam._sparsifier
    assert sp.stats["windows"] >= 1, sp.stats
    assert sp.stats["killed"] > 0
    n_sparsified = slam.compressed_map_points_in_map()
    assert n_sparsified > 0

    # accuracy preserved
    est_xyz = np.stack([T[:3, 3] for T in est])
    gt_xyz = np.stack([T[:3, 3] for T in poses])
    path_len = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz)
    assert rmse < 0.025 * path_len, (rmse, path_len)

    # shutdown flushes the remaining keyframes (ref ShutdownMapCompressing)
    n_kf = slam.keyframes_in_map()
    slam.shutdown()
    assert len(sp.done) == slam.n_kf
    # every valid keyframe is sparsified after shutdown
    ms = slam.ms
    kfv = np.asarray(ms.kf_valid)
    assert np.asarray(ms.kf_sparsified)[kfv].all()

    # memory reduction: sparsified keyframes keep only live observations
    kp_live = int(np.asarray(ms.kp_valid).sum())
    kp_total = int(kfv.sum()) * 512
    assert kp_live < 0.7 * kp_total, (kp_live, kp_total)
    stats = slam.memory_stats()
    assert stats["reduction"] > 0.3, stats
    assert stats["mp_selector_killed"] > 0


def test_inertial_gate_blocks_windows_until_viba2():
    """Ref MapSparsification::CheckNewKeyFrames waits for the map's
    inertial-BA2 flag in IMU mode (src/MapSparsification.cc:197-198): no
    window may be solved before the staged VIBA refinement (stage >= 2)."""
    slam = build_system(sparsify=True)
    slam.cfg.use_imu = True
    sp = slam._sparsifier
    calls = []
    sp._sparsify = lambda batch: calls.append(list(batch))
    sp.queue = list(range(8))

    # not initialized -> gated
    slam.imu_initialized = False
    sp.maybe_sparsify()
    assert calls == [] and len(sp.queue) == 8

    # initialized but pre-VIBA -> still gated
    slam.imu_initialized = True
    slam._imu_stage = 1
    sp.maybe_sparsify()
    assert calls == [] and len(sp.queue) == 8

    # VIBA refined -> windows solve
    slam._imu_stage = 2
    sp.maybe_sparsify()
    assert len(calls) == 1 and calls[0] == [0, 1, 2, 3]

    # shutdown flush overrides the gate (ref RequestFinish path)
    slam._imu_stage = 0
    sp.maybe_sparsify(force=True)
    assert len(sp.queue) == 0

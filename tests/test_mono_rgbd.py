"""Monocular and RGB-D frontends end-to-end on the synthetic worlds."""
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


def build(**kw):
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6),
        min_init_depth_points=100, max_frames_between_kf=8, **kw)
    return System(cfg)


@pytest.mark.slow
def test_rgbd_odometry(rng):
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    poses = synth.make_trajectory(25, "arc")
    slam = build()
    for i, T_wc in enumerate(poses):
        img, depth = world.render_rgbd(K, T_wc, H, W)
        slam.track_rgbd(img, depth, 0.1 * i)
    assert slam.state == "OK"
    # recorded trajectory (what the reference saves + scores)
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est_xyz = np.stack([T[:3, 3] for _, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz)
    assert rmse < 0.02 * path, (rmse, path)


@pytest.mark.slow
def test_mono_odometry(rng):
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    poses = synth.make_trajectory(30, "arc")
    slam = build()
    for i, T_wc in enumerate(poses):
        img = world.render(K, T_wc, H, W)
        slam.track_monocular(img, 0.1 * i)
    assert slam.state == "OK", slam.state
    assert slam.keyframes_in_map() >= 2
    # evaluate the recorded trajectory, up-to-scale (mono scale arbitrary)
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = [(ts, T) for ts, T in slam.poses_wc()]
    est_xyz = np.stack([T[:3, 3] for _, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz, with_scale=True)
    # mono accumulates scale drift without Sim3 loop correction; this gate
    # checks sane odometry, not loop-closed accuracy
    assert rmse < 0.12 * path, (rmse, path)

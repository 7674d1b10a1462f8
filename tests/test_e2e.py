"""End-to-end stereo odometry on a rendered synthetic world.

The Phase-1 gate (SURVEY §7): track a deterministic sequence with known
ground truth and assert ATE is small relative to trajectory length.
"""
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


def build_system():
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2),
                  bf=FX * BASELINE, width=W, height=H,
                  th_depth=BASELINE * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib,
        orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6),
        min_init_depth_points=100,
        max_frames_between_kf=8,
    )
    return System(cfg)


@pytest.mark.slow
def test_stereo_odometry_synthetic(rng):
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    n_frames = 30
    poses = synth.make_trajectory(n_frames, "arc")
    slam = build_system()

    pred = []
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BASELINE, H, W)
        T_cw = slam.track_stereo(im_l, im_r, timestamp=0.1 * i)
        pred.append(np.linalg.inv(T_cw))

    assert slam.state == "OK"
    assert slam.keyframes_in_map() >= 3
    assert slam.map_points_in_map() > 200

    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    est_xyz, gt_xyz = [], []
    # evaluate the RECORDED trajectory — what the reference saves and
    # scores (SaveTrajectoryKITTI + evaluate_ate_scale.py); the per-frame
    # return value is the pipeline's one-frame-ahead prediction
    for ts, Twc in slam.poses_wc():
        est_xyz.append(Twc[:3, 3])
        gt_xyz.append(gt_by_ts[round(ts, 6)][:3, 3])
    assert len(est_xyz) >= n_frames - 2
    est_xyz = np.stack(est_xyz)
    gt_xyz = np.stack(gt_xyz)
    path_len = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz)
    # gate: < 2% of trajectory length
    assert rmse < 0.02 * path_len, (rmse, path_len)
    # the streaming per-frame estimate stays within 4% (prediction error)
    pred_xyz = np.stack([T[:3, 3] for T in pred])
    gt_all = np.stack([T[:3, 3] for T in poses])
    assert ate_rmse(pred_xyz, gt_all) < 0.04 * path_len

    # trajectory export runs
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        slam.save_trajectory_kitti(os.path.join(d, "kitti.txt"))
        slam.save_trajectory_tum(os.path.join(d, "tum.txt"))
        assert len(open(os.path.join(d, "kitti.txt")).readlines()) == n_frames


def test_horn_alignment_identity(rng):
    X = rng.normal(size=(20, 3))
    assert ate_rmse(X, X) < 1e-12
    # known rigid offset
    from scipy.spatial.transform import Rotation
    R = Rotation.from_euler("xyz", [0.3, -0.2, 0.5]).as_matrix()
    Y = (R @ X.T).T + np.array([1.0, 2.0, 3.0])
    assert ate_rmse(X, Y) < 1e-9

"""Save a mapped world, reload into a fresh System, relocalize, keep
tracking (the reference's disabled atlas save/load, made real)."""
import os
import tempfile

import numpy as np
import pytest

from ms_slam.utils import synth
from ms_slam.utils.checkpoint import load_map, save_map

from test_loop_closing import np as _np  # noqa: F401


@pytest.mark.slow
def test_save_load_relocalize(rng):
    from ms_slam.models.map_state import MapConfig
    from ms_slam.ops.orb import OrbConfig
    from ms_slam.pipeline.frontend import Calib
    from ms_slam.pipeline.system import System, SystemConfig

    H, W, FX, BL = 240, 320, 260.0, 0.15
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 45, fps=10.0)

    def make():
        return System(SystemConfig(
            calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
            map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                          local_mp_cap=2048, window_kf=6,
                          grid_w=16, grid_h=12),
            min_init_depth_points=100, max_frames_between_kf=4,
            sparsify=True, sparsify_n=40, sparsify_window=4,
            sparsify_queue_min=2, nonlocal_kf=3, loop_closing=True))

    world = synth.BoxWorld(rng, half=7.0)
    poses = synth.make_trajectory(60, "orbit")[:30]
    slam = make()
    est = []
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        est.append(slam.track_stereo(im_l, im_r, 0.1 * i).copy())
    assert slam.state == "OK"
    slam.shutdown()  # sparsifies everything -> populates the database
    n_mp = slam.map_points_in_map()
    n_kf = slam.keyframes_in_map()
    assert n_mp > 100

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        save_map(path, slam)

        slam2 = make()
        load_map(path, slam2)
        assert slam2.map_points_in_map() == n_mp
        assert slam2.keyframes_in_map() == n_kf
        assert slam2.state == "LOST"

        # feed a frame from the mapped area: must relocalize, then the
        # next frame's local-map tracking refines the pose
        T_wc = poses[10]
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        slam2.track_stereo(im_l, im_r, 100.0)
        assert slam2.state == "OK"
        slam2.track_stereo(im_l, im_r, 100.1)
        slam2._flush_pipeline()        # complete the in-flight refinement
        assert slam2.state == "OK"
        # consistency with the original run's FINAL trajectory at that
        # frame (the map carries drift vs ground truth; frame entries are
        # recorded relative to reference keyframes whose poses keep moving
        # under BA, so agreement is bounded by the map's internal drift
        # band, not exact)
        final10 = [T for ts, T in slam.poses_wc()][10]
        err = np.linalg.norm(
            np.linalg.inv(slam2.current_pose())[:3, 3] - final10[:3, 3])
        # band recalibrated (0.4 -> 0.5) for the scale-aware keyframe
        # culling rule, which keeps slightly different keyframes
        assert err < 0.5, err

"""Long-sequence pool recycling: the fixed-capacity pools must survive
sequences that create several times more map points than the pool holds
(VERDICT r1 item 2; ref MapPoint::SetBadFlag actually frees memory,
/root/reference/src/MapPoint.cc:227-254 — our analog is the device-side
free-slot allocator in models/map_state.alloc_map_slots + the host keyframe
free-list)."""
import numpy as np
import pytest

from ms_slam.models.map_state import MapConfig
from ms_slam.ops.orb import OrbConfig
from ms_slam.pipeline.frontend import Calib
from ms_slam.pipeline.system import System, SystemConfig
from ms_slam.utils import synth

H, W, FX, BL = 192, 256, 210.0, 0.15
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


@pytest.mark.slow
def test_long_run_slot_recycling(rng):
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 40, fps=10.0)
    # pool deliberately small: the run must recycle slots to survive
    max_mp = 3072
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=256, n_levels=4),
        map=MapConfig(max_kf=96, max_mp=max_mp, n_feat=256,
                      local_mp_cap=1024, window_kf=6,
                      grid_w=16, grid_h=12),
        min_init_depth_points=60, max_frames_between_kf=4,
        sparsify=True, sparsify_n=25, sparsify_lambda=500.0,
        sparsify_window=8, sparsify_queue_min=4, nonlocal_kf=4)
    slam = System(cfg)
    # long corridor: forward motion, points continuously leave the frustum
    world = synth.CorridorWorld(rng, half_w=3.0, y_floor=1.6,
                                tex_scale=0.06)
    n_frames = 400
    poses = synth.make_trajectory(n_frames, "forward")

    ok_frames = 0
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        slam.track_stereo(im_l, im_r, 0.1 * i)
        ok_frames += slam.state == "OK"
    slam.shutdown()

    # survived: tracking healthy for the vast majority of the run
    assert slam.state == "OK"
    assert ok_frames > 0.9 * n_frames, ok_frames
    # created well beyond the pool capacity => slots were recycled
    assert slam.n_mp > 1.3 * max_mp, (slam.n_mp, max_mp)
    # the pool itself stays bounded and the sparsifier keeps it lean
    assert slam.map_points_in_map() <= max_mp
    # keyframe slots recycle too (more keyframes created than pool rows)
    assert slam.kf_ord > slam.n_kf, (slam.kf_ord, slam.n_kf)
    assert len(slam.kf_order) <= slam.n_kf
    # the newest keyframe still spawned fresh points (allocation never
    # starved at the end of the run)
    last = slam.kf_order[-1]
    import jax.numpy as jnp
    assert int(jnp.sum(slam.ms.obs_mp[last] >= 0)) > 20
    # sparsification actually compressed the survivors (the 256-feature
    # corridor has thin coverage; reference-scale >70% compression is
    # asserted by the dense-feature memory A/B test)
    stats = slam._sparsifier.stats
    assert stats["killed"] > 0.3 * (stats["killed"] + stats["kept"]), stats

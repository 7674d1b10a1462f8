"""Stereo-fisheye (two-camera KannalaBrandt8) frontend: lapping-area
matching + KB8 two-view triangulation, and end-to-end tracking on an
unrectified fisheye pair (ref Frame fisheye ctor with Nleft/Nright,
src/Frame.cc; KannalaBrandt8::matchAndtriangulate,
src/CameraModels/KannalaBrandt8.cpp; Camera1/2.overlappingBegin/End,
src/Settings.cc:263-333)."""
import numpy as np
import jax.numpy as jnp
import pytest

from ms_slam.models.map_state import MapConfig
from ms_slam.ops.orb import OrbConfig
from ms_slam.pipeline.frontend import Calib, process_stereo_fisheye
from ms_slam.pipeline.system import System, SystemConfig
from ms_slam.utils import synth
from ms_slam.utils.evaluate import ate_rmse

H, W = 240, 320
FX = 150.0
BL = 0.4
KB8P = (FX, FX, W / 2, H / 2, 0.02, -0.005, 0.001, -0.0002)


def fisheye_calib():
    # right camera at +x baseline in the left frame (pure translation):
    # X_r = X_l - [BL, 0, 0]
    T_rl = (1.0, 0.0, 0.0, -BL,
            0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 1.0, 0.0)
    return Calib(model=1, params=KB8P, bf=FX * BL, width=W, height=H,
                 th_depth=BL * 40, fps=10.0,
                 params2=KB8P, T_rl=T_rl,
                 lapping=(0, W - 1, 0, W - 1))


def test_fisheye_frontend_triangulates(rng):
    """The frontend's KB8 triangulated depths must match the rendered
    ground-truth geometry."""
    world = synth.BoxWorld(rng, half=6.0)
    T = np.eye(4)
    im_l, im_r = world.render_fisheye_stereo(KB8P, T, BL, H, W)
    calib = fisheye_calib()
    cfg = OrbConfig(n_features=512, n_levels=4)
    stacked = jnp.asarray(np.stack([im_l, im_r]).astype(np.uint8))
    fd = process_stereo_fisheye(stacked, calib, cfg)
    depth = np.asarray(fd.depth)
    xy = np.asarray(fd.feats.xy)
    ok = depth > 0
    assert ok.sum() > 100, ok.sum()
    # ground-truth depth at each matched feature: re-render ray depths
    rays = synth.kb8_rays(KB8P, H, W)
    d = rays @ T[:3, :3].T
    Ow = T[:3, 3]
    gt_depth = np.full((H, W), np.inf)
    for ax, val, _, _ in world.iter_planes():
        da = d[..., ax]
        da_s = np.where(np.abs(da) > 1e-9, da, 1e-9)
        t = np.where(np.abs(da) > 1e-9, (val - Ow[ax]) / da_s, -1)
        okp = (t > 0.1) & (t < gt_depth)
        gt_depth = np.where(okp, t, gt_depth)
    # depth = z in cam frame = t * ray_z = t (rays have z=1)
    ui = np.clip(np.round(xy[ok, 0]).astype(int), 0, W - 1)
    vi = np.clip(np.round(xy[ok, 1]).astype(int), 0, H - 1)
    gt = gt_depth[vi, ui]
    rel = np.abs(depth[ok] - gt) / gt
    # accuracy bound set by the rig geometry: disparity ~ fx*B/z ~ 10 px
    # at depth 6, so sub-pixel keypoint noise costs ~5% depth
    assert np.median(rel) < 0.07, np.median(rel)
    assert (rel < 0.15).mean() > 0.75, (rel < 0.15).mean()


@pytest.mark.slow
def test_fisheye_stereo_tracks_end_to_end(rng):
    """A synthetic fisheye stereo sequence tracks end-to-end with
    Camera.type KannalaBrandt8 and NO rectification."""
    calib = fisheye_calib()
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6),
        min_init_depth_points=100, max_frames_between_kf=8)
    slam = System(cfg)
    world = synth.BoxWorld(rng, half=6.0)
    poses = synth.make_trajectory(25, "arc")
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_fisheye_stereo(KB8P, T_wc, BL, H, W)
        slam.track_stereo(im_l, im_r, 0.1 * i)
    slam._flush_pipeline()
    assert slam.state == "OK", slam.state
    assert slam.keyframes_in_map() >= 2
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est_xyz = np.stack([T[:3, 3] for _, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz)
    assert rmse < 0.03 * path, (rmse, path)

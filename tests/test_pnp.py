"""Prior-free PnP RANSAC (MLPnPsolver analog, ref src/MLPnPsolver.cpp)."""
import jax
import jax.numpy as jnp
import numpy as np

from ms_slam.ops import cameras, pnp
from ms_slam.ops.lie import se3_apply
from scipy.spatial.transform import Rotation

PIN = cameras.pad_params([300.0, 300.0, 160.0, 120.0])


def _make_scene(rng, n=200, outlier_frac=0.3, noise=0.3):
    X = rng.uniform(-4, 4, (n, 3))
    X[:, 2] += 9.0
    R = Rotation.from_euler("xyz", [0.4, -0.7, 0.25]).as_matrix()
    t = np.array([0.6, -0.4, 1.2])
    Xc = (R @ X.T).T + t
    uv = np.array(cameras.project(0, PIN, jnp.asarray(Xc)))
    uv += rng.normal(0, noise, uv.shape)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(-80, 80, (n_out, 2))
    return X, uv, R, t, out_idx


def test_pnp_recovers_pose_far_from_prior(rng):
    X, uv, R, t, out_idx = _make_scene(rng)
    res = pnp.pnp_ransac(
        0, PIN, jnp.asarray(X), jnp.asarray(uv),
        jnp.ones(len(X)), jnp.ones(len(X), bool), jax.random.PRNGKey(1))
    assert bool(res.ok)
    assert np.allclose(np.asarray(res.R), R, atol=5e-3), res.R
    assert np.allclose(np.asarray(res.t), t, atol=2e-2)
    # outliers rejected
    inl = np.asarray(res.inlier)
    assert not inl[out_idx].any() or inl[out_idx].mean() < 0.1


def test_pnp_rejects_degenerate(rng):
    # pure noise correspondences: must not report a confident pose
    X = rng.uniform(-4, 4, (100, 3)); X[:, 2] += 9.0
    uv = rng.uniform(0, 320, (100, 2))
    res = pnp.pnp_ransac(0, PIN, jnp.asarray(X), jnp.asarray(uv),
                         jnp.ones(100), jnp.ones(100, bool),
                         jax.random.PRNGKey(2), min_inliers=25)
    assert not bool(res.ok)


import pytest


@pytest.mark.slow
def test_relocalization_far_from_keyframes(rng):
    """Relocalize from a pose far (in rotation + translation) from EVERY
    stored keyframe pose — impossible with prior-seeded refinement, needs
    the prior-free PnP (ref MLPnPsolver use, src/Tracking.cc:3688-3713).
    Also exercises reloc WITHOUT loop closing (sparsify-only database)."""
    from ms_slam.models.map_state import MapConfig
    from ms_slam.ops.orb import OrbConfig
    from ms_slam.pipeline.frontend import Calib
    from ms_slam.pipeline.system import System, SystemConfig
    from ms_slam.utils import synth

    H, W, FX, BL = 240, 320, 260.0, 0.15
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 45, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6,
                      grid_w=16, grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=4,
        sparsify=True, sparsify_n=60, sparsify_window=4,
        sparsify_queue_min=2, nonlocal_kf=3,
        loop_closing=False)          # reloc must work without the closer
    slam = System(cfg)
    world = synth.BoxWorld(rng, half=7.0)
    poses = synth.make_trajectory(80, "orbit")[:25]
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        slam.track_stereo(im_l, im_r, 0.1 * i)
    slam.shutdown()                  # sparsifies -> populates the database
    assert slam.kf_db is not None and slam.kf_db.present.any()

    # query pose: 25 deg yaw + 0.5 m off any trajectory pose
    T_q = poses[12].copy()
    T_q[:3, :3] = T_q[:3, :3] @ Rotation.from_euler(
        "y", np.deg2rad(25)).as_matrix()
    T_q[:3, 3] += np.array([0.35, -0.1, 0.3])
    im_l, im_r = world.render_stereo(K, T_q, BL, H, W)
    slam.state = "LOST"
    slam._lost_frames = 0
    slam.vel = None
    slam.track_stereo(im_l, im_r, 99.0)
    assert slam.state == "OK"
    c_est = np.linalg.inv(slam.current_pose())[:3, 3]
    err = np.linalg.norm(c_est - T_q[:3, 3])
    # bounded by the map's own drift, not by prior distance
    assert err < 0.35, err

"""Two-view reconstruction: essential + homography paths and model
selection (ref TwoViewReconstruction::Reconstruct — parallel H/F RANSAC,
RH score-ratio selection, ReconstructH Faugeras decomposition,
/root/reference/src/TwoViewReconstruction.cc:114-127,571;
include/TwoViewReconstruction.h:57-60)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation

from ms_slam.ops import twoview

FX, W, H = 260.0, 320, 240
PARAMS = jnp.asarray([FX, FX, W / 2, H / 2])


def _project(X, R, t):
    Xc = X @ R.T + t
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + W / 2,
                     FX * Xc[:, 1] / Xc[:, 2] + H / 2], -1), Xc[:, 2]


def _run_case(rng, X, R2, t2, noise=0.3):
    xy1, z1 = _project(X, np.eye(3), np.zeros(3))
    xy2, z2 = _project(X, R2, t2)
    ok = ((z1 > 0.1) & (z2 > 0.1)
          & (xy1[:, 0] > 0) & (xy1[:, 0] < W)
          & (xy1[:, 1] > 0) & (xy1[:, 1] < H)
          & (xy2[:, 0] > 0) & (xy2[:, 0] < W)
          & (xy2[:, 1] > 0) & (xy2[:, 1] < H))
    xy1 = xy1 + rng.normal(0, noise, xy1.shape)
    xy2 = xy2 + rng.normal(0, noise, xy2.shape)
    res = twoview.reconstruct(0, PARAMS, jnp.asarray(xy1),
                              jnp.asarray(xy2), jnp.asarray(ok),
                              jax.random.PRNGKey(3))
    t_gt = t2 / np.linalg.norm(t2)
    R_est, t_est = np.asarray(res.R), np.asarray(res.t)
    rot_err = np.degrees(np.arccos(np.clip(
        (np.trace(R_est @ R2.T) - 1) / 2, -1, 1)))
    t_err = np.degrees(np.arccos(np.clip(abs(t_est @ t_gt), -1, 1)))
    return bool(res.ok), rot_err, t_err


def test_general_scene_recovers_motion(rng):
    N = 400
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  rng.uniform(6, 16, N)], -1)
    R2 = Rotation.from_euler("y", 0.05).as_matrix()
    t2 = np.array([-0.6, 0.05, 0.1])
    ok, rot_err, t_err = _run_case(rng, X, R2, t2)
    assert ok
    assert rot_err < 1.0, rot_err
    assert t_err < 5.0, t_err


def test_planar_scene_homography_path(rng):
    """Fronto-planar scene: the fundamental-matrix decomposition is
    ambiguous (all points on one plane), the homography path must carry
    the initialization (ref ReconstructH)."""
    N = 400
    X = np.stack([rng.uniform(-5, 5, N), rng.uniform(-4, 4, N),
                  np.full(N, 10.0)], -1)
    R2 = Rotation.from_euler("y", 0.05).as_matrix()
    t2 = np.array([-0.6, 0.05, 0.1])
    ok, rot_err, t_err = _run_case(rng, X, R2, t2)
    assert ok, "planar init must succeed via the homography family"
    assert rot_err < 1.0, rot_err
    assert t_err < 5.0, t_err


def test_pure_rotation_rejected(rng):
    """No parallax: neither family may report a confident reconstruction
    (ref Reconstruct fails on insufficient parallax and init retries)."""
    N = 400
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                  rng.uniform(6, 16, N)], -1)
    R2 = Rotation.from_euler("y", 0.08).as_matrix()
    t2 = np.zeros(3)
    xy1, _ = _project(X, np.eye(3), np.zeros(3))
    xy2, z2 = _project(X, R2, t2)
    ok = ((z2 > 0.1)
          & (xy2[:, 0] > 0) & (xy2[:, 0] < W)
          & (xy2[:, 1] > 0) & (xy2[:, 1] < H))
    res = twoview.reconstruct(0, PARAMS, jnp.asarray(xy1),
                              jnp.asarray(xy2), jnp.asarray(ok),
                              jax.random.PRNGKey(3))
    assert not bool(res.ok)


def test_homography_decomposition_exact():
    """Faugeras decomposition recovers (R, t) from an exact plane-induced
    homography H = R + t n^T / d."""
    R = Rotation.from_euler("yxz", [0.2, -0.1, 0.05]).as_matrix()
    t = np.array([0.3, -0.1, 0.2])
    n = np.array([0.1, -0.05, 1.0])
    n = n / np.linalg.norm(n)
    d = 5.0
    Hm = R + np.outer(t, n) / d
    Rs, ts = twoview._decompose_homography(jnp.asarray(Hm))
    t_u = t / np.linalg.norm(t)
    errs = []
    for k in range(8):
        rot_err = np.degrees(np.arccos(np.clip(
            (np.trace(np.asarray(Rs[k]) @ R.T) - 1) / 2, -1, 1)))
        t_err = np.degrees(np.arccos(np.clip(
            abs(np.asarray(ts[k]) @ t_u), -1, 1)))
        errs.append((rot_err, t_err))
    best = min(errs, key=lambda e: e[0] + e[1])
    assert best[0] < 0.1 and best[1] < 0.1, errs


@pytest.mark.slow
def test_mono_init_on_planar_world(rng):
    """End-to-end: monocular initialization on a pure fronto-planar world
    (wall only, no floor) — the regime the homography model exists for."""
    from ms_slam.models.map_state import MapConfig
    from ms_slam.ops.orb import OrbConfig
    from ms_slam.pipeline.frontend import Calib
    from ms_slam.pipeline.system import System, SystemConfig
    from ms_slam.utils import synth
    from ms_slam.utils.evaluate import ate_rmse

    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=0.0,
                  width=W, height=H, th_depth=0.0, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512,
                      local_mp_cap=2048, window_kf=6),
        max_frames_between_kf=8)
    slam = System(cfg)
    # wall only: floor pushed out of every view
    world = synth.PlaneWorld(rng, z_wall=10.0, y_floor=1e5)
    n_frames = 30
    poses = []
    for i in range(n_frames):
        T = np.eye(4)
        s = i / (n_frames - 1)
        T[:3, 3] = [1.5 * s, 0.2 * np.sin(2 * np.pi * s), 0.5 * s]
        poses.append(T)
    for i, T_wc in enumerate(poses):
        img = world.render(K, T_wc, H, W)
        slam.track_monocular(img, 0.1 * i)
    assert slam.state == "OK", slam.state
    assert slam.keyframes_in_map() >= 2
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est_xyz = np.stack([T[:3, 3] for _, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    rmse = ate_rmse(est_xyz, gt_xyz, with_scale=True)
    assert rmse < 0.12 * path, (rmse, path)

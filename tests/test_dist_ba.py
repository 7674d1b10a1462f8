"""Distributed BA on virtual CPU meshes must match the single-device
solver."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ms_slam.ops import ba, cameras
from ms_slam.parallel import dist_ba

from test_ba import make_bundle, PIN, BF


@pytest.mark.parametrize("n_dev", [4, 8])
def test_dist_matches_single(rng, n_dev):
    assert len(jax.devices()) >= n_dev
    Rs, ts, P, f_cam, f_pt, f_uv, f_ur, F = make_bundle(rng, n_cams=5,
                                                        n_pts=120)
    # pad factor table to a multiple of n_dev for even sharding
    pad = (-F) % n_dev
    f_cam = np.pad(f_cam, (0, pad))
    f_pt = np.pad(f_pt, (0, pad))
    f_uv = np.pad(f_uv, ((0, pad), (0, 0)))
    f_ur = np.pad(f_ur, (0, pad), constant_values=-1.0)
    f_valid = np.zeros(F + pad, bool)
    f_valid[:F] = True
    sigma2 = np.ones(F + pad)

    n_cams, n_pts = Rs.shape[0], P.shape[0]
    cam_opt = np.ones(n_cams, bool)
    cam_opt[:2] = False
    Rp = Rs.copy()
    tp = ts + np.concatenate(
        [np.zeros((2, 3)), rng.normal(0, 0.05, (n_cams - 2, 3))])
    Pp = P + rng.normal(0, 0.02, P.shape)

    args = (jnp.asarray(Rp), jnp.asarray(tp), jnp.asarray(cam_opt),
            jnp.asarray(Pp), jnp.ones(n_pts, bool))
    fargs = (jnp.asarray(f_cam), jnp.asarray(f_pt), jnp.asarray(f_uv),
             jnp.asarray(f_ur), jnp.asarray(sigma2), jnp.asarray(f_valid))

    mesh = dist_ba.make_mesh(n_dev)
    R_d, t_d, P_d, _ = dist_ba.dist_ba_solve(
        mesh, cameras.PINHOLE, PIN, BF, *args, *fargs, n_iters=6)

    # reference: single-device ba_solve has a two-stage schedule, so compare
    # against a straight run of the same math by using dist solve on a
    # 1-device mesh
    mesh1 = dist_ba.make_mesh(1)
    R_1, t_1, P_1, _ = dist_ba.dist_ba_solve(
        mesh1, cameras.PINHOLE, PIN, BF, *args, *fargs, n_iters=6)

    np.testing.assert_allclose(R_d, R_1, atol=1e-8)
    np.testing.assert_allclose(t_d, t_1, atol=1e-8)
    np.testing.assert_allclose(P_d, P_1, atol=1e-8)

    # and it actually solves the problem
    for c in range(2, n_cams):
        dt_err = np.linalg.norm(np.asarray(t_d[c]) - ts[c])
        assert dt_err < 0.02, (c, dt_err)


def _total_chi2(ms, calib, orb_cfg):
    """Total weighted reprojection chi2 over all valid observations."""
    from ms_slam.pipeline.mapping_ops import _scale2

    K, N = ms.obs_mp.shape
    obs = np.asarray(ms.obs_mp)
    valid = ((obs >= 0) & np.asarray(ms.kf_valid)[:, None]
             & np.asarray(ms.kp_valid))
    R = np.asarray(ms.kf_R)[:, None].repeat(N, 1).reshape(K * N, 3, 3)
    t = np.asarray(ms.kf_t)[:, None].repeat(N, 1).reshape(K * N, 3)
    X = np.asarray(ms.mp_pos)[np.clip(obs, 0, None).reshape(-1)]
    Xc = np.einsum("fij,fj->fi", R, X) + t
    fx, fy, cx, cy = (100.0, 100.0, 50.0, 50.0)
    z = np.maximum(Xc[:, 2], 1e-6)
    u = fx * Xc[:, 0] / z + cx
    v = fy * Xc[:, 1] / z + cy
    uv = np.asarray(ms.kp_xy).reshape(K * N, 2)
    s2 = np.asarray(_scale2(orb_cfg))[
        np.asarray(ms.kp_octave).reshape(-1)]
    e2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / s2
    return float(np.sum(e2[valid.reshape(-1)]))


def test_pipeline_dist_global_ba_solves():
    """The pipeline's sharded post-loop global BA (dist_global_ba, used by
    LoopCloser when SystemConfig.dist_ba_devices > 1): the 8-device and
    1-device meshes must both drive the map's reprojection cost down to the
    same level. (Bitwise pose equality across mesh sizes is NOT asserted:
    the reduced camera system is solved with preconditioned CG, and Krylov
    iterations in f32 are sensitive to psum reduction order in the
    weakly-determined gauge subspace; f64 exactness across meshes is
    covered by test_dist_matches_single.)"""
    from ms_slam.models import map_state as M
    from ms_slam.ops.orb import OrbConfig as _OC
    from ms_slam.pipeline.frontend import Calib

    rng = np.random.default_rng(11)
    # consistent bundle in a MapState: 4 cams each observing 16 points at
    # their exact projections, then poses/points perturbed
    cfg_m = M.MapConfig(max_kf=8, max_mp=64, n_feat=16)
    ms = M.empty_map(cfg_m)
    fx, fy, cx, cy = 100.0, 100.0, 50.0, 50.0
    X = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    X[:, 2] += 8.0
    for k in range(4):
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.3 * k, 0.05 * k, 0.1 * k], np.float32)
        Xc = X @ R.T + t
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                       fy * Xc[:, 1] / Xc[:, 2] + cy], -1).astype(np.float32)
        dt_k = np.zeros(3) if k == 0 else rng.normal(0, 0.05, 3)
        ms = M.insert_keyframe(
            ms, jnp.asarray(k), jnp.asarray(R),
            jnp.asarray((t + dt_k).astype(np.float32)),
            jnp.asarray(uv), jnp.zeros(16, jnp.int32),
            jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint32)),
            jnp.full(16, -1.0), jnp.full(16, -1.0),
            jnp.ones(16, bool), jnp.arange(16, dtype=jnp.int32),
            jnp.asarray(k))
    ms = M.add_map_points(
        ms, jnp.arange(16), jnp.ones(16, bool),
        jnp.asarray(X + rng.normal(0, 0.03, X.shape).astype(np.float32)),
        jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint32)),
        jnp.zeros((16, 3)), jnp.zeros(16), jnp.full(16, 100.0),
        jnp.zeros(16, jnp.int32))
    calib = Calib(model=cameras.PINHOLE, params=(fx, fy, cx, cy),
                  bf=15.0, width=100, height=100, th_depth=6.0, fps=10.0)
    orb_cfg = _OC(n_features=16, n_levels=4)

    c0 = _total_chi2(ms, calib, orb_cfg)
    mesh8 = dist_ba.make_mesh(8)
    mesh1 = dist_ba.make_mesh(1)
    ms8 = dist_ba.dist_global_ba(ms, calib, orb_cfg, 0, mesh8, n_iters=6)
    ms1 = dist_ba.dist_global_ba(ms, calib, orb_cfg, 0, mesh1, n_iters=6)
    c8 = _total_chi2(ms8, calib, orb_cfg)
    c1 = _total_chi2(ms1, calib, orb_cfg)
    # both shardings converge (small_map perturbs a perfect bundle, so the
    # optimum is near zero reprojection cost)
    assert c8 < 0.05 * c0, (c8, c0)
    assert c1 < 0.05 * c0, (c1, c0)
    # and to the same quality
    assert abs(c8 - c1) < 0.02 * c0 + 1e-6, (c8, c1, c0)


def test_dist_ba_devices_beyond_mesh_raises():
    """Asking for more BA devices than exist is an error at construction,
    not a silent fall-back to the single-device solve."""
    from ms_slam.models.map_state import MapConfig
    from ms_slam.ops.orb import OrbConfig
    from ms_slam.pipeline.frontend import Calib
    from ms_slam.pipeline.system import System, SystemConfig

    calib = Calib(model=cameras.PINHOLE, params=(100.0, 100.0, 50.0, 50.0),
                  bf=15.0, width=100, height=100, th_depth=6.0, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=128, n_levels=4),
        map=MapConfig(max_kf=8, max_mp=256, n_feat=128, local_mp_cap=128),
        loop_closing=True, dist_ba_devices=len(jax.devices()) + 1)
    with pytest.raises(ValueError, match="dist_ba_devices"):
        System(cfg)

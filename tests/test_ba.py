import jax.numpy as jnp
import numpy as np

from ms_slam.ops import ba, cameras, lie

PIN = cameras.pad_params([400.0, 400.0, 320.0, 240.0])
BF = 40.0


def make_bundle(rng, n_cams=6, n_pts=200, noise=0.2):
    """Cameras on an arc looking at a point cloud."""
    P = rng.uniform(-5, 5, size=(n_pts, 3)).astype(np.float64)
    P[:, 2] += 12.0
    Rs, ts = [], []
    for c in range(n_cams):
        xi = np.array([0.8 * c, 0.05 * c, 0.02 * c,
                       0.01 * c, 0.03 * c, -0.01 * c]) * 0.3
        R, t = lie.se3_exp(jnp.asarray(xi))
        Rs.append(np.asarray(R))
        ts.append(np.asarray(t))
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    f_cam, f_pt, f_uv, f_ur = [], [], [], []
    for c in range(n_cams):
        Xc = (Rs[c] @ P.T).T + ts[c]
        uv = np.asarray(cameras.pinhole_project(PIN, jnp.asarray(Xc)))
        vis = (Xc[:, 2] > 1) & (uv[:, 0] > 0) & (uv[:, 0] < 640) & \
              (uv[:, 1] > 0) & (uv[:, 1] < 480)
        for p in np.where(vis)[0]:
            f_cam.append(c)
            f_pt.append(p)
            f_uv.append(uv[p] + rng.normal(0, noise, 2))
            f_ur.append(uv[p, 0] - BF / Xc[p, 2] + rng.normal(0, noise))
    F = len(f_cam)
    return (Rs, ts, P,
            np.asarray(f_cam, np.int32), np.asarray(f_pt, np.int32),
            np.asarray(f_uv, np.float64), np.asarray(f_ur, np.float64), F)


class TestBA:
    def test_converges_to_ground_truth(self, rng):
        Rs, ts, P, f_cam, f_pt, f_uv, f_ur, F = make_bundle(rng)
        n_cams, n_pts = Rs.shape[0], P.shape[0]
        # perturb all but the first two cameras (gauge) and all points
        Rp, tp = Rs.copy(), ts.copy()
        for c in range(2, n_cams):
            xi = rng.normal(0, 0.02, 6)
            dR, dt_ = lie.se3_exp(jnp.asarray(xi))
            Rp[c] = np.asarray(dR) @ Rs[c]
            tp[c] = np.asarray(dR) @ ts[c] + np.asarray(dt_)
        Pp = P + rng.normal(0, 0.05, P.shape)
        cam_opt = np.ones(n_cams, bool)
        cam_opt[:2] = False

        res = ba.ba_solve(
            cameras.PINHOLE, PIN, jnp.asarray(BF),
            jnp.asarray(Rp), jnp.asarray(tp), jnp.asarray(cam_opt),
            jnp.asarray(Pp), jnp.ones(n_pts, bool),
            jnp.asarray(f_cam), jnp.asarray(f_pt), jnp.asarray(f_uv),
            jnp.asarray(f_ur), jnp.ones(F), jnp.ones(F, bool),
            n_iters=15)

        for c in range(2, n_cams):
            dR = np.asarray(res.kf_R[c]) @ Rs[c].T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            dt_err = np.linalg.norm(np.asarray(res.kf_t[c]) - ts[c])
            assert ang < 0.1, (c, ang)
            assert dt_err < 0.03, (c, dt_err)
        # points: median error small
        perr = np.linalg.norm(np.asarray(res.mp_pos) - P, axis=1)
        assert np.median(perr) < 0.06, np.median(perr)  # ~noise floor at 0.2px
        # most factors inliers
        assert int(jnp.sum(res.f_inlier)) > 0.85 * F

    def test_fixed_cameras_unchanged(self, rng):
        Rs, ts, P, f_cam, f_pt, f_uv, f_ur, F = make_bundle(rng, n_cams=4)
        n_cams, n_pts = Rs.shape[0], P.shape[0]
        cam_opt = np.zeros(n_cams, bool)  # everything fixed
        res = ba.ba_solve(
            cameras.PINHOLE, PIN, jnp.asarray(BF),
            jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(cam_opt),
            jnp.asarray(P), jnp.zeros(n_pts, bool),
            jnp.asarray(f_cam), jnp.asarray(f_pt), jnp.asarray(f_uv),
            jnp.asarray(f_ur), jnp.ones(F), jnp.ones(F, bool), n_iters=3)
        np.testing.assert_allclose(res.kf_R, Rs, atol=1e-12)
        np.testing.assert_allclose(res.mp_pos, P, atol=1e-12)


def test_duplicate_factor_keeps_lowest_index():
    """Camera-blocked solve: of two factors for the same (point, camera)
    pair, the LOWER factor index survives and the other is flagged as an
    outlier, on every backend (scatter-min, not a scatter-set whose winner
    is implementation-defined)."""
    from ms_slam.utils.parity import ba_window
    args = list(ba_window(n_cams=3, n_feat=32, n_pts=40, seed=3))
    f_pt, f_uv, f_ur, f_valid = args[8], args[9], args[10], args[12]
    lo, hi = 32 + 2, 32 + 5             # two slots of camera 1
    f_pt[hi], f_uv[hi], f_ur[hi] = f_pt[lo], f_uv[lo] + 0.3, f_ur[lo] + 0.3
    assert f_valid[lo] and f_valid[hi]
    res = ba.ba_solve(cameras.PINHOLE, *[jnp.asarray(a) for a in args],
                      n_iters=3, cam_blocked=True)
    inl = np.asarray(res.f_inlier)
    assert inl[lo] and not inl[hi]
    assert inl[f_valid].sum() >= f_valid.sum() - 3

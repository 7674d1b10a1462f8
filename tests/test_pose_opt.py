import jax.numpy as jnp
import numpy as np

from ms_slam.ops import cameras, lie, pose_opt

PIN = cameras.pad_params([500.0, 500.0, 320.0, 240.0])
BF = 50.0  # baseline*fx


def make_problem(rng, n=256, noise=0.3, outlier_frac=0.1, stereo=True):
    X = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 20, size=n)
    xi_true = np.array([0.2, -0.1, 0.05, 0.03, -0.02, 0.04], np.float32)
    R, t = lie.se3_exp(jnp.asarray(xi_true))
    Xc = lie.se3_apply(R, t, jnp.asarray(X))
    uv = cameras.pinhole_project(PIN, Xc)
    ur = uv[:, 0] - BF / Xc[:, 2]
    uv = np.asarray(uv) + rng.normal(0, noise, size=(n, 2))
    ur = np.asarray(ur) + rng.normal(0, noise, size=n)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(20, 80, size=(n_out, 2))
    if not stereo:
        ur = np.full(n, -1.0, np.float32)
    return (jnp.asarray(X), jnp.asarray(uv.astype(np.float32)),
            jnp.asarray(ur.astype(np.float32)), (R, t), xi_true)


class TestPoseOptimize:
    def _run(self, rng, stereo):
        X, uv, ur, (R_true, t_true), xi_true = make_problem(rng, stereo=stereo)
        n = X.shape[0]
        # perturbed init
        xi0 = xi_true + np.array([0.1, -0.05, 0.08, 0.02, 0.03, -0.02], np.float32)
        R0, t0 = lie.se3_exp(jnp.asarray(xi0))
        res = pose_opt.pose_optimize(
            cameras.PINHOLE, PIN, jnp.asarray(BF), R0, t0, X, uv, ur,
            sigma2=jnp.ones(n), mask=jnp.ones(n, bool))
        # pose error
        dR = np.asarray(res.R) @ np.asarray(R_true).T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        dt = np.linalg.norm(np.asarray(res.t) - np.asarray(t_true))
        return ang, dt, int(res.n_inliers)

    def test_stereo_recovery(self, rng):
        ang, dt, n_in = self._run(rng, stereo=True)
        assert ang < 0.1, ang
        assert dt < 0.02, dt
        assert n_in > 180, n_in

    def test_mono_recovery(self, rng):
        ang, dt, n_in = self._run(rng, stereo=False)
        assert ang < 0.15, ang
        assert dt < 0.05, dt
        assert n_in > 180, n_in

    def test_outliers_rejected(self, rng):
        X, uv, ur, (R_true, t_true), xi_true = make_problem(
            rng, outlier_frac=0.3)
        n = X.shape[0]
        R0, t0 = lie.se3_exp(jnp.asarray(xi_true))  # start at truth
        res = pose_opt.pose_optimize(
            cameras.PINHOLE, PIN, jnp.asarray(BF), R0, t0, X, uv, ur,
            sigma2=jnp.ones(n), mask=jnp.ones(n, bool))
        # ~30% outliers should be excluded
        assert int(res.n_inliers) < 0.8 * n
        dR = np.asarray(res.R) @ np.asarray(R_true).T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.1, ang

"""Preintegration vs direct numerical integration of ground-truth motion."""
import jax.numpy as jnp
import numpy as np

from ms_slam.ops import imu, lie

G = np.array([0.0, 0.0, -imu.GRAVITY])


def simulate(rng, n=200, dt=0.005, bg=None, ba=None):
    """Simulate a moving body; returns true states and perfect IMU samples."""
    bg = np.zeros(3) if bg is None else bg
    ba = np.zeros(3) if ba is None else ba
    R = np.eye(3)
    v = np.array([0.3, -0.1, 0.2])
    p = np.zeros(3)
    meas = []
    Rs, vs, ps = [R.copy()], [v.copy()], [p.copy()]
    for k in range(n):
        t = k * dt
        omega = np.array([0.4 * np.sin(t), 0.3, -0.2 * np.cos(t)])
        a_w = np.array([0.5 * np.cos(t), 0.2, 0.4 * np.sin(2 * t)])  # world
        a_body = R.T @ (a_w - G)
        meas.append([dt, *(a_body + ba), *(omega + bg)])
        # integrate truth with the same discretization as preintegration
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ np.asarray(lie.so3_exp(jnp.asarray(omega * dt)))
        Rs.append(R.copy())
        vs.append(v.copy())
        ps.append(p.copy())
    return (np.asarray(meas), Rs, vs, ps)


class TestPreintegration:
    def test_matches_truth_zero_bias(self, rng):
        meas, Rs, vs, ps = simulate(rng)
        n = meas.shape[0]
        st = imu.integrate(jnp.zeros(6), jnp.asarray(meas),
                           jnp.ones(n, bool),
                           jnp.asarray(1e-3), jnp.asarray(1e-2),
                           jnp.asarray(1e-6), jnp.asarray(1e-5))
        R2, v2, p2 = imu.predict_state(
            st, jnp.asarray(Rs[0]), jnp.asarray(vs[0]), jnp.asarray(ps[0]),
            jnp.zeros(3), jnp.zeros(3))
        np.testing.assert_allclose(R2, Rs[-1], atol=1e-5)
        np.testing.assert_allclose(v2, vs[-1], atol=1e-4)
        np.testing.assert_allclose(p2, ps[-1], atol=1e-4)
        # residual at the true states is ~0
        r = imu.inertial_residual(
            st, jnp.asarray(Rs[0]), jnp.asarray(vs[0]), jnp.asarray(ps[0]),
            jnp.asarray(Rs[-1]), jnp.asarray(vs[-1]), jnp.asarray(ps[-1]),
            jnp.zeros(3), jnp.zeros(3))
        assert float(jnp.max(jnp.abs(r))) < 1e-4

    def test_masked_rows_ignored(self, rng):
        meas, *_ = simulate(rng, n=50)
        pad = np.zeros((30, 7))
        both = np.concatenate([meas, pad])
        valid = np.arange(80) < 50
        st1 = imu.integrate(jnp.zeros(6), jnp.asarray(meas),
                            jnp.ones(50, bool), jnp.asarray(1e-3),
                            jnp.asarray(1e-2), jnp.asarray(1e-6),
                            jnp.asarray(1e-5))
        st2 = imu.integrate(jnp.zeros(6), jnp.asarray(both),
                            jnp.asarray(valid), jnp.asarray(1e-3),
                            jnp.asarray(1e-2), jnp.asarray(1e-6),
                            jnp.asarray(1e-5))
        np.testing.assert_allclose(st1.dP, st2.dP, atol=1e-12)
        np.testing.assert_allclose(st1.dR, st2.dR, atol=1e-12)

    def test_bias_jacobian_accuracy(self, rng):
        """First-order bias correction must track reintegration."""
        meas, Rs, vs, ps = simulate(rng, n=100)
        n = meas.shape[0]
        args = (jnp.ones(n, bool), jnp.asarray(1e-3), jnp.asarray(1e-2),
                jnp.asarray(1e-6), jnp.asarray(1e-5))
        st0 = imu.integrate(jnp.zeros(6), jnp.asarray(meas), *args)
        db = np.array([0.002, -0.001, 0.003, 0.01, -0.02, 0.015])
        # exact: reintegrate with biases subtracted
        st1 = imu.integrate(jnp.asarray(-db), jnp.asarray(meas), *args)
        # first-order correction from st0
        dR_corr = imu.delta_rotation(st0, jnp.asarray(-db[:3]))
        dV_corr = imu.delta_velocity(st0, jnp.asarray(-db[:3]),
                                     jnp.asarray(-db[3:]))
        dP_corr = imu.delta_position(st0, jnp.asarray(-db[:3]),
                                     jnp.asarray(-db[3:]))
        np.testing.assert_allclose(dR_corr, st1.dR, atol=5e-4)
        np.testing.assert_allclose(dV_corr, st1.dV, atol=5e-3)
        np.testing.assert_allclose(dP_corr, st1.dP, atol=5e-3)

    def test_covariance_grows(self, rng):
        meas, *_ = simulate(rng, n=100)
        st = imu.integrate(jnp.zeros(6), jnp.asarray(meas),
                           jnp.ones(100, bool), jnp.asarray(1e-3),
                           jnp.asarray(1e-2), jnp.asarray(1e-6),
                           jnp.asarray(1e-5))
        C9 = np.asarray(st.C[:9, :9])
        assert np.all(np.linalg.eigvalsh(C9) > 0)
        info = np.asarray(imu.information(st))
        assert np.isfinite(info).all()

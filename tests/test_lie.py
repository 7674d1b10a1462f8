import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ms_slam.ops import lie



def rand_w(rng, n=32, scale=2.0):
    return jnp.asarray(rng.normal(size=(n, 3)) * scale)


class TestSO3:
    def test_exp_log_roundtrip(self, rng):
        w = rand_w(rng, scale=1.0)
        R = lie.so3_exp(w)
        w2 = lie.so3_log(R)
        np.testing.assert_allclose(w, w2, atol=1e-9)

    def test_exp_is_rotation(self, rng):
        w = rand_w(rng)
        R = lie.so3_exp(w)
        eye = jnp.broadcast_to(jnp.eye(3), R.shape)
        np.testing.assert_allclose(R @ jnp.swapaxes(R, -1, -2), eye, atol=1e-12)
        np.testing.assert_allclose(jnp.linalg.det(R), 1.0, atol=1e-12)

    def test_small_angle(self):
        w = jnp.array([[1e-10, 0, 0], [0.0, 0, 0]])
        R = lie.so3_exp(w)
        np.testing.assert_allclose(R[1], jnp.eye(3), atol=1e-15)
        # gradient finite at zero
        g = jax.grad(lambda w: jnp.sum(lie.so3_exp(w)))(jnp.zeros(3))
        assert np.all(np.isfinite(g))

    def test_log_near_pi(self, rng):
        axis = rng.normal(size=(8, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        w = jnp.asarray(axis * (np.pi - 1e-7))
        R = lie.so3_exp(w)
        w2 = lie.so3_log(R)
        np.testing.assert_allclose(w, w2, atol=1e-5)

    def test_quat_roundtrip(self, rng):
        w = rand_w(rng)
        R = lie.so3_exp(w)
        q = lie.rot_to_quat(R)
        R2 = lie.quat_to_rot(q)
        np.testing.assert_allclose(R, R2, atol=1e-10)

    def test_right_jacobian_fd(self, rng):
        """J_r: exp(w + dw) ~ exp(w) exp(J_r dw)."""
        w = jnp.asarray(rng.normal(size=3))
        Jr = lie.so3_right_jacobian(w)
        for k in range(3):
            dw = jnp.zeros(3).at[k].set(1e-7)
            lhs = lie.so3_exp(w + dw)
            rhs = lie.so3_exp(w) @ lie.so3_exp(Jr @ dw)
            np.testing.assert_allclose(lhs, rhs, atol=1e-10)

    def test_right_jacobian_inv(self, rng):
        w = jnp.asarray(rng.normal(size=(16, 3)))
        J = lie.so3_right_jacobian(w)
        Ji = lie.so3_right_jacobian_inv(w)
        eye = jnp.broadcast_to(jnp.eye(3), J.shape)
        np.testing.assert_allclose(J @ Ji, eye, atol=1e-9)

    def test_normalize_rotation(self, rng):
        w = rand_w(rng, n=4, scale=1.0)
        R = lie.so3_exp(w) + 1e-4 * jnp.asarray(rng.normal(size=(4, 3, 3)))
        Rn = lie.normalize_rotation(R)
        eye = jnp.broadcast_to(jnp.eye(3), Rn.shape)
        np.testing.assert_allclose(Rn @ jnp.swapaxes(Rn, -1, -2), eye, atol=1e-7)


class TestSE3:
    def test_exp_log_roundtrip(self, rng):
        xi = jnp.asarray(rng.normal(size=(32, 6)))
        R, t = lie.se3_exp(xi)
        xi2 = lie.se3_log(R, t)
        np.testing.assert_allclose(xi, xi2, atol=1e-9)

    def test_compose_inv(self, rng):
        xa = jnp.asarray(rng.normal(size=(8, 6)))
        xb = jnp.asarray(rng.normal(size=(8, 6)))
        Ra, ta = lie.se3_exp(xa)
        Rb, tb = lie.se3_exp(xb)
        Rc, tc = lie.se3_compose(Ra, ta, Rb, tb)
        Ri, ti = lie.se3_inv(Rc, tc)
        Re, te = lie.se3_compose(Rc, tc, Ri, ti)
        np.testing.assert_allclose(Re, jnp.broadcast_to(jnp.eye(3), Re.shape), atol=1e-10)
        np.testing.assert_allclose(te, 0.0, atol=1e-10)

    def test_apply_matches_matrix(self, rng):
        xi = jnp.asarray(rng.normal(size=6))
        X = jnp.asarray(rng.normal(size=(10, 3)))
        R, t = lie.se3_exp(xi)
        Y = lie.se3_apply(R, t, X)
        M = lie.se3_matrix(R, t)
        Xh = jnp.concatenate([X, jnp.ones((10, 1))], axis=-1)
        Y2 = (M @ Xh.T).T[:, :3]
        np.testing.assert_allclose(Y, Y2, atol=1e-12)


class TestSim3:
    def test_exp_log_roundtrip(self, rng):
        xi = jnp.asarray(rng.normal(size=(32, 7)) * 0.8)
        s, R, t = lie.sim3_exp(xi)
        xi2 = lie.sim3_log(s, R, t)
        np.testing.assert_allclose(xi, xi2, atol=1e-8)

    def test_zero_is_identity(self):
        s, R, t = lie.sim3_exp(jnp.zeros(7))
        np.testing.assert_allclose(s, 1.0, atol=1e-12)
        np.testing.assert_allclose(R, jnp.eye(3), atol=1e-12)
        np.testing.assert_allclose(t, 0.0, atol=1e-12)

    def test_compose_inv(self, rng):
        xa = jnp.asarray(rng.normal(size=(8, 7)) * 0.5)
        xb = jnp.asarray(rng.normal(size=(8, 7)) * 0.5)
        sa, Ra, ta = lie.sim3_exp(xa)
        sb, Rb, tb = lie.sim3_exp(xb)
        sc, Rc, tc = lie.sim3_compose(sa, Ra, ta, sb, Rb, tb)
        si, Ri, ti = lie.sim3_inv(sc, Rc, tc)
        se, Re, te = lie.sim3_compose(sc, Rc, tc, si, Ri, ti)
        np.testing.assert_allclose(se, 1.0, atol=1e-10)
        np.testing.assert_allclose(Re, jnp.broadcast_to(jnp.eye(3), Re.shape), atol=1e-10)
        np.testing.assert_allclose(te, 0.0, atol=1e-9)

    def test_sim3_apply_scale(self, rng):
        X = jnp.asarray(rng.normal(size=(5, 3)))
        s = jnp.asarray(2.0)
        R = jnp.eye(3)
        t = jnp.zeros(3)
        Y = lie.sim3_apply(s, R, t, X)
        np.testing.assert_allclose(Y, 2.0 * X, atol=1e-12)

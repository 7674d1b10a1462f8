import jax
import jax.numpy as jnp
import numpy as np

from ms_slam.ops import cameras


PIN = jnp.asarray([718.856, 718.856, 607.1928, 185.2157, 0, 0, 0, 0])  # KITTI-ish
KB = jnp.asarray([190.978, 190.973, 254.932, 256.897,
                  0.003482, 0.000715, -0.002053, 0.000203])  # TUM-VI-ish fisheye


def rand_points(rng, n=64):
    X = rng.normal(size=(n, 3))
    X[:, 2] = np.abs(X[:, 2]) + 1.0  # in front
    return jnp.asarray(X)


class TestPinhole:
    def test_project_unproject(self, rng):
        X = rand_points(rng)
        uv = cameras.pinhole_project(PIN, X)
        ray = cameras.pinhole_unproject(PIN, uv)
        # ray * z should reproduce the point
        Xr = ray * X[:, 2:3]
        np.testing.assert_allclose(Xr, X, atol=1e-9)

    def test_jacobian_matches_ad(self, rng):
        X = rand_points(rng, 16)
        J = cameras.pinhole_project_jac(PIN, X)
        Jad = jax.vmap(jax.jacfwd(lambda x: cameras.pinhole_project(PIN, x)))(X)
        np.testing.assert_allclose(J, Jad, atol=1e-8)


class TestKB8:
    def test_project_unproject(self, rng):
        X = rand_points(rng)
        uv = cameras.kb8_project(KB, X)
        ray = cameras.kb8_unproject(KB, uv)
        # compare directions
        d1 = ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)
        d2 = X / jnp.linalg.norm(X, axis=-1, keepdims=True)
        np.testing.assert_allclose(d1, d2, atol=1e-6)

    def test_jacobian_matches_ad(self, rng):
        X = rand_points(rng, 16)
        J = cameras.kb8_project_jac(KB, X)
        Jad = jax.vmap(jax.jacfwd(lambda x: cameras.kb8_project(KB, x)))(X)
        np.testing.assert_allclose(J, Jad, atol=1e-6)

    def test_center_projection(self):
        X = jnp.asarray([[0.0, 0.0, 5.0]])
        uv = cameras.kb8_project(KB, X)
        np.testing.assert_allclose(uv[0], KB[2:4], atol=1e-6)


def test_triangulation(rng):
    from ms_slam.ops import lie, triangulate
    X = rand_points(rng, 32) + jnp.asarray([0, 0, 4.0])
    # camera 1 at origin, camera 2 translated
    xi = jnp.asarray([0.5, 0.02, 0.01, 0.01, -0.03, 0.02])
    R2, t2 = lie.se3_exp(xi)
    P1 = jnp.broadcast_to(jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], 1), (32, 3, 4))
    P2 = jnp.broadcast_to(jnp.concatenate([R2, t2[:, None]], 1), (32, 3, 4))
    x1 = X / X[:, 2:3]
    Xc2 = lie.se3_apply(R2, t2, X)
    x2 = Xc2 / Xc2[:, 2:3]
    Xt = triangulate.triangulate_dlt(x1, x2, P1, P2)
    np.testing.assert_allclose(Xt, X, atol=1e-6)

    # midpoint method
    o1 = jnp.zeros((32, 3))
    Ri, ti = lie.se3_inv(R2, t2)
    o2 = jnp.broadcast_to(ti, (32, 3))
    d1 = x1
    d2 = jnp.einsum("ij,nj->ni", Ri, x2)
    Xm = triangulate.triangulate_midpoint(o1, d1, o2, d2)
    np.testing.assert_allclose(Xm, X, atol=1e-6)

"""Batched camera models: Pinhole and Kannala-Brandt8 (fisheye).

Batched replacement for the reference's GeometricCamera virtual interface
(/root/reference/include/CameraModels/GeometricCamera.h:61-86,
 src/CameraModels/Pinhole.cpp, src/CameraModels/KannalaBrandt8.cpp).

Instead of virtual dispatch, each model is a set of pure functions over a
flat parameter vector; everything maps over point batches. Projection
Jacobians are analytic (matching projectJac) so Gauss-Newton never needs AD
in the hot loop (though all functions are also jax-differentiable).

Parameter layouts:
  pinhole: [fx, fy, cx, cy]
  kb8:     [fx, fy, cx, cy, k0, k1, k2, k3]
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

PINHOLE = 0
KB8 = 1

_Z_MIN = 1e-6


# ---------------------------------------------------------------------------
# Pinhole (ref src/CameraModels/Pinhole.cpp:project/unproject/projectJac)
# ---------------------------------------------------------------------------

def pinhole_project(params: jnp.ndarray, Xc: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame points (...,3) -> pixels (...,2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = jnp.maximum(Xc[..., 2], _Z_MIN)
    u = fx * Xc[..., 0] / z + cx
    v = fy * Xc[..., 1] / z + cy
    return jnp.stack([u, v], axis=-1)


def pinhole_unproject(params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixels (...,2) -> unit-depth bearing (...,3) with z=1."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def pinhole_project_jac(params: jnp.ndarray, Xc: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(Xc): (...,2,3)."""
    fx, fy = params[0], params[1]
    x, y = Xc[..., 0], Xc[..., 1]
    z = jnp.maximum(Xc[..., 2], _Z_MIN)
    zi = 1.0 / z
    zi2 = zi * zi
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([fx * zi, zero, -fx * x * zi2], axis=-1)
    row1 = jnp.stack([zero, fy * zi, -fy * y * zi2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (equidistant fisheye, 4 distortion coeffs)
# (ref src/CameraModels/KannalaBrandt8.cpp:project:37-70, unproject
#  Newton iteration :120-160, projectJac :180-230)
# ---------------------------------------------------------------------------

def kb8_project(params: jnp.ndarray, Xc: jnp.ndarray) -> jnp.ndarray:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.maximum(r2, 0.0))
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    inv_r = jnp.where(r > 1e-8, 1.0 / jnp.maximum(r, 1e-8), 1.0)
    scale = jnp.where(r > 1e-8, theta_d * inv_r, jnp.ones_like(r))
    u = fx * x * scale + cx
    v = fy * y * scale + cy
    return jnp.stack([u, v], axis=-1)


def kb8_unproject(params: jnp.ndarray, uv: jnp.ndarray, iters: int = 10) -> jnp.ndarray:
    """Pixels -> bearing with z=1 via fixed-count Newton on theta
    (the reference's while-loop becomes a static 10-iteration unroll)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = jnp.sqrt(mx * mx + my * my)
    theta_d_c = jnp.clip(theta_d, -jnp.pi / 2, jnp.pi / 2)
    theta = theta_d_c

    def body(_, th):
        t2 = th * th
        f = th * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3)))) - theta_d_c
        df = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + 9 * t2 * k3)))
        return th - f / jnp.where(jnp.abs(df) > 1e-8, df, 1.0)

    theta = jax.lax.fori_loop(0, iters, body, theta)
    scale = jnp.where(theta_d > 1e-8,
                      jnp.tan(theta) / jnp.maximum(theta_d, 1e-8),
                      jnp.ones_like(theta_d))
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def kb8_project_jac(params: jnp.ndarray, Xc: jnp.ndarray) -> jnp.ndarray:
    """Analytic d(uv)/dXc (...,2,3); mirrors the chain rule of
    KannalaBrandt8::projectJac."""
    fx, fy = params[0], params[1]
    k0, k1, k2, k3 = params[4], params[5], params[6], params[7]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r2 = jnp.maximum(x * x + y * y, 1e-12)
    r = jnp.sqrt(r2)
    R2 = r2 + z * z
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    fp = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + 9 * t2 * k3)))
    # dtheta/d(x,y,z)
    dth_dx = x * z / (R2 * r)
    dth_dy = y * z / (R2 * r)
    dth_dz = -r / R2
    g = f / r  # radial scale
    # dg/d* = (fp * dth * r - f * dr/d*) / r^2, dr/dx = x/r
    dg_dx = (fp * dth_dx * r - f * (x / r)) / r2
    dg_dy = (fp * dth_dy * r - f * (y / r)) / r2
    dg_dz = fp * dth_dz / r
    row0 = jnp.stack([fx * (g + x * dg_dx), fx * x * dg_dy, fx * x * dg_dz], axis=-1)
    row1 = jnp.stack([fy * y * dg_dx, fy * (g + y * dg_dy), fy * y * dg_dz], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Model-dispatched wrappers. `model` is a static python int; params is padded
# to length 8 so both models share one layout.
# ---------------------------------------------------------------------------

def project(model: int, params: jnp.ndarray, Xc: jnp.ndarray) -> jnp.ndarray:
    if model == PINHOLE:
        return pinhole_project(params, Xc)
    return kb8_project(params, Xc)


def unproject(model: int, params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model: int, params: jnp.ndarray, Xc: jnp.ndarray) -> jnp.ndarray:
    if model == PINHOLE:
        return pinhole_project_jac(params, Xc)
    return kb8_project_jac(params, Xc)


def pad_params(p) -> jnp.ndarray:
    p = jnp.asarray(p, dtype=jnp.float32)
    return jnp.pad(p, (0, 8 - p.shape[0]))

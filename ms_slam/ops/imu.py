"""IMU preintegration on manifold (Forster-style), batched.

Replaces IMU::Preintegrated (/root/reference/include/ImuTypes.h:143-230,
src/ImuTypes.cc IntegrateNewMeasurement): delta rotation/velocity/position,
9x9 measurement covariance + 6x6 bias random walk, incremental bias
Jacobians (JRg/JVg/JVa/JPg/JPa), bias-corrected getters and state
prediction. The reference's per-measurement C++ loop becomes one lax.scan
over a padded measurement array, so whole inter-frame batches integrate in
a single fused kernel; Reintegrate (bias update) is just re-running the
scan with the new bias — the measurements are kept.

Update order matches the reference exactly (dP before dV before dR, using
the pre-update dR; A/B linearization; right-Jacobian rotation increment;
NormalizeRotation after compose) — SURVEY Appendix A "Preintegration
update order".
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie

GRAVITY = 9.81  # ref include/ImuTypes.h:43 GRAVITY_VALUE


class PreintState(NamedTuple):
    """Preintegrated quantities between two frames/keyframes."""

    dT: jnp.ndarray     # () total time
    dR: jnp.ndarray     # (3,3)
    dV: jnp.ndarray     # (3,)
    dP: jnp.ndarray     # (3,)
    C: jnp.ndarray      # (15,15) covariance [theta, v, p, bg, ba]
    JRg: jnp.ndarray    # (3,3) d(dR)/d(bg)
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    bias: jnp.ndarray   # (6,) [bg, ba] used during integration


def init_state(bias: jnp.ndarray, dtype=jnp.float32) -> PreintState:
    z3 = jnp.zeros((3, 3), dtype)
    return PreintState(
        dT=jnp.zeros((), dtype), dR=jnp.eye(3, dtype=dtype),
        dV=jnp.zeros(3, dtype), dP=jnp.zeros(3, dtype),
        C=jnp.zeros((15, 15), dtype),
        JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3,
        bias=bias.astype(dtype))


@partial(jax.jit, static_argnames=())
def integrate(bias: jnp.ndarray, meas: jnp.ndarray, valid: jnp.ndarray,
              noise_gyro: jnp.ndarray, noise_acc: jnp.ndarray,
              walk_gyro: jnp.ndarray, walk_acc: jnp.ndarray) -> PreintState:
    """Integrate a padded measurement batch.

    meas: (M,7) rows [dt, ax, ay, az, gx, gy, gz]; valid: (M,) mask.
    noise_*: continuous-time noise densities already discretized by the
    caller or raw (we discretize per-sample: sigma^2/dt).
    """
    bias = bias.astype(meas.dtype)
    st = init_state(bias, meas.dtype)
    bg = bias[:3]
    ba = bias[3:]

    def step(st: PreintState, row):
        m, ok = row
        dt = m[0]
        acc = m[1:4] - ba
        gyr = m[4:7] - bg
        dt_s = jnp.where(ok, dt, 0.0)

        # measurement covariances for this sample (ref Calib ctor: Cov =
        # sigma^2/dt discretization happens via multiplying by 1/dt)
        safe_dt = jnp.maximum(dt, 1e-6)
        Nga = jnp.diag(jnp.concatenate([
            jnp.full(3, noise_gyro ** 2 / safe_dt),
            jnp.full(3, noise_acc ** 2 / safe_dt)])).astype(m.dtype)
        NgaWalk = jnp.diag(jnp.concatenate([
            jnp.full(3, walk_gyro ** 2 * safe_dt),
            jnp.full(3, walk_acc ** 2 * safe_dt)])).astype(m.dtype)

        # 1) position and velocity with pre-update dR (ref ImuTypes.cc
        #    IntegrateNewMeasurement: dP uses old dR and old dV)
        acc_w = st.dR @ acc
        dP = st.dP + st.dV * dt_s + 0.5 * acc_w * dt_s * dt_s
        dV = st.dV + acc_w * dt_s

        # A/B for the 9x9 block [theta, v, p]
        ah = lie.hat(acc)
        A = jnp.eye(9, dtype=m.dtype)
        A = A.at[3:6, 0:3].set(-st.dR @ ah * dt_s)
        A = A.at[6:9, 0:3].set(-0.5 * st.dR @ ah * dt_s * dt_s)
        A = A.at[6:9, 3:6].set(jnp.eye(3, dtype=m.dtype) * dt_s)
        B = jnp.zeros((9, 6), m.dtype)
        B = B.at[3:6, 3:6].set(st.dR * dt_s)
        B = B.at[6:9, 3:6].set(0.5 * st.dR * dt_s * dt_s)

        # bias jacobians for P/V (pre-update dR, ref :216-220)
        JPa = st.JPa + st.JVa * dt_s - 0.5 * st.dR * dt_s * dt_s
        JPg = st.JPg + st.JVg * dt_s - 0.5 * st.dR @ ah @ st.JRg * dt_s * dt_s
        JVa = st.JVa - st.dR * dt_s
        JVg = st.JVg - st.dR @ ah @ st.JRg * dt_s

        # 2) rotation increment (right Jacobian)
        w_dt = gyr * dt_s
        dRi = lie.so3_exp(w_dt)
        rightJ = lie.so3_right_jacobian(w_dt)
        A = A.at[0:3, 0:3].set(dRi.T)
        B = B.at[0:3, 0:3].set(rightJ * dt_s)
        dR = lie.normalize_rotation(st.dR @ dRi)
        JRg = dRi.T @ st.JRg - rightJ * dt_s

        # covariance propagation (9x9 + bias walk, ref :225-229)
        C9 = A @ st.C[:9, :9] @ A.T + B @ Nga @ B.T
        Cb = st.C[9:15, 9:15] + NgaWalk
        C = st.C.at[:9, :9].set(C9).at[9:15, 9:15].set(Cb)

        new = PreintState(dT=st.dT + dt_s, dR=dR, dV=dV, dP=dP, C=C,
                          JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                          bias=st.bias)
        # masked rows leave the state untouched
        out = jax.tree.map(lambda n, o: jnp.where(ok, n, o), new, st)
        return out, None

    st, _ = jax.lax.scan(step, st, (meas, valid))
    return st


# ---------------------------------------------------------------------------
# Bias-corrected getters (ref GetDeltaRotation/Velocity/Position with
# updated bias, include/ImuTypes.h:190-205)
# ---------------------------------------------------------------------------

def delta_rotation(st: PreintState, bg_new: jnp.ndarray) -> jnp.ndarray:
    db = bg_new - st.bias[:3]
    return lie.normalize_rotation(st.dR @ lie.so3_exp(st.JRg @ db))


def delta_velocity(st: PreintState, bg_new, ba_new) -> jnp.ndarray:
    return st.dV + st.JVg @ (bg_new - st.bias[:3]) \
        + st.JVa @ (ba_new - st.bias[3:])


def delta_position(st: PreintState, bg_new, ba_new) -> jnp.ndarray:
    return st.dP + st.JPg @ (bg_new - st.bias[:3]) \
        + st.JPa @ (ba_new - st.bias[3:])


def predict_state(st: PreintState, R_wb: jnp.ndarray, v_w: jnp.ndarray,
                  p_w: jnp.ndarray, bg, ba, g=None):
    """Propagate body state across the preintegration interval (ref
    Tracking::PredictStateIMU, src/Tracking.cc:1727)."""
    if g is None:
        g = jnp.asarray([0.0, 0.0, -GRAVITY], R_wb.dtype)
    dT = st.dT
    R2 = R_wb @ delta_rotation(st, bg)
    v2 = v_w + g * dT + R_wb @ delta_velocity(st, bg, ba)
    p2 = p_w + v_w * dT + 0.5 * g * dT * dT + R_wb @ delta_position(st, bg, ba)
    return R2, v2, p2


# ---------------------------------------------------------------------------
# Inertial residual (EdgeInertial, ref src/G2oTypes.cc / include/G2oTypes.h)
# ---------------------------------------------------------------------------

def inertial_residual(st: PreintState,
                      R1, v1, p1, R2, v2, p2, bg, ba, g=None):
    """9-dim preintegration factor residual [er, ev, ep] between body
    states 1 and 2 (world frame, R = R_wb)."""
    if g is None:
        g = jnp.asarray([0.0, 0.0, -GRAVITY], R1.dtype)
    dT = st.dT
    dR = delta_rotation(st, bg)
    dV = delta_velocity(st, bg, ba)
    dP = delta_position(st, bg, ba)
    er = lie.so3_log(dR.T @ R1.T @ R2)
    ev = R1.T @ (v2 - v1 - g * dT) - dV
    ep = R1.T @ (p2 - p1 - v1 * dT - 0.5 * g * dT * dT) - dP
    return jnp.concatenate([er, ev, ep])


def information(st: PreintState) -> jnp.ndarray:
    """9x9 information of the preintegration factor (inverse of the
    propagated covariance, symmetrized like the reference).

    Regularization is RELATIVE to the covariance scale so the f32 inverse
    stays positive definite (tiny-noise covariances are ~1e-8; an absolute
    epsilon is invisible and the inverse can go indefinite, NaN-ing any
    downstream Cholesky)."""
    C = st.C[:9, :9]
    C = 0.5 * (C + C.T)
    eps = 1e-4 * jnp.maximum(jnp.trace(C) / 9.0, 1e-12)
    C = C + eps * jnp.eye(9, dtype=C.dtype)
    info = jnp.linalg.inv(C)
    return 0.5 * (info + info.T)


def sqrt_information(st: PreintState) -> jnp.ndarray:
    """Cholesky factor L (info = L L^T) with relative jitter; use L.T as
    the residual whitener."""
    info = information(st)
    jit = 1e-6 * jnp.maximum(jnp.trace(info) / 9.0, 1e-12)
    return jnp.linalg.cholesky(info + jit * jnp.eye(9, dtype=info.dtype))

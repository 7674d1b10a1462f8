"""Batched Lie-group operations: SO(3), SE(3), Sim(3).

Batched replacement for the reference's Sophus usage
(/root/reference/Thirdparty/Sophus, used for every pose in e.g.
include/KeyFrame.h, src/ImuTypes.cc). Everything here is a pure function on
stacked arrays so it vmaps/jits cleanly; rotations are 3x3 matrices (batched
matmuls), tangents are 6-vectors ordered [upsilon(3), omega(3)]
(translation-first, matching Sophus' SE3::log convention).

All formulas use Taylor fallbacks below `_EPS` so float32 gradients stay
finite at the identity.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _safe_theta(theta2):
    """Returns (small, theta) where theta = sqrt(theta2) is safe to
    differentiate: the sqrt is evaluated at >= _SMALL2 so grads never see
    0/0 (the small branch must then use theta2 polynomials only)."""
    small = theta2 < _SMALL2
    theta = jnp.sqrt(jnp.where(small, 1.0, theta2))
    return small, theta


_SMALL2 = 1e-8  # theta^2 threshold for Taylor branches


def _sinc_t2(theta2):
    """sin(theta)/theta as a function of theta^2, grad-safe at 0."""
    small, th = _safe_theta(theta2)
    return jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(th) / th)


def _cosc_t2(theta2):
    """(1-cos(theta))/theta^2, grad-safe at 0."""
    small, th = _safe_theta(theta2)
    return jnp.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - jnp.cos(th)) / jnp.where(small, 1.0, theta2))


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: (...,3) tangent -> (...,3,3) rotation."""
    theta2 = jnp.sum(w * w, axis=-1)
    W = hat(w)
    W2 = W @ W
    a = _sinc_t2(theta2)[..., None, None]
    b = _cosc_t2(theta2)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix logarithm: (...,3,3) -> (...,3).

    Stable for angles near 0 and near pi (quaternion extraction route).
    """
    # Convert to quaternion (w,x,y,z) via Shepperd's method, then log.
    q = rot_to_quat(R)
    return quat_log(q)


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """(...,3,3) -> unit quaternion (...,4) ordered (w,x,y,z), w>=0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate extractions; pick the numerically largest pivot.
    def _ssqrt(v):
        # grad-safe sqrt(max(v,0)): unselected branches otherwise produce
        # 0 * inf = NaN cotangents through take_along_axis in reverse mode
        ok = v > 1e-8
        return jnp.where(ok, jnp.sqrt(jnp.where(ok, v, 1.0)), 0.0)

    def _safe(d):
        # selected pivot always has d >= 1, so the guard only sanitizes the
        # branches that are discarded by the argmax selection below
        return jnp.where(jnp.abs(d) > 1e-6, d, 1.0)

    qw0 = _ssqrt(1.0 + tr) / 2.0
    c0 = jnp.stack(
        [qw0, (m21 - m12) / _safe(4.0 * qw0), (m02 - m20) / _safe(4.0 * qw0),
         (m10 - m01) / _safe(4.0 * qw0)], axis=-1)
    qx1 = _ssqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = jnp.stack(
        [(m21 - m12) / _safe(4.0 * qx1), qx1, (m01 + m10) / _safe(4.0 * qx1),
         (m02 + m20) / _safe(4.0 * qx1)], axis=-1)
    qy2 = _ssqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = jnp.stack(
        [(m02 - m20) / _safe(4.0 * qy2), (m01 + m10) / _safe(4.0 * qy2), qy2,
         (m12 + m21) / _safe(4.0 * qy2)], axis=-1)
    qz3 = _ssqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = jnp.stack(
        [(m10 - m01) / _safe(4.0 * qz3), (m02 + m20) / _safe(4.0 * qz3),
         (m12 + m21) / _safe(4.0 * qz3), qz3], axis=-1)
    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22],
                       axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # (...,4cand,4)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)
    q = q[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # canonical sign
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """(...,4) (w,x,y,z) -> (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def quat_log(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> rotation vector (...,3), grad-safe at identity
    (plain norm() is non-differentiable at 0)."""
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = jnp.sum(v * v, axis=-1)
    small = vn2 < _EPS * _EPS
    vn = jnp.sqrt(jnp.where(small, 1.0, vn2))
    theta = 2.0 * jnp.arctan2(vn, w)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), theta / vn)
    return v * scale[..., None]


def so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian J_l of SO(3): (...,3) -> (...,3,3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small, th = _safe_theta(theta2)
    W = hat(w)
    W2 = W @ W
    b = _cosc_t2(theta2)[..., None, None]  # (1-cos)/th^2
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (th - jnp.sin(th)) / jnp.where(small, 1.0, theta2 * th))[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b * W + c * W2


def so3_right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian J_r(w) = J_l(-w). Matches IMU::IntegratedRotation's
    rightJ (ref: /root/reference/src/ImuTypes.cc)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian, closed form."""
    theta2 = jnp.sum(w * w, axis=-1)
    small, th = _safe_theta(theta2)
    W = hat(w)
    W2 = W @ W
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / jnp.where(small, 1.0, theta2))
        - (1.0 + jnp.cos(th)) / (2.0 * th * jnp.sin(th)),
    )[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + 0.5 * W + coef * W2


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate/det): pure elementwise
    math instead of a batched LU, whose pivoting is a serial chain for
    tiny blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], -1),
        jnp.stack([A21, A22, A23], -1),
        jnp.stack([A31, A32, A33], -1)], -2)
    return adj * inv_det[..., None, None]


def solve3x3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3x3 solve via the closed-form inverse."""
    return jnp.einsum("...ij,...j->...i", inv3x3(A), b)


def solve_psd6(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """6x6 symmetric-positive-definite solve via 2x2-block Schur on the
    closed-form 3x3 inverse. linalg.solve lowers tiny systems through a
    pivoted LU whose serial dependency chain dominates the per-iteration
    cost of the pose optimizer; this is ~30 fused VPU ops.

    [[P, Q], [Q^T, S]] x = [u, v]:  S' = S - Q^T P^-1 Q;
    x2 = S'^-1 (v - Q^T P^-1 u);  x1 = P^-1 (u - Q x2).

    Conditioning note: the cofactor-based 3x3 inverses lose precision in
    f32 for ill-conditioned Hessians (LU pivots; this doesn't). Callers
    are LM loops whose damping keeps the blocks diagonally dominant, and
    whose accept/reject step discards any cost-increasing update, which
    bounds the impact of a bad solve to a wasted iteration."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    S = A[..., 3:, 3:]
    u = b[..., :3]
    v = b[..., 3:]
    Pi = inv3x3(P)
    PiQ = Pi @ Q
    Sp = S - jnp.swapaxes(Q, -1, -2) @ PiQ
    Piu = jnp.einsum("...ij,...j->...i", Pi, u)
    x2 = jnp.einsum("...ij,...j->...i", inv3x3(Sp),
                    v - jnp.einsum("...ji,...j->...i", PiQ, u))
    x1 = Piu - jnp.einsum("...ij,...j->...i", PiQ, x2)
    return jnp.concatenate([x1, x2], axis=-1)


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project near-rotation back onto SO(3) (ref IMU::NormalizeRotation,
    /root/reference/src/ImuTypes.cc) via quaternion round-trip (SVD-free)."""
    return quat_to_rot(rot_to_quat(R))


# ---------------------------------------------------------------------------
# SE(3): represented as a pair (R: (...,3,3), t: (...,3)).
# ---------------------------------------------------------------------------

def se3_exp(xi: jnp.ndarray):
    """(...,6) [v, w] -> (R, t)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, v)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> (...,6) [v, w]."""
    w = so3_log(R)
    v = solve3x3(so3_left_jacobian(w), t)
    return jnp.concatenate([v, w], axis=-1)


def se3_compose(Ra, ta, Rb, tb):
    """T_a * T_b."""
    R = Ra @ Rb
    t = jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return R, t


def se3_inv(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, X):
    """Transform points X (...,3)."""
    return jnp.einsum("...ij,...j->...i", R, X) + t


def se3_matrix(R, t):
    """(R,t) -> (...,4,4) homogeneous matrix."""
    batch = R.shape[:-2]
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# Sim(3): (s: (...,), R: (...,3,3), t: (...,3)). Tangent ordered [v, w, sigma].
# Used by loop closing / essential-graph optimization (ref g2o::Sim3,
# /root/reference/src/Optimizer.cc:1410 OptimizeEssentialGraph).
# ---------------------------------------------------------------------------

def sim3_apply(s, R, t, X):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, X) + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    s = sa * sb
    R = Ra @ Rb
    t = sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return s, R, t


def sim3_inv(s, R, t):
    si = 1.0 / s
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -si[..., None] * jnp.einsum("...ij,...j->...i", Rt, t)
    return si, Rt, ti


def _sim3_W(w: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """The 'W' matrix of Sim(3) exp (t = W v): W = C I + A hat(w) + B hat(w)^2.

    Standard closed form (Strasdat thesis / Sophus sim3 calcW) with Taylor
    fallbacks in the four (sigma small?, theta small?) regimes.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    small_t, theta = _safe_theta(theta2)
    Om = hat(w)
    Om2 = Om @ Om
    es = jnp.exp(sigma)

    small_s = jnp.abs(sigma) < 1e-5
    ss = jnp.where(small_s, 1.0, sigma)      # safe sigma
    th = jnp.where(small_t, 1.0, theta)      # safe theta

    # sigma ~ 0 branch
    A_s0 = jnp.where(small_t, 0.5 - theta * theta / 24.0,
                     (1.0 - jnp.cos(th)) / (th * th))
    B_s0 = jnp.where(small_t, 1.0 / 6.0 - theta * theta / 120.0,
                     (th - jnp.sin(th)) / (th * th * th))
    C_s0 = jnp.ones_like(theta)

    # sigma != 0 branch
    C_s = (es - 1.0) / ss
    A_s_t0 = ((ss - 1.0) * es + 1.0) / (ss * ss)
    B_s_t0 = (es * (0.5 * ss * ss - ss + 1.0) - 1.0) / (ss * ss * ss)
    a = es * jnp.sin(th)
    b = es * jnp.cos(th)
    c = th * th + ss * ss
    A_s_t = (a * ss + (1.0 - b) * th) / (th * c)
    B_s_t = (C_s - ((b - 1.0) * ss + a * th) / c) / (th * th)

    A = jnp.where(small_s, A_s0, jnp.where(small_t, A_s_t0, A_s_t))
    B = jnp.where(small_s, B_s0, jnp.where(small_t, B_s_t0, B_s_t))
    C = jnp.where(small_s, C_s0, C_s)

    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), Om.shape)
    return C[..., None, None] * eye + A[..., None, None] * Om + B[..., None, None] * Om2


def sim3_exp(xi: jnp.ndarray):
    """(...,7) [v, w, sigma] -> (s, R, t)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(w)
    W = _sim3_W(w, sigma)
    t = jnp.einsum("...ij,...j->...i", W, v)
    return s, R, t


def sim3_log(s, R, t) -> jnp.ndarray:
    """(s,R,t) -> (...,7) [v, w, sigma]."""
    sigma = jnp.log(s)
    w = so3_log(R)
    W = _sim3_W(w, sigma)
    v = solve3x3(W, t)
    return jnp.concatenate([v, w, sigma[..., None]], axis=-1)

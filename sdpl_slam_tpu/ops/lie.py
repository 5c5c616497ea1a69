"""SO(3)/SE(3) Lie-group operations, batch-friendly and jit/grad-safe.

Conventions (chosen to match the g2o math the reference relies on):

* A pose is a 4x4 homogeneous matrix ``T`` (row-major, like the reference's
  ``cv::Mat`` poses, e.g. /root/reference/src/Tracking.cc camera poses).
* A tangent (twist) vector is ``xi = [omega(3), v(3)]`` -- rotation first,
  translation second.  This is g2o's ``SE3Quat::exp`` ordering, which the
  reference's analytic Jacobians assume
  (/root/reference/dependencies/g2o/g2o/types/types_six_dof_expmap.cpp:1008).
* Retraction during optimization is *left* multiplication:
  ``T <- exp(xi) @ T`` (g2o ``VertexSE3Expmap::oplusImpl``).

All functions are scalar-pose; batch with ``jax.vmap``.  Small-angle branches
use ``jnp.where`` guards so gradients are NaN-free under ``jax.grad``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector: hat(w) @ x == cross(w, x)."""
    zero = jnp.zeros((), dtype=w.dtype)
    return jnp.stack(
        [
            jnp.stack([zero, -w[2], w[1]]),
            jnp.stack([w[2], zero, -w[0]]),
            jnp.stack([-w[1], w[0], zero]),
        ]
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`."""
    return jnp.stack([W[2, 1], W[0, 2], W[1, 0]])


def _safe_norm(w: jnp.ndarray) -> jnp.ndarray:
    """eps-regularized norm: gradient is 0 (not NaN) at w == 0."""
    return jnp.sqrt(jnp.sum(w * w) + 1e-24)


def _sinc(theta: jnp.ndarray) -> jnp.ndarray:
    """sin(theta)/theta with a Taylor branch at 0 (grad-safe)."""
    small = jnp.abs(theta) < 1e-5
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    return jnp.where(small, 1.0 - theta * theta / 6.0, jnp.sin(safe) / safe)


def _cosc(theta: jnp.ndarray) -> jnp.ndarray:
    """(1-cos(theta))/theta^2 with a Taylor branch at 0 (grad-safe)."""
    small = jnp.abs(theta) < 1e-5
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    return jnp.where(small, 0.5 - theta * theta / 24.0, (1.0 - jnp.cos(safe)) / (safe * safe))


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula: R = I + sinc(t) hat(w) + cosc(t) hat(w)^2."""
    theta = _safe_norm(w)
    W = hat(w)
    return (
        jnp.eye(3, dtype=w.dtype)
        + _sinc(theta) * W
        + _cosc(theta) * (W @ W)
    )


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map of SO(3).  Valid for angles < pi (clamped trace, like the
    reference's rotation-error metric /root/reference/src/Tracking.cc:5030)."""
    trace = jnp.clip(jnp.trace(R), -1.0, 3.0)
    cos_t = jnp.clip(0.5 * (trace - 1.0), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_t)
    w_hat = 0.5 * (R - R.T)
    # w = theta / (2 sin(theta)) * vee(R - R^T); Taylor at 0.
    small = theta < 1e-5
    safe_t = jnp.where(small, jnp.ones_like(theta), theta)
    scale = jnp.where(small, 1.0 + theta * theta / 6.0, safe_t / jnp.sin(safe_t))
    return scale * vee(w_hat)


def rotation_angle_deg(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle in degrees via the clamped-trace acos formula used by the
    reference metrics (/root/reference/src/Tracking.cc:5026-5040)."""
    trace = jnp.trace(R)
    cos_t = jnp.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    return jnp.degrees(jnp.arccos(cos_t))


def _left_jacobian_v(w: jnp.ndarray) -> jnp.ndarray:
    """The V matrix in se(3) exp: t = V @ v."""
    theta = _safe_norm(w)
    W = hat(w)
    theta2 = theta * theta
    small = theta < 1e-5
    safe2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    # (theta - sin theta)/theta^3
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (1.0 - _sinc(theta)) / safe2,
    )
    return jnp.eye(3, dtype=w.dtype) + _cosc(theta) * W + c * (W @ W)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map se(3) -> SE(3); xi = [omega, v]."""
    w, v = xi[:3], xi[3:]
    R = so3_exp(w)
    t = _left_jacobian_v(w) @ v
    T = jnp.eye(4, dtype=xi.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SE(3) -> se(3); returns [omega, v]."""
    R = T[:3, :3]
    t = T[:3, 3]
    w = so3_log(R)
    V = _left_jacobian_v(w)
    v = jnp.linalg.solve(V, t)
    return jnp.concatenate([w, v])


def se3_inv(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(3) inverse (reference ``Converter::toInvMatrix``,
    /root/reference/src/Converter.cc)."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    Ti = Ti.at[:3, 3].set(-R.T @ t)
    return Ti


def se3_retract(T: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative retraction ``exp(xi) @ T`` (g2o SE3 vertex oplus)."""
    return se3_exp(xi) @ T


def so3_orthonormalize(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation back onto SO(3): one Newton iteration of the
    polar decomposition, ``R <- R (3I - R^T R) / 2`` (error eps -> O(eps^2)).

    Why this exists: chained f32 pose compositions drift from orthonormality
    (a steady drift where the matmul rounds with a systematic bias, a
    random walk where it does not).  The reference never
    sees this because g2o stores rotations as unit quaternions in double
    (``g2o::SE3Quat``); the reference's clamped-trace rotation-error metric
    (/root/reference/src/Tracking.cc:5030) reads any orthonormality deficit
    directly as phantom rotation error, which grows with sequence length.
    Two 3x3 matmuls, branch-free, grad-safe.
    """
    RtR = jnp.matmul(R.T, R, precision=jax.lax.Precision.HIGHEST)
    return 0.5 * jnp.matmul(
        R, 3.0 * jnp.eye(3, dtype=R.dtype) - RtR,
        precision=jax.lax.Precision.HIGHEST,
    )


def se3_orthonormalize(T: jnp.ndarray) -> jnp.ndarray:
    """``so3_orthonormalize`` on the rotation block of a 4x4 pose."""
    return T.at[:3, :3].set(so3_orthonormalize(T[:3, :3]))


def transform_point(T: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Apply a 4x4 pose to 3D point(s); x has shape (..., 3).

    Uses full-f32 matmul precision: a TF32 or bf16 product costs ~1e-3
    relative error or more, far too coarse for metric SLAM geometry.
    """
    return (
        jnp.matmul(x, T[:3, :3].T, precision=jax.lax.Precision.HIGHEST)
        + T[:3, 3]
    )


def line_transform_6x6(T: jnp.ndarray) -> jnp.ndarray:
    """The 6x6 Pluecker-line motion matrix [[R, hat(t) R], [0, R]] for pose T,
    acting on L = [n, d].  Matches the reference's ``LineTransformation``
    (/root/reference/dependencies/g2o/g2o/types/edge_se3_ortho_line.cpp:100-109)."""
    R = T[:3, :3]
    t = T[:3, 3]
    top = jnp.concatenate([R, hat(t) @ R], axis=1)
    bot = jnp.concatenate([jnp.zeros((3, 3), dtype=T.dtype), R], axis=1)
    return jnp.concatenate([top, bot], axis=0)

"""Projective and line geometry: pinhole camera, Pluecker/orthonormal lines.

These are the batched array equivalents of the reference's scalar geometry:

* pinhole projection / unprojection   (/root/reference/src/Frame.cc:1140-1290)
* Pluecker construction               (/root/reference/src/Frame.cc:1564-1579)
* infinite image-line coefficients    (/root/reference/src/Frame.cc:589-593)
* orthonormal 4-dof line representation and its retraction
  (/root/reference/dependencies/g2o/g2o/types/vertex_line.h:32-58,
   edge_se3_ortho_line.cpp:314 ``orthonormal2plucker``)
* the line residual primitives used by the BA edges
  (point-to-Pluecker distance, reciprocal-product line distance)

Everything broadcasts over leading batch dimensions unless noted.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp



class Intrinsics(NamedTuple):
    """Pinhole intrinsics (fx, fy, cx, cy) -- yaml keys ``Camera.*``."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @staticmethod
    def from_config(cfg) -> "Intrinsics":
        return Intrinsics(
            jnp.float32(cfg.fx), jnp.float32(cfg.fy),
            jnp.float32(cfg.cx), jnp.float32(cfg.cy),
        )

    @property
    def matrix(self) -> jnp.ndarray:
        one = jnp.ones_like(self.fx)
        zero = jnp.zeros_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, zero, self.cx]),
                jnp.stack([zero, self.fy, self.cy]),
                jnp.stack([zero, zero, one]),
            ]
        )


def project(K: Intrinsics, X: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    """Pinhole projection of camera-frame points X (..., 3) -> pixels (..., 2).

    Zero/negative depths are guarded; callers gate validity separately.
    """
    z = X[..., 2]
    safe_z = jnp.where(jnp.abs(z) < eps, jnp.full_like(z, eps), z)
    u = K.fx * X[..., 0] / safe_z + K.cx
    v = K.fy * X[..., 1] / safe_z + K.cy
    return jnp.stack([u, v], axis=-1)


def backproject(K: Intrinsics, uv: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Unproject pixels (..., 2) at depth z (...,) to camera-frame (..., 3).

    Mirrors ``Frame::UnprojectStereoStat`` (/root/reference/src/Frame.cc:1140).
    """
    x = (uv[..., 0] - K.cx) * z / K.fx
    y = (uv[..., 1] - K.cy) * z / K.fy
    return jnp.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# Pluecker lines.  L = [n(3), d(3)]: d = unit direction, n = p x d for any
# point p on the line.
# ---------------------------------------------------------------------------


def plucker_from_endpoints(p_start: jnp.ndarray, p_end: jnp.ndarray,
                           eps: float = 1e-12) -> jnp.ndarray:
    """Pluecker coordinates from two 3D endpoints (..., 3) -> (..., 6).

    d = (p_end - p_start)/||.||, n = p_start x d
    -- exactly ``Frame::CalculatePlucker`` (/root/reference/src/Frame.cc:1564-1579).
    """
    d = p_end - p_start
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    d = d / jnp.maximum(norm, eps)
    n = jnp.cross(p_start, d)
    return jnp.concatenate([n, d], axis=-1)


def transform_plucker(T: jnp.ndarray, L: jnp.ndarray) -> jnp.ndarray:
    """Transform Pluecker line(s) (..., 6) by the 4x4 pose T:
    n' = R n + hat(t) R d ; d' = R d."""
    R = T[:3, :3]
    t = T[:3, 3]
    n, d = L[..., :3], L[..., 3:]
    # full-f32 precision: a TF32 or bf16 matmul is too coarse for metric
    # geometry
    hi = jax.lax.Precision.HIGHEST
    Rd = jnp.matmul(d, R.T, precision=hi)
    Rn = jnp.matmul(n, R.T, precision=hi)
    n_new = Rn + jnp.cross(jnp.broadcast_to(t, Rd.shape), Rd)
    return jnp.concatenate([n_new, Rd], axis=-1)


def point_to_plucker_distance(p: jnp.ndarray, L: jnp.ndarray) -> jnp.ndarray:
    """||p x d - n|| : distance of 3D point(s) to a unit-direction Pluecker
    line, the ``EdgeSE3OrthoLine`` residual primitive
    (/root/reference/dependencies/g2o/g2o/types/edge_se3_ortho_line.cpp:111-113)."""
    n, d = L[..., :3], L[..., 3:]
    return jnp.linalg.norm(jnp.cross(p, d) - n, axis=-1)


def plucker_line_distance(L1: jnp.ndarray, L2: jnp.ndarray,
                          eps: float = 1e-6) -> jnp.ndarray:
    """Reciprocal-product distance between two Pluecker lines (..., 6).

    Non-parallel: |d1.n2 + d2.n1| / ||d1 x d2||.
    Collinear (||d1 x d2|| < 1e-6): ||d1 x (n1 - n2/s)|| / ||d1||^2, the
    ``LineLandmarkMotionTernaryEdge`` branch
    (/root/reference/dependencies/g2o/g2o/types/types_dyn_slam3d.cpp:226-315).
    The reference computes the direction scale s as mean(d2/d1) per component,
    which is 0/0=NaN whenever a direction component is zero (and the reference
    then aborts on the NaN).  We use the least-squares scale
    s = (d1.d2)/(d1.d1), identical for truly parallel lines and NaN-free.
    Implemented with ``jnp.where`` for NaN-free gradients.
    """
    def safe_norm(x):
        # eps-regularized L2 norm: grad-safe at x == 0 (d/dx -> 0, not NaN).
        return jnp.sqrt(jnp.sum(x * x, axis=-1) + 1e-20)

    n1, d1 = L1[..., :3], L1[..., 3:]
    n2, d2 = L2[..., :3], L2[..., 3:]
    cross = jnp.cross(d1, d2)
    cross_norm = safe_norm(cross)
    parallel = cross_norm < eps

    # General branch (guard denominator).
    gen = jnp.abs(jnp.sum(d1 * n2, axis=-1) + jnp.sum(d2 * n1, axis=-1))
    gen = gen / jnp.where(parallel, jnp.ones_like(cross_norm), cross_norm)

    # Collinear branch (least-squares direction scale, see docstring).
    s = (
        jnp.sum(d1 * d2, axis=-1, keepdims=True)
        / jnp.maximum(jnp.sum(d1 * d1, axis=-1, keepdims=True), 1e-12)
    )
    s = jnp.where(jnp.abs(s) < 1e-12, jnp.full_like(s, 1e-12), s)
    col = safe_norm(jnp.cross(d1, n1 - n2 / s))
    col = col / jnp.maximum(jnp.sum(d1 * d1, axis=-1), 1e-12)

    return jnp.where(parallel, col, gen)


def plucker_angle_error(L1: jnp.ndarray, L2: jnp.ndarray) -> jnp.ndarray:
    """1 - |cos(angle)| of the two line directions, the second component of
    the line-motion ternary residual (types_dyn_slam3d.cpp:309-312)."""
    d1 = L1[..., 3:]
    d2 = L2[..., 3:]
    n1 = jnp.maximum(jnp.linalg.norm(d1, axis=-1), 1e-12)
    n2 = jnp.maximum(jnp.linalg.norm(d2, axis=-1), 1e-12)
    return 1.0 - jnp.abs(jnp.sum(d1 * d2, axis=-1) / (n1 * n2))


# ---------------------------------------------------------------------------
# Orthonormal 4-dof line representation: (U in SO(3), W in SO(2)).
# Stored as U (3,3) and w = (w00, w10) the first column of W (cos, sin).
# ---------------------------------------------------------------------------


def plucker_to_orthonormal(L: jnp.ndarray, eps: float = 1e-12):
    """(n, d) -> (U, w).  U = [n/|n|, d/|d|, (n x d)/|n x d|],
    w = (|n|, |d|)/sqrt(|n|^2+|d|^2)."""
    n, d = L[..., :3], L[..., 3:]
    nn = jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), eps)
    nd = jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), eps)
    c = jnp.cross(n, d)
    nc = jnp.maximum(jnp.linalg.norm(c, axis=-1, keepdims=True), eps)
    U = jnp.stack([n / nn, d / nd, c / nc], axis=-1)  # columns
    scale = jnp.sqrt(nn * nn + nd * nd)
    w = jnp.concatenate([nn / scale, nd / scale], axis=-1)
    return U, w


def orthonormal_to_plucker(U: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """(U, w) -> Pluecker [n, d]: n = w0 * U[:,0], d = w1 * U[:,1]
    (``orthonormal2plucker``, edge_se3_ortho_line.cpp:314-319)."""
    n = w[..., 0:1] * U[..., :, 0]
    d = w[..., 1:2] * U[..., :, 1]
    return jnp.concatenate([n, d], axis=-1)


def _rot_x(t):
    c, s = jnp.cos(t), jnp.sin(t)
    one, zero = jnp.ones_like(t), jnp.zeros_like(t)
    return jnp.stack([
        jnp.stack([one, zero, zero]),
        jnp.stack([zero, c, -s]),
        jnp.stack([zero, s, c]),
    ])


def _rot_y(t):
    c, s = jnp.cos(t), jnp.sin(t)
    one, zero = jnp.ones_like(t), jnp.zeros_like(t)
    return jnp.stack([
        jnp.stack([c, zero, s]),
        jnp.stack([zero, one, zero]),
        jnp.stack([-s, zero, c]),
    ])


def _rot_z(t):
    c, s = jnp.cos(t), jnp.sin(t)
    one, zero = jnp.ones_like(t), jnp.zeros_like(t)
    return jnp.stack([
        jnp.stack([c, -s, zero]),
        jnp.stack([s, c, zero]),
        jnp.stack([zero, zero, one]),
    ])


def orthonormal_retract(U: jnp.ndarray, w: jnp.ndarray,
                        delta: jnp.ndarray):
    """4-dof update: U <- U Rx(d0) Ry(d1) Rz(d2), W <- W R(d3)
    (``VertexLine::oplusImpl``, vertex_line.h:32-58).  Single line; vmap it."""
    U_new = U @ _rot_x(delta[0]) @ _rot_y(delta[1]) @ _rot_z(delta[2])
    c, s = jnp.cos(delta[3]), jnp.sin(delta[3])
    # W = [[w0, -w1], [w1, w0]]; W R(d3) first column = (w0 c - w1 s, w1 c + w0 s)
    w_new = jnp.stack([w[0] * c - w[1] * s, w[1] * c + w[0] * s])
    return U_new, w_new


# ---------------------------------------------------------------------------
# Image-space infinite lines.
# ---------------------------------------------------------------------------


def infinite_line_image(p: jnp.ndarray, q: jnp.ndarray,
                        eps: float = 1e-12) -> jnp.ndarray:
    """Normalized homogeneous line through pixels p, q (..., 2) -> (..., 3):
    (p_h x q_h) / ||p_h x q_h|| -- the reference's infinite-line coefficients
    (/root/reference/src/Frame.cc:589-593) and the flow-line edge's ``line``
    (types_six_dof_expmap.h:648-765)."""
    ones = jnp.ones(p.shape[:-1] + (1,), dtype=p.dtype)
    ph = jnp.concatenate([p, ones], axis=-1)
    qh = jnp.concatenate([q, ones], axis=-1)
    l = jnp.cross(ph, qh)
    # eps inside the sqrt: gradient stays finite for degenerate p == q
    norm = jnp.sqrt(jnp.sum(l * l, axis=-1, keepdims=True) + eps)
    return l / norm


def point_to_image_line(pix: jnp.ndarray, line: jnp.ndarray) -> jnp.ndarray:
    """Dot of homogeneous pixel with line coefficients: line . [u, v, 1]."""
    return (
        line[..., 0] * pix[..., 0]
        + line[..., 1] * pix[..., 1]
        + line[..., 2]
    )


def undistort_points_np(uv, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0,
                        p2=0.0, k3=0.0, iterations=5):
    """Iterative radial-tangential keypoint undistortion on host numpy --
    ``Frame::UndistortKeyPoints`` (/root/reference/src/Frame.cc:1037-1081,
    which delegates to cv::undistortPoints on the detected keypoints).
    Identity (no copy) when all coefficients are zero, which is the case
    for every shipped yaml.  ``uv``: (N, 2) pixel coordinates."""
    import numpy as np

    if k1 == 0.0 and k2 == 0.0 and p1 == 0.0 and p2 == 0.0 and k3 == 0.0:
        return uv
    uv = np.asarray(uv, np.float64)
    x = (uv[:, 0] - cx) / fx
    y = (uv[:, 1] - cy) / fy
    x_u, y_u = x.copy(), y.copy()
    # fixed-point iteration of the OpenCV distortion model inverse
    for _ in range(iterations):
        r2 = x_u * x_u + y_u * y_u
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x_u * y_u + p2 * (r2 + 2.0 * x_u * x_u)
        dy = p1 * (r2 + 2.0 * y_u * y_u) + 2.0 * p2 * x_u * y_u
        x_u = (x - dx) / radial
        y_u = (y - dy) / radial
    out = np.stack([x_u * fx + cx, y_u * fy + cy], axis=1)
    return out.astype(np.float32)

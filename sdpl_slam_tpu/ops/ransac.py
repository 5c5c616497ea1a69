"""Batched RANSAC rigid-pose initialization (the cv::solvePnPRansac stand-in).

The reference initializes camera pose and object motions with OpenCV
AP3P RANSAC (500 iters, 0.4 px, conf 0.98 -- /root/reference/src/
Tracking.cc:2770-2779 and :2841-2972), then refines with the joint-flow
optimizer.  AP3P's quartic root-finding is branchy scalar code; with RGB-D
we have current-frame depth, so the minimal solver here is 3-point 3D-3D
alignment via orthonormal triads (exact for minimal samples, pure
arithmetic): all hypotheses are solved simultaneously as batched array
math with no data-dependent control flow.  Candidate scoring keeps the reference's
criterion exactly:
reprojection of last-frame 3D through the candidate pose vs the current 2D
position, inlier at < 0.4 px.  (Same init quality target, different minimal
solver; final estimates come from the identical joint optimizer.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import geometry
from .geometry import Intrinsics

_HI = jax.lax.Precision.HIGHEST


class RansacResult(NamedTuple):
    pose: jnp.ndarray        # (4,4) best world->camera candidate
    inliers: jnp.ndarray     # (N,) bool under the best candidate
    n_inliers: jnp.ndarray   # scalar int32


def _triad_align(P: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """Closed-form rigid alignment T with Q ~= R P + t for one MINIMAL
    sample of 3 correspondences, via orthonormal triads: build the frame
    (u, v, u x v) on each triangle and compose R = F_Q F_P^T.  Exact for
    rigid samples (what RANSAC hypotheses are), pure arithmetic -- no SVD
    iteration, which would dominate the batched hypothesis solve.
    Degenerate (collinear) samples produce a garbage rotation that the
    inlier scoring rejects.  P, Q: (3, 3) rows are points."""

    def frame(A):
        u = A[1] - A[0]
        u = u / (jnp.linalg.norm(u) + 1e-12)
        v = A[2] - A[0]
        v = v - jnp.dot(v, u) * u
        v = v / (jnp.linalg.norm(v) + 1e-12)
        w = jnp.cross(u, v)
        return jnp.stack([u, v, w], axis=1)

    R = jnp.matmul(frame(Q), frame(P).T, precision=_HI)
    t = Q.mean(axis=0) - R @ P.mean(axis=0)
    T = jnp.eye(4, dtype=P.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def ransac_rigid_init(
    X_last: jnp.ndarray,     # (N, 3) last-frame 3D in WORLD
    uv_cur: jnp.ndarray,     # (N, 2) current 2D positions
    X_cur: jnp.ndarray,      # (N, 3) current-frame 3D in CAMERA coords
    valid: jnp.ndarray,      # (N,) bool (usable for sampling & scoring)
    K: Intrinsics,
    key: jnp.ndarray,
    n_hypotheses: int = 256,
    reproj_thresh: float = 0.4,
) -> RansacResult:
    """All-hypotheses-parallel RANSAC: sample 3-point subsets, solve Horn,
    score by reprojection, return the best pose + its inlier set."""
    n = X_last.shape[0]
    dtype = X_last.dtype

    # compact valid rows to a prefix so uniform sampling hits only them
    order = jnp.argsort(jnp.where(valid, 0, 1), stable=True)
    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 3)
    Xl = X_last[order]
    Xc = X_cur[order]

    u = jax.random.uniform(key, (n_hypotheses, 3))
    idx = jnp.minimum((u * n_valid).astype(jnp.int32), n_valid - 1)

    P = Xl[idx]                      # (S, 3, 3)
    Q = Xc[idx]
    T = jax.vmap(_triad_align)(P, Q)  # (S, 4, 4)

    # score: reproject all last-3D through each candidate
    Xh = jnp.concatenate([X_last, jnp.ones((n, 1), dtype)], axis=1)
    Xc_all = jnp.einsum("sij,nj->sni", T, Xh, precision=_HI)[..., :3]
    proj = geometry.project(K, Xc_all)                      # (S, N, 2)
    err = jnp.linalg.norm(proj - uv_cur[None], axis=-1)
    front = Xc_all[..., 2] > 0
    inl = valid[None] & front & (err < reproj_thresh)       # (S, N)
    counts = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(counts)
    return RansacResult(
        pose=T[best], inliers=inl[best], n_inliers=counts[best]
    )

"""ORB descriptors: intensity-centroid orientation + rotated BRIEF, and
Hamming matching as a +/-1 matmul.

Parity notes (vs /root/reference/src/ORBextractor.cc):
* Orientation is the intensity-centroid angle over the umax-bounded
  circular patch (``IC_Angle``, ORBextractor.cc:66-95; umax setup
  :443-457) -- the per-row integer column bounds are replicated exactly.
* The 256 BRIEF point pairs are OpenCV's learned ``bit_pattern_31_``
  table (embedded by the reference at ORBextractor.cc:139-396; a
  published constant, reproduced in :mod:`.orb_pattern`).  Bit i is
  ``I(rot(p1)) < I(rot(p2))`` with the reference's exact rotation
  convention (``computeOrbDescriptor``, ORBextractor.cc:97-137):
  col = round(x cos - y sin), row = round(x sin + y cos); round is
  half-to-even, matching cvRound.  Descriptors remain a DEAD output in
  this pipeline -- matching is optical-flow-driven (SURVEY.md section
  2.1) -- but they are now bit-identical to the reference formula given
  the same smoothed intensities and angle (tests/test_orb_pattern.py).
* The pre-smoothing is a 7x7 Gaussian, sigma 2, reflect-101 borders,
  like the reference's GaussianBlur (ORBextractor.cc:1105); float
  arithmetic here vs OpenCV's fixed-point, so smoothed intensities can
  differ by <1 LSB on real images -- the formula-level test injects the
  smoothed patch directly.
* Matching (for the resurrected-retrieval use case): Hamming distance
  via the +/-1 encoding:  ham = (256 - A B^T) / 2  -- one f32 matmul
  instead of XOR+popcount loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .orb_pattern import BIT_PATTERN_31

PATCH = 31
HALF = PATCH // 2
N_BITS = 256
# the learned pattern's max point radius is ~18.38 (rotations reach
# offset 18), so descriptor sampling needs an extended patch
R_EXT = 18
PATCH_EXT = 2 * R_EXT + 1


def _gather_patches(img: jnp.ndarray, uv: jnp.ndarray,
                    radius: int = HALF) -> jnp.ndarray:
    """(N, 2r+1, 2r+1) patches centred at integral uv (clamped)."""
    h, w = img.shape
    side = 2 * radius + 1
    pad = radius + 1
    p = jnp.pad(img.astype(jnp.float32), pad, mode="edge")
    # reference centers at cvRound(pt) (ORBextractor.cc:70,105)
    base_u = jnp.clip(
        jnp.round(uv[:, 0]).astype(jnp.int32), 0, w - 1) + pad - radius
    base_v = jnp.clip(
        jnp.round(uv[:, 1]).astype(jnp.int32), 0, h - 1) + pad - radius

    def one(bu, bv):
        return jax.lax.dynamic_slice(p, (bv, bu), (side, side))

    return jax.vmap(one)(base_u, base_v)


@functools.lru_cache()
def _umax() -> np.ndarray:
    """Integer circular-patch column bounds, exactly as the reference
    builds them (ORBextractor.cc:443-457): rows 0..vmax from the circle
    equation with cvRound, rows vmin..HALF forced symmetric."""
    umax = np.zeros(HALF + 2, np.int64)
    vmax = int(np.floor(HALF * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF * np.sqrt(2.0) / 2))
    hp2 = float(HALF * HALF)
    for v in range(vmax + 1):
        # cvRound = round-half-to-even; sqrt values here are never .5
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    # for HALF=15 this is the canonical ORB table
    # [15,15,15,15,14,14,14,13,13,12,11,10,9,8,6,3]
    return umax[: HALF + 1]


@functools.lru_cache()
def _circular_mask() -> np.ndarray:
    """(31, 31) {0,1} mask of the IC_Angle summation region: row v
    (|v| <= 15) spans columns |u| <= umax[|v|]."""
    um = _umax()
    ys, xs = np.mgrid[-HALF:HALF + 1, -HALF:HALF + 1]
    return (np.abs(xs) <= um[np.abs(ys)]).astype(np.float32)


def ic_angle(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation (radians) per keypoint
    (``IC_Angle``, ORBextractor.cc:66-95)."""
    patches = _gather_patches(img, uv)
    mask = jnp.asarray(_circular_mask())
    ys, xs = np.mgrid[-HALF:HALF + 1, -HALF:HALF + 1]
    m01 = jnp.sum(patches * mask * jnp.asarray(ys, jnp.float32), axis=(1, 2))
    m10 = jnp.sum(patches * mask * jnp.asarray(xs, jnp.float32), axis=(1, 2))
    return jnp.arctan2(m01, m10)


def descriptor_bits_at_angle(patches: jnp.ndarray,
                             ang: jnp.ndarray) -> jnp.ndarray:
    """(N, 37, 37) smoothed patches + (N,) angles (radians) -> (N, 256)
    uint8 bits, the exact ``computeOrbDescriptor`` formula
    (ORBextractor.cc:97-137): for each learned pair, sample at
    (row + round(x sin + y cos), col + round(x cos - y sin)) and set the
    bit when the first intensity is strictly below the second."""
    pat = jnp.asarray(BIT_PATTERN_31, jnp.float32)        # (256, 4)
    c, s = jnp.cos(ang), jnp.sin(ang)                     # (N,)

    def rot(x, y):
        # reference: col offset = x*a - y*b, row offset = x*b + y*a
        xr = c[:, None] * x[None] - s[:, None] * y[None]
        yr = s[:, None] * x[None] + c[:, None] * y[None]
        xi = jnp.round(xr).astype(jnp.int32) + R_EXT
        yi = jnp.round(yr).astype(jnp.int32) + R_EXT
        return yi * PATCH_EXT + xi

    flat = patches.reshape(patches.shape[0], -1)
    v1 = jnp.take_along_axis(flat, rot(pat[:, 0], pat[:, 1]), axis=1)
    v2 = jnp.take_along_axis(flat, rot(pat[:, 2], pat[:, 3]), axis=1)
    return (v1 < v2).astype(jnp.uint8)


@functools.lru_cache()
def _gauss7() -> np.ndarray:
    """OpenCV getGaussianKernel(7, 2): normalized 7-tap Gaussian."""
    k = np.exp(-((np.arange(7) - 3.0) ** 2) / (2.0 * 2.0 ** 2))
    return (k / k.sum()).astype(np.float32)


def _gaussian_blur_7x7(img: jnp.ndarray) -> jnp.ndarray:
    """Separable 7x7 sigma-2 Gaussian with reflect-101 borders, like the
    reference's GaussianBlur(Size(7,7), 2, 2, BORDER_REFLECT_101)
    (ORBextractor.cc:1105)."""
    k = jnp.asarray(_gauss7())
    p = jnp.pad(img.astype(jnp.float32), 3, mode="reflect")
    # horizontal then vertical 7-tap
    h = sum(p[:, i:i + img.shape[1]] * k[i] for i in range(7))
    v = sum(h[i:i + img.shape[0], :] * k[i] for i in range(7))
    return v


@jax.jit
def brief_descriptors(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """256-bit rotated-BRIEF descriptors -> (N, 256) uint8 bits.

    Pipeline per the reference: Gaussian-smooth the level image
    (ORBextractor.cc:1105), IC-angle orientation, then the learned
    bit_pattern_31_ comparisons under the rotated sampling grid."""
    img_s = _gaussian_blur_7x7(img)
    ang = ic_angle(img_s, uv)
    patches = _gather_patches(img_s, uv, radius=R_EXT)    # (N, 37, 37)
    return descriptor_bits_at_angle(patches, ang)


@jax.jit
def hamming_distance_matrix(a_bits: jnp.ndarray,
                            b_bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) x (M, 256) bit arrays -> (N, M) Hamming distances via the
    +/-1-encoding matmul: ham = (256 - A B^T)/2 (the 'XOR-popcount as
    matmul' formulation)."""
    a = a_bits.astype(jnp.float32) * 2.0 - 1.0
    b = b_bits.astype(jnp.float32) * 2.0 - 1.0
    dot = jnp.matmul(a, b.T, precision=jax.lax.Precision.DEFAULT)
    return 0.5 * (a_bits.shape[1] - dot)


def match_descriptors(a_bits: jnp.ndarray, b_bits: jnp.ndarray,
                      max_distance: int = 64):
    """Mutual nearest-neighbour Hamming matching -> (idx_b_for_a, valid)."""
    d = hamming_distance_matrix(a_bits, b_bits)
    best_ab = jnp.argmin(d, axis=1)
    best_ba = jnp.argmin(d, axis=0)
    mutual = best_ba[best_ab] == jnp.arange(a_bits.shape[0])
    dist = jnp.take_along_axis(d, best_ab[:, None], axis=1)[:, 0]
    return best_ab, mutual & (dist <= max_distance)

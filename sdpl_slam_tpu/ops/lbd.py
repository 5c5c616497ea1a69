"""Line Band Descriptor (LBD): batched band-gradient statistics.

Faithful array formulation of the reference's BinaryDescriptor
(/root/reference/3rdparty/line_descriptor/src/binary_descriptor_custom.cpp):

- line-support region of NUM_OF_BANDS=9 bands x widthOfBand=7 rows across
  the line (:57, :113), each row sampled along the line direction;
- per row, separate sums of the positive/negative parts of the gradient
  projected on the line direction dL and its orthogonal dO (:1165-1180);
- global Gaussian weight over the 63 cross-line rows (sigma = (63-1)/2,
  :162-175) applied to the row sums (:1185-1193);
- band aggregation with LOCAL Gaussian weights (sigma = (2w+1)/2, :144-160):
  each row contributes to its own band (coef gaussCoefL[h%w + w]) and to the
  adjacent bands (coefs gaussCoefL[h%w + 2w] above / gaussCoefL[h%w] below,
  :1196-1241); squared sums use the squared coefficient;
- per-band mean/std with invN = 1/(2w) for the edge bands, 1/(3w) inside
  (:1252-1259); per-band 8-vector layout
  [m_pL, m_nL, m_pO, m_nO, s_pL, s_nL, s_pO, s_nO] (:1262-1279);
- mean part and std part L2-normalized SEPARATELY (:1286-1314), then
  clamped at 0.4 and renormalized jointly (:1316-1340);
- binarization over the fixed 32 band-pair ``combinations`` table (:74-106):
  byte c has bit i set iff desVec[8*b1+i] > desVec[8*b2+i]
  (binaryConversion, :401-412; assembly :660-666) -> 256 bits, compatible
  with :func:`..ops.orb.hamming_distance_matrix`.

Fixed-shape adaptation: the reference walks every pixel along the line (variable
length); here each row is sampled at a fixed ``N_SAMPLES`` positions
spanning the segment (static shapes).  Row sums then carry a constant
factor relative to the reference, which cancels in the L2 normalizations.

Note the descriptors are a dead output at runtime in the reference -- the
tracker matches by optical flow, not descriptors (SURVEY.md section 2.1).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

N_SAMPLES = 32        # fixed samples along the line (static shape)
N_BANDS = 9           # NUM_OF_BANDS (:57)
BAND_WIDTH = 7        # widthOfBand_ (:113)
_N_ROWS = N_BANDS * BAND_WIDTH

# the reference's 32 band-pair combinations (:74-106)
_COMBINATIONS = np.array([
    [0, 1], [0, 2], [0, 3], [0, 4], [0, 5], [0, 6],
    [1, 2], [1, 3], [1, 4], [1, 5], [1, 6],
    [2, 3], [2, 4], [2, 5], [2, 6], [2, 7], [2, 8],
    [3, 4], [3, 5], [3, 6], [3, 7], [3, 8],
    [4, 5], [4, 6], [4, 7], [4, 8],
    [5, 6], [5, 7], [5, 8],
    [6, 7], [6, 8],
    [7, 8],
], np.int32)


def _gauss_coefs():
    """(global (63,), local (21,)) Gaussian weights (:144-175)."""
    w = BAND_WIDTH
    u_l = (w * 3 - 1) / 2.0
    sigma_l = (w * 2 + 1) / 2.0
    i = np.arange(w * 3, dtype=np.float64)
    coef_l = np.exp(-((i - u_l) ** 2) / (2 * sigma_l * sigma_l))
    u_g = (_N_ROWS - 1) / 2.0
    sigma_g = u_g
    j = np.arange(_N_ROWS, dtype=np.float64)
    coef_g = np.exp(-((j - u_g) ** 2) / (2 * sigma_g * sigma_g))
    return coef_g.astype(np.float32), coef_l.astype(np.float32)


_COEF_G, _COEF_L = _gauss_coefs()


def _band_matrices():
    """(9, 63) coef / coef^2 matrices mapping weighted row sums to band
    sums, encoding the own/above/below contributions (:1196-1241)."""
    w = BAND_WIDTH
    A = np.zeros((N_BANDS, _N_ROWS), np.float32)
    for h in range(_N_ROWS):
        band = h // w
        A[band, h] += _COEF_L[h % w + w]            # own band
        if band - 1 >= 0:
            A[band - 1, h] += _COEF_L[h % w + 2 * w]  # band above
        if band + 1 < N_BANDS:
            A[band + 1, h] += _COEF_L[h % w]          # band below
    return A, A * A


_BAND_A, _BAND_A2 = _band_matrices()

# invN per band: edge bands only see 2w rows, inner bands 3w (:1252-1259)
_INV_N = np.full(N_BANDS, 1.0 / (BAND_WIDTH * 3.0), np.float32)
_INV_N[0] = _INV_N[-1] = 1.0 / (BAND_WIDTH * 2.0)


def _grad(img):
    """3x3 Sobel, matching the reference's cv::Sobel inputs (:393-396)."""
    img = img.astype(jnp.float32)
    p = jnp.pad(img, 1, mode="edge")
    gx = (
        (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    )
    gy = (
        (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    )
    return gx, gy


def _bilinear(img, u, v):
    h, w = img.shape
    u = jnp.clip(u, 0.0, w - 1.001)
    v = jnp.clip(v, 0.0, h - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = u - u0
    dv = v - v0
    a = img[v0, u0]
    b = img[v0, u0 + 1]
    c = img[v0 + 1, u0]
    d = img[v0 + 1, u0 + 1]
    return (
        a * (1 - du) * (1 - dv) + b * du * (1 - dv)
        + c * (1 - du) * dv + d * du * dv
    )


@jax.jit
def lbd_float_descriptors(img: jnp.ndarray, uv4: jnp.ndarray) -> jnp.ndarray:
    """(L, 4) segments -> (L, 72) float LBD descriptors (normalized,
    clamped; the reference's returnFloatDescr output, :668-681)."""
    gx, gy = _grad(img)
    s = uv4[:, :2]
    e = uv4[:, 2:]
    d = e - s
    length = jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    dL = d / length                                  # along-line unit
    dO = jnp.stack([-dL[:, 1], dL[:, 0]], -1)        # orthogonal unit

    ts = jnp.linspace(0.0, 1.0, N_SAMPLES)
    hs = jnp.arange(_N_ROWS, dtype=jnp.float32) - (_N_ROWS - 1) / 2.0
    # sample grid: (L, R=63, S, 2); row h offset across, t along
    base = s[:, None, :] + ts[None, :, None] * d[:, None, :]   # (L, S, 2)
    pts = base[:, None, :, :] + hs[None, :, None, None] * dO[:, None, None, :]
    pu, pv = pts[..., 0], pts[..., 1]
    sgx = _bilinear(gx, pu, pv)                      # (L, R, S)
    sgy = _bilinear(gy, pu, pv)
    gDL = sgx * dL[:, None, None, 0] + sgy * dL[:, None, None, 1]
    gDO = sgx * dO[:, None, None, 0] + sgy * dO[:, None, None, 1]

    # per-row sums of the 4 signed components (:1165-1180), then the
    # global Gaussian row weight (:1185-1193)
    comps = jnp.stack([
        jnp.maximum(gDL, 0), jnp.maximum(-gDL, 0),
        jnp.maximum(gDO, 0), jnp.maximum(-gDO, 0),
    ], axis=-1)                                      # (L, R, S, 4)
    row = comps.sum(axis=2) * _COEF_G[None, :, None]  # (L, R, 4)
    row2 = row * row

    # band aggregation with local Gaussian coefs (:1196-1241)
    band = jnp.einsum("br,lrc->lbc", jnp.asarray(_BAND_A), row)
    band2 = jnp.einsum("br,lrc->lbc", jnp.asarray(_BAND_A2), row2)
    inv_n = jnp.asarray(_INV_N)[None, :, None]
    mean = band * inv_n                              # (L, 9, 4)
    var = jnp.maximum(band2 * inv_n - mean * mean, 0.0)
    std = jnp.sqrt(var)

    # per-band layout [m_pL, m_nL, m_pO, m_nO, s_pL, s_nL, s_pO, s_nO]
    des = jnp.concatenate([mean, std], axis=-1)      # (L, 9, 8)
    des = des.reshape(uv4.shape[0], -1)              # (L, 72)

    # normalize mean part and std part separately (:1286-1314)
    idx = jnp.arange(72)
    is_mean = (idx % 8) < 4
    nm = jnp.linalg.norm(jnp.where(is_mean, des, 0.0), axis=1, keepdims=True)
    ns = jnp.linalg.norm(jnp.where(is_mean, 0.0, des), axis=1, keepdims=True)
    des = jnp.where(is_mean, des / (nm + 1e-12), des / (ns + 1e-12))
    # clamp at 0.4 and renormalize (:1316-1340)
    des = jnp.minimum(des, 0.4)
    des = des / (jnp.linalg.norm(des, axis=1, keepdims=True) + 1e-12)
    return des


@jax.jit
def lbd_descriptors(img: jnp.ndarray, uv4: jnp.ndarray) -> jnp.ndarray:
    """(L, 4) segments -> (L, 256) uint8 bit descriptors via the 32
    band-pair combinations (:74-106, :401-412, :660-666)."""
    des = lbd_float_descriptors(img, uv4)            # (L, 72)
    b1 = jnp.asarray(_COMBINATIONS[:, 0])
    b2 = jnp.asarray(_COMBINATIONS[:, 1])
    f1 = des.reshape(-1, N_BANDS, 8)[:, b1, :]       # (L, 32, 8)
    f2 = des.reshape(-1, N_BANDS, 8)[:, b2, :]
    bits = (f1 > f2).astype(jnp.uint8)               # bit i of byte c
    return bits.reshape(-1, 256)

"""Vectorized FAST corner detection + pyramid + grid distribution.

Array re-design of the reference's ORB extractor front end
(/root/reference/src/ORBextractor.cc): 8-level image pyramid (scale 1.2),
FAST-9/16 segment test with ini/min thresholds (ComputeKeyPointsOctTree,
:754), and spatially-distributed keypoint retention (DistributeOctTree,
:528).  The per-pixel segment test is evaluated for ALL pixels at once as
16 shifted image planes (elementwise ops that XLA fuses); the octree distribution is
replaced by a per-cell top-k on a regular grid -- the same goal (spatially
even coverage capped at nFeatures) with a fixed-shape, sort-based
formulation.  Descriptors are intentionally omitted from the hot path: the
reference computes BRIEF but never matches with it -- correspondence is
optical-flow-driven (SURVEY.md section 2.1 ORBextractor row).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 (OpenCV FAST_9_16 order): (du, dv)
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # FAST-9: a corner has 9 contiguous ring pixels all brighter
#            (or all darker) than the centre by more than the threshold


def _has_arc(mask: jnp.ndarray) -> jnp.ndarray:
    """Whether the 16-bit ring mask (bit i = ring pixel i passes) holds a
    circular run of 9 set bits: the circle unrolled into 32 bits, runs of
    2, 4 and 8 by shift-and, then one more bit."""
    m = mask | (mask << 16)
    r2 = m & (m >> 1)
    r4 = r2 & (r2 >> 2)
    r8 = r4 & (r4 >> 4)
    return (r8 & (m >> 8) & 0xFFFF) != 0


def _fast_responses(img: jnp.ndarray, thresholds) -> list:
    """FAST-9/16 corner response for every pixel, one map per threshold
    (0 = not a corner), all from one pass over the 16 ring offsets.

    Each threshold's bright and dark tests are packed into 16-bit masks
    and its score accumulates ring by ring, so everything is elementwise
    work on static slices of one zero-padded image: XLA fuses it into one
    loop that reads the image, with no (16, H, W) intermediate.  Score:
    OpenCV-style sum-of-absolute-differences over the ring (statistically
    equivalent ranking).
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    p = jnp.pad(img, 3)
    n = len(thresholds)
    bright, dark, sad = [0] * n, [0] * n, [0.0] * n
    for i, (du, dv) in enumerate(_CIRCLE):
        d = p[3 + dv:3 + dv + h, 3 + du:3 + du + w] - img
        a = jnp.abs(d)
        bit = jnp.int32(1 << i)
        for k, t in enumerate(thresholds):
            bright[k] = bright[k] | jnp.where(d > t, bit, 0)
            dark[k] = dark[k] | jnp.where(d < -t, bit, 0)
            sad[k] = sad[k] + jnp.maximum(a - t, 0.0)
    return [
        jnp.where(_has_arc(b) | _has_arc(dk), sc, 0.0)
        for b, dk, sc in zip(bright, dark, sad)
    ]


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9/16 corner response for every pixel (0 = not a corner)."""
    return _fast_responses(img, (threshold,))[0]


def _level_score(img: jnp.ndarray, cfg: FastPyramidConfig) -> jnp.ndarray:
    """Two-pass FAST response of one pyramid level (ORBextractor.cc:790-810):
    where the strict threshold finds no corner, the weak one fills in at a
    quarter of its score."""
    score, score_min = _fast_responses(
        img, (cfg.ini_threshold, cfg.min_threshold))
    return jnp.where(score > 0, score, 0.25 * score_min)


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression."""
    mx = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((score >= mx) & (score > 0), score, 0.0)


def _grid_topk(score: jnp.ndarray, cell: int, per_cell: int):
    """Top-``per_cell`` corners per (cell x cell) tile.  Returns flat
    (uv, score, valid) of size n_cells*per_cell."""
    h, w = score.shape
    gh, gw = h // cell, w // cell
    s = score[: gh * cell, : gw * cell]
    tiles = s.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(gh * gw, cell * cell)
    val, idx = jax.lax.top_k(tiles, per_cell)         # (C, per_cell)
    cy = (jnp.arange(gh * gw) // gw) * cell
    cx = (jnp.arange(gh * gw) % gw) * cell
    v = cy[:, None] + idx // cell
    u = cx[:, None] + idx % cell
    uv = jnp.stack([u, v], axis=-1).reshape(-1, 2).astype(jnp.float32)
    sc = val.reshape(-1)
    return uv, sc, sc > 0


class FastPyramidConfig(NamedTuple):
    n_features: int = 2500
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_threshold: float = 20.0
    min_threshold: float = 7.0
    cell: int = 32
    per_cell: int = 4


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_keypoints_batch(imgs: jnp.ndarray,
                           cfg: "FastPyramidConfig" = None):
    """Batched multi-frame detection (SURVEY.md section 2.3: the batched
    front-end replacing the reference's per-frame extraction loops):
    imgs (B, H, W) -> (uv (B, n, 2), score (B, n), valid (B, n)).  One
    compiled program amortizes pyramid+FAST over the frame batch."""
    cfg = cfg or FastPyramidConfig()
    return jax.vmap(lambda im: detect_keypoints(im, cfg))(imgs)


@functools.partial(
    jax.jit, static_argnames=("cfg",)
)
def detect_keypoints(img: jnp.ndarray, cfg: FastPyramidConfig = FastPyramidConfig()):
    """Multi-scale FAST detection with even spatial distribution.

    Returns (uv, score, valid) with shape caps n_features; uv in level-0
    pixel coordinates (integral, like the reference's keypoints).
    """
    h, w = img.shape
    img_f = img.astype(jnp.float32)
    all_uv, all_sc, all_va = [], [], []
    for lvl in range(cfg.n_levels):
        s = cfg.scale_factor ** lvl
        lh, lw = int(round(h / s)), int(round(w / s))
        if min(lh, lw) < 32:
            break
        lvl_img = (
            img_f if lvl == 0
            else jax.image.resize(img_f, (lh, lw), "linear")
        )
        score = _nms3(_level_score(lvl_img, cfg))
        cell = max(cfg.cell // int(round(s)), 8)
        uv, sc, va = _grid_topk(score, cell, cfg.per_cell)
        all_uv.append(jnp.round(uv * s))
        all_sc.append(sc)
        all_va.append(va)
    uv = jnp.concatenate(all_uv)
    sc = jnp.concatenate(all_sc)
    va = jnp.concatenate(all_va)
    # global top-n_features by response among valid
    order = jax.lax.top_k(jnp.where(va, sc, -1.0), cfg.n_features)[1]
    uv_out = uv[order]
    sc_out = sc[order]
    va_out = va[order] & (sc_out > 0)
    return uv_out, sc_out, va_out

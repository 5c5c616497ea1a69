"""ORB keypoint-retention distribution parity vs the octree oracle.

The reference retains FAST corners per level with DistributeOctTree
(/root/reference/src/ORBextractor.cc:528-754); the production path
uses per-cell top-k + global response top-k (ops/fast.py:_grid_topk).
These tests quantify, on synthetic corner fields, that the grid policy
retains a keypoint SET with the same statistical properties the octree
produces: spatial occupancy, retention count, response preference, and
point-level overlap.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sdpl_slam_tpu.ops import fast
from sdpl_slam_tpu.ops.octree_oracle import (
    distribute_octree, features_per_level, retain_reference,
)


H, W = 200, 608
N_TARGET = 250


def _corner_field(seed, n=2000, clustered=False):
    """Sparse response map of isolated corner responses."""
    rng = np.random.default_rng(seed)
    score = np.zeros((H, W), np.float32)
    if clustered:
        # half the corners inside one 100x80 hotspot
        xs1 = rng.integers(200, 300, n // 2)
        ys1 = rng.integers(60, 140, n // 2)
        xs2 = rng.integers(3, W - 3, n - n // 2)
        ys2 = rng.integers(3, H - 3, n - n // 2)
        xs = np.concatenate([xs1, xs2])
        ys = np.concatenate([ys1, ys2])
    else:
        xs = rng.integers(3, W - 3, n)
        ys = rng.integers(3, H - 3, n)
    score[ys, xs] = rng.uniform(5.0, 200.0, n).astype(np.float32)
    return score


def _grid_retain(score, n_target, cell=32, per_cell=4):
    """The production retention policy on one level's response map."""
    uv, sc, va = fast._grid_topk(jnp.asarray(score), cell, per_cell)
    uv, sc, va = np.asarray(uv), np.asarray(sc), np.asarray(va)
    order = np.argsort(-np.where(va, sc, -1.0))[:n_target]
    keep = order[va[order] & (sc[order] > 0)]
    return np.concatenate(
        [uv[keep], sc[keep, None]], axis=1
    )


def _occupancy(rows, bx=8, by=4):
    hgrid = np.zeros((by, bx))
    for x, y, _ in rows:
        hgrid[min(int(y * by / H), by - 1), min(int(x * bx / W), bx - 1)] += 1
    return hgrid / max(len(rows), 1)


@pytest.fixture(scope="module", params=[False, True],
                ids=["uniform", "clustered"])
def retained(request):
    score = _corner_field(7, clustered=request.param)
    ref = retain_reference(score, N_TARGET)
    prod = _grid_retain(score, N_TARGET)
    return score, ref, prod


def test_retention_counts_match(retained):
    _, ref, prod = retained
    assert len(ref) > 0 and len(prod) > 0
    # octree stops at >= N leaves (one keypoint each); grid caps at N
    assert abs(len(prod) - len(ref)) <= 0.25 * len(ref), (
        len(ref), len(prod))


def test_spatial_occupancy_matches(retained):
    _, ref, prod = retained
    tv = 0.5 * np.abs(_occupancy(ref) - _occupancy(prod)).sum()
    # total-variation distance between block histograms
    assert tv <= 0.25, tv


def test_response_preference_matches(retained):
    _, ref, prod = retained
    # both policies keep locally-strongest corners: retained mean
    # response must be comparable (and far above the field mean)
    m_ref, m_prod = ref[:, 2].mean(), prod[:, 2].mean()
    assert m_prod >= 0.85 * m_ref, (m_ref, m_prod)


def test_point_overlap(retained):
    score, ref, prod = retained
    # a majority of octree-retained keypoints are also grid-retained
    ps = {(int(x), int(y)) for x, y, _ in prod}
    hits = sum(1 for x, y, _ in ref if (int(x), int(y)) in ps)
    assert hits / len(ref) >= 0.5, hits / len(ref)


def test_features_per_level_series():
    """mnFeaturesPerLevel: geometric split with remainder on the last
    level (ORBextractor.cc:409-424)."""
    fpl = features_per_level(2500, 1.2, 8)
    assert len(fpl) == 8
    assert sum(fpl) == 2500
    assert fpl[0] > fpl[1] > fpl[6]
    ratio = fpl[1] / fpl[0]
    assert abs(ratio - 1 / 1.2) < 0.02


def test_octree_keeps_best_per_leaf():
    """In a field with one dominant corner per area, the octree keeps
    exactly the dominant ones."""
    score = np.zeros((64, 128), np.float32)
    strong = [(10, 10), (100, 20), (40, 50), (80, 55)]
    for i, (x, y) in enumerate(strong):
        score[y, x] = 100.0 + i
        score[y + 2, x + 2] = 1.0       # weak shadow nearby
    rows = retain_reference(score, 4)
    got = {(int(x), int(y)) for x, y, _ in rows}
    assert got == set(strong), got

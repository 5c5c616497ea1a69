import jax.numpy as jnp
import numpy as np
import pytest

from sdpl_slam_tpu.ops import fast


def make_corner_image(rng, h=192, w=320, n_squares=30):
    """Random bright rectangles on dark background: corners at known spots."""
    img = np.full((h, w), 30, np.uint8)
    corners = []
    for _ in range(n_squares):
        y = rng.integers(10, h - 30)
        x = rng.integers(10, w - 30)
        hh = rng.integers(8, 20)
        ww = rng.integers(8, 20)
        img[y:y + hh, x:x + ww] = 220
        corners += [(x, y), (x + ww - 1, y), (x, y + hh - 1),
                    (x + ww - 1, y + hh - 1)]
    return img, np.asarray(corners, np.float32)


def test_fast_score_map_detects_rect_corners(rng):
    img, corners = make_corner_image(rng, n_squares=10)
    score = np.asarray(fast.fast_score_map(jnp.asarray(img), 20.0))
    # most true corners have a strong response within 2px
    hits = 0
    for (x, y) in corners:
        patch = score[max(int(y) - 2, 0):int(y) + 3,
                      max(int(x) - 2, 0):int(x) + 3]
        if patch.max() > 0:
            hits += 1
    assert hits / len(corners) > 0.7, hits / len(corners)
    # flat regions: no response
    assert score[5:20, 5:20].max() == 0.0


def test_detect_keypoints_end_to_end(rng):
    img, corners = make_corner_image(rng)
    cfg = fast.FastPyramidConfig(n_features=500, n_levels=4)
    uv, sc, valid = fast.detect_keypoints(jnp.asarray(img), cfg)
    uv = np.asarray(uv)[np.asarray(valid)]
    assert len(uv) > 50
    # all detections inside the image
    assert (uv[:, 0] >= 0).all() and (uv[:, 0] < 320).all()
    assert (uv[:, 1] >= 0).all() and (uv[:, 1] < 192).all()
    # recall: most ground-truth corners have a detection within 3 px
    hits = 0
    for (x, y) in corners:
        d = np.abs(uv - [x, y]).max(axis=1).min() if len(uv) else 99
        if d <= 3:
            hits += 1
    assert hits / len(corners) > 0.6, hits / len(corners)


def test_detect_keypoints_spatial_distribution(rng):
    """Corners everywhere -> detections must cover all quadrants."""
    img, _ = make_corner_image(rng, n_squares=60)
    cfg = fast.FastPyramidConfig(n_features=300, n_levels=2)
    uv, sc, valid = fast.detect_keypoints(jnp.asarray(img), cfg)
    uv = np.asarray(uv)[np.asarray(valid)]
    for qx in (0, 1):
        for qy in (0, 1):
            n = (
                (uv[:, 0] >= qx * 160) & (uv[:, 0] < (qx + 1) * 160)
                & (uv[:, 1] >= qy * 96) & (uv[:, 1] < (qy + 1) * 96)
            ).sum()
            assert n > 10, (qx, qy, n)


def _fast_reference(img, t):
    """Per-pixel FAST-9/16 straight from its definition, in numpy."""
    img = img.astype(np.float64)
    h, w = img.shape
    p = np.pad(img, 3)
    ring = np.stack([p[3 + dv:3 + dv + h, 3 + du:3 + du + w]
                     for du, dv in fast._CIRCLE]) - img
    out = np.zeros((h, w))
    for mask in (ring > t, ring < -t):
        run = np.zeros((h, w), bool)
        for s in range(16):
            run |= np.all([mask[(s + k) % 16] for k in range(9)], axis=0)
        out = np.where(run, np.maximum(np.abs(ring) - t, 0).sum(0), out)
    return out


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_score_map_matches_definition(rng, threshold):
    img = rng.integers(0, 255, (48, 70)).astype(np.uint8)
    img[10:30, 20:40] = 250                       # solid corners too
    got = np.asarray(fast.fast_score_map(jnp.asarray(img), threshold))
    np.testing.assert_array_equal(got, _fast_reference(img, threshold))
    assert (got > 0).mean() > 0.05


def test_level_score_two_thresholds(rng):
    """The one-pass pair equals the strict map, filled in by a quarter of
    the weak map where the strict one found nothing."""
    img = rng.integers(0, 255, (40, 64)).astype(np.uint8)
    cfg = fast.FastPyramidConfig()
    got = np.asarray(fast._level_score(jnp.asarray(img, jnp.float32), cfg))
    hi = _fast_reference(img, cfg.ini_threshold)
    lo = _fast_reference(img, cfg.min_threshold)
    np.testing.assert_array_equal(got, np.where(hi > 0, hi, 0.25 * lo))

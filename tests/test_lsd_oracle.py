"""Line-detector fidelity vs the faithful LSD oracle.

The oracle (ops/lsd_oracle.py) is a from-spec numpy implementation of
the von Gioi LSD algorithm that the reference runs via OpenCV's
createLineSegmentDetector (LSDDetector_custom.cpp:291-309).  Tests:

 1. the oracle itself behaves like LSD: finds the edges of synthetic
    rectangles with sub-pixel endpoints, and its NFA a-contrario control
    yields ~zero detections on pure noise;
 2. the production tiled-PCA detector (ops/lines.py) is measured
    against the oracle on textured synthetic scenes with quantified
    recall / precision / perpendicular-error thresholds -- replacing the
    earlier self-referential recall tests.
"""

import math

import numpy as np
import pytest

from sdpl_slam_tpu.ops.lsd_oracle import (
    LSDOracle, LSDParams, detect_pyramid,
)


def _draw_bar(img, cx, cy, length, width, angle, amp):
    h, w = img.shape
    dx, dy = math.cos(angle), math.sin(angle)
    yy, xx = np.mgrid[0:h, 0:w]
    l = (xx - cx) * dx + (yy - cy) * dy
    t = -(xx - cx) * dy + (yy - cy) * dx
    img[(np.abs(l) < length / 2) & (np.abs(t) < width / 2)] += amp


def _scene(seed, h=240, w=320, n_bars=6):
    """Textured scene: noisy background + illumination gradient + random
    bright bars (each contributes two long parallel edges)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(110.0, 5.0, (h, w))
    img += np.linspace(0, 25, w)[None, :]
    bars = []
    for _ in range(n_bars):
        cx = rng.uniform(60, w - 60)
        cy = rng.uniform(50, h - 50)
        ang = rng.uniform(0, math.pi)
        ln = rng.uniform(70, 150)
        wd = rng.uniform(6, 14)
        _draw_bar(img, cx, cy, ln, wd, ang, rng.uniform(45, 75))
        bars.append((cx, cy, ln, wd, ang))
    return np.clip(img, 0, 255), bars


def _seg_angle(s):
    return math.atan2(s[3] - s[1], s[2] - s[0])


def _perp_dist(p, seg):
    """Distance of point p to the infinite line through seg."""
    x1, y1, x2, y2 = seg[:4]
    dx, dy = x2 - x1, y2 - y1
    n = math.hypot(dx, dy)
    if n < 1e-9:
        return math.hypot(p[0] - x1, p[1] - y1)
    return abs((p[0] - x1) * dy - (p[1] - y1) * dx) / n


def _overlap_frac(a, b):
    """Fraction of segment a's length that projects inside segment b's
    longitudinal extent."""
    x1, y1, x2, y2 = b[:4]
    dx, dy = x2 - x1, y2 - y1
    n = math.hypot(dx, dy)
    if n < 1e-9:
        return 0.0
    ux, uy = dx / n, dy / n
    ta = sorted([
        ((a[0] - x1) * ux + (a[1] - y1) * uy),
        ((a[2] - x1) * ux + (a[3] - y1) * uy),
    ])
    lo, hi = max(ta[0], 0.0), min(ta[1], n)
    la = math.hypot(a[2] - a[0], a[3] - a[1])
    return max(hi - lo, 0.0) / max(la, 1e-9)


def _match(a, b, ang_tol=math.radians(10), lat_tol=3.0, min_ov=0.5):
    """Does segment a lie along segment b?"""
    d = abs(_seg_angle(a) - _seg_angle(b)) % math.pi
    d = min(d, math.pi - d)
    if d > ang_tol:
        return False
    if _perp_dist(((a[0] + a[2]) / 2, (a[1] + a[3]) / 2), b) > lat_tol:
        return False
    return _overlap_frac(a, b) > min_ov


def _detector_fidelity(oracle_segs, det_segs, min_len=25.0):
    """recall: oracle lines (len >= min_len) covered by detections;
    precision: detections lying along some oracle line; perp RMS of
    matched detection endpoints to the oracle infinite line."""
    o_long = [s for s in oracle_segs
              if math.hypot(s[2] - s[0], s[3] - s[1]) >= min_len]
    hits = 0
    for o in o_long:
        if any(_match(d, o, min_ov=0.3) or _match(o, d, min_ov=0.3)
               for d in det_segs):
            hits += 1
    recall = hits / max(len(o_long), 1)
    good = 0
    errs = []
    for d in det_segs:
        m = [o for o in oracle_segs if _match(d, o, min_ov=0.55)]
        if m:
            good += 1
            o = m[0]
            errs += [_perp_dist((d[0], d[1]), o),
                     _perp_dist((d[2], d[3]), o)]
    precision = good / max(len(det_segs), 1)
    rms = float(np.sqrt(np.mean(np.square(errs)))) if errs else np.inf
    return recall, precision, rms


# ---------------------------------------------------------------------------
# 1. oracle sanity
# ---------------------------------------------------------------------------


def test_oracle_finds_rectangle_edges():
    rng = np.random.default_rng(1)
    img = rng.normal(120, 4, (120, 160))
    img[30:80, 40:120] += 60
    segs = LSDOracle(LSDParams()).detect(np.clip(img, 0, 255))
    # the four edges: x~40, x~119, y~29, y~79 (edge falls between pixels)
    expected = [
        (39, 29, 39, 79), (118, 29, 118, 79),
        (40, 28, 119, 28), (40, 78, 119, 78),
    ]
    for e in expected:
        assert any(_match(np.asarray(e, float), s, lat_tol=2.5,
                          min_ov=0.55)
                   for s in segs), (e, segs[:, :4])


def test_oracle_nfa_controls_noise():
    """a-contrario property: iid noise must yield (almost) no detections
    -- this is exactly what the tiled-PCA path lacked a gate for."""
    total = 0
    for seed in range(3):
        rng = np.random.default_rng(seed)
        img = rng.normal(128, 20, (160, 200))
        segs = LSDOracle(LSDParams()).detect(np.clip(img, 0, 255))
        total += len(segs)
    assert total <= 1, total


def test_oracle_pyramid_min_length_quirk():
    """detect_pyramid applies the reference's quirk: min_length is in
    full-image units but gates IN-OCTAVE lengths (so octave-1 keeps
    segments whose full-res length is 2x the threshold)."""
    rng = np.random.default_rng(2)
    img = rng.normal(120, 4, (120, 160))
    img[30:80, 40:120] += 60
    segs = detect_pyramid(np.clip(img, 0, 255), n_octaves=2)
    assert len(segs) > 0
    min_len = 0.02 * 120
    for s in segs:
        in_oct = math.hypot(s[2] - s[0], s[3] - s[1]) / (2.0 ** s[5])
        assert in_oct > min_len * 0.99


# ---------------------------------------------------------------------------
# 2. production detector vs oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fidelity_runs():
    from sdpl_slam_tpu.ops import lines as L

    runs = []
    for seed in (11, 12, 13):
        img, _ = _scene(seed)
        oracle_segs = detect_pyramid(img, n_octaves=2)[:, :4]
        det = L.detect_lines_np(img.astype(np.float32))
        runs.append((oracle_segs, det))
    return runs


def test_production_recall_vs_oracle(fidelity_runs):
    recalls = [
        _detector_fidelity(o, d)[0] for o, d in fidelity_runs
    ]
    # tiled-PCA must recover the overwhelming majority of true LSD lines
    assert np.mean(recalls) >= 0.75, recalls
    assert min(recalls) >= 0.6, recalls


def test_production_precision_vs_oracle(fidelity_runs):
    precisions = [
        _detector_fidelity(o, d)[1] for o, d in fidelity_runs
    ]
    assert np.mean(precisions) >= 0.7, precisions


def test_production_endpoint_error_vs_oracle(fidelity_runs):
    rms = [_detector_fidelity(o, d)[2] for o, d in fidelity_runs]
    assert np.mean(rms) <= 1.5, rms

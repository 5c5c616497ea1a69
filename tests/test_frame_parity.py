"""The jnp feature-selection ops (models/frame.py, run by the
device-resident paths) must agree exactly with the host numpy mirrors
(models/frame_host.py, run by the host path)."""

import jax.numpy as jnp
import numpy as np

from sdpl_slam_tpu.models import frame as fr
from sdpl_slam_tpu.models import frame_host as fh

from synthetic import SynthConfig, SynthSequence



def assert_valid_rows_equal(out_j, out_h):
    """Compare outputs only where valid (padding rows are unspecified)."""
    vj = np.asarray(out_j[-1])
    vh = np.asarray(out_h[-1])
    np.testing.assert_array_equal(vj, vh)
    for a, b in zip(out_j[:-1], out_h[:-1]):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a[vj], b[vh], atol=1e-5)


def maps(rng):
    seq = SynthSequence(SynthConfig(n_frames=2, n_objects=1, seed=3))
    f = seq.frame(0)
    return f.depth, f.flow, f.mask, f.lines


def test_static_point_selection_parity(rng):
    depth, flow, mask, _ = maps(rng)
    h, w = mask.shape
    cand = np.round(rng.uniform([1, 1], [w - 2, h - 2], (500, 2))).astype(
        np.float32
    )
    valid = rng.uniform(size=500) > 0.1
    out_j = fr.select_static_points(
        jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(depth),
        jnp.asarray(flow), jnp.asarray(mask), 70.0, 256,
    )
    out_h = fh.select_static_points(cand, valid, depth, flow, mask, 70.0, 256)
    assert_valid_rows_equal(out_j, out_h)


def test_object_point_selection_parity(rng):
    depth, flow, mask, _ = maps(rng)
    out_j = fr.select_object_points(
        jnp.asarray(depth), jnp.asarray(flow), jnp.asarray(mask), 30.0, 512,
    )
    out_h = fh.select_object_points(depth, flow, mask, 30.0, 512)
    assert_valid_rows_equal(out_j, out_h)


def test_static_line_selection_parity(rng):
    depth, flow, mask, lines = maps(rng)
    n = len(lines)
    cap = 64
    cand = np.zeros((80, 4), np.float32)
    cand[:n] = lines[:80]
    valid = np.arange(80) < n
    out_j = fr.select_static_lines(
        jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(depth),
        jnp.asarray(flow), jnp.asarray(mask), 70.0, cap,
    )
    out_h = fh.select_static_lines(cand, valid, depth, flow, mask, 70.0, cap)
    assert_valid_rows_equal(out_j, out_h)

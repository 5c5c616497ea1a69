"""Frame feature ops: fixed-capacity, mask-validated per-frame state.

Array re-design of the reference ``Frame`` (/root/reference/src/Frame.cc) and
the per-frame parts of ``Tracking``: instead of ragged ``std::vector``s and
scalar loops, every feature family lives in a fixed-capacity array with a
validity mask, so the whole front-end is gathers/wheres that XLA fuses.

Index-alignment invariant (the reference's core trick): object features are
index-aligned between adjacent frames -- ``cur.obj_uv = last.obj_corres``
(/root/reference/src/Tracking.cc:334), so frame-to-frame correspondence is
the identity and no matching problem exists.  Static features likewise
(``cur.stat_uv = last.stat_corres``, Tracking.cc:273-276).

Lookups use integer truncation of pixel coordinates, replicating the
reference's ``.at<T>((int)y, (int)x)`` accesses.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import geometry, lie
from ..ops.geometry import Intrinsics


def _ifloor(x):
    return jnp.floor(x).astype(jnp.int32)


def lookup_nearest(img: jnp.ndarray, uv: jnp.ndarray):
    """img[(int)v, (int)u] with clamped indices; also returns in-bounds mask
    using the reference's open-interval bounds (0 < u < W-1, 0 < v < H-1,
    Tracking.cc:305-311)."""
    h, w = img.shape[0], img.shape[1]
    u = _ifloor(uv[..., 0])
    v = _ifloor(uv[..., 1])
    inb = (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)
    uc = jnp.clip(u, 0, w - 1)
    vc = jnp.clip(v, 0, h - 1)
    return img[vc, uc], inb


def compact_by_mask(arrays, keep: jnp.ndarray, cap: int):
    """Select rows where ``keep`` is True, preserving order, into arrays of
    length ``cap`` (the static-shape replacement for erase/push_back).

    Returns (compacted arrays, valid mask, gather index used).
    """
    n = keep.shape[0]
    order = jnp.argsort(jnp.where(keep, 0, 1), stable=True)[:cap]
    count = jnp.sum(keep.astype(jnp.int32))
    valid = jnp.arange(cap) < jnp.minimum(count, cap)
    out = tuple(a[order] for a in arrays)
    return out, valid, order


def grid_sample_uv(height: int, width: int, n_per_axis: int = None,
                   n_grid: int = 20, n_points: int = 3000,
                   dtype=jnp.float32) -> jnp.ndarray:
    """Uniformly sampled pixel grid, the ``SampleKeyPoints`` equivalent
    (/root/reference/src/Frame.cc:1494-1562: 3000 points on a 20x20 grid).
    Deterministic uniform lattice (the reference uses an RNG inside grid
    cells; parity is statistical)."""
    n = int(round(n_points ** 0.5))
    us = jnp.linspace(2.0, width - 3.0, max(n, 2), dtype=dtype)
    vs = jnp.linspace(2.0, height - 3.0, max((n_points + n - 1) // n, 2), dtype=dtype)
    uu, vv = jnp.meshgrid(us, vs)
    pts = jnp.stack([uu.ravel(), vv.ravel()], axis=-1)
    # integer pixel positions, like the reference's detections/samples
    # (FAST corners and sampled keypoints are integral) -- avoids a
    # systematic half-pixel bias in the nearest-neighbour flow lookups
    return jnp.round(pts[:n_points])


def stride_grid_uv(height: int, width: int, step: int = 4,
                   dtype=jnp.float32) -> jnp.ndarray:
    """The stride-``step`` pixel lattice used for semi-dense object sampling
    (/root/reference/src/Frame.cc:769-809, step=4, row-major i,j order)."""
    vs = jnp.arange(0, height, step)
    us = jnp.arange(0, width, step)
    vv, uu = jnp.meshgrid(vs, us, indexing="ij")
    return jnp.stack([uu.ravel(), vv.ravel()], axis=-1).astype(dtype)


def select_static_points(
    cand_uv: jnp.ndarray,
    cand_valid: jnp.ndarray,
    depth: jnp.ndarray,
    flow: jnp.ndarray,
    mask: jnp.ndarray,
    th_depth_bg: float,
    cap: int,
):
    """Static-point selection (Frame.cc:491-515): keep candidates with
    mask == 0, depth in (0, ThDepthBG], nonzero flow, and flow-warped
    position in bounds.  Returns (uv, depth, flow, corres, valid)."""
    h, w = mask.shape
    d, inb = lookup_nearest(depth, cand_uv)
    m, _ = lookup_nearest(mask, cand_uv)
    fu, _ = lookup_nearest(flow[..., 0], cand_uv)
    fv, _ = lookup_nearest(flow[..., 1], cand_uv)
    f = jnp.stack([fu, fv], axis=-1)
    corres = cand_uv + f
    keep = (
        cand_valid
        & inb
        & (m == 0)
        & (d > 0)
        & (d <= th_depth_bg)
        & (fu != 0)
        & (fv != 0)
        & (corres[:, 0] < w) & (corres[:, 1] < h)
        & (corres[:, 0] > 0) & (corres[:, 1] > 0)
    )
    (uv, d, f, corres), valid, _ = compact_by_mask(
        (cand_uv, d, f, corres), keep, cap
    )
    return uv, d, f, corres, valid


def select_object_points(
    depth: jnp.ndarray,
    flow: jnp.ndarray,
    mask: jnp.ndarray,
    th_depth_obj: float,
    cap: int,
    step: int = 4,
):
    """Semi-dense object sampling on a stride-`step` grid inside the mask
    (Frame.cc:769-809).  Returns (uv, depth, flow, corres, sem, valid)."""
    h, w = mask.shape
    uv = stride_grid_uv(h, w, step)
    d, _ = lookup_nearest(depth, uv)
    m, _ = lookup_nearest(mask, uv)
    fu, _ = lookup_nearest(flow[..., 0], uv)
    fv, _ = lookup_nearest(flow[..., 1], uv)
    f = jnp.stack([fu, fv], axis=-1)
    corres = uv + f
    keep = (
        (m != 0)
        & (d > 0)
        & (d < th_depth_obj)
        & (corres[:, 0] < w) & (corres[:, 0] > 0)
        & (corres[:, 1] < h) & (corres[:, 1] > 0)
    )
    (uv, d, f, corres, m), valid, _ = compact_by_mask(
        (uv, d, f, corres, m), keep, cap
    )
    return uv, d, f, corres, m.astype(jnp.int32), valid


def select_static_lines(
    cand_uv4: jnp.ndarray,
    cand_valid: jnp.ndarray,
    depth: jnp.ndarray,
    flow: jnp.ndarray,
    mask: jnp.ndarray,
    th_depth_bg: float,
    cap: int,
):
    """Static-line selection (Frame.cc:516-603): both endpoints mask == 0,
    depths in (0, ThDepthBG], depth-discontinuity test at the midpoint
    (|d_mid - (d_s+d_e)/2| <= 10*len/1000, Frame.cc:349-380), nonzero
    endpoint flows, warped endpoints in bounds."""
    h, w = mask.shape
    s_uv, e_uv = cand_uv4[:, :2], cand_uv4[:, 2:]
    ds, inb_s = lookup_nearest(depth, s_uv)
    de, inb_e = lookup_nearest(depth, e_uv)
    ms, _ = lookup_nearest(mask, s_uv)
    me, _ = lookup_nearest(mask, e_uv)
    mid = 0.5 * (s_uv + e_uv)
    dm, _ = lookup_nearest(depth, mid)
    length = jnp.linalg.norm(e_uv - s_uv, axis=-1)
    disc_ok = jnp.abs(dm - 0.5 * (ds + de)) <= 10.0 * length / 1000.0
    fsu, _ = lookup_nearest(flow[..., 0], s_uv)
    fsv, _ = lookup_nearest(flow[..., 1], s_uv)
    feu, _ = lookup_nearest(flow[..., 0], e_uv)
    fev, _ = lookup_nearest(flow[..., 1], e_uv)
    f4 = jnp.stack([fsu, fsv, feu, fev], axis=-1)
    corres = cand_uv4 + f4
    degenerate = (jnp.abs(s_uv[:, 0] - e_uv[:, 0]) < 1e-6) & (
        jnp.abs(s_uv[:, 1] - e_uv[:, 1]) < 1e-6
    )
    inb_corr = (
        (corres[:, 0] < w) & (corres[:, 0] > 0)
        & (corres[:, 1] < h) & (corres[:, 1] > 0)
        & (corres[:, 2] < w) & (corres[:, 2] > 0)
        & (corres[:, 3] < h) & (corres[:, 3] > 0)
    )
    keep = (
        cand_valid & inb_s & inb_e & ~degenerate
        & (ms == 0) & (me == 0)
        & (ds > 0) & (ds <= th_depth_bg)
        & (de > 0) & (de <= th_depth_bg)
        & disc_ok
        & (fsu != 0) & (fsv != 0) & (feu != 0) & (fev != 0)
        & inb_corr
    )
    d2 = jnp.stack([ds, de], axis=-1)
    (uv4, d2, f4, corres), valid, _ = compact_by_mask(
        (cand_uv4, d2, f4, corres), keep, cap
    )
    return uv4, d2, f4, corres, valid


def select_object_lines(
    cand_uv4: jnp.ndarray,
    cand_valid: jnp.ndarray,
    depth: jnp.ndarray,
    flow: jnp.ndarray,
    mask: jnp.ndarray,
    th_depth_obj: float,
    cap: int,
):
    """Object-line selection: both endpoints on the SAME nonzero mask label
    (Frame.cc:529-534, 814-875), depths in (0, ThDepthObj), warped endpoints
    in bounds."""
    h, w = mask.shape
    s_uv, e_uv = cand_uv4[:, :2], cand_uv4[:, 2:]
    ds, inb_s = lookup_nearest(depth, s_uv)
    de, inb_e = lookup_nearest(depth, e_uv)
    ms, _ = lookup_nearest(mask, s_uv)
    me, _ = lookup_nearest(mask, e_uv)
    fsu, _ = lookup_nearest(flow[..., 0], s_uv)
    fsv, _ = lookup_nearest(flow[..., 1], s_uv)
    feu, _ = lookup_nearest(flow[..., 0], e_uv)
    fev, _ = lookup_nearest(flow[..., 1], e_uv)
    f4 = jnp.stack([fsu, fsv, feu, fev], axis=-1)
    corres = cand_uv4 + f4
    degenerate = (jnp.abs(s_uv[:, 0] - e_uv[:, 0]) < 1e-6) & (
        jnp.abs(s_uv[:, 1] - e_uv[:, 1]) < 1e-6
    )
    inb_corr = (
        (corres[:, 0] < w) & (corres[:, 0] > 0)
        & (corres[:, 1] < h) & (corres[:, 1] > 0)
        & (corres[:, 2] < w) & (corres[:, 2] > 0)
        & (corres[:, 3] < h) & (corres[:, 3] > 0)
    )
    keep = (
        cand_valid & inb_s & inb_e & ~degenerate
        & (ms != 0) & (ms == me)
        & (ds > 0) & (ds < th_depth_obj)
        & (de > 0) & (de < th_depth_obj)
        & inb_corr
    )
    d2 = jnp.stack([ds, de], axis=-1)
    (uv4, d2, f4, corres, ms), valid, _ = compact_by_mask(
        (cand_uv4, d2, f4, corres, ms), keep, cap
    )
    return uv4, d2, f4, corres, ms.astype(jnp.int32), valid


def world_points(K: Intrinsics, T_cw: jnp.ndarray, uv: jnp.ndarray,
                 depth: jnp.ndarray) -> jnp.ndarray:
    """Unproject pixels at depth into WORLD coordinates
    (``Optimizer::Get3DinWorld``, /root/reference/src/Optimizer.cc:8022)."""
    Xc = geometry.backproject(K, uv, depth)
    return lie.transform_point(lie.se3_inv(T_cw), Xc)


def world_lines(K: Intrinsics, T_cw: jnp.ndarray, uv4: jnp.ndarray,
                depth2: jnp.ndarray) -> jnp.ndarray:
    """World 3D endpoints (start, end) of image line segments -> (..., 6)."""
    s = world_points(K, T_cw, uv4[..., :2], depth2[..., 0])
    e = world_points(K, T_cw, uv4[..., 2:], depth2[..., 1])
    return jnp.concatenate([s, e], axis=-1)


def preprocess_depth(depth_raw: jnp.ndarray, choose_data: int,
                     depth_map_factor: float, bf: float) -> jnp.ndarray:
    """Depth conversion (Tracking.cc:192-219): negatives -> 0; OMD divides by
    DepthMapFactor; KITTI converts disparity: bf / (d / factor).  Any other
    mode (VirtualKITTI=3) matches neither reference branch and leaves the
    values unscaled (Tracking.cc:203-216 has no case for it)."""
    d = jnp.where(depth_raw < 0, 0.0, depth_raw)
    if choose_data == 1:      # OMD
        out = d / depth_map_factor
    elif choose_data == 2:    # KITTI
        out = jnp.where(d > 0, bf / (d / depth_map_factor), 0.0)
    else:
        out = d
    return jnp.where(depth_raw < 0, 0.0, out)

"""Device-resident frame loop: the WHOLE per-frame pipeline as one jit.

Motivation: in the host-orchestrated loop the host renewal sits between
one frame's result pull and the next frame's dispatch, so every frame
pays a device->host round trip on its critical path however the work is
scheduled.  Keeping the tracked feature state ON DEVICE breaks that
chain: frame t+1's step consumes
frame t's renewal output device-to-device, the host only pushes images
(cheap direction) and receives map rows on a LAGGING asynchronous
stream that never blocks a dispatch.

This module re-implements, in fixed-shape jnp with exact host-path
semantics (parity-tested in tests/test_resident.py):

 * mask recovery               (Tracking.cc:4730-4810, tracking._update_mask)
 * inheritance                 (Tracking.cc:269-473,  frame_host.inherit)
 * candidate selections        (Frame.cc:491-875,     frame.select_*)
 * object grouping/association (Tracking.cc:2077-2523, 2631-2699)
 * camera + object solves      (solvers.frame_solvers, as in tracking)
 * scene-flow static test      (Tracking.cc:1989-2075, 2528-2560)
 * label commit + id allocation(Tracking.cc:2560-2736)
 * feature renewal             (Tracking.cc:3959-4730)

The per-object host bookkeeping that only feeds the Map (GT motions,
speeds, output rows) stays on the host, consuming the lagged pull.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry, lie, ransac
from ..ops.geometry import Intrinsics
from ..solvers import frame_solvers as fs
from . import frame as fr

I4 = jnp.eye(4, dtype=jnp.float32)


class ResidentState(NamedTuple):
    """Device-resident tracked-feature state (the host ``last`` dict +
    ``last_meta`` + mask/flow mirrors as one pytree)."""

    pose: jnp.ndarray          # (4,4) T_cw of the last processed frame
    velocity: jnp.ndarray      # (4,4) mVelocity
    # static points (NS)
    s_uv: jnp.ndarray
    s_d: jnp.ndarray
    s_f: jnp.ndarray
    s_c: jnp.ndarray
    s_valid: jnp.ndarray
    # static lines (NLS)
    l_uv: jnp.ndarray
    l_d: jnp.ndarray
    l_f: jnp.ndarray
    l_c: jnp.ndarray
    l_valid: jnp.ndarray
    # object points (NO)
    o_uv: jnp.ndarray
    o_d: jnp.ndarray
    o_f: jnp.ndarray
    o_c: jnp.ndarray
    o_sem: jnp.ndarray
    o_label: jnp.ndarray
    o_valid: jnp.ndarray
    # object lines (NLO)
    ol_uv: jnp.ndarray
    ol_d: jnp.ndarray
    ol_f: jnp.ndarray
    ol_c: jnp.ndarray
    ol_sem: jnp.ndarray
    ol_label: jnp.ndarray
    ol_valid: jnp.ndarray
    # association meta (last_meta; row order = committed group order)
    meta_sem: jnp.ndarray      # (MAXO,) i32
    meta_label: jnp.ndarray    # (MAXO,) i32
    meta_stat: jnp.ndarray     # (MAXO,) bool
    meta_motion: jnp.ndarray   # (MAXO,4,4)
    meta_n: jnp.ndarray        # scalar i32
    max_id: jnp.ndarray        # scalar i32
    # image mirrors for the next frame's mask recovery (dense mode; the
    # sampled/chained mode holds (1,1) dummies -- recovery runs on host)
    last_mask: jnp.ndarray     # (H,W) i32
    last_flow: jnp.ndarray     # (H,W,2) f32
    # provenance of each row w.r.t. the PREVIOUS state (models/chained.py
    # gathers host-pushed samples by these): asso >= 0 = kept from that
    # previous-state row; else cand >= 0 = born from that candidate row
    s_asso: jnp.ndarray        # (NS,) i32
    s_cand: jnp.ndarray        # (NS,) i32
    l_asso: jnp.ndarray        # (NLS,) i32
    l_cand: jnp.ndarray        # (NLS,) i32
    o_asso: jnp.ndarray        # (NO,) i32
    o_cand: jnp.ndarray        # (NO,) i32
    ol_asso: jnp.ndarray       # (NLO,) i32
    ol_cand: jnp.ndarray       # (NLO,) i32


def _ifloor(x):
    return jnp.floor(x).astype(jnp.int32)


def _lookup(img, uv):
    """img[(int)v, (int)u] clamped + reference open-interval bounds."""
    h, w = img.shape[0], img.shape[1]
    u = _ifloor(uv[..., 0])
    v = _ifloor(uv[..., 1])
    inb = (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)
    return img[jnp.clip(v, 0, h - 1), jnp.clip(u, 0, w - 1)], inb


def _first_k(mask, k, order=None):
    """Indices of the first ``k`` True entries (optionally in a fixed
    permutation ``order``), exactly matching np.nonzero()[0][:k] /
    order[mask[order]][:k].  Returns (idx (k,), valid (k,))."""
    n = mask.shape[0]
    if order is not None:
        order = jnp.asarray(order)
        m = mask[order]
        pos, = jnp.nonzero(m, size=k, fill_value=n)
        idx = jnp.where(pos < n, order[jnp.clip(pos, 0, n - 1)], 0)
        valid = pos < n
        return idx.astype(jnp.int32), valid
    idx, = jnp.nonzero(mask, size=k, fill_value=n)
    valid = idx < n
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32), valid


def _sorted_unique(vals, valid, cap):
    """First ``cap`` distinct values of vals[valid] in ascending order
    (np.unique semantics).  Returns (uniq (cap,), uniq_valid (cap,))."""
    big = jnp.iinfo(jnp.int32).max
    v = jnp.where(valid, vals, big)
    s = jnp.sort(v)
    isnew = jnp.concatenate([jnp.array([True]), s[1:] != s[:-1]])
    isnew = isnew & (s != big)
    idx, ok = _first_k(isnew, cap)
    return s[idx], ok


def _scatter_occupancy(h, w, uv, valid):
    """1px-dilated occupancy bitmap of valid uv positions
    (tracking._near_occupied)."""
    occ = jnp.zeros((h + 2, w + 2), jnp.bool_)
    x = jnp.clip(uv[:, 0].astype(jnp.int32), 0, w - 1)
    y = jnp.clip(uv[:, 1].astype(jnp.int32), 0, h - 1)
    x = jnp.where(valid, x, w + 1)   # park invalid rows out of the dilate
    y = jnp.where(valid, y, h + 1)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            occ = occ.at[y + dy, x + dx].set(True)
    return occ


def _near_occupied(occ, uv, h, w):
    x = jnp.clip(uv[:, 0].astype(jnp.int32), 0, w - 1)
    y = jnp.clip(uv[:, 1].astype(jnp.int32), 0, h - 1)
    return occ[y + 1, x + 1]


def _line_dup(cand_uv4, kept_uv4, kept_valid):
    """Static-line dedup gate (Tracking.cc:4174-4203)."""
    c_dir = cand_uv4[:, 2:] - cand_uv4[:, :2]
    k_dir = kept_uv4[:, 2:] - kept_uv4[:, :2]
    c_mid = 0.5 * (cand_uv4[:, 2:] + cand_uv4[:, :2])
    k_mid = 0.5 * (kept_uv4[:, 2:] + kept_uv4[:, :2])
    c_len = jnp.linalg.norm(c_dir, axis=1) + 1e-9
    k_len = jnp.linalg.norm(k_dir, axis=1) + 1e-9
    cosang = (c_dir @ k_dir.T) / (c_len[:, None] * k_len[None, :])
    md2 = (
        jnp.sum(c_mid * c_mid, 1)[:, None]
        + jnp.sum(k_mid * k_mid, 1)[None, :]
        - 2.0 * (c_mid @ k_mid.T)
    )
    r = 0.5 * jnp.maximum(c_len[:, None], k_len[None, :])
    dup = (cosang > jnp.cos(jnp.pi / 30)) & (md2 < r * r) & kept_valid[None, :]
    return dup.any(axis=1)


def _obj_line_dup(cand_uv4, kept_uv4, kept_valid):
    """Object-line dedup gate (Tracking.cc:4584-4602): angle < 1 rad AND
    midpoint distance < 1 px."""
    a1 = jnp.arctan2(cand_uv4[:, 3] - cand_uv4[:, 1],
                     cand_uv4[:, 2] - cand_uv4[:, 0])
    a2 = jnp.arctan2(kept_uv4[:, 3] - kept_uv4[:, 1],
                     kept_uv4[:, 2] - kept_uv4[:, 0])
    ad = jnp.abs(a1[:, None] - a2[None, :])
    ad = jnp.where(ad > jnp.pi, 2 * jnp.pi - ad, ad)
    m1 = 0.5 * (cand_uv4[:, :2] + cand_uv4[:, 2:])
    m2 = 0.5 * (kept_uv4[:, :2] + kept_uv4[:, 2:])
    md2 = (
        jnp.sum(m1 * m1, 1)[:, None]
        + jnp.sum(m2 * m2, 1)[None, :]
        - 2.0 * (m1 @ m2.T)
    )
    dup = (ad < 1.0) & (md2 < 1.0) & kept_valid[None, :]
    return dup.any(axis=1)


@functools.lru_cache(maxsize=8)
def _strided_order(n: int, step: int):
    # numpy, NOT jnp: a cached device constant created inside one trace
    # leaks into later traces (UnexpectedTracerError)
    order = []
    for start in range(step):
        order.extend(range(start, n, step))
    return np.asarray(order, np.int32)


def _majority_nonzero_is_bg(samples, valid):
    """True iff the most frequent value among samples[valid] is 0
    (host: np.unique(...,return_counts) argmax), ties to the SMALLEST
    value like np.unique's sorted order."""
    big = jnp.iinfo(jnp.int32).max
    s = jnp.sort(jnp.where(valid, samples, big))
    n = s.shape[0]
    heads = jnp.concatenate([jnp.array([True]), s[1:] != s[:-1]])
    run_id = jnp.cumsum(heads.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(jnp.ones(n, jnp.int32), run_id, n)
    head_count = jnp.where(heads & (s != big), counts[run_id], -1)
    best = jnp.argmax(head_count)  # first max = smallest value on ties
    return (s[best] == 0), jnp.any(valid)


def update_mask_dev(mask, state: ResidentState, maxo: int):
    """Mask recovery (Tracking.cc:4730-4810, tracking._update_mask).

    One fused splat for ALL recovered labels: the warp (pixel + last
    flow) is label-independent, and scatter-max reproduces the host's
    ascending-label overwrite order exactly (later = larger label wins a
    collision in both)."""
    h, w = mask.shape
    sem = state.o_sem
    valid = state.o_valid & (sem > 0)
    labs, lab_ok = _sorted_unique(sem, valid, maxo)

    corres = state.o_c
    u = corres[:, 0].astype(jnp.int32)
    v = corres[:, 1].astype(jnp.int32)
    inb = (u > 0) & (u < w) & (v > 0) & (v < h)
    samples = mask[jnp.clip(v, 0, h - 1), jnp.clip(u, 0, w - 1)]

    def vote(k):
        lab = labs[k]
        sel = valid & (sem == lab) & inb
        enough = jnp.sum(sel.astype(jnp.int32)) >= 100
        is_bg, any_s = _majority_nonzero_is_bg(samples, sel)
        return lab_ok[k] & enough & is_bg & any_s

    recover = jax.vmap(vote)(jnp.arange(maxo))          # (maxo,)

    # per-pixel: does this pixel's LAST label get recovered?
    rec_pix = (
        (state.last_mask[None] == labs[:, None, None])
        & recover[:, None, None]
    ).any(axis=0)
    ys, xs = jnp.mgrid[0:h, 0:w]
    fx = state.last_flow[..., 0].astype(jnp.int32)
    fy = state.last_flow[..., 1].astype(jnp.int32)
    nx = xs + fx
    ny = ys + fy
    ok = rec_pix & (nx > 0) & (nx < w) & (ny > 0) & (ny < h)
    splat = jnp.zeros_like(mask).at[
        jnp.clip(ny, 0, h - 1), jnp.clip(nx, 0, w - 1)
    ].max(jnp.where(ok, state.last_mask, 0))
    return jnp.where(splat > 0, splat, mask)


def inherit_dev(state: ResidentState, depth, mask, th_depth_obj):
    """Device port of frame_host.inherit."""
    s_uv = state.s_c
    s_d, s_inb = _lookup(depth, s_uv)
    s_d = jnp.where(s_inb & (s_d > 0), s_d, -1.0)

    l_uv = state.l_c
    ld_s, li_s = _lookup(depth, l_uv[:, :2])
    ld_e, li_e = _lookup(depth, l_uv[:, 2:])
    l_ok = li_s & li_e & (ld_s > 0) & (ld_e > 0)
    l_d = jnp.where(l_ok[:, None], jnp.stack([ld_s, ld_e], 1), -1.0)

    o_uv = state.o_c
    o_d, o_inb = _lookup(depth, o_uv)
    o_m, _ = _lookup(mask, o_uv)
    o_ok = o_inb & (o_d < th_depth_obj) & (o_d > 0)
    o_d = jnp.where(o_ok, o_d, 0.1)
    o_sem = jnp.where(o_ok, o_m, 0).astype(jnp.int32)

    ol_uv = state.ol_c
    old_s, oli_s = _lookup(depth, ol_uv[:, :2])
    old_e, oli_e = _lookup(depth, ol_uv[:, 2:])
    olm, _ = _lookup(mask, ol_uv[:, :2])
    ol_ok = (
        oli_s & oli_e
        & (old_s > 0) & (old_s < th_depth_obj)
        & (old_e > 0) & (old_e < th_depth_obj)
    )
    ol_d = jnp.where(ol_ok[:, None], jnp.stack([old_s, old_e], 1), 0.1)
    ol_sem = jnp.where(ol_ok, olm, 0).astype(jnp.int32)
    return s_uv, s_d, l_uv, l_d, o_uv, o_d, o_sem, ol_uv, ol_d, ol_sem


def line_track_filter_dev(line_uv, line_valid, depth, mask):
    """Device port of frame_host.line_track_filter (Tracking.cc:1056-1099)."""
    s_uv, e_uv = line_uv[:, :2], line_uv[:, 2:]
    ds, _ = _lookup(depth, s_uv)
    de, _ = _lookup(depth, e_uv)
    dm, _ = _lookup(depth, 0.5 * (s_uv + e_uv))
    ms, _ = _lookup(mask, s_uv)
    me, _ = _lookup(mask, e_uv)
    length = jnp.linalg.norm(e_uv - s_uv, axis=-1)
    ok = (
        (jnp.abs(dm - 0.5 * (ds + de)) <= 10.0 * length / 1000.0)
        & (ms == 0) & (me == 0)
    )
    return line_valid & ok


def _filt_point(uv, depth, flow, mask):
    """Renewal point filter (tracking._renew_frame_info.filt_point; the
    40.0 depth gate is the reference's hard-coded renewal threshold)."""
    h, w = mask.shape
    x = uv[:, 0].astype(jnp.int32)
    y = uv[:, 1].astype(jnp.int32)
    inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
    xc = jnp.clip(x, 0, w - 1)
    yc = jnp.clip(y, 0, h - 1)
    m = mask[yc, xc]
    d = depth[yc, xc]
    f = flow[yc, xc]
    corr = uv + f
    ok = (
        inb & (m == 0) & (d > 0) & (d <= 40.0)
        & (f[:, 0] != 0) & (f[:, 1] != 0)
        & (corr[:, 0] < w) & (corr[:, 0] > 0)
        & (corr[:, 1] < h) & (corr[:, 1] > 0)
    )
    return ok, d, f, corr


def _filt_line(uv4, depth, flow, mask):
    """Renewal line filter (tracking._renew_frame_info.filt_line)."""
    h, w = mask.shape
    xs = uv4[:, 0].astype(jnp.int32)
    ys = uv4[:, 1].astype(jnp.int32)
    xe = uv4[:, 2].astype(jnp.int32)
    ye = uv4[:, 3].astype(jnp.int32)
    inb = (
        (xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
        & (xe > 0) & (xe < w - 1) & (ye > 0) & (ye < h - 1)
    )
    xsc, ysc = jnp.clip(xs, 0, w - 1), jnp.clip(ys, 0, h - 1)
    xec, yec = jnp.clip(xe, 0, w - 1), jnp.clip(ye, 0, h - 1)
    ms = mask[ysc, xsc]
    me = mask[yec, xec]
    ds = depth[ysc, xsc]
    de = depth[yec, xec]
    xm = jnp.clip((xs + xe) // 2, 0, w - 1)
    ym = jnp.clip((ys + ye) // 2, 0, h - 1)
    dm = depth[ym, xm]
    ln = jnp.sqrt(((xs - xe) ** 2 + (ys - ye) ** 2).astype(jnp.float32))
    disc = jnp.abs(dm - 0.5 * (ds + de)) <= 10.0 * ln / 1000.0
    fs_ = flow[ysc, xsc]
    fe_ = flow[yec, xec]
    f4 = jnp.concatenate([fs_, fe_], axis=1)
    corr = uv4 + f4
    degen = (jnp.abs(uv4[:, 0] - uv4[:, 2]) < 1e-6) & (
        jnp.abs(uv4[:, 1] - uv4[:, 3]) < 1e-6
    )
    ok = (
        inb & ~degen & (ms == 0) & (me == 0)
        & (ds > 0) & (ds <= 40.0) & (de > 0) & (de <= 40.0)
        & disc
        & (corr[:, 0] > 0) & (corr[:, 0] < w)
        & (corr[:, 1] > 0) & (corr[:, 1] < h)
        & (corr[:, 2] > 0) & (corr[:, 2] < w)
        & (corr[:, 3] > 0) & (corr[:, 3] < h)
    )
    d2 = jnp.stack([ds, de], axis=1)
    return ok, d2, f4, corr


def _obj_filt(uv, depth, flow, mask, th_depth_obj):
    """Renewal object-point filter (tracking._renew_frame_info.obj_filt)."""
    h, w = mask.shape
    x = uv[:, 0].astype(jnp.int32)
    y = uv[:, 1].astype(jnp.int32)
    inb = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
    xc = jnp.clip(x, 0, w - 1)
    yc = jnp.clip(y, 0, h - 1)
    m = mask[yc, xc]
    d = depth[yc, xc]
    f = flow[yc, xc]
    corr = uv + f
    ok = (
        inb & (m != 0) & (d > 0) & (d < th_depth_obj)
        & (corr[:, 0] < w) & (corr[:, 0] > 0)
        & (corr[:, 1] < h) & (corr[:, 1] > 0)
    )
    return ok, m, d, f, corr


def _masked_mode(vals, valid):
    """Most frequent value among vals[valid]; smallest value on ties
    (np.unique + argmax semantics).  Returns (mode_value, any_valid)."""
    big = jnp.iinfo(jnp.int32).max
    s = jnp.sort(jnp.where(valid, vals, big))
    n = s.shape[0]
    heads = jnp.concatenate([jnp.array([True]), s[1:] != s[:-1]])
    run_id = jnp.cumsum(heads.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(jnp.ones(n, jnp.int32), run_id, n)
    head_count = jnp.where(heads & (s != big), counts[run_id], -1)
    best = jnp.argmax(head_count)
    return s[best], jnp.any(valid)


class StageInputs(NamedTuple):
    """Plane-derived inputs to the core stage.  The dense step computes
    these from the full depth/flow/mask planes on device; the chained
    sampled step (models/chained.py) unpacks them from a host-pushed
    sample bundle (samples taken at the host's shadow positions)."""

    stat_tmp: tuple      # (uv, d, f, c, v)              candidate selections
    line_tmp: tuple      # (uv4, d2, f4, c4, v)
    obj_tmp: tuple       # (uv, d, f, c, sem, v)
    oline_tmp: tuple     # (uv4, d2, f4, c4, sem, v)
    inh: tuple           # inherit outputs (s_uv, s_d, l_uv, l_d, o_uv,
    #                      o_d, o_sem, ol_uv, ol_d, ol_sem)
    line_ok0: jnp.ndarray


class DenseFilts:
    """Renewal plane-filter accessor over full device planes (the
    resident mode).  The chained mode substitutes SampledFilts whose
    methods return host-pushed per-row filter results instead."""

    def __init__(self, depth, flow, mask, th_depth_obj):
        self.depth, self.flow, self.mask = depth, flow, mask
        self.th = th_depth_obj

    # state-row filters, evaluated at the (solve-updated) positions
    def stat_state(self, uv):
        return _filt_point(uv, self.depth, self.flow, self.mask)

    def line_state(self, uv4):
        return _filt_line(uv4, self.depth, self.flow, self.mask)

    def obj_state(self, uv):
        return _obj_filt(uv, self.depth, self.flow, self.mask, self.th)

    # candidate filters (fixed candidate positions)
    def stat_cand(self, uv):
        return _filt_point(uv, self.depth, self.flow, self.mask)

    def line_cand(self, uv4):
        return _filt_line(uv4, self.depth, self.flow, self.mask)

    def obj_cand(self, uv):
        return _obj_filt(uv, self.depth, self.flow, self.mask, self.th)

    def oline_cand_ok(self, uv4):
        return _filt_line(uv4, self.depth, self.flow, self.mask)[0]

    # flow at merged object-line rows (invalid rows are zeroed to (0,0)
    # so the lookup lands on flow[0,0] -- preserved exactly)
    def flow4(self, uv4):
        h, w = self.mask.shape
        f_s = self.flow[
            jnp.clip(uv4[:, 1].astype(jnp.int32), 0, h - 1),
            jnp.clip(uv4[:, 0].astype(jnp.int32), 0, w - 1),
        ]
        f_e = self.flow[
            jnp.clip(uv4[:, 3].astype(jnp.int32), 0, h - 1),
            jnp.clip(uv4[:, 2].astype(jnp.int32), 0, w - 1),
        ]
        return jnp.concatenate([f_s, f_e], axis=1)

    def flow4_final(self, uv4, carried_f4, valid):
        # dense: re-look-up at the merged positions (bit-exact with the
        # pre-refactor behavior, including the flow[0,0] value on zeroed
        # invalid rows); carried values are ignored
        return self.flow4(uv4)


def build_core_stage(cfg, K: Intrinsics, caps: dict):
    """The plane-free core of the per-frame step: grouping, solves,
    commit, renewal.  Shared verbatim between the dense resident step and
    the sampled chained step."""
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    P, L, MAXO, GCAP = caps["P"], caps["L"], caps["MAXO"], caps["GCAP"]
    KITTI = 2
    shr_c = cfg.boundary_shrink_x if cfg.choose_data == KITTI else 0
    shr_r = cfg.boundary_shrink_y if cfg.choose_data == KITTI else 0
    n_hyp_cam = max(min(int(cfg.pnp_iterations), 128), 8)
    n_hyp_obj = max(n_hyp_cam // 2, 8)

    def cam_solve(T_init, T_wl, pts, lns):
        return fs.solve_flow_pose(
            T_init, T_wl, pts, lns, K,
            rp_thres=cfg.rp_thres,
            flow_prior_info=cfg.flow_prior_info_cam,
            line_prior_info=cfg.flow_prior_info_cam,
            max_iterations=cfg.lm_iterations,
            use_lines=cfg.use_lines,
            rel_tol=cfg.lm_rel_tol,
        )

    def obj_solve_one(T_init, T_wl, pts, lns):
        return fs.solve_flow_pose(
            T_init, T_wl, pts, lns, K,
            rp_thres=cfg.rp_thres,
            flow_prior_info=cfg.flow_prior_info_obj,
            line_prior_info=cfg.flow_prior_info_obj,
            max_iterations=cfg.lm_iterations,
            use_lines=cfg.use_lines,
            rel_tol=cfg.lm_rel_tol,
        )

    def _model_inliers(model, X_w, cur_uv, valid):
        proj = geometry.project(K, lie.transform_point(model, X_w))
        rpe = jnp.linalg.norm(cur_uv - proj, axis=-1)
        front = lie.transform_point(model, X_w)[:, 2] > 0
        return valid & front & (rpe < cfg.pnp_reproj_error)

    def init_model_cam(key, velocity, T_lw, last_uv, last_depth,
                       cur_uv, cur_depth, valid):
        """GetInitModelCam (Tracking.cc:2738-2838; tracking.py mirror)."""
        X_w = fr.world_points(K, T_lw, last_uv, last_depth)
        X_c = geometry.backproject(K, cur_uv, cur_depth)
        rs = ransac.ransac_rigid_init(
            X_w, cur_uv, X_c, valid & (cur_depth > 0), K, key,
            n_hypotheses=n_hyp_cam, reproj_thresh=cfg.pnp_reproj_error,
        )
        model = velocity @ T_lw
        mm_inl = _model_inliers(model, X_w, cur_uv, valid)
        mm_n = jnp.sum(mm_inl.astype(jnp.int32))
        use_ransac = rs.n_inliers > mm_n
        T_init = jnp.where(use_ransac, rs.pose, model)
        subset = jnp.where(use_ransac, rs.inliers, mm_inl)
        return T_init, subset

    def init_model_obj_one(key, model, T_lw, last_uv, last_depth,
                           cur_uv, cur_depth, valid):
        """GetInitModelObj (Tracking.cc:2841-2972)."""
        X_w = fr.world_points(K, T_lw, last_uv, last_depth)
        X_c = geometry.backproject(K, cur_uv, cur_depth)
        rs = ransac.ransac_rigid_init(
            X_w, cur_uv, X_c, valid & (cur_depth > 0), K, key,
            n_hypotheses=n_hyp_obj, reproj_thresh=cfg.pnp_reproj_error,
        )
        mm_inl = _model_inliers(model, X_w, cur_uv, valid)
        mm_n = jnp.sum(mm_inl.astype(jnp.int32))
        use_ransac = rs.n_inliers > mm_n
        T_init = jnp.where(use_ransac, rs.pose, model)
        subset = jnp.where(use_ransac, rs.inliers, mm_inl)
        return T_init, subset, jnp.maximum(rs.n_inliers, mm_n)

    def scene_flow_static_frac(pose, T_wl, o_obs, o_depth, o_cur_uv,
                               o_cur_d, sf_valid):
        """x-z world scene-flow fraction below SFMgThres
        (Tracking.cc:1989-2075/:2528-2560)."""
        Xp_w = lie.transform_point(
            T_wl, geometry.backproject(K, o_obs, o_depth)
        )
        T_wc = jnp.linalg.inv(pose)
        Xc_w = lie.transform_point(
            T_wc, geometry.backproject(K, o_cur_uv, o_cur_d)
        )
        f3 = Xc_w - Xp_w
        sfn = jnp.sqrt(f3[..., 0] ** 2 + f3[..., 2] ** 2)
        v = sf_valid.astype(jnp.float32)
        n = jnp.maximum(jnp.sum(v, axis=-1), 1.0)
        small = v * (sfn < cfg.sf_mg_thres).astype(jnp.float32)
        return jnp.sum(small, axis=-1) / n

    def core(state: ResidentState, si: StageInputs, filts, hw,
             gt_sem_prev, gt_sem_cur, key, last_mask, last_flow):
        h, w = hw
        stat_tmp, line_tmp = si.stat_tmp, si.line_tmp
        obj_tmp, oline_tmp = si.obj_tmp, si.oline_tmp
        (s_uv, s_d, l_uv, l_d, o_uv, o_d, o_sem, ol_uv, ol_d,
         ol_sem) = si.inh
        last_s_valid = state.s_valid & (state.s_d > 0) & (s_d > 0)
        line_ok0 = si.line_ok0 & state.l_valid
        l_use = state.l_valid & (state.l_d.min(axis=-1) > 0) & line_ok0
        T_lw = state.pose

        # ---- grouping (Tracking.cc:2077-2523) ----
        sf_valid = state.o_valid & (state.o_sem > 0) & (o_sem > 0)
        labs, lab_ok = _sorted_unique(o_sem, sf_valid, GCAP)

        pmask_all = (
            sf_valid[None, :] & (o_sem[None, :] == labs[:, None])
            & lab_ok[:, None]
        )                                            # (GCAP, NO)
        lmask_all = (
            state.ol_valid[None, :] & (ol_sem[None, :] == labs[:, None])
            & lab_ok[:, None]
        )                                            # (GCAP, NLO)
        npts = jnp.sum(pmask_all.astype(jnp.int32), axis=1)
        nlns = jnp.sum(lmask_all.astype(jnp.int32), axis=1)
        # boundary rejection counts
        pu, pv = o_uv[:, 0], o_uv[:, 1]
        p_near = (
            (pv < shr_r) | (pv > h - shr_r) | (pu < shr_c) | (pu > w - shr_c)
        )
        l_near = (
            (ol_uv[:, 1] < shr_r) | (ol_uv[:, 1] > h - shr_r)
            | (ol_uv[:, 0] < shr_c) | (ol_uv[:, 0] > w - shr_c)
            | (ol_uv[:, 3] < shr_r) | (ol_uv[:, 3] > h - shr_r)
            | (ol_uv[:, 2] < shr_c) | (ol_uv[:, 2] > w - shr_c)
        )
        near = (
            jnp.sum((pmask_all & p_near[None, :]).astype(jnp.int32), axis=1)
            + jnp.sum((lmask_all & l_near[None, :]).astype(jnp.int32), axis=1)
        )
        # strict > 0.5 boundary-fraction rejection like the host
        pass_b = ~(near.astype(jnp.float32) / jnp.maximum(
            npts + nlns, 1).astype(jnp.float32) > 0.5)
        far_small = (
            (jnp.sum(jnp.where(pmask_all, o_d[None, :], 0.0), axis=1)
             / jnp.maximum(npts, 1).astype(jnp.float32) > cfg.th_depth_obj)
            | (npts < cfg.min_object_points)
        )
        # association: majority of LAST-frame semantic labels over the
        # group's points + lines (Tracking.cc:2631-2699)
        comb_vals = jnp.concatenate(
            [jnp.broadcast_to(state.o_sem[None, :], pmask_all.shape),
             jnp.broadcast_to(state.ol_sem[None, :], lmask_all.shape)],
            axis=1,
        )
        comb_valid = jnp.concatenate([pmask_all, lmask_all], axis=1)
        assoc_sem, _ = jax.vmap(_masked_mode)(comb_vals, comb_valid)
        meta_rows = jnp.arange(MAXO)
        match = (
            (state.meta_sem[None, :] == assoc_sem[:, None])
            & state.meta_stat[None, :]
            & (meta_rows[None, :] < state.meta_n)
        )                                            # (GCAP, MAXO)
        found = match.any(axis=1) & (state.max_id > 1)
        row = jnp.argmax(match, axis=1)
        assigned0 = jnp.where(found, state.meta_label[row], -1)
        H_prev = jnp.where(
            found[:, None, None], state.meta_motion[row], I4[None]
        )
        group_exists = lab_ok & (npts > 0) & pass_b
        # groups[:MAXO] in label-ascending order
        g_idx, g_ok = _first_k(group_exists, MAXO)
        g_lab = labs[g_idx]
        g_far = far_small[g_idx]
        g_assigned0 = assigned0[g_idx]
        g_H_prev = H_prev[g_idx]
        g_pmask = pmask_all[g_idx] & g_ok[:, None]
        g_lmask = lmask_all[g_idx] & g_ok[:, None]

        # ---- buckets (tracking._build_buckets, fixed MAXO lanes) ----
        pidx, prow_ok = jax.vmap(lambda m: _first_k(m, P))(g_pmask)
        lidx, lrow_ok = jax.vmap(lambda m: _first_k(m, L))(g_lmask)
        pt_obs = state.o_uv[pidx] * prow_ok[..., None]
        pt_depth = jnp.where(prow_ok, state.o_d[pidx], 1.0)
        pt_flow0 = (o_uv[pidx] - state.o_uv[pidx]) * prow_ok[..., None]
        pt_cur_uv = o_uv[pidx] * prow_ok[..., None]
        pt_cur_d = jnp.where(prow_ok, o_d[pidx], 0.0)
        pt_valid = prow_ok & (state.o_d[pidx] > 0)
        pt_sfvalid = prow_ok & sf_valid[pidx]
        ln_obs = state.ol_uv[lidx] * lrow_ok[..., None]
        ln_depth = jnp.where(lrow_ok[..., None], state.ol_d[lidx], 1.0)
        ln_flow0 = (ol_uv[lidx] - state.ol_uv[lidx]) * lrow_ok[..., None]
        ln_valid = lrow_ok & (state.ol_d[lidx].min(axis=-1) > 0)

        # ---- fused solves (tracking.fused_track) ----
        T_init, subset = init_model_cam(
            key, state.velocity, T_lw, state.s_uv, state.s_d, s_uv, s_d,
            last_s_valid,
        )
        # flow0 for the camera = the STORED last-frame flow samples
        # (host packs last["stat_flow"]/last["line_flow"] verbatim)
        cam_pts = fs.PointBundle(
            obs=state.s_uv, flow0=state.s_f, depth=state.s_d,
            valid=subset,
        )
        cam_lns = fs.LineBundle(
            obs=state.l_uv, flow0=state.l_f, depth=state.l_d,
            valid=l_use,
        )
        T_wl = jnp.linalg.inv(T_lw)
        cam = cam_solve(T_init, T_wl, cam_pts, cam_lns)
        pose = cam.pose
        static_frac = scene_flow_static_frac(
            pose, T_wl, pt_obs, pt_depth, pt_cur_uv, pt_cur_d, pt_sfvalid
        )
        T_models = jnp.einsum("ij,njk->nik", pose, g_H_prev)
        # lane-index folding: identical stream for any lane count (the
        # host path may use a narrower power-of-two bucket)
        okeys = jax.vmap(
            lambda i: jax.random.fold_in(jax.random.fold_in(key, 7), i)
        )(jnp.arange(MAXO))
        T_is, init_inl, init_n = jax.vmap(
            init_model_obj_one, in_axes=(0, 0, None, 0, 0, 0, 0, 0)
        )(okeys, T_models, T_lw, pt_obs, pt_depth, pt_cur_uv, pt_cur_d,
          pt_valid)
        opts = fs.PointBundle(obs=pt_obs, flow0=pt_flow0, depth=pt_depth,
                              valid=pt_valid & init_inl)
        olns = fs.LineBundle(obs=ln_obs, flow0=ln_flow0, depth=ln_depth,
                             valid=ln_valid)
        res = jax.vmap(obj_solve_one, in_axes=(0, None, 0, 0))(
            T_is, T_wl, opts, olns
        )

        # ---- commit (Tracking.cc:2528-2736 + 1277-1528) ----
        is_static = static_frac > cfg.sf_ds_thres
        committed = g_ok & ~is_static & ~g_far
        needs_new = committed & (g_assigned0 < 0)
        new_rank = jnp.cumsum(needs_new.astype(jnp.int32)) - 1
        assigned = jnp.where(
            needs_new, state.max_id + new_rank, g_assigned0
        )
        assigned = jnp.where(committed, assigned, -1)
        max_id_new = state.max_id + jnp.sum(needs_new.astype(jnp.int32))
        gt_have = (
            (g_lab[:, None] == gt_sem_prev[None, :]).any(axis=1)
            & (g_lab[:, None] == gt_sem_cur[None, :]).any(axis=1)
        )
        stat = committed & gt_have & (init_n >= cfg.min_pnp_inliers_obj)
        inv_pose = jnp.linalg.inv(pose)
        H_lane = jnp.einsum("ij,njk->nik", inv_pose, res.pose)
        H_lane = jnp.where(stat[:, None, None], H_lane, I4[None])
        # centre: masked mean of last-frame world points over pidx rows
        Xw_lane = jax.vmap(
            lambda uv, d: fr.world_points(K, state.pose, uv, d)
        )(state.o_uv[pidx], state.o_d[pidx])
        nrow = jnp.maximum(jnp.sum(prow_ok.astype(jnp.float32), 1), 1.0)
        centre = (
            jnp.sum(Xw_lane * prow_ok[..., None], axis=1) / nrow[:, None]
        )
        centre = jnp.where(
            (jnp.sum(prow_ok.astype(jnp.int32), 1) > 0)[:, None],
            centre, 0.0,
        )

        # per-point labels: map each object point/line to its lane
        pt_lane_match = g_pmask                     # (MAXO, NO) disjoint
        ln_lane_match = g_lmask
        lane_label_pt = jnp.where(
            is_static & g_ok, 0, jnp.where(committed, assigned, -1)
        )
        # lanes are disjoint over points (one semantic label per point)
        obj_label = jnp.where(
            pt_lane_match.any(0),
            jnp.sum(
                pt_lane_match.astype(jnp.int32) * lane_label_pt[:, None],
                axis=0,
            ),
            -1,
        ).astype(jnp.int32)
        oline_label = jnp.where(
            ln_lane_match.any(0),
            jnp.sum(
                ln_lane_match.astype(jnp.int32) * lane_label_pt[:, None],
                axis=0,
            ),
            -1,
        ).astype(jnp.int32)

        # meta' (host last_meta): committed lanes in order
        m_idx, m_ok = _first_k(committed, MAXO)
        meta_sem = jnp.where(m_ok, g_lab[m_idx], 0)
        meta_label = jnp.where(m_ok, assigned[m_idx], -1)
        meta_stat = m_ok & stat[m_idx]
        meta_motion = jnp.where(m_ok[:, None, None], H_lane[m_idx], I4[None])
        meta_n = jnp.sum(m_ok.astype(jnp.int32))

        # velocity (Tracking.cc:1177-1183)
        velocity = pose @ jnp.linalg.inv(state.pose)

        # ---- position updates from optimized flows ----
        s_uv_upd = jnp.where(
            cam.point_inlier[:, None], state.s_uv + cam.flow, s_uv
        )
        l_uv_upd = jnp.where(
            cam.line_inlier[:, None], state.l_uv + cam.line_flow, l_uv
        )
        # object points: only stat lanes update (Tracking._track obj loop)
        upd_pt = stat[:, None] & prow_ok & res.point_inlier
        o_uv_new = o_uv
        o_uv_new = o_uv_new.at[pidx].set(
            jnp.where(
                upd_pt[..., None],
                state.o_uv[pidx] + res.flow,
                o_uv_new[pidx],
            )
        )
        obj_ok_flags = jnp.zeros(NO, jnp.bool_).at[pidx].set(upd_pt)
        upd_ln = stat[:, None] & lrow_ok & res.line_inlier
        ol_uv_new = ol_uv
        ol_uv_new = ol_uv_new.at[lidx].set(
            jnp.where(
                upd_ln[..., None],
                state.ol_uv[lidx] + res.line_flow,
                ol_uv_new[lidx],
            )
        )
        oline_ok_flags = jnp.zeros(NLO, jnp.bool_).at[lidx].set(upd_ln)

        # ---- renewal (Tracking.cc:3959-4730) ----
        new_state, core_out = _renew_core(
            cfg, K, caps, si, filts, hw,
            pose, velocity,
            stat_tmp, line_tmp, obj_tmp, oline_tmp,
            s_uv_upd, s_d, cam.point_inlier,
            l_uv_upd, l_d, cam.line_inlier,
            o_uv_new, o_d, o_sem, obj_label, obj_ok_flags,
            ol_uv_new, ol_d, ol_sem, oline_label, oline_ok_flags,
            meta_sem, meta_label, meta_stat, meta_motion, meta_n,
            max_id_new, last_mask, last_flow,
        )

        out = dict(
            pose=pose, velocity=velocity, **core_out,
            lane_label=jnp.where(m_ok, assigned[m_idx], -1),
            lane_sem=meta_sem,
            lane_stat=meta_stat,
            lane_H=meta_motion,
            lane_centre=jnp.where(m_ok[:, None], centre[m_idx], 0.0),
            lane_valid=m_ok,
            n_point_inliers=jnp.sum(cam.point_inlier.astype(jnp.int32)),
        )
        # pack into ONE f32 buffer: the map outputs come home in a single
        # async transfer instead of 30+ per-leaf copies
        spec = out_spec(caps)
        buf = jnp.concatenate(
            [jnp.ravel(out[name]).astype(jnp.float32)
             for name, _, _ in spec]
        )
        return new_state, buf

    return core


def dense_stage_inputs(cfg, caps, state, depth, flow, mask):
    """Compute StageInputs from full device planes (the resident mode).
    Candidate selections are appended by the caller (they depend on the
    detector outputs)."""
    inh = inherit_dev(state, depth, mask, cfg.th_depth_obj)
    line_ok0 = line_track_filter_dev(
        inh[2], state.l_valid, depth, mask
    )
    return inh, line_ok0


def build_resident_step(cfg, K: Intrinsics, caps: dict):
    """Build the jitted device-resident frame step (dense planes).

    ``caps``: dict with NS, NLS, NO, NLO, P, L, MAXO, GCAP.  The returned
    function has signature

        step(state, depth_raw, flow, mask_in, cand_uv, cand_valid,
             lcand_uv4, lcand_valid, gt_sem_prev, gt_sem_cur, key)
        -> (new_state, out_buf)

    where gt_sem_* are fixed-size (16,) i32 arrays of semantic labels with
    an available GT object pose in the previous/current frame (-1 pads).
    """
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    MAXO = caps["MAXO"]
    core = build_core_stage(cfg, K, caps)

    def step(state: ResidentState, depth_raw, flow, mask_in,
             cand_uv, cand_valid, lcand_uv4, lcand_valid,
             gt_sem_prev, gt_sem_cur, key):
        h, w = mask_in.shape
        # compressed-input mode pushes f16 depth/flow + u8 mask
        # (~3.3 MB/frame instead of ~8 MB); decompression is a cast
        depth_raw = depth_raw.astype(jnp.float32)
        flow = flow.astype(jnp.float32)
        depth = fr.preprocess_depth(
            depth_raw, cfg.choose_data, cfg.depth_map_factor, cfg.bf
        )
        mask = update_mask_dev(mask_in.astype(jnp.int32), state, MAXO)

        # ---- candidate selections (Frame ctor) ----
        obj_tmp = fr.select_object_points(
            depth, flow, mask, cfg.th_depth_obj, NO
        )
        stat_tmp = fr.select_static_points(
            cand_uv, cand_valid, depth, flow, mask, cfg.th_depth_bg, NS
        )
        line_tmp = fr.select_static_lines(
            lcand_uv4, lcand_valid, depth, flow, mask, cfg.th_depth_bg, NLS
        )
        oline_tmp = fr.select_object_lines(
            lcand_uv4, lcand_valid, depth, flow, mask, cfg.th_depth_obj, NLO
        )

        # ---- inherit (Tracking.cc:269-473) ----
        inh, line_ok0 = dense_stage_inputs(cfg, caps, state, depth, flow,
                                           mask)
        si = StageInputs(
            stat_tmp=stat_tmp, line_tmp=line_tmp, obj_tmp=obj_tmp,
            oline_tmp=oline_tmp, inh=inh, line_ok0=line_ok0,
        )
        filts = DenseFilts(depth, flow, mask, cfg.th_depth_obj)
        return core(state, si, filts, (h, w), gt_sem_prev, gt_sem_cur,
                    key, mask, flow)

    return step


def out_spec(caps):
    """(name, shape, kind) rows of the packed resident-step output."""
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    MAXO = caps["MAXO"]
    # NOTE: the world-3D arrays are NOT in the buffer -- they are exactly
    # world_points/world_lines(pose, uv, depth), recomputed on host in
    # _apply_out (30k floats of d2h per frame saved)
    return [
        ("pose", (4, 4), "f"), ("velocity", (4, 4), "f"),
        ("stat_uv", (NS, 2), "f"), ("stat_depth", (NS,), "f"),
        ("stat_valid", (NS,), "bool"),
        ("stat_asso", (NS,), "int"),
        ("line_uv", (NLS, 4), "f"), ("line_depth", (NLS, 2), "f"),
        ("line_valid", (NLS,), "bool"),
        ("line_asso", (NLS,), "int"),
        ("obj_uv", (NO, 2), "f"), ("obj_depth", (NO,), "f"),
        ("obj_valid", (NO,), "bool"),
        ("obj_asso", (NO,), "int"), ("obj_label", (NO,), "int"),
        ("obj_sem", (NO,), "int"),
        ("oline_uv", (NLO, 4), "f"), ("oline_depth", (NLO, 2), "f"),
        ("oline_valid", (NLO,), "bool"),
        ("oline_asso", (NLO,), "int"), ("oline_label", (NLO,), "int"),
        ("oline_sem", (NLO,), "int"),
        ("lane_label", (MAXO,), "int"), ("lane_sem", (MAXO,), "int"),
        ("lane_stat", (MAXO,), "bool"), ("lane_H", (MAXO, 4, 4), "f"),
        ("lane_centre", (MAXO, 3), "f"), ("lane_valid", (MAXO,), "bool"),
        ("n_point_inliers", (), "int"),
    ]


def unpack_out(buf: "np.ndarray", caps) -> dict:
    """Slice the packed output buffer into a dict of (writable, viewing)
    numpy arrays."""
    out = {}
    o = 0
    for name, shape, kind in out_spec(caps):
        n = 1
        for s in shape:
            n *= s
        a = buf[o:o + n].reshape(shape)
        o += n
        if kind == "bool":
            a = a > 0.5
        elif kind == "int":
            a = a.astype(np.int32)
        out[name] = a
    return out


def _rank_within_sem(sem, active, n_total):
    """For candidate rows (masked by ``active``), the 0-based rank of each
    row WITHIN its semantic label, counting in ascending row order -- used
    to apply per-label caps exactly like the host's per-label
    nonzero()[:cap] loops."""
    n = sem.shape[0]
    big = jnp.iinfo(jnp.int32).max
    key = jnp.where(active, sem, big)
    order = jnp.argsort(key, stable=True)          # sem-major, idx-minor
    s_sorted = key[order]
    heads = jnp.concatenate([jnp.array([True]), s_sorted[1:] != s_sorted[:-1]])
    pos = jnp.arange(n)
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(heads, pos, -1)
    )
    rank_sorted = pos - run_start
    rank = jnp.zeros(n, jnp.int32).at[order].set(rank_sorted.astype(jnp.int32))
    return jnp.where(active, rank, n_total)


def _merge_keep_topup(kept_vals, kept_n, top_vals, top_n, cap):
    """Rows 0..kept_n-1 from kept, then top rows, fixed shape ``cap``.
    kept_vals/top_vals: tuples of (cap, ...) arrays already compacted."""
    j = jnp.arange(cap)
    take_top = j >= kept_n
    tidx = jnp.clip(j - kept_n, 0, cap - 1)
    out = tuple(
        jnp.where(
            _bdims(take_top, k.ndim), t[tidx], k
        )
        for k, t in zip(kept_vals, top_vals)
    )
    valid = j < jnp.minimum(kept_n + top_n, cap)
    return out, valid


def _bdims(mask, ndim):
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def _renew_core(cfg, K, caps, si, filts, hw,
                pose, velocity,
                stat_tmp, line_tmp, obj_tmp, oline_tmp,
                s_uv, s_d, stat_ok,
                l_uv, l_d, line_ok,
                o_uv, o_d, o_sem, obj_label, obj_ok,
                ol_uv, ol_d, ol_sem, oline_label, oline_ok,
                meta_sem, meta_label, meta_stat, meta_motion, meta_n,
                max_id, last_mask, last_flow):
    """Device port of Tracking._renew_frame_info (Tracking.cc:3959-4730).
    Returns (ResidentState, core-output dict for the host map mirror).
    All plane lookups go through ``filts`` (dense planes or host-pushed
    samples)."""
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    P, L, MAXO = caps["P"], caps["L"], caps["MAXO"]
    h, w = hw

    # ---- static points ----
    keep_ok, kd, kf, kc = filts.stat_state(s_uv)
    keep = stat_ok & keep_ok
    kept_idx, kept_v = _first_k(keep, NS)
    nk = jnp.sum(keep.astype(jnp.int32))
    nk = jnp.minimum(nk, NS)
    k_uv = s_uv[kept_idx] * kept_v[:, None]
    k_d = jnp.where(kept_v, kd[kept_idx], 0.0)
    k_f = kf[kept_idx] * kept_v[:, None]
    k_c = kc[kept_idx] * kept_v[:, None]
    k_asso = jnp.where(kept_v, kept_idx, -1)
    k_cnd = jnp.full(NS, -1, jnp.int32)

    cs_uv, cs_d, cs_f, cs_c, cs_v = stat_tmp
    cand_ok, cd, cf, cc = filts.stat_cand(cs_uv)
    cand_ok = cand_ok & cs_v
    occ = _scatter_occupancy(h, w, k_uv, kept_v)
    cand_ok = cand_ok & ~(
        (nk > 0) & _near_occupied(occ, cs_uv, h, w)
    )
    order = _strided_order(NS, 10)
    t_idx, t_v = _first_k(cand_ok, NS, order=order)
    nt = jnp.sum(cand_ok.astype(jnp.int32))
    t_uv = cs_uv[t_idx] * t_v[:, None]
    t_d = jnp.where(t_v, cd[t_idx], 0.0)
    t_f = cf[t_idx] * t_v[:, None]
    t_c = cc[t_idx] * t_v[:, None]
    t_asso = jnp.full(NS, -1, jnp.int32)
    t_cnd = jnp.where(t_v, t_idx, -1)
    ((new_uv, new_d, new_f, new_c, new_asso, new_cnd),
     stat_valid) = _merge_keep_topup(
        (k_uv, k_d, k_f, k_c, k_asso, k_cnd), nk,
        (t_uv, t_d, t_f, t_c, t_asso, t_cnd), nt, NS,
    )
    new_uv = new_uv * stat_valid[:, None]
    new_d = new_d * stat_valid
    new_f = new_f * stat_valid[:, None]
    new_c = new_c * stat_valid[:, None]
    new_asso = jnp.where(stat_valid, new_asso, -1)
    new_cnd = jnp.where(stat_valid, new_cnd, -1)

    # ---- static lines ----
    lk_ok, lkd, lkf, lkc = filts.line_state(l_uv)
    lkeep = line_ok & lk_ok
    lkept_idx, lkept_v = _first_k(lkeep, NLS)
    nlk = jnp.minimum(jnp.sum(lkeep.astype(jnp.int32)), NLS)
    kl_uv = l_uv[lkept_idx] * lkept_v[:, None]
    kl_d = ld_k = jnp.where(lkept_v[:, None], lkd[lkept_idx], 0.0)
    kl_f = lkf[lkept_idx] * lkept_v[:, None]
    kl_c = lkc[lkept_idx] * lkept_v[:, None]
    kl_asso = jnp.where(lkept_v, lkept_idx, -1)
    kl_cnd = jnp.full(NLS, -1, jnp.int32)

    cl_uv, cl_d, cl_f, cl_c, cl_v = line_tmp
    cok, cld, clf, clc = filts.line_cand(cl_uv)
    cok = cok & cl_v
    cok = cok & ~((nlk > 0) & _line_dup(cl_uv, kl_uv, lkept_v))
    tl_idx, tl_v = _first_k(cok, NLS)
    ntl = jnp.sum(cok.astype(jnp.int32))
    tl_uv = cl_uv[tl_idx] * tl_v[:, None]
    tl_d = jnp.where(tl_v[:, None], cld[tl_idx], 0.0)
    tl_f = clf[tl_idx] * tl_v[:, None]
    tl_c = clc[tl_idx] * tl_v[:, None]
    tl_asso = jnp.full(NLS, -1, jnp.int32)
    tl_cnd = jnp.where(tl_v, tl_idx, -1)
    ((new_l, new_ld, new_lf, new_lc, new_lasso, new_lcnd),
     line_valid) = (
        _merge_keep_topup(
            (kl_uv, kl_d, kl_f, kl_c, kl_asso, kl_cnd), nlk,
            (tl_uv, tl_d, tl_f, tl_c, tl_asso, tl_cnd), ntl, NLS,
        )
    )
    new_l = new_l * line_valid[:, None]
    new_ld = new_ld * line_valid[:, None]
    new_lf = new_lf * line_valid[:, None]
    new_lc = new_lc * line_valid[:, None]
    new_lasso = jnp.where(line_valid, new_lasso, -1)
    new_lcnd = jnp.where(line_valid, new_lcnd, -1)

    # ---- object points: keep + per-object top-up + new labels ----
    co_uv, co_d, co_f, co_c, co_s, co_v = obj_tmp
    ok_o, m_o, d_o, f_o, c_o = filts.obj_state(o_uv)
    tracked, tr_ok = _sorted_unique(
        obj_label, obj_label > 0, MAXO
    )
    cok_all, cm, cdd, cff, ccc = filts.obj_cand(co_uv)
    cok_all = cok_all & co_v

    def lane(labK, okK):
        keepm = (obj_label == labK) & obj_ok & ok_o & okK
        idx, iv = _first_k(keepm, P)
        n = jnp.minimum(jnp.sum(keepm.astype(jnp.int32)), P)
        sem_now, anyk = _masked_mode(m_o, keepm)
        sem_now = jnp.where(anyk, sem_now, 0)
        kv = (
            o_uv[idx] * iv[:, None],
            jnp.where(iv, d_o[idx], 0.0),
            f_o[idx] * iv[:, None],
            c_o[idx] * iv[:, None],
            jnp.where(iv, m_o[idx], 0),
            jnp.where(iv, idx, -1),
            jnp.full(P, -1, jnp.int32),
        )
        occK = _scatter_occupancy(h, w, o_uv[idx], iv)
        topm = (
            cok_all & (cm == sem_now) & (sem_now != 0) & okK
            & ~((n > 0) & _near_occupied(occK, co_uv, h, w))
        )
        tidx, tv = _first_k(topm, P)
        tn = jnp.sum(topm.astype(jnp.int32))
        tvv = (
            co_uv[tidx] * tv[:, None],
            jnp.where(tv, cdd[tidx], 0.0),
            cff[tidx] * tv[:, None],
            ccc[tidx] * tv[:, None],
            jnp.where(tv, cm[tidx], 0),
            jnp.full(P, -1, jnp.int32),
            jnp.where(tv, tidx, -1),
        )
        (uv, d, f, c, sem, asso, cnd), lv = _merge_keep_topup(
            kv, n, tvv, tn, P
        )
        lv = lv & okK
        return (uv, d, f, c, sem, asso, cnd, lv, sem_now)

    (L_uv, L_d, L_f, L_c, L_sem, L_asso, L_cnd, L_v, L_semnow) = jax.vmap(
        lane
    )(tracked, tr_ok)

    # live semantic labels (host live_sems: sem_now of every tracked lane)
    live_sems = jnp.where(tr_ok, L_semnow, -1)

    # new-label candidates: per new sem, capped P, sem-ascending
    is_live = (cm[:, None] == live_sems[None, :]).any(axis=1)
    new_cand = cok_all & (cm != 0) & ~is_live
    rank = _rank_within_sem(cm, new_cand, NO)
    new_sel = new_cand & (rank < P)
    # order rows by (sem, idx): stable argsort on sem
    big = jnp.iinfo(jnp.int32).max
    nkey = jnp.where(new_sel, cm, big)
    norder = jnp.argsort(nkey, stable=True)
    n_new = jnp.sum(new_sel.astype(jnp.int32))
    N_uv = co_uv[norder]
    N_d = cdd[norder]
    N_f = cff[norder]
    N_c = ccc[norder]
    N_sem = cm[norder]
    N_v = jnp.arange(NO) < n_new

    # global compaction: tracked lanes (lane-major) then new labels
    flat_v = L_v.reshape(-1)
    flat = [a.reshape((MAXO * P,) + a.shape[2:])
            for a in (L_uv, L_d, L_f, L_c, L_sem, L_asso, L_cnd)]
    lane_lab = jnp.broadcast_to(tracked[:, None], (MAXO, P)).reshape(-1)
    g_idx, g_v = _first_k(flat_v, NO)
    tracked_total = jnp.sum(flat_v.astype(jnp.int32))
    T_vals = (
        flat[0][g_idx] * g_v[:, None],
        jnp.where(g_v, flat[1][g_idx], 0.0),
        flat[2][g_idx] * g_v[:, None],
        flat[3][g_idx] * g_v[:, None],
        jnp.where(g_v, flat[4][g_idx], 0),
        jnp.where(g_v, flat[5][g_idx], -1),
        jnp.where(g_v, flat[6][g_idx], -1),
        jnp.where(g_v, lane_lab[g_idx], -2),
    )
    N_vals = (
        N_uv, N_d, N_f, N_c, N_sem,
        jnp.full(NO, -1, jnp.int32),
        jnp.where(N_v, norder.astype(jnp.int32), -1),
        jnp.full(NO, -2, jnp.int32),
    )
    ((no_uv, no_d, no_f, no_c, no_sem, no_asso, no_cnd, no_label),
     obj_valid) = (
        _merge_keep_topup(T_vals, tracked_total, N_vals, n_new, NO)
    )
    no_uv = no_uv * obj_valid[:, None]
    no_d = no_d * obj_valid
    no_f = no_f * obj_valid[:, None]
    no_c = no_c * obj_valid[:, None]
    no_sem = jnp.where(obj_valid, no_sem, 0)
    no_asso = jnp.where(obj_valid, no_asso, -1)
    no_cnd = jnp.where(obj_valid, no_cnd, -1)
    no_label = jnp.where(obj_valid, no_label, -2)

    # ---- object lines: keep + per-object top-up + new labels ----
    col_uv, col_d, col_f, col_c, col_s, col_v = oline_tmp
    col_ok_all = filts.oline_cand_ok(col_uv)
    # flow at the kept object-line positions, carried through the merge
    # so the sampled mode never needs a post-merge plane lookup
    ol_f_now = filts.flow4(ol_uv)

    def lane_l(labK, okK, sem_nowK):
        keepm = (oline_label == labK) & oline_ok & okK
        idx, iv = _first_k(keepm, L)
        n = jnp.minimum(jnp.sum(keepm.astype(jnp.int32)), L)
        kv = (
            ol_uv[idx] * iv[:, None],
            jnp.where(iv[:, None], ol_d[idx], 0.0),
            jnp.where(iv, ol_sem[idx], 0),
            jnp.where(iv, idx, -1),
            jnp.full(L, -1, jnp.int32),
            ol_f_now[idx] * iv[:, None],
        )
        topm = (
            col_v & col_ok_all & (col_s == sem_nowK) & (sem_nowK != 0)
            & okK & ~_obj_line_dup(col_uv, kv[0], iv)
        )
        tidx, tv = _first_k(topm, L)
        tn = jnp.sum(topm.astype(jnp.int32))
        tvv = (
            col_uv[tidx] * tv[:, None],
            jnp.where(tv[:, None], col_d[tidx], 0.0),
            jnp.where(tv, col_s[tidx], 0),
            jnp.full(L, -1, jnp.int32),
            jnp.where(tv, tidx, -1),
            col_f[tidx] * tv[:, None],
        )
        (uv, d, sem, asso, cnd, f4), lv = _merge_keep_topup(
            kv, n, tvv, tn, L
        )
        lv = lv & okK
        return uv, d, sem, asso, cnd, f4, lv

    OL_uv, OL_d, OL_sem, OL_asso, OL_cnd, OL_f, OL_v = jax.vmap(lane_l)(
        tracked, tr_ok, L_semnow
    )
    # new-label lines: (sem, idx)-sorted, no per-label cap (host quirk)
    nl_is_live = (col_s[:, None] == live_sems[None, :]).any(axis=1)
    nl_sel = col_v & (col_s != 0) & ~nl_is_live
    nlkey = jnp.where(nl_sel, col_s, big)
    nlorder = jnp.argsort(nlkey, stable=True)
    n_nl = jnp.sum(nl_sel.astype(jnp.int32))
    NL_vals = (
        col_uv[nlorder], col_d[nlorder], col_s[nlorder],
        jnp.full(NLO, -1, jnp.int32),
        jnp.where(jnp.arange(NLO) < n_nl, nlorder.astype(jnp.int32), -1),
        col_f[nlorder],
        jnp.full(NLO, -2, jnp.int32),
    )
    flat_lv = OL_v.reshape(-1)
    flat_l = [a.reshape((MAXO * L,) + a.shape[2:])
              for a in (OL_uv, OL_d, OL_sem, OL_asso, OL_cnd, OL_f)]
    lane_lab_l = jnp.broadcast_to(tracked[:, None], (MAXO, L)).reshape(-1)
    gl_idx, gl_v = _first_k(flat_lv, NLO)
    tracked_l_total = jnp.sum(flat_lv.astype(jnp.int32))
    TL_vals = (
        flat_l[0][gl_idx] * gl_v[:, None],
        jnp.where(gl_v[:, None], flat_l[1][gl_idx], 0.0),
        jnp.where(gl_v, flat_l[2][gl_idx], 0),
        jnp.where(gl_v, flat_l[3][gl_idx], -1),
        jnp.where(gl_v, flat_l[4][gl_idx], -1),
        flat_l[5][gl_idx] * gl_v[:, None],
        jnp.where(gl_v, lane_lab_l[gl_idx], -2),
    )
    ((nol_uv, nol_d, nol_sem, nol_asso, nol_cnd, nol_fcar, nol_label),
     oline_valid) = (
        _merge_keep_topup(TL_vals, tracked_l_total, NL_vals, n_nl, NLO)
    )
    nol_uv = nol_uv * oline_valid[:, None]
    nol_d = nol_d * oline_valid[:, None]
    nol_sem = jnp.where(oline_valid, nol_sem, 0)
    nol_asso = jnp.where(oline_valid, nol_asso, -1)
    nol_cnd = jnp.where(oline_valid, nol_cnd, -1)
    nol_label = jnp.where(oline_valid, nol_label, -2)
    # flows/corres at the new line positions: dense mode re-looks-up at
    # the merged (zeroed-if-invalid) positions, exactly as before; the
    # sampled mode substitutes the carried values
    nol_f = filts.flow4_final(nol_uv, nol_fcar, oline_valid)
    nol_c = nol_uv + nol_f

    # ---- 3D in world ----
    stat_3d = fr.world_points(K, pose, new_uv, new_d)
    line_3d = fr.world_lines(K, pose, new_l, new_ld)
    obj_3d = fr.world_points(K, pose, no_uv, no_d)
    oline_3d = fr.world_lines(K, pose, nol_uv, nol_d)

    state = ResidentState(
        pose=pose, velocity=velocity,
        s_uv=new_uv, s_d=new_d, s_f=new_f, s_c=new_c, s_valid=stat_valid,
        l_uv=new_l, l_d=new_ld, l_f=new_lf, l_c=new_lc, l_valid=line_valid,
        o_uv=no_uv, o_d=no_d, o_f=no_f, o_c=no_c, o_sem=no_sem,
        o_label=no_label, o_valid=obj_valid,
        ol_uv=nol_uv, ol_d=nol_d, ol_f=nol_f, ol_c=nol_c, ol_sem=nol_sem,
        ol_label=nol_label, ol_valid=oline_valid,
        meta_sem=meta_sem, meta_label=meta_label, meta_stat=meta_stat,
        meta_motion=meta_motion, meta_n=meta_n, max_id=max_id,
        last_mask=last_mask, last_flow=last_flow,
        s_asso=new_asso, s_cand=new_cnd,
        l_asso=new_lasso, l_cand=new_lcnd,
        o_asso=no_asso, o_cand=no_cnd,
        ol_asso=nol_asso, ol_cand=nol_cnd,
    )
    core = dict(
        stat_uv=new_uv, stat_depth=new_d, stat_3d=stat_3d,
        stat_valid=stat_valid, stat_asso=new_asso,
        line_uv=new_l, line_depth=new_ld, line_3d=line_3d,
        line_valid=line_valid, line_asso=new_lasso,
        obj_uv=no_uv, obj_depth=no_d, obj_3d=obj_3d, obj_valid=obj_valid,
        obj_asso=no_asso, obj_label=no_label, obj_sem=no_sem,
        oline_uv=nol_uv, oline_depth=nol_d, oline_3d=oline_3d,
        oline_valid=oline_valid, oline_asso=nol_asso,
        oline_label=nol_label, oline_sem=nol_sem,
    )
    return state, core


# ---------------------------------------------------------------------------
# host <-> device state conversion
# ---------------------------------------------------------------------------

def state_from_host(last: dict, last_meta: dict, max_id: int,
                    velocity, last_mask, last_flow, maxo: int):
    """Lift the host tracker's ``last`` dict + ``last_meta`` into a
    ResidentState (device_put happens lazily on first use)."""
    import numpy as np

    ms = np.zeros(maxo, np.int32)
    ml = np.full(maxo, -1, np.int32)
    mt = np.zeros(maxo, bool)
    mm = np.tile(np.eye(4, dtype=np.float32), (maxo, 1, 1))
    n = min(len(last_meta.get("sem_position", [])), maxo)
    for k in range(n):
        ms[k] = last_meta["sem_position"][k]
        ml[k] = last_meta["mod_label"][k]
        mt[k] = bool(last_meta["obj_stat"][k])
        H = last_meta["obj_motion"].get(last_meta["mod_label"][k])
        if H is not None:
            mm[k] = H
    vel = np.eye(4, dtype=np.float32) if velocity is None else velocity
    return ResidentState(
        pose=jnp.asarray(last["pose"]),
        velocity=jnp.asarray(vel),
        s_uv=jnp.asarray(last["stat_uv"]),
        s_d=jnp.asarray(last["stat_depth"]),
        s_f=jnp.asarray(last["stat_flow"]),
        s_c=jnp.asarray(last["stat_corres"]),
        s_valid=jnp.asarray(last["stat_valid"]),
        l_uv=jnp.asarray(last["line_uv"]),
        l_d=jnp.asarray(last["line_depth"]),
        l_f=jnp.asarray(last["line_flow"]),
        l_c=jnp.asarray(last["line_corres"]),
        l_valid=jnp.asarray(last["line_valid"]),
        o_uv=jnp.asarray(last["obj_uv"]),
        o_d=jnp.asarray(last["obj_depth"]),
        o_f=jnp.asarray(last["obj_flow"]),
        o_c=jnp.asarray(last["obj_corres"]),
        o_sem=jnp.asarray(last["obj_sem"]),
        o_label=jnp.asarray(last["obj_label"]),
        o_valid=jnp.asarray(last["obj_valid"]),
        ol_uv=jnp.asarray(last["oline_uv"]),
        ol_d=jnp.asarray(last["oline_depth"]),
        ol_f=jnp.asarray(last["oline_flow"]),
        ol_c=jnp.asarray(last["oline_corres"]),
        ol_sem=jnp.asarray(last["oline_sem"]),
        ol_label=jnp.asarray(last["oline_label"]),
        ol_valid=jnp.asarray(last["oline_valid"]),
        meta_sem=jnp.asarray(ms),
        meta_label=jnp.asarray(ml),
        meta_stat=jnp.asarray(mt),
        meta_motion=jnp.asarray(mm),
        meta_n=jnp.asarray(n, jnp.int32),
        max_id=jnp.asarray(max_id, jnp.int32),
        last_mask=jnp.asarray(last_mask, jnp.int32),
        last_flow=jnp.asarray(last_flow, jnp.float32),
        # identity provenance: every row is its own ancestor at entry
        s_asso=jnp.arange(len(last["stat_uv"]), dtype=jnp.int32),
        s_cand=jnp.full(len(last["stat_uv"]), -1, jnp.int32),
        l_asso=jnp.arange(len(last["line_uv"]), dtype=jnp.int32),
        l_cand=jnp.full(len(last["line_uv"]), -1, jnp.int32),
        o_asso=jnp.arange(len(last["obj_uv"]), dtype=jnp.int32),
        o_cand=jnp.full(len(last["obj_uv"]), -1, jnp.int32),
        ol_asso=jnp.arange(len(last["oline_uv"]), dtype=jnp.int32),
        ol_cand=jnp.full(len(last["oline_uv"]), -1, jnp.int32),
    )


def state_to_host(state: ResidentState) -> dict:
    """Pull the ResidentState back into a host ``last`` dict (+meta)."""
    import numpy as np

    g = lambda x: np.asarray(x)
    last = dict(
        pose=g(state.pose),
        stat_uv=g(state.s_uv), stat_depth=g(state.s_d),
        stat_flow=g(state.s_f), stat_corres=g(state.s_c),
        stat_valid=g(state.s_valid),
        line_uv=g(state.l_uv), line_depth=g(state.l_d),
        line_flow=g(state.l_f), line_corres=g(state.l_c),
        line_valid=g(state.l_valid),
        obj_uv=g(state.o_uv), obj_depth=g(state.o_d),
        obj_flow=g(state.o_f), obj_corres=g(state.o_c),
        obj_sem=g(state.o_sem), obj_label=g(state.o_label),
        obj_valid=g(state.o_valid),
        oline_uv=g(state.ol_uv), oline_depth=g(state.ol_d),
        oline_flow=g(state.ol_f), oline_corres=g(state.ol_c),
        oline_sem=g(state.ol_sem), oline_label=g(state.ol_label),
        oline_valid=g(state.ol_valid),
    )
    n = int(state.meta_n)
    meta = {
        "sem_position": [int(x) for x in g(state.meta_sem)[:n]],
        "mod_label": [int(x) for x in g(state.meta_label)[:n]],
        "obj_stat": [bool(x) for x in g(state.meta_stat)[:n]],
        "obj_motion": {
            int(l): g(state.meta_motion)[k]
            for k, l in enumerate(g(state.meta_label)[:n])
            if bool(g(state.meta_stat)[k])
        },
    }
    return last, meta, int(state.max_id)


def gt_sem_table(gt_rows, cap: int = 16):
    """Semantic labels with an available GT object pose row (-1 pads)."""
    import numpy as np

    t = np.full(cap, -1, np.int32)
    for i, row in enumerate(gt_rows[:cap]):
        t[i] = int(row[1])
    return t


# ---------------------------------------------------------------------------
# Host driver: non-blocking dispatch + lagging map mirror
# ---------------------------------------------------------------------------

# jitted resident steps shared across identically-configured drivers
_STEP_MEMO: dict = {}


def jit_resident_step(cfg, K: Intrinsics, caps: dict):
    """Memoized ``jax.jit(build_resident_step(...))``: identical
    (settings, caps) share one traced+compiled program (K is derived
    from the settings, so the fingerprint covers it)."""
    from ..utils.config import settings_fingerprint
    key = ("raw", settings_fingerprint(cfg), repr(sorted(caps.items())))
    fn = _STEP_MEMO.get(key)
    if fn is None:
        fn = _STEP_MEMO[key] = jax.jit(build_resident_step(cfg, K, caps))
    return fn


class ResidentDriver:
    """Drives the device-resident frame loop for a host ``Tracking``.

    Per frame the host only: computes GT tables, pushes the four image
    planes, dispatches ONE jit, and spawns a detached pull thread for the
    map outputs.  Results drain ``LAG`` frames behind into the MapState,
    so no dispatch ever waits on a device->host transfer.  BA triggers
    and mode exits force a full drain (and, for BA, a refined-pose push
    back into the device state)."""

    LAG = 2

    def __init__(self, tracker):
        import collections

        self.tr = tracker
        self.caps = dict(
            NS=tracker.NS, NLS=tracker.NLS, NO=tracker.NO, NLO=tracker.NLO,
            P=tracker.P_OBJ, L=tracker.L_OBJ, MAXO=tracker.MAXO,
            GCAP=2 * tracker.MAXO,
        )
        self.state = None
        self.pending = collections.deque()
        self._fns = {}
        self._prev_gt = None        # (gt_objs, pose_gt) of frame f-1
        self._last_pose = None      # most recent drained pose (T_cw)

    # -- eligibility ----------------------------------------------------
    @staticmethod
    def eligible(cfg):
        return (
            cfg.use_joint_optimization
            and cfg.k1 == 0 and cfg.k2 == 0 and cfg.k3 == 0
            and cfg.p1 == 0 and cfg.p2 == 0
        )

    # -- mode transitions ----------------------------------------------
    def enter(self):
        tr = self.tr
        self.state = state_from_host(
            tr.last, tr.last_meta, tr.max_id, tr.velocity,
            tr.last_mask_np, tr.last_flow_np, tr.MAXO,
        )
        self._prev_gt = (tr.last.get("gt_objs", []), tr.last["pose_gt"])
        self._last_pose = np.asarray(tr.last["pose"])

    def exit(self):
        """Drain everything and write the device state back to the host
        tracker (so host-path frames / checkpointing can continue)."""
        tr = self.tr
        self.drain_all()
        last, meta, max_id = state_to_host(self.state)
        last["pose_gt"] = self._prev_gt[1]
        last["gt_objs"] = self._prev_gt[0]
        tr.last = last
        tr.last_meta = meta
        tr.max_id = max_id
        tr.velocity = np.asarray(self.state.velocity)
        tr.last_mask_np = np.asarray(self.state.last_mask)
        tr.last_flow_np = np.asarray(self.state.last_flow)
        tr.mask_np = tr.last_mask_np.copy()
        self.state = None

    # -- per-frame ------------------------------------------------------
    def _fn(self, need_fast, need_lines, use_grid):
        keyk = (need_fast, need_lines, use_grid)
        fn = self._fns.get(keyk)
        if fn is not None:
            return fn
        tr = self.tr
        cfg = tr.cfg
        caps = self.caps
        # share the jitted step across identically-configured drivers
        # (a fresh closure per driver would recompile the whole program)
        from ..utils.config import settings_fingerprint
        memo_key = (keyk, settings_fingerprint(cfg),
                    repr(sorted(caps.items())), tr.N_CAND, tr.NL_CAND)
        fn = _STEP_MEMO.get(memo_key)
        if fn is not None:
            self._fns[keyk] = fn
            return fn
        step = build_resident_step(cfg, tr.K, caps)
        N_CAND, NL_CAND = tr.N_CAND, tr.NL_CAND
        if need_fast or need_lines:
            from ..ops import fast as fast_ops, lines as line_ops

            fcfg = tr._fast_cfg() if need_fast else None
            lcfg = tr._line_cfg() if need_lines else None

        def run(state, gray, depth_raw, flow, mask,
                inj_cand, inj_cand_v, inj_l, inj_lv,
                gt_prev, gt_cur, fid):
            h, w = mask.shape
            if need_fast:
                uv, _, va = fast_ops.detect_keypoints(
                    gray.astype(jnp.float32), fcfg
                )
                n = min(uv.shape[0], N_CAND)
                cand = jnp.zeros((N_CAND, 2), jnp.float32).at[:n].set(
                    uv[:n].astype(jnp.float32)
                )
                cand_v = jnp.zeros(N_CAND, jnp.bool_).at[:n].set(va[:n])
            elif use_grid:
                cand = jnp.asarray(
                    fr.grid_sample_uv(h, w, n_points=N_CAND), jnp.float32
                )
                cand_v = jnp.ones(N_CAND, jnp.bool_)
            else:
                cand, cand_v = inj_cand, inj_cand_v
            if need_lines:
                seg = line_ops.detect_lines(
                    gray.astype(jnp.float32), lcfg
                )
                # compact valid rows in order, like the host's uv4[valid]
                idx, iv = _first_k(seg.valid, NL_CAND)
                lcand = seg.uv4[idx] * iv[:, None]
                lv = iv
            else:
                lcand, lv = inj_l, inj_lv
            key = jax.random.PRNGKey(fid)
            return step(state, depth_raw, flow, mask, cand, cand_v,
                        lcand, lv, gt_prev, gt_cur, key)

        fn = jax.jit(run)
        _STEP_MEMO[memo_key] = fn
        self._fns[keyk] = fn
        return fn

    def track(self, gray, depth_raw, flow, mask, pose_gt, gt_objs,
              timing, f_id, n_images, stop_frame,
              line_detections=None, point_detections=None):
        import threading
        import time as _time

        tr = self.tr
        cfg = tr.cfg

        # BA trigger for the PREVIOUS frame must complete before this
        # dispatch (the refined pose feeds this frame's solve)
        if self._lba_trigger(f_id - 1):
            self.drain_all()
            self._run_partial_ba()
        else:
            from ..solvers import ba_builder
            ba_builder.maybe_precompile_partial_async(
                tr.map, tr.K, cfg, use_lines=cfg.use_lines,
                stop_frame=stop_frame,
            )

        need_fast = cfg.use_sample_fea == 0 and point_detections is None
        need_lines = line_detections is None and cfg.use_lines
        use_grid = not need_fast and point_detections is None
        fn = self._fn(need_fast, need_lines, use_grid)

        N_CAND, NL_CAND = tr.N_CAND, tr.NL_CAND
        inj_cand = np.zeros((N_CAND, 2), np.float32)
        inj_cand_v = np.zeros(N_CAND, bool)
        if point_detections is not None:
            n = min(len(point_detections), N_CAND)
            inj_cand[:n] = point_detections[:n]
            inj_cand_v[:n] = True
        inj_l = np.zeros((NL_CAND, 4), np.float32)
        inj_lv = np.zeros(NL_CAND, bool)
        if line_detections is not None and len(line_detections):
            n = min(len(line_detections), NL_CAND)
            inj_l[:n] = line_detections[:n]
            inj_lv[:n] = True

        # input-plane compression (ROADMAP #2): f16 depth/flow + u8 mask
        # halve the dense push to ~3.3 MB/frame; decompressed on device
        # by a cast.  f16 keeps ~3 decimal digits -- sub-mm depth and
        # milli-pixel flow quantization, far below the sensor/flow noise.
        if cfg.resident_compress_input:
            depth_push = jnp.asarray(
                np.asarray(depth_raw, np.float32).astype(np.float16)
            )
            flow_push = jnp.asarray(
                np.ascontiguousarray(flow, dtype=np.float32)
                .astype(np.float16)
            )
            mask_push = jnp.asarray(
                np.clip(np.asarray(mask), 0, 255).astype(np.uint8)
            )
        else:
            depth_push = jnp.asarray(depth_raw, jnp.float32)
            flow_push = jnp.asarray(
                np.ascontiguousarray(flow, dtype=np.float32)
            )
            mask_push = jnp.asarray(mask, jnp.int32)
        t0 = _time.perf_counter()
        state, out = fn(
            self.state, jnp.asarray(np.ascontiguousarray(gray)),
            depth_push, flow_push, mask_push,
            inj_cand, inj_cand_v, inj_l, inj_lv,
            gt_sem_table(self._prev_gt[0]), gt_sem_table(gt_objs),
            jnp.asarray(f_id, jnp.int32),
        )
        self.state = state
        timing[1] = (_time.perf_counter() - t0) * 1e3

        out.copy_to_host_async()
        holder = {"np": None, "err": None}

        def _pull(out=out, holder=holder):
            try:
                # np.array: a writable copy (BA write-back mutates map
                # rows in place)
                holder["np"] = np.array(out)
            except Exception as e:
                holder["err"] = e

        th = threading.Thread(target=_pull, daemon=True)
        th.start()
        self.pending.append(dict(
            f_id=f_id, th=th, holder=holder,
            pose_gt=pose_gt, gt_objs=gt_objs,
            prev_gt=self._prev_gt, timing=timing.copy(),
            stop_frame=stop_frame,
        ))
        self._prev_gt = (gt_objs, pose_gt)

        while len(self.pending) > self.LAG:
            self._drain_one()
        # the LAST frame of the sequence finishes synchronously so the
        # final pose/map are exact
        if f_id >= stop_frame or f_id >= n_images - 1:
            self.drain_all()
            run_global = (
                cfg.run_global_ba if cfg.run_global_ba is not None
                else cfg.choose_data == 2
            )
            if f_id == stop_frame and run_global:
                self.exit()
                from ..solvers import ba_builder
                ba_builder.full_batch_optimization(
                    tr.map, tr.K, cfg, use_lines=cfg.use_lines
                )
        return np.asarray(self._last_pose)

    # -- draining -------------------------------------------------------
    def drain_all(self):
        while self.pending:
            self._drain_one()

    def _lba_trigger(self, f_id):
        cfg = self.tr.cfg
        return (
            cfg.run_local_ba
            and f_id >= 0
            and (f_id - cfg.overlap_size + 1)
            % max(cfg.window_size - cfg.overlap_size, 1) == 0
            and f_id >= cfg.window_size - 1
        )

    def _run_partial_ba(self):
        import time as _time

        tr = self.tr
        cfg = tr.cfg
        from ..solvers import ba_builder

        t0 = _time.perf_counter()
        ba_builder.partial_batch_optimization(
            tr.map, tr.K, cfg.window_size, cfg, use_lines=cfg.use_lines,
        )
        tr.map.lba_times.append((_time.perf_counter() - t0) * 1e3)
        pose_np = np.linalg.inv(tr.map.camera_poses[-1]).astype(np.float32)
        self.state = self.state._replace(pose=jnp.asarray(pose_np))
        self._last_pose = pose_np

    def _drain_one(self):
        import time as _time

        p = self.pending.popleft()
        t0 = _time.perf_counter()
        p["th"].join()
        perf = getattr(self, "perf", None)
        if perf is not None:
            now = _time.perf_counter()
            h = p["holder"]
            perf.setdefault("drain_join", []).append((now - t0) * 1e3)
            if "t1" in h:
                perf.setdefault("pull_dur", []).append(
                    (h["t1"] - h["t0"]) * 1e3
                )
                if "t_exec" in h:
                    perf.setdefault("pull_exec", []).append(
                        (h["t_exec"] - h["t0"]) * 1e3
                    )
                    perf.setdefault("pull_xfer", []).append(
                        (h["t1"] - h["t_exec"]) * 1e3
                    )
                # negative = the pull landed before the drain asked
                perf.setdefault("pull_slack", []).append(
                    (h["t1"] - t0) * 1e3
                )
        if p["holder"]["err"] is not None:
            raise p["holder"]["err"]
        o = unpack_out(p["holder"]["np"], self.caps)
        self._apply_out(p, o)
        return p, o

    def _apply_out(self, p, o):
        tr = self.tr
        cfg = tr.cfg
        pose_np = o["pose"]
        velocity = o["velocity"]
        pose_gt = p["pose_gt"]
        prev_gt_objs, prev_pose_gt = p["prev_gt"]
        curr_twc_gt = np.linalg.inv(pose_gt)
        last_twc_gt = np.linalg.inv(prev_pose_gt)
        EYE = np.eye(4, dtype=np.float32)

        obj_meta = []
        for k in range(tr.MAXO):
            if not bool(o["lane_valid"][k]):
                continue
            sem = int(o["lane_sem"][k])
            stat = bool(o["lane_stat"][k])
            H = np.asarray(o["lane_H"][k], np.float32)
            centre = np.asarray(o["lane_centre"][k], np.float32)
            L_w_p = tr._gt_obj_pose(list(prev_gt_objs), sem, last_twc_gt)
            L_w_c = tr._gt_obj_pose(list(p["gt_objs"]), sem, curr_twc_gt)
            H_gt_body = EYE.copy()
            H_gt_world = EYE.copy()
            pose_pre = EYE.copy()
            if L_w_p is not None and L_w_c is not None:
                H_gt_body = (np.linalg.inv(L_w_p) @ L_w_c).astype(np.float32)
                H_gt_world = (L_w_c @ np.linalg.inv(L_w_p)).astype(np.float32)
                pose_pre = L_w_p
            sp = H_gt_world[:3, 3] - (
                np.eye(3) - H_gt_world[:3, :3]
            ) @ centre[:3]
            obj_meta.append(dict(
                label=int(o["lane_label"][k]), sem=sem, stat=stat, H=H,
                speed_gt=float(np.linalg.norm(sp)) * 36.0,
                H_gt_body=H_gt_body, pose_pre=pose_pre, centre=centre,
            ))

        # ---- map mirror (tracking._push_map) ----
        from . import tracking as _T

        m = tr.map
        st = o
        # world-3D arrays are intentionally NOT in the pulled buffer
        # (out_spec NOTE): recompute them here from pose/uv/depth --
        # identical math to frame.world_points/world_lines on device
        stat_3d = _T._np_world_points(
            tr.K, pose_np, st["stat_uv"], st["stat_depth"]
        )
        line_3d = _T._np_world_lines(
            tr.K, pose_np, st["line_uv"], st["line_depth"]
        )
        obj_3d = _T._np_world_points(
            tr.K, pose_np, st["obj_uv"], st["obj_depth"]
        )
        oline_3d = _T._np_world_lines(
            tr.K, pose_np, st["oline_uv"], st["oline_depth"]
        )
        m.stat_uv.append(st["stat_uv"])
        m.stat_depth.append(st["stat_depth"])
        m.stat_3d.append(stat_3d)
        m.stat_valid.append(st["stat_valid"])
        m.stat_asso.append(st["stat_asso"])
        m.line_uv.append(st["line_uv"])
        m.line_depth.append(st["line_depth"])
        m.line_3d.append(line_3d)
        m.line_valid.append(st["line_valid"])
        m.line_asso.append(st["line_asso"])
        m.line_plucker.append(
            _T._np_plucker(line_3d[:, :3], line_3d[:, 3:])
        )
        m.dyn_uv.append(st["obj_uv"])
        m.dyn_depth.append(st["obj_depth"])
        m.dyn_3d.append(obj_3d)
        m.dyn_valid.append(st["obj_valid"])
        m.dyn_asso.append(st["obj_asso"])
        m.dyn_label.append(st["obj_label"])
        m.dline_uv.append(st["oline_uv"])
        m.dline_depth.append(st["oline_depth"])
        m.dline_3d.append(oline_3d)
        m.dline_valid.append(st["oline_valid"])
        m.dline_asso.append(st["oline_asso"])
        m.dline_label.append(st["oline_label"])
        m.dline_plucker.append(
            _T._np_plucker(oline_3d[:, :3], oline_3d[:, 3:])
        )
        m.camera_poses.append(np.linalg.inv(pose_np).astype(np.float32))
        m.camera_poses_rf.append(np.linalg.inv(pose_np).astype(np.float32))
        m.camera_poses_gt.append(np.linalg.inv(pose_gt).astype(np.float32))

        # live tripwire: inline per-frame camera RPE vs GT, like the
        # reference's per-frame cout (/root/reference/src/Tracking.cc:1190)
        every = getattr(cfg, "rpe_print_every", 0)
        if every and len(m.camera_poses) >= 2 \
                and (len(m.camera_poses) - 1) % every == 0:
            from ..utils import metrics as _metrics

            t_e, r_e = _metrics.camera_rpe(
                m.camera_poses[-2:], m.camera_poses_gt[-2:]
            )
            print("[frame %4d] camera RPE: t=%.4f m  r=%.4f deg  "
                  "(pt inliers %d)"
                  % (len(m.camera_poses) - 1, t_e, r_e,
                     int(o["n_point_inliers"])), flush=True)

        cam_motion = np.linalg.inv(velocity).astype(np.float32)
        motions = [cam_motion]
        pose_pres = [cam_motion]
        labels = [0]
        sems = [0]
        stats = [True]
        centres = [np.zeros(3, np.float32)]
        motions_gt = [
            (prev_pose_gt @ np.linalg.inv(pose_gt)).astype(np.float32)
        ]
        speeds = [1.0]
        for om in obj_meta:
            if not om["stat"]:
                continue
            motions.append(om["H"])
            pose_pres.append(om["pose_pre"])
            labels.append(om["label"])
            sems.append(om["sem"])
            stats.append(True)
            centres.append(om["centre"])
            motions_gt.append(om["H_gt_body"])
            speeds.append(om["speed_gt"])
        m.rigid_motions.append(motions)
        m.rigid_motions_rf.append([x.copy() for x in motions])
        m.rigid_motions_gt.append(motions_gt)
        m.obj_pose_pre.append(pose_pres)
        m.rigid_centres.append(centres)
        m.rm_labels.append(labels)
        m.sm_labels.append(sems)
        m.obj_stat.append(stats)
        m.speeds_gt.append(speeds)
        m.frame_times.append(p["timing"])
        self._last_pose = pose_np
        tr.velocity = velocity

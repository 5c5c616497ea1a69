"""Line-segment detection: the LSD / EDLines replacement.

The reference detects lines with LSD (region growing over level-lines) or
EDLines (edge drawing) inside 3rdparty/line_descriptor
(/root/reference/src/Lineextractor.cc:47-135).  Both are inherently
sequential, data-dependent region-growers -- the known-hard kernel for a
data-parallel accelerator (SURVEY.md 7.3).  This module uses a block-parallel reformulation:

 1. Sobel gradients -> magnitude + level-line orientation (mod pi).
 2. Edge mask: magnitude threshold + thin non-maximum suppression.
 3. The image is tiled; each tile fits a straight segment to its edge
    pixels by weighted PCA (first/second moments -> principal direction,
    extent = min/max projection).  A tile emits a segment only when it has
    enough edge support and the orientation is coherent (anisotropy test).
 4. Collinear merge rounds: neighbouring tiles' segments that are aligned
    (angle, lateral offset, endpoint gap) are merged into longer segments.
    Each round at most doubles segment length; a few rounds recover long
    structure lines.  All rounds are fixed-shape vectorized ops.

Output format matches the pipeline contract: (L, 4) endpoint arrays
(sx, sy, ex, ey) + validity, like the injected detections consumed by
``Tracking.grab_rgbd``.  LBD descriptors are intentionally not computed:
the reference computes them but matches lines by optical flow, never by
descriptor (SURVEY.md section 2.1 Lineextractor row).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


class LineDetectConfig(NamedTuple):
    grad_threshold: float = 30.0     # ~2*5.2 quantization of LSD (q=2)
    tile: int = 8
    min_support: int = 5             # edge pixels per tile
    # scatter anisotropy gate: modest, because the orientation-coherence
    # filter (LSD's 22.5 deg tolerance) is the primary noise rejector and
    # short partial-tile strokes legitimately have lambda1/lambda2 ~ 5
    min_anisotropy: float = 4.0
    merge_rounds: int = 4
    merge_angle_cos: float = 0.985   # ~10 deg
    merge_lateral: float = 2.5       # px
    merge_gap: float = 8.0           # px
    min_length: float = 12.0         # final length gate
    max_lines: int = 512
    # octave pyramid: the reference detects on a 2-level Gaussian pyramid
    # with scale 2 (/root/reference/src/Lineextractor.cc:84-96,
    # LSDDetector_custom.cpp:58) -- shallow / low-contrast structure that
    # fragments at full resolution coheres at half resolution
    n_octaves: int = 2
    # endpoint refinement: extend endpoints along the segment direction
    # while the thinned edge map keeps supporting them (closes the gap
    # between per-tile fragments so the merge rounds can chain them)
    refine_steps: int = 12
    # 0 = LSD-style edge map (threshold + gradient-direction NMS),
    # 1 = EDLines-style (anchors + directed propagation along level lines;
    #     /root/reference/src/Lineextractor.cc:100-135, ED_Lib)
    mode: int = 0
    # a-contrario validation (the NFA control of LSD/EDLines, von Gioi
    # IPOL 2012 / NFA.cpp in the reference's ED_Lib): sample level-line
    # orientations along a 3-px-wide strip around each candidate and
    # require the aligned-point count to be binomially significant
    # against p0 = ang_th/180 at the NFA threshold  NT = (w*h)^(5/2)*11.
    # Device-friendly via the Hoeffding/KL lower bound on the binomial
    # tail (conservative: accepts slightly fewer than the exact test).
    # This is what kills the short noise-texture fits the tiled-PCA
    # stage produces on textured surfaces (measured against the faithful
    # oracle in tests/test_lsd_oracle.py).
    nfa_gate: bool = True
    nfa_samples: int = 24
    nfa_ang_tol_deg: float = 22.5
    nfa_log_eps: float = 0.0
    # keep only the N longest detections (reference lsd_nfeatures,
    # Tracking.cc:113 / LSDDetectorC sorts by response and truncates);
    # 0 = unlimited (the reference default)
    n_features: int = 0


def _sobel(img: jnp.ndarray):
    img = img.astype(jnp.float32)
    p = jnp.pad(img, 1, mode="edge")
    # 3x3 Sobel
    gx = (
        (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    )
    gy = (
        (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    )
    return gx, gy


def _thin_edges(mag: jnp.ndarray, gx: jnp.ndarray, gy: jnp.ndarray,
                threshold: float):
    """Gradient-direction NMS (quantized to 4 directions)."""
    h, w = mag.shape
    p = jnp.pad(mag, 1)
    c = p[1:-1, 1:-1]
    n = {
        "e": p[1:-1, 2:], "w": p[1:-1, :-2],
        "s": p[2:, 1:-1], "n": p[:-2, 1:-1],
        "se": p[2:, 2:], "nw": p[:-2, :-2],
        "ne": p[:-2, 2:], "sw": p[2:, :-2],
    }
    ax, ay = jnp.abs(gx), jnp.abs(gy)
    diag = (ax > 0.4142 * ay) & (ay > 0.4142 * ax)
    same_sign = (gx * gy) > 0
    horiz = (ax >= ay) & ~diag          # gradient mostly x -> compare e/w
    vert = (ay > ax) & ~diag
    keep = jnp.where(
        horiz, (c >= n["e"]) & (c >= n["w"]),
        jnp.where(
            vert, (c >= n["s"]) & (c >= n["n"]),
            jnp.where(
                same_sign,
                (c >= n["se"]) & (c >= n["nw"]),
                (c >= n["ne"]) & (c >= n["sw"]),
            ),
        ),
    )
    return keep & (mag > threshold)


class Segments(NamedTuple):
    uv4: jnp.ndarray      # (N, 4) sx, sy, ex, ey
    length: jnp.ndarray   # (N,)
    valid: jnp.ndarray    # (N,)


def _tile_fit(edge: jnp.ndarray, mag: jnp.ndarray, tile: int,
              min_support: int, min_anisotropy: float,
              gx: jnp.ndarray = None, gy: jnp.ndarray = None,
              angle_tol_deg: float = 22.5):
    """Weighted-PCA segment fit per tile with LSD-style orientation
    coherence: only edge pixels whose level-line angle lies within
    ``angle_tol_deg`` of the tile's dominant orientation contribute (the
    region-growing tolerance of LSD, /root/reference/src/
    Lineextractor.cc:62 ``ang_th 22.5``).  Isolated blobs/corners have
    incoherent orientations and are excluded.  Returns per-tile segment
    grid (gh, gw, 4) + validity."""
    h, w = edge.shape
    gh, gw = h // tile, w // tile
    e = edge[: gh * tile, : gw * tile].astype(jnp.float32)
    m = mag[: gh * tile, : gw * tile] * e

    if gx is not None:
        # doubled-angle unit vectors of the LEVEL LINE (perpendicular to
        # the gradient; doubling makes the pi-periodicity a full period)
        gxc = gx[: gh * tile, : gw * tile]
        gyc = gy[: gh * tile, : gw * tile]
        g2 = gxc * gxc + gyc * gyc + 1e-9
        c2 = (gxc * gxc - gyc * gyc) / g2      # cos(2*theta_grad)
        s2 = (2.0 * gxc * gyc) / g2            # sin(2*theta_grad)

        def tiles0(a):
            return (
                a.reshape(gh, tile, gw, tile).transpose(0, 2, 1, 3)
                .reshape(gh, gw, tile * tile)
            )

        tw = tiles0(m)
        tc2 = tiles0(c2)
        ts2 = tiles0(s2)
        # dominant orientation by 4-bin histogram over [0, pi), weighted by
        # magnitude: a line's pixels concentrate in one bin while isolated
        # blobs/corners spread over all bins, so a single high-contrast blob
        # cannot hijack the tile's orientation (a straight circular-mean
        # over doubled angles can be dominated by one strong outlier).
        import numpy as _np0

        bin_c2 = jnp.asarray(
            _np0.cos(2 * _np0.radians([0.0, 45.0, 90.0, 135.0])),
            jnp.float32)
        bin_s2 = jnp.asarray(
            _np0.sin(2 * _np0.radians([0.0, 45.0, 90.0, 135.0])),
            jnp.float32)
        cos45 = float(_np0.cos(_np0.radians(45.0)))
        # (gh, gw, P, 4): pixel within 22.5 deg of bin centre
        inbin = (
            tc2[..., None] * bin_c2 + ts2[..., None] * bin_s2
        ) > cos45
        bin_w = jnp.sum(tw[..., None] * inbin, axis=-2)     # (gh, gw, 4)
        best = jnp.argmax(bin_w, axis=-1)                   # (gh, gw)
        sel = jnp.take_along_axis(
            inbin, best[..., None, None], axis=-1
        )[..., 0]                                           # (gh, gw, P)
        twb = tw * sel
        wsum0 = jnp.maximum(jnp.sum(twb, -1), 1e-6)
        mc2 = jnp.sum(twb * tc2, -1) / wsum0
        ms2 = jnp.sum(twb * ts2, -1) / wsum0
        nrm = jnp.sqrt(mc2 * mc2 + ms2 * ms2 + 1e-12)
        mc2, ms2 = mc2 / nrm, ms2 / nrm
        # cos(2(theta - theta_dom)) > cos(2*tol)
        import numpy as _np

        cos_tol = float(_np.cos(_np.radians(2 * angle_tol_deg)))
        coh = (
            tc2 * mc2[..., None] + ts2 * ms2[..., None]
        ) > cos_tol
        # rebuild full-res inlier mask and apply to the weights
        coh_full = (
            coh.reshape(gh, gw, tile, tile).transpose(0, 2, 1, 3)
            .reshape(gh * tile, gw * tile)
        )
        e = e * coh_full
        m = m * coh_full

    ys = jax.lax.broadcasted_iota(jnp.float32, (gh * tile, gw * tile), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (gh * tile, gw * tile), 1)

    def tiles(a):
        return (
            a.reshape(gh, tile, gw, tile).transpose(0, 2, 1, 3)
            .reshape(gh, gw, tile * tile)
        )

    wgt0 = tiles(m)
    tx = tiles(xs)
    ty = tiles(ys)

    def _fit(wgt):
        wsum = jnp.sum(wgt, -1)
        wsafe = jnp.maximum(wsum, 1e-6)
        mx = jnp.sum(wgt * tx, -1) / wsafe
        my = jnp.sum(wgt * ty, -1) / wsafe
        dx = tx - mx[..., None]
        dy = ty - my[..., None]
        sxx = jnp.sum(wgt * dx * dx, -1) / wsafe
        syy = jnp.sum(wgt * dy * dy, -1) / wsafe
        sxy = jnp.sum(wgt * dx * dy, -1) / wsafe
        # eigen of [[sxx, sxy], [sxy, syy]]
        tr = sxx + syy
        det = sxx * syy - sxy * sxy
        disc = jnp.sqrt(jnp.maximum(tr * tr / 4 - det, 0.0))
        l1 = tr / 2 + disc
        l2 = tr / 2 - disc
        # principal direction: eigenvector of lambda1; when sxy ~ 0 the
        # axes are already principal -- pick the larger-variance axis
        off = jnp.abs(sxy) > 1e-9
        vx = jnp.where(off, l1 - syy, jnp.where(sxx >= syy, 1.0, 0.0))
        vy = jnp.where(off, sxy, jnp.where(sxx >= syy, 0.0, 1.0))
        vn = jnp.sqrt(vx * vx + vy * vy + 1e-12)
        return mx, my, vx / vn, vy / vn, l1, l2, dx, dy

    # robust refit: pixels whose orientation matched the dominant bin but
    # that sit laterally off the fitted line (e.g. one face of a blob) are
    # dropped and the moments recomputed once
    mx, my, vx, vy, l1, l2, dx, dy = _fit(wgt0)
    lat = jnp.abs(dy * vx[..., None] - dx * vy[..., None])
    wgt = wgt0 * (lat <= 2.0)
    mx, my, vx, vy, l1, l2, dx, dy = _fit(wgt)
    # extent: min/max projection of edge pixels on v
    proj = dx * vx[..., None] + dy * vy[..., None]
    pmax = jnp.max(jnp.where(wgt > 0, proj, -1e9), -1)
    pmin = jnp.min(jnp.where(wgt > 0, proj, 1e9), -1)
    count = jnp.sum((wgt > 0).astype(jnp.float32), -1)
    aniso = l1 / jnp.maximum(l2, 1e-6)
    ok = (count >= min_support) & (aniso >= min_anisotropy) & (pmax > pmin)
    s = jnp.stack(
        [mx + pmin * vx, my + pmin * vy, mx + pmax * vx, my + pmax * vy],
        axis=-1,
    )
    return s, ok


def _merge_pairs(seg, ok, nbr_seg, nbr_ok, cfg: LineDetectConfig,
                 allow=None):
    """Try to merge each tile's segment with a neighbour's.  Returns merged
    segment + merged flag (applied where both exist and are collinear)."""
    d1 = seg[..., 2:] - seg[..., :2]
    d2 = nbr_seg[..., 2:] - nbr_seg[..., :2]
    l1 = jnp.linalg.norm(d1, axis=-1) + 1e-9
    l2 = jnp.linalg.norm(d2, axis=-1) + 1e-9
    cosang = jnp.abs(jnp.sum(d1 * d2, -1)) / (l1 * l2)
    # lateral offset of neighbour's midpoint from our infinite line
    mid2 = 0.5 * (nbr_seg[..., :2] + nbr_seg[..., 2:])
    n1 = jnp.stack([-d1[..., 1], d1[..., 0]], -1) / l1[..., None]
    lat = jnp.abs(jnp.sum((mid2 - seg[..., :2]) * n1, -1))
    # endpoint gap: smallest distance between endpoints
    gaps = jnp.stack([
        jnp.linalg.norm(seg[..., 2:] - nbr_seg[..., :2], axis=-1),
        jnp.linalg.norm(seg[..., :2] - nbr_seg[..., 2:], axis=-1),
        jnp.linalg.norm(seg[..., 2:] - nbr_seg[..., 2:], axis=-1),
        jnp.linalg.norm(seg[..., :2] - nbr_seg[..., :2], axis=-1),
    ], -1).min(-1)
    can = (
        ok & nbr_ok
        & (cosang > cfg.merge_angle_cos)
        & (lat < cfg.merge_lateral)
        & (gaps < cfg.merge_gap)
    )
    if allow is not None:
        can = can & allow
    # merged endpoints: extreme projections of all 4 endpoints on the
    # LENGTH-WEIGHTED blended direction through the length-weighted
    # centroid.  Inheriting seg1's direction verbatim amplifies its small
    # tile-fit angle error over the merged length (a 5 deg error on an
    # 8 px fragment becomes a 13 px lateral skew at 150 px).
    u1 = d1 / l1[..., None]
    u2 = d2 / l2[..., None]
    sign = jnp.sign(jnp.sum(u1 * u2, -1, keepdims=True))
    ub = u1 * l1[..., None] + sign * u2 * l2[..., None]
    ub = ub / (jnp.linalg.norm(ub, axis=-1, keepdims=True) + 1e-9)
    mid1 = 0.5 * (seg[..., :2] + seg[..., 2:])
    cen = (mid1 * l1[..., None] + mid2 * l2[..., None]) / (
        (l1 + l2)[..., None]
    )
    pts = jnp.stack(
        [seg[..., :2], seg[..., 2:], nbr_seg[..., :2], nbr_seg[..., 2:]], -2
    )                                              # (..., 4, 2)
    t = jnp.sum((pts - cen[..., None, :]) * ub[..., None, :], -1)
    tmin = jnp.min(t, -1)
    tmax = jnp.max(t, -1)
    new_s = cen + tmin[..., None] * ub
    new_e = cen + tmax[..., None] * ub
    merged = jnp.concatenate([new_s, new_e], -1)
    return jnp.where(can[..., None], merged, seg), can


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Gaussian blur (binomial 1-2-1 separable) + stride-2 decimation: one
    octave of the reference's line pyramid (LSDDetector_custom.cpp:58)."""
    img = img.astype(jnp.float32)
    p = jnp.pad(img, 1, mode="edge")
    bx = 0.25 * (p[1:-1, :-2] + 2 * p[1:-1, 1:-1] + p[1:-1, 2:])
    p2 = jnp.pad(bx, ((1, 1), (0, 0)), mode="edge")
    b = 0.25 * (p2[:-2] + 2 * p2[1:-1] + p2[2:])
    return b[::2, ::2]


def _ed_edges(mag: jnp.ndarray, gx: jnp.ndarray, gy: jnp.ndarray,
              threshold: float, steps: int = 24):
    """EDLines-style edge map: sparse ANCHORS (strict maxima across the
    gradient direction, clearing the threshold with margin) grown by
    directed propagation ALONG the level line, the parallel analog of
    ED_Lib's anchor + smart-route walk (/root/reference/3rdparty/
    line_descriptor/src/ED_Lib/ED.cpp).  Each step every lit pixel lights
    whichever neighbours lie along its level-line direction that themselves
    clear a low threshold and dominate their lateral triple -- chains grow
    from anchors along lines only, so texture/noise pixels above threshold
    but off any chain stay dark (ED's key difference from thresholded NMS).
    """
    h, w = mag.shape
    # level-line direction = perpendicular to gradient
    ax, ay = jnp.abs(gx), jnp.abs(gy)
    # quantized as in _thin_edges: 4 directions
    diag = (ax > 0.4142 * ay) & (ay > 0.4142 * ax)
    same_sign = (gx * gy) > 0
    horiz_g = (ax >= ay) & ~diag       # gradient mostly x -> line vertical
    vert_g = (ay > ax) & ~diag

    p = jnp.pad(mag, 1)
    c = p[1:-1, 1:-1]
    n = {
        "e": p[1:-1, 2:], "w": p[1:-1, :-2],
        "s": p[2:, 1:-1], "n": p[:-2, 1:-1],
        "se": p[2:, 2:], "nw": p[:-2, :-2],
        "ne": p[:-2, 2:], "sw": p[2:, :-2],
    }
    # lateral dominance (same NMS predicate as the LSD path)
    dominant = jnp.where(
        horiz_g, (c >= n["e"]) & (c >= n["w"]),
        jnp.where(
            vert_g, (c >= n["s"]) & (c >= n["n"]),
            jnp.where(
                same_sign,
                (c >= n["se"]) & (c >= n["nw"]),
                (c >= n["ne"]) & (c >= n["sw"]),
            ),
        ),
    )
    grow_ok = dominant & (mag > 0.5 * threshold)
    # anchors: dominant WITH margin over laterals, high threshold (ED's
    # anchor test: peak exceeds neighbours by ANCHOR_TH)
    margin = 2.0
    anchor = jnp.where(
        horiz_g, (c >= n["e"] + margin) & (c >= n["w"] + margin),
        jnp.where(
            vert_g, (c >= n["s"] + margin) & (c >= n["n"] + margin),
            jnp.where(
                same_sign,
                (c >= n["se"] + margin) & (c >= n["nw"] + margin),
                (c >= n["ne"] + margin) & (c >= n["sw"] + margin),
            ),
        ),
    ) & (mag > threshold)

    # propagation along the level line: the two along-line neighbour
    # offsets per direction class (dy, dx) and their diagonal tolerance
    def shift(m, dy, dx):
        return jnp.roll(m, (dy, dx), axis=(0, 1))

    def step(lit, _):
        # a pixel joins if it can grow and any along-line neighbour
        # (w.r.t. ITS OWN direction class, +-1 lateral slack) is lit
        reach_h = (
            shift(lit, -1, 0) | shift(lit, 1, 0)
            | shift(lit, -1, 1) | shift(lit, 1, 1)
            | shift(lit, -1, -1) | shift(lit, 1, -1)
        )          # line vertical -> neighbours above/below
        reach_v = (
            shift(lit, 0, -1) | shift(lit, 0, 1)
            | shift(lit, 1, -1) | shift(lit, 1, 1)
            | shift(lit, -1, -1) | shift(lit, -1, 1)
        )
        reach_d1 = (
            shift(lit, -1, 1) | shift(lit, 1, -1)
            | shift(lit, -1, 0) | shift(lit, 1, 0)
            | shift(lit, 0, 1) | shift(lit, 0, -1)
        )          # line along ne-sw
        reach_d2 = (
            shift(lit, -1, -1) | shift(lit, 1, 1)
            | shift(lit, -1, 0) | shift(lit, 1, 0)
            | shift(lit, 0, 1) | shift(lit, 0, -1)
        )
        reach = jnp.where(
            horiz_g, reach_h,
            jnp.where(
                vert_g, reach_v,
                jnp.where(same_sign, reach_d1, reach_d2),
            ),
        )
        return lit | (grow_ok & reach), None

    lit, _ = jax.lax.scan(step, anchor, None, length=steps)
    return lit


def _refine_endpoints(seg, ok, edge, mag, steps: int):
    """Extend each segment's endpoints outward along its direction while
    the thinned edge map keeps support within +-1 px laterally (sub-pixel
    endpoint refinement / gap closing; the reference's LSD emits exact
    region extents, our tile fit truncates at tile borders)."""
    if steps <= 0:
        return seg
    h, w = edge.shape
    em = (edge & (mag > 0)).astype(jnp.float32)
    d = seg[..., 2:] - seg[..., :2]
    ln = jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
    u = d / ln                                    # (..., 2) unit dir
    nrm = jnp.stack([-u[..., 1], u[..., 0]], -1)  # lateral unit

    def sample(pts):
        # bilinear-free: nearest lookup with clamping; support = max over
        # lateral offsets {-1, 0, 1}
        def look(q):
            x = jnp.clip(jnp.round(q[..., 0]).astype(jnp.int32), 0, w - 1)
            y = jnp.clip(jnp.round(q[..., 1]).astype(jnp.int32), 0, h - 1)
            inb = (
                (q[..., 0] >= 0) & (q[..., 0] <= w - 1)
                & (q[..., 1] >= 0) & (q[..., 1] <= h - 1)
            )
            return em[y, x] * inb
        s = look(pts)
        s = jnp.maximum(s, look(pts + nrm[..., None, :]))
        s = jnp.maximum(s, look(pts - nrm[..., None, :]))
        return s

    ts = jnp.arange(1, steps + 1, dtype=jnp.float32)

    def extend(base, direction):
        pts = base[..., None, :] + direction[..., None, :] * ts[:, None]
        sup = sample(pts)                          # (..., steps)
        # contiguous support run (allow one-pixel holes: relaxed cumprod)
        run = jnp.cumprod(jnp.minimum(sup + jnp.roll(sup, -1, -1), 1.0),
                          axis=-1)
        ext = jnp.sum(run, -1)
        return base + direction * ext[..., None]

    new_e = extend(seg[..., 2:], u)
    new_s = extend(seg[..., :2], -u)
    refined = jnp.concatenate([new_s, new_e], -1)
    return jnp.where(ok[..., None], refined, seg)


def _nfa_gate(uv4: jnp.ndarray, valid: jnp.ndarray,
              gx: jnp.ndarray, gy: jnp.ndarray,
              cfg: LineDetectConfig) -> jnp.ndarray:
    """Vectorized a-contrario segment validation.

    For each candidate segment, gather level-line angles at
    ``nfa_samples`` positions along the segment for 3 lateral offset rows
    (the detected center may sit +-1 px off the true edge crest) and
    count samples whose edge direction aligns with the segment direction
    within ``nfa_ang_tol_deg`` (and whose gradient clears the detection
    threshold -- LSD's NOTDEF pixels count as unaligned).  LSD scores
    the full fitted rectangle width; here every SUBSET of the 3 offset
    rows (7 hypotheses -- a 2-px stroke has two aligned gradient crests
    and a flat interior, a 1-px edge one crest) is scored with the EXACT
    binomial tail  B(n, k, p0) = I_p0(k, n-k+1)  (regularized incomplete
    beta, the same quantity LSD's nfa() computes) and the best must
    satisfy  -log10 B - logNT - log10(7) > log_eps  (the hypothesis
    count folded into the number-of-tests the a-contrario way).  Short
    segments resample the same pixels; counts are rescaled by
    min(1, length/S) so the evidence stays per-pixel."""
    from jax.scipy.special import betainc

    h, w = gx.shape
    S = cfg.nfa_samples
    p0 = cfg.nfa_ang_tol_deg / 180.0
    prec = jnp.float32(np.pi * p0)
    logNT = (2.5 * np.log10(float(h) * float(w)) + np.log10(11.0)
             + np.log10(7.0))

    s, e = uv4[:, :2], uv4[:, 2:]
    d = e - s
    length = jnp.linalg.norm(d, axis=-1)
    u = d / jnp.maximum(length, 1e-6)[:, None]           # (N, 2)
    nrm = jnp.stack([-u[:, 1], u[:, 0]], axis=-1)        # unit normal
    t = jnp.linspace(0.0, 1.0, S, dtype=jnp.float32)     # (S,)
    base = s[:, None, :] + t[None, :, None] * d[:, None, :]   # (N, S, 2)
    offs = jnp.asarray([-1.0, 0.0, 1.0], jnp.float32)
    pts = base[:, :, None, :] + offs[None, None, :, None] * nrm[:, None, None, :]
    px = jnp.floor(pts[..., 0]).astype(jnp.int32)
    py = jnp.floor(pts[..., 1]).astype(jnp.int32)
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pxc = jnp.clip(px, 0, w - 1)
    pyc = jnp.clip(py, 0, h - 1)
    gxs = gx[pyc, pxc]
    gys = gy[pyc, pxc]
    mag_ok = (gxs * gxs + gys * gys) > cfg.grad_threshold ** 2
    # edge (level-line) direction is perpendicular to the gradient; the
    # segment aligns when |angle(edge) - angle(seg)| mod pi <= prec,
    # equivalently |gradient . segdir| <= |g| sin(prec)
    gdot = gxs * u[:, None, None, 0] + gys * u[:, None, None, 1]
    gmag = jnp.sqrt(gxs * gxs + gys * gys)
    aligned = inb & mag_ok & (
        jnp.abs(gdot) <= gmag * jnp.sin(prec) + 1e-6
    )
    scale = jnp.minimum(1.0, length / float(S))[:, None]
    n_row = jnp.sum(inb, axis=1) * scale                 # (N, 3) per row
    k_row = jnp.sum(aligned, axis=1) * scale             # (N, 3)
    # 7 row subsets as 0/1 combination masks
    combos = jnp.asarray(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1],
         [1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1]], jnp.float32
    )                                                    # (7, 3)
    n = n_row @ combos.T                                 # (N, 7)
    k = k_row @ combos.T
    q = k / jnp.maximum(n, 1.0)
    # exact tail; betainc needs a,b > 0 -- combos with k==0 are never
    # significant, mask them instead
    a = jnp.maximum(k, 0.5)
    b = jnp.maximum(n - k, 0.0) + 1.0
    tail = jnp.clip(betainc(a, b, p0), 1e-30, 1.0)
    sig = -jnp.log10(tail) - logNT
    sig = jnp.where((k > 0) & (q > p0), sig, -jnp.inf)
    best = jnp.max(sig, axis=-1)
    return valid & (best > cfg.nfa_log_eps)


def _detect_octave(img: jnp.ndarray, cfg: LineDetectConfig) -> Segments:
    """Single-octave detection on ``img``'s own pixel grid."""
    gx, gy = _sobel(img)
    mag = jnp.sqrt(gx * gx + gy * gy)
    if cfg.mode == 1:
        edge = _ed_edges(mag, gx, gy, cfg.grad_threshold)
    else:
        edge = _thin_edges(mag, gx, gy, cfg.grad_threshold)
    seg, ok = _tile_fit(edge, mag, cfg.tile, cfg.min_support,
                        cfg.min_anisotropy, gx=gx, gy=gy)
    seg = _refine_endpoints(seg, ok, edge, mag, cfg.refine_steps)

    # merge rounds over 4 neighbour directions (right, down, down-right,
    # down-left).  Round r looks at stride 2^r (parallel-reduction style:
    # surviving merged segments live in the 'left' tile, so chains double
    # in reach each round).  Consumed neighbours are invalidated.
    gh, gw = ok.shape
    for rnd in range(cfg.merge_rounds):
        stride = 1 << rnd
        for (dy0, dx0) in ((0, 1), (1, 0), (1, 1), (1, -1)):
            dy, dx = dy0 * stride, dx0 * stride
            if abs(dy) >= gh or abs(dx) >= gw:
                continue
            nbr = jnp.roll(seg, (-dy, -dx), axis=(0, 1))
            nbr_ok = jnp.roll(ok, (-dy, -dx), axis=(0, 1))
            # edge tiles must not wrap
            row_ok = (
                jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 0) < gh - dy
            )
            if dx >= 0:
                col_ok = (
                    jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 1) < gw - dx
                )
            else:
                col_ok = (
                    jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 1) >= -dx
                )
            nbr_ok = nbr_ok & row_ok & col_ok
            # parity-disjoint absorbers: a tile may absorb its neighbour
            # only on the even slot of this round's stride, so nothing is
            # simultaneously absorbed and extended (parallel reduction)
            if dx0 != 0:
                idx = jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 1)
            else:
                idx = jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 0)
            allow = ((idx // stride) % 2) == 0
            seg, did = _merge_pairs(seg, ok, nbr, nbr_ok, cfg, allow)
            # invalidate consumed neighbours
            consumed = jnp.roll(did, (dy, dx), axis=(0, 1))
            shifted_back_ok = (
                jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 0) >= dy
            )
            if dx >= 0:
                shifted_back_ok &= (
                    jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 1) >= dx
                )
            else:
                shifted_back_ok &= (
                    jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 1) < gw + dx
                )
            ok = ok & ~(consumed & shifted_back_ok)

    flat = seg.reshape(-1, 4)
    length = jnp.linalg.norm(flat[:, 2:] - flat[:, :2], axis=-1)
    valid = ok.reshape(-1) & (length >= 0.5 * cfg.min_length)
    if cfg.nfa_gate:
        valid = _nfa_gate(flat, valid, gx, gy, cfg)
    # keep the longest max_lines
    score = jnp.where(valid, length, -1.0)
    top = jax.lax.top_k(score, min(cfg.max_lines, score.shape[0]))[1]
    return Segments(
        uv4=flat[top], length=length[top],
        valid=valid[top],
    )


def _merge_all(uv4: jnp.ndarray, valid: jnp.ndarray,
               cfg: LineDetectConfig) -> Segments:
    """Global collinear merge ON DEVICE: all-pairs mergeability gates
    (angle / lateral offset / endpoint gap -- same thresholds as the tile
    rounds), connected components by min-label propagation with pointer
    jumping, then one length-weighted orthogonal regression per component
    via segment reductions.  Replaces the host merge on the per-frame
    path: its output rides the same async device->host copy as the rest
    of the detector, so the host pays nothing."""
    n = uv4.shape[0]
    d = uv4[:, 2:] - uv4[:, :2]
    ln = jnp.linalg.norm(d, axis=-1) + 1e-9
    u = d / ln[:, None]
    nrm = jnp.stack([-u[:, 1], u[:, 0]], 1)
    mid = 0.5 * (uv4[:, :2] + uv4[:, 2:])

    cosang = jnp.abs(jnp.matmul(u, u.T, precision=_HI))
    lat = jnp.abs(
        jnp.matmul(nrm, mid.T, precision=_HI)
        - jnp.sum(nrm * uv4[:, :2], -1)[:, None]
    )
    si = jnp.sum(uv4[:, :2] * u, -1)[:, None]
    t0 = jnp.matmul(u, uv4[:, :2].T, precision=_HI) - si
    t1 = jnp.matmul(u, uv4[:, 2:].T, precision=_HI) - si
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    gap = jnp.maximum(tlo - ln[:, None], -thi)
    vv = valid[:, None] & valid[None, :]
    can = (
        vv
        & (cosang > cfg.merge_angle_cos)
        & ((lat < cfg.merge_lateral) | (lat.T < cfg.merge_lateral))
        & (gap < cfg.merge_gap)
    )
    can = can | can.T
    can = can | jnp.eye(n, dtype=bool)

    def body(lab, _):
        nxt = jnp.min(jnp.where(can, lab[None, :], n), axis=1)
        nxt = jnp.minimum(lab, nxt)
        nxt = jnp.minimum(nxt, nxt[nxt])        # pointer jumping
        return nxt, None

    lab, _ = jax.lax.scan(body, jnp.arange(n), None, length=10)

    # per-component length-weighted orthogonal regression, keyed by root
    pts = jnp.concatenate([uv4[:, :2], uv4[:, 2:]], 0)          # (2n, 2)
    w1 = jnp.where(valid, ln, 0.0)
    wts = jnp.concatenate([w1, w1])
    root = jnp.concatenate([lab, lab])
    wsum = jnp.maximum(jax.ops.segment_sum(wts, root, n), 1e-9)
    cx = jax.ops.segment_sum(wts * pts[:, 0], root, n) / wsum
    cy = jax.ops.segment_sum(wts * pts[:, 1], root, n) / wsum
    dx = pts[:, 0] - cx[root]
    dy = pts[:, 1] - cy[root]
    cxx = jax.ops.segment_sum(wts * dx * dx, root, n)
    cyy = jax.ops.segment_sum(wts * dy * dy, root, n)
    cxy = jax.ops.segment_sum(wts * dx * dy, root, n)
    theta = 0.5 * jnp.arctan2(2 * cxy, cxx - cyy)
    ux, uy = jnp.cos(theta), jnp.sin(theta)
    t = dx * ux[root] + dy * uy[root]
    tmin = jax.ops.segment_min(jnp.where(wts > 0, t, jnp.inf), root, n)
    tmax = jax.ops.segment_max(jnp.where(wts > 0, t, -jnp.inf), root, n)
    out = jnp.stack([
        cx + tmin * ux, cy + tmin * uy,
        cx + tmax * ux, cy + tmax * uy,
    ], 1)
    out_len = jnp.where(jnp.isfinite(tmax - tmin), tmax - tmin, 0.0)
    is_root = lab == jnp.arange(n)
    out_valid = valid & is_root & (out_len >= cfg.min_length)
    out = jnp.where(out_valid[:, None], out, uv4)
    return Segments(uv4=out, length=out_len, valid=out_valid)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect_lines(img: jnp.ndarray,
                 cfg: LineDetectConfig = LineDetectConfig()) -> Segments:
    """Detect line segments over ``cfg.n_octaves`` pyramid levels; returns
    fixed-cap (n_octaves * max_lines, 4) + validity, coordinates on the
    full-resolution grid, globally collinear-merged on device.  Mirrors
    the reference's 2-octave Gaussian pyramid detection
    (/root/reference/src/Lineextractor.cc:84-96); cross-octave duplicates
    collapse in the final device merge, like BinaryDescriptor's octave
    fusion."""
    img = img.astype(jnp.float32)
    outs = []
    for o in range(max(1, cfg.n_octaves)):
        if o > 0:
            img = _downsample2(img)
        # shorter structures need fewer support pixels at coarse octaves;
        # min_length is a full-resolution quantity
        ocfg = cfg._replace(
            min_length=cfg.min_length / (2.0 ** o),
            min_support=max(4, cfg.min_support // (1 + o)),
        )
        s = _detect_octave(img, ocfg)
        scale = jnp.float32(2.0 ** o)
        outs.append(Segments(
            uv4=s.uv4 * scale, length=s.length * scale, valid=s.valid,
        ))
    cat = Segments(
        uv4=jnp.concatenate([s.uv4 for s in outs], 0),
        length=jnp.concatenate([s.length for s in outs], 0),
        valid=jnp.concatenate([s.valid for s in outs], 0),
    )
    merged = _merge_all(cat.uv4, cat.valid, cfg)
    if cfg.n_features > 0:
        # lsd_nfeatures cap: keep exactly the n_features longest valid
        # detections (the reference truncates the response-sorted list;
        # top_k's index tie-break truncates ties rather than keeping all)
        ln = jnp.where(merged.valid, merged.length, -1.0)
        n_keep = min(int(cfg.n_features), int(ln.shape[0]))
        _, top_idx = jax.lax.top_k(ln, n_keep)
        keep = jnp.zeros(ln.shape[0], bool).at[top_idx].set(True)
        merged = merged._replace(valid=keep & merged.valid)
    return merged


def merge_components_np(uv4, valid,
                        cfg: LineDetectConfig = LineDetectConfig()):
    """Final collinear merge on host: one vectorized all-pairs mergeability
    test (angle / lateral offset / endpoint gap, the same gates as the
    device rounds), connected components over that graph (union-find), and
    per component the extreme endpoint projections onto the longest
    member's direction.  O(K^2) in vectorized numpy (K <= max_lines), a
    few ms -- the previous greedy per-segment loop was Python-quadratic and
    sat on the post-sync critical path of every frame.

    Returns the merged (L, 4) float32 detections (length-filtered).
    """
    import numpy as np

    segs = np.asarray(uv4)[np.asarray(valid)].astype(np.float32)
    k = len(segs)
    if k == 0:
        return segs.astype(np.float32).reshape(0, 4)
    d = segs[:, 2:] - segs[:, :2]
    ln = np.linalg.norm(d, axis=1) + 1e-9
    u = (d / ln[:, None]).astype(np.float32)
    nrm = np.stack([-u[:, 1], u[:, 0]], axis=1)
    mid = 0.5 * (segs[:, :2] + segs[:, 2:])

    # all-pairs gates as rank-2 BLAS products (no (k,k,2) intermediates:
    # at K ~ 800 those float64 tensors cost tens of ms on the frame path)
    cosang = np.abs(u @ u.T)
    # lateral offset of j's midpoint from i's infinite line:
    # lat[i,j] = |mid_j.n_i - s_i.n_i|
    lat = np.abs((nrm @ mid.T) - np.einsum("ik,ik->i", nrm, segs[:, :2])[:, None])
    # endpoint projections of j's endpoints on i's direction, rooted at s_i
    si_ui = np.einsum("ik,ik->i", segs[:, :2], u)[:, None]
    t0 = (u @ segs[:, :2].T) - si_ui
    t1 = (u @ segs[:, 2:].T) - si_ui
    tlo = np.minimum(t0, t1)
    thi = np.maximum(t0, t1)
    gap = np.maximum(tlo - ln[:, None], -thi)
    can = (
        (cosang > cfg.merge_angle_cos)
        & ((lat < cfg.merge_lateral) | (lat.T < cfg.merge_lateral))
        & (gap < cfg.merge_gap)
    )
    can = can | can.T
    np.fill_diagonal(can, True)

    # connected components by min-label propagation with pointer jumping
    # (fully vectorized; the old per-pair union-find python loop cost
    # 30-50 ms/frame on the critical path at K ~ 800)
    lab = np.arange(k)
    for _ in range(32):
        nxt = np.minimum(lab, np.where(can, lab[None, :], k).min(1))
        nxt = np.minimum(nxt, nxt[nxt])        # pointer jumping
        if np.array_equal(nxt, lab):
            break
        lab = nxt
    _, comp = np.unique(lab, return_inverse=True)
    nc = comp.max() + 1

    # length-weighted orthogonal regression PER COMPONENT over member
    # endpoints (the component's direction comes from ALL fragments, not
    # the longest one, whose tile-fit angle error would skew long merged
    # segments) -- all reductions via bincount
    pts = np.concatenate([segs[:, :2], segs[:, 2:]], axis=0)   # (2k, 2)
    wts = np.concatenate([ln, ln])
    root = np.concatenate([comp, comp])
    wsum = np.bincount(root, wts, minlength=nc)
    cx = np.bincount(root, wts * pts[:, 0], minlength=nc) / wsum
    cy = np.bincount(root, wts * pts[:, 1], minlength=nc) / wsum
    dx = pts[:, 0] - cx[root]
    dy = pts[:, 1] - cy[root]
    cxx = np.bincount(root, wts * dx * dx, minlength=nc)
    cyy = np.bincount(root, wts * dy * dy, minlength=nc)
    cxy = np.bincount(root, wts * dx * dy, minlength=nc)
    theta = 0.5 * np.arctan2(2 * cxy, cxx - cyy)
    ux, uy = np.cos(theta), np.sin(theta)
    t = dx * ux[root] + dy * uy[root]
    tmin = np.full(nc, np.inf)
    tmax = np.full(nc, -np.inf)
    np.minimum.at(tmin, root, t)
    np.maximum.at(tmax, root, t)
    out = np.stack([
        cx + tmin * ux, cy + tmin * uy,
        cx + tmax * ux, cy + tmax * uy,
    ], axis=1).astype(np.float32)
    length = np.linalg.norm(out[:, 2:] - out[:, :2], axis=1)
    return out[length >= cfg.min_length]


def detect_lines_np(img, cfg: LineDetectConfig = LineDetectConfig()):
    """Device detection (incl. the on-device global merge) -> numpy (L, 4)
    detections, the form consumed by Tracking.grab_rgbd."""
    import numpy as np

    segs = detect_lines(img, cfg)
    uv4 = np.asarray(segs.uv4)
    valid = np.asarray(segs.valid)
    return uv4[valid].astype(np.float32).reshape(-1, 4)

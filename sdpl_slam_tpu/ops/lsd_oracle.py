"""Faithful host-side LSD oracle (von Gioi et al., IPOL 2012).

The reference's line front-end is OpenCV's ``createLineSegmentDetector``
run per pyramid octave
(/root/reference/3rdparty/line_descriptor/src/LSDDetector_custom.cpp:291-309
with the options set in /root/reference/src/Lineextractor.cc:54-70:
refine=LSD_REFINE_ADV, scale=0.8, sigma_scale=0.6, quant=2.0,
ang_th=22.5, log_eps=0.0, density_th=0.8, n_bins=1024,
min_length=0.02*min(w,h)).  OpenCV's implementation is the von Gioi
IPOL LSD algorithm: level-line field -> greedy region growing ->
rectangle approximation -> density refinement -> NFA (number of false
alarms) validation with rectangle improvement.

This module is a from-scratch numpy implementation of that ALGORITHM
(from its published description), deliberately slow and scalar -- it is
the fidelity ORACLE for the production tiled-PCA detector
(ops/lines.py), giving the a-contrario false-detection control the
production path approximates.  tests/test_lsd_oracle.py measures the
production detector's recall/precision/endpoint error against it.

Not a copy of OpenCV/IPOL code; written from the algorithm spec:
R. Grompone von Gioi, J. Jakubowicz, J.-M. Morel, G. Randall,
"LSD: a Line Segment Detector", Image Processing On Line, 2012.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

NOTDEF = -1024.0


class LSDParams(NamedTuple):
    """OpenCV createLineSegmentDetector parameters with the reference's
    values (Lineextractor.cc:54-70)."""

    refine: int = 2          # LSD_REFINE_ADV
    scale: float = 0.8
    sigma_scale: float = 0.6
    quant: float = 2.0
    ang_th: float = 22.5
    log_eps: float = 0.0
    density_th: float = 0.8
    n_bins: int = 1024


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with reflect-101 borders."""
    radius = max(1, int(math.ceil(sigma * 3.0)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img.astype(np.float64), radius, mode="reflect")
    tmp = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, pad)
    out = np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, tmp)
    return out


def _resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    h, w = img.shape
    ys = (np.arange(new_h) + 0.5) * (h / new_h) - 0.5
    xs = (np.arange(new_w) + 0.5) * (w / new_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def _ll_angle(img: np.ndarray, threshold: float):
    """Level-line field: 2x2 gradient, angle orthogonal to the gradient.

    gx = (I(x+1,y)-I(x,y) + I(x+1,y+1)-I(x,y+1)) / 2
    gy = (I(x,y+1)-I(x,y) + I(x+1,y+1)-I(x+1,y)) / 2
    angle = atan2(gx, -gy); pixels with |g| <= threshold are NOTDEF."""
    h, w = img.shape
    modgrad = np.zeros((h, w))
    angles = np.full((h, w), NOTDEF)
    I = img.astype(np.float64)
    com1 = I[1:, 1:] - I[:-1, :-1]       # D - A
    com2 = I[:-1, 1:] - I[1:, :-1]       # B - C
    gx = (com1 + com2) / 2.0
    gy = (com1 - com2) / 2.0
    norm = np.sqrt(gx * gx + gy * gy)
    modgrad[:-1, :-1] = norm
    ang = np.arctan2(gx, -gy)
    defined = norm > threshold
    angles[:-1, :-1] = np.where(defined, ang, NOTDEF)
    return angles, modgrad


def _angle_diff(a: float, b: float) -> float:
    d = a - b
    while d <= -math.pi:
        d += 2 * math.pi
    while d > math.pi:
        d -= 2 * math.pi
    return abs(d)


def _is_aligned(ang: float, theta: float, prec: float) -> bool:
    """Level-line angle vs rectangle direction, mod pi (IPOL isaligned)."""
    if ang == NOTDEF:
        return False
    t = theta - ang
    if t < 0.0:
        t = -t
    if t > 1.5 * math.pi:
        t -= 2 * math.pi
        if t < 0.0:
            t = -t
    return t <= prec


def _log10_binom_tail(n: int, k: int, p: float) -> float:
    """log10 of the binomial tail  sum_{i=k..n} C(n,i) p^i (1-p)^(n-i)."""
    if k <= 0:
        return 0.0
    if k > n:
        return -np.inf
    lg = math.lgamma
    lp = math.log(p)
    l1p = math.log1p(-p)
    terms = []
    for i in range(k, n + 1):
        terms.append(
            lg(n + 1) - lg(i + 1) - lg(n - i + 1) + i * lp + (n - i) * l1p
        )
    m = max(terms)
    s = sum(math.exp(t - m) for t in terms)
    return (m + math.log(s)) / math.log(10.0)


class _Rect:
    __slots__ = ("x1", "y1", "x2", "y2", "width", "x", "y",
                 "theta", "dx", "dy", "prec", "p")

    def copy(self):
        r = _Rect()
        for s in self.__slots__:
            setattr(r, s, getattr(self, s))
        return r


class LSDOracle:
    """One-image LSD run (scaled internal image).  Use ``detect``."""

    def __init__(self, params: LSDParams = LSDParams()):
        self.P = params

    # -- region growing ------------------------------------------------
    def _region_grow(self, x0, y0, prec):
        angles, used = self.angles, self.used
        h, w = angles.shape
        reg = [(x0, y0)]
        used[y0, x0] = True
        reg_angle = angles[y0, x0]
        sumdx = math.cos(reg_angle)
        sumdy = math.sin(reg_angle)
        i = 0
        while i < len(reg):
            xx, yy = reg[i]
            i += 1
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    x, y = xx + dx, yy + dy
                    if x < 0 or y < 0 or x >= w or y >= h:
                        continue
                    if used[y, x]:
                        continue
                    a = angles[y, x]
                    if a == NOTDEF or _angle_diff(a, reg_angle) >= prec:
                        continue
                    used[y, x] = True
                    reg.append((x, y))
                    sumdx += math.cos(a)
                    sumdy += math.sin(a)
                    reg_angle = math.atan2(sumdy, sumdx)
        return reg, reg_angle

    # -- rectangle approximation ---------------------------------------
    def _get_theta(self, reg, x, y, reg_angle, prec):
        mg = self.modgrad
        Ixx = Iyy = Ixy = 0.0
        for (xi, yi) in reg:
            wgt = mg[yi, xi]
            Ixx += wgt * (yi - y) ** 2
            Iyy += wgt * (xi - x) ** 2
            Ixy -= wgt * (xi - x) * (yi - y)
        lam = 0.5 * (Ixx + Iyy - math.sqrt((Ixx - Iyy) ** 2 + 4 * Ixy ** 2))
        if abs(Ixx) > abs(Iyy):
            theta = math.atan2(lam - Ixx, Ixy)
        else:
            theta = math.atan2(Ixy, lam - Iyy)
        if _angle_diff(theta, reg_angle) > prec:
            theta += math.pi
        return theta

    def _region2rect(self, reg, reg_angle, prec, p):
        mg = self.modgrad
        sw = sx = sy = 0.0
        for (xi, yi) in reg:
            wgt = mg[yi, xi]
            sw += wgt
            sx += wgt * xi
            sy += wgt * yi
        x, y = sx / sw, sy / sw
        theta = self._get_theta(reg, x, y, reg_angle, prec)
        dx, dy = math.cos(theta), math.sin(theta)
        lmin = lmax = wmin = wmax = 0.0
        for (xi, yi) in reg:
            l = (xi - x) * dx + (yi - y) * dy
            ww = -(xi - x) * dy + (yi - y) * dx
            lmin, lmax = min(lmin, l), max(lmax, l)
            wmin, wmax = min(wmin, ww), max(wmax, ww)
        r = _Rect()
        r.x1, r.y1 = x + lmin * dx, y + lmin * dy
        r.x2, r.y2 = x + lmax * dx, y + lmax * dy
        r.width = max(wmax - wmin, 1.0)
        r.x, r.y, r.theta, r.dx, r.dy = x, y, theta, dx, dy
        r.prec, r.p = prec, p
        return r

    # -- NFA -----------------------------------------------------------
    def _rect_nfa(self, r: _Rect) -> float:
        """-log10(NFA) of the rectangle: count aligned points among the
        integer pixels inside it."""
        h, w = self.angles.shape
        cx, cy = (r.x1 + r.x2) / 2.0, (r.y1 + r.y2) / 2.0
        length = math.hypot(r.x2 - r.x1, r.y2 - r.y1)
        half_l = length / 2.0 + 1.0
        half_w = r.width / 2.0
        # bounding box
        rad = half_l + half_w + 2.0
        x_lo = max(0, int(math.floor(cx - rad)))
        x_hi = min(w - 1, int(math.ceil(cx + rad)))
        y_lo = max(0, int(math.floor(cy - rad)))
        y_hi = min(h - 1, int(math.ceil(cy + rad)))
        pt = alg = 0
        for yy in range(y_lo, y_hi + 1):
            for xx in range(x_lo, x_hi + 1):
                l = (xx - cx) * r.dx + (yy - cy) * r.dy
                ww = -(xx - cx) * r.dy + (yy - cy) * r.dx
                if abs(l) > half_l or abs(ww) > half_w:
                    continue
                pt += 1
                if _is_aligned(self.angles[yy, xx], r.theta, r.prec):
                    alg += 1
        return -self.logNT - _log10_binom_tail(pt, alg, r.p)

    def _rect_improve(self, r: _Rect) -> (float, _Rect):
        """IPOL rect_improve: finer precision, thinner width, trimmed
        sides; returns the best (log_nfa, rect)."""
        log_eps = self.P.log_eps
        best = self._rect_nfa(r)
        best_r = r
        if best > log_eps:
            return best, best_r
        # try finer precisions
        rr = r.copy()
        for _ in range(5):
            rr = rr.copy()
            rr.p /= 2.0
            rr.prec = rr.p * math.pi
            nfa = self._rect_nfa(rr)
            if nfa > best:
                best, best_r = nfa, rr
        if best > log_eps:
            return best, best_r
        # try to reduce width
        rr = best_r.copy()
        for _ in range(5):
            if rr.width - 0.5 >= 0.5:
                rr = rr.copy()
                rr.width -= 0.5
                nfa = self._rect_nfa(rr)
                if nfa > best:
                    best, best_r = nfa, rr
        if best > log_eps:
            return best, best_r
        # try to reduce one side
        rr = best_r.copy()
        for _ in range(5):
            if rr.width - 0.5 >= 0.5:
                rr = rr.copy()
                rr.x1 += -rr.dy * 0.25
                rr.y1 += rr.dx * 0.25
                rr.x2 += -rr.dy * 0.25
                rr.y2 += rr.dx * 0.25
                rr.width -= 0.5
                nfa = self._rect_nfa(rr)
                if nfa > best:
                    best, best_r = nfa, rr
        if best > log_eps:
            return best, best_r
        # the other side
        rr = best_r.copy()
        for _ in range(5):
            if rr.width - 0.5 >= 0.5:
                rr = rr.copy()
                rr.x1 -= -rr.dy * 0.25
                rr.y1 -= rr.dx * 0.25
                rr.x2 -= -rr.dy * 0.25
                rr.y2 -= rr.dx * 0.25
                rr.width -= 0.5
                nfa = self._rect_nfa(rr)
                if nfa > best:
                    best, best_r = nfa, rr
        if best > log_eps:
            return best, best_r
        # even finer precision
        rr = best_r.copy()
        for _ in range(5):
            rr = rr.copy()
            rr.p /= 2.0
            rr.prec = rr.p * math.pi
            nfa = self._rect_nfa(rr)
            if nfa > best:
                best, best_r = nfa, rr
        return best, best_r

    # -- density refinement (LSD_REFINE_STD part) ----------------------
    def _density(self, reg, r):
        length = math.hypot(r.x2 - r.x1, r.y2 - r.y1)
        return len(reg) / max(length * r.width, 1e-12)

    def _reduce_region_radius(self, reg, reg_angle, prec, p, r, xc, yc):
        density = self._density(reg, r)
        rad1 = math.hypot(xc - r.x1, yc - r.y1)
        rad2 = math.hypot(xc - r.x2, yc - r.y2)
        rad = max(rad1, rad2)
        while density < self.P.density_th:
            rad *= 0.75
            keep = []
            for (xi, yi) in reg:
                if (xi - xc) ** 2 + (yi - yc) ** 2 <= rad * rad:
                    keep.append((xi, yi))
                else:
                    self.used[yi, xi] = False
            reg = keep
            if len(reg) < 2:
                return None, None
            r = self._region2rect(reg, reg_angle, prec, p)
            density = self._density(reg, r)
        return reg, r

    def _refine(self, reg, reg_angle, prec, p, r, xc, yc):
        density = self._density(reg, r)
        if density >= self.P.density_th:
            return reg, r
        # re-estimate angle tolerance from points near the seed
        ang_c = self.angles[yc, xc]
        s = s2 = 0.0
        n = 0
        for (xi, yi) in reg:
            self.used[yi, xi] = False
            if math.hypot(xi - xc, yi - yc) < r.width:
                a = self.angles[yi, xi]
                d = a - ang_c
                while d <= -math.pi:
                    d += 2 * math.pi
                while d > math.pi:
                    d -= 2 * math.pi
                s += d
                s2 += d * d
                n += 1
        if n == 0:
            return None, None
        mean = s / n
        tau = 2.0 * math.sqrt(max(s2 / n - mean * mean, 0.0))
        reg, reg_angle = self._region_grow(xc, yc, tau)
        if len(reg) < 2:
            return None, None
        r = self._region2rect(reg, reg_angle, prec, p)
        if self._density(reg, r) < self.P.density_th:
            return self._reduce_region_radius(
                reg, reg_angle, prec, p, r, xc, yc
            )
        return reg, r

    # -- top level -----------------------------------------------------
    def detect(self, image: np.ndarray) -> np.ndarray:
        """Run LSD on a grayscale image.  Returns (N, 5) float array of
        [x1, y1, x2, y2, log_nfa] in INPUT-image coordinates."""
        P = self.P
        img = np.asarray(image, np.float64)
        if P.scale != 1.0:
            sigma = (P.sigma_scale / P.scale if P.scale < 1.0
                     else P.sigma_scale)
            blurred = _gaussian_blur(img, sigma)
            nh = max(4, int(round(img.shape[0] * P.scale)))
            nw = max(4, int(round(img.shape[1] * P.scale)))
            img = _resize_bilinear(blurred, nh, nw)
        h, w = img.shape

        prec = math.pi * P.ang_th / 180.0
        p = P.ang_th / 180.0
        rho = P.quant / math.sin(prec)

        self.angles, self.modgrad = _ll_angle(img, rho)
        self.used = np.zeros((h, w), bool)
        self.logNT = (5.0 * (math.log10(w) + math.log10(h)) / 2.0
                      + math.log10(11.0))
        min_reg_size = int(-self.logNT / math.log10(p))

        # pseudo-ordering by gradient magnitude (n_bins bins, descending)
        max_grad = self.modgrad.max()
        if max_grad <= 0:
            return np.zeros((0, 5), np.float32)
        bins = np.minimum(
            (self.modgrad * P.n_bins / max_grad).astype(int), P.n_bins - 1
        )
        order = np.argsort(-bins.ravel(), kind="stable")
        ys, xs = np.unravel_index(order, (h, w))

        out = []
        for x0, y0 in zip(xs, ys):
            if self.used[y0, x0] or self.angles[y0, x0] == NOTDEF:
                continue
            reg, reg_angle = self._region_grow(int(x0), int(y0), prec)
            if len(reg) < min_reg_size:
                continue
            r = self._region2rect(reg, reg_angle, prec, p)
            if P.refine >= 1:
                reg_r = self._refine(reg, reg_angle, prec, p, r,
                                     int(x0), int(y0))
                if reg_r[0] is None:
                    continue
                reg, r = reg_r
                if len(reg) < min_reg_size:
                    continue
            if P.refine >= 2:
                log_nfa, r = self._rect_improve(r)
            else:
                log_nfa = self._rect_nfa(r)
            if log_nfa <= P.log_eps:
                continue
            out.append([r.x1, r.y1, r.x2, r.y2, log_nfa])

        segs = np.asarray(out, np.float64).reshape(-1, 5)
        if P.scale != 1.0:
            segs[:, :4] /= P.scale
        return segs.astype(np.float32)


def detect_pyramid(image: np.ndarray, n_octaves: int = 2,
                   pyr_scale: float = 2.0,
                   params: LSDParams = LSDParams(),
                   min_length_frac: float = 0.02) -> np.ndarray:
    """The reference's per-octave LSD sweep
    (LSDDetector_custom.cpp:304-353): run LSD on each pyramid level
    (INTER_LINEAR downscale by ``pyr_scale``), drop segments whose
    IN-OCTAVE length is below ``min_length_frac*min(w,h)`` of the FULL
    image (the reference quirk at :325-326 -- the threshold is in full-
    image units but compared against octave-frame lengths), scale
    coordinates back up.  Returns (N, 6): [x1,y1,x2,y2,log_nfa,octave]."""
    img = np.asarray(image, np.float64)
    h, w = img.shape
    min_length = min_length_frac * min(w, h)
    oracle = LSDOracle(params)
    out = []
    level = img
    for oct_i in range(n_octaves):
        if oct_i > 0:
            nh = int(round(h / pyr_scale ** oct_i))
            nw = int(round(w / pyr_scale ** oct_i))
            level = _resize_bilinear(img, nh, nw)
        segs = oracle.detect(level)
        scale_up = pyr_scale ** oct_i
        for s in segs:
            length = math.hypot(s[0] - s[2], s[1] - s[3])
            if length > min_length:
                out.append([s[0] * scale_up, s[1] * scale_up,
                            s[2] * scale_up, s[3] * scale_up, s[4],
                            float(oct_i)])
    return np.asarray(out, np.float32).reshape(-1, 6)

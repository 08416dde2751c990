"""The OpenCV image operations the scale-bar reader needs, in numpy and
scipy, equal bit for bit to OpenCV 5.0's results on uint8 images.

The reader's Otsu threshold and glyph correlations follow from these
pixels, so a value one level off can flip a glyph. Each function models
OpenCV's own arithmetic, including which pixels go through its vector
code (float32 products rounded half to even) and which through its scalar
fixed-point code (rounded half up):

- ``bgr_to_gray``: 15-bit fixed-point BT.601 weights.
- ``otsu_threshold``: OpenCV's double-precision scan, keeping the first of
  equal maxima.
- ``resize_cubic_x2``: INTER_CUBIC at 2x. 11-bit horizontal weights; the
  vertical pass in float32 over groups of 8 output columns, the rest in
  fixed point, except that a source of at least 4 rows takes every column
  through the float32 pass.
- ``resize_area``: INTER_AREA to any size. Integer downscales average
  blocks (2x2 blocks round half up, others in float32), other downscales
  take OpenCV's float32 area tables, and an axis that grows takes the
  linear route with area-style weights and its 16-bit vector rounding.
- ``connected_components_with_stats``: 8-connected labels numbered as
  OpenCV's block scan numbers them (first 2x2 block of each component,
  blocks in row-major order).
- ``gaussian_blur3``: the 3x3 kernel for sigma 0, fixed point, border
  reflect-101.
- ``rotation_matrix2d`` and ``warp_affine_linear``: OpenCV's matrix and its
  float32 warp (fused multiply-adds, 16 output columns per vector, a
  scalar tail), zero border.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
from scipy import ndimage

F32 = np.float32
_COEF_BITS = 11
_COEF = 1 << _COEF_BITS  # OpenCV's INTER_RESIZE_COEF_SCALE


def bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)`` for uint8 BGR."""
    px = image.astype(np.int32)
    y = px[..., 0] * 3735 + px[..., 1] * 19235 + px[..., 2] * 9798
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


def otsu_threshold(gray: np.ndarray) -> Tuple[float, np.ndarray]:
    """``cv2.threshold(gray, 0, 255, THRESH_BINARY + THRESH_OTSU)``:
    (threshold, binary image with 255 above it)."""
    hist = np.bincount(gray.ravel(), minlength=256)
    scale = 1.0 / gray.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = max_sigma = 0.0
    max_val = 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, i
    thresh = float(max_val)
    return thresh, np.where(gray > thresh, 255, 0).astype(np.uint8)


# -- INTER_CUBIC at 2x --------------------------------------------------------


def _cubic_weights(x) -> list:
    x = F32(x)
    a, one = F32(-0.75), F32(1)
    c0 = ((a * (x + one) - F32(5) * a) * (x + one) + F32(8) * a) * (x + one) - F32(4) * a
    c1 = ((a + F32(2)) * x - (a + F32(3))) * x * x + one
    c2 = ((a + F32(2)) * (one - x) - (a + F32(3))) * (one - x) * (one - x) + one
    return [c0, c1, c2, one - c0 - c1 - c2]


@lru_cache(maxsize=256)
def _cubic_table(ssize: int, dsize: int, scale: float):
    """(source taps [dsize,4] clamped to the image, 11-bit weights [dsize,4])."""
    idx = np.empty((dsize, 4), np.int64)
    wts = np.empty((dsize, 4), np.int64)
    for d in range(dsize):
        f = F32((d + 0.5) * scale - 0.5)
        s = int(np.floor(f))
        for k, c in enumerate(_cubic_weights(F32(f - F32(s)))):
            idx[d, k] = min(max(s - 1 + k, 0), ssize - 1)
            wts[d, k] = int(np.rint(F32(c) * F32(_COEF)))
    return idx, wts


def resize_cubic_x2(image: np.ndarray) -> np.ndarray:
    """``cv2.resize(image, None, fx=2, fy=2, interpolation=INTER_CUBIC)``
    for a 2-D uint8 image."""
    h, w = image.shape
    big_h, big_w = 2 * h, 2 * w
    xi, xw = _cubic_table(w, big_w, 0.5)
    yi, yw = _cubic_table(h, big_h, 0.5)
    # |sums| stay below 2**31: 255 x 2336 (the positive weights) x 2336
    rows = (image.astype(np.int32)[:, xi] * xw[None].astype(np.int32)).sum(-1, dtype=np.int32)  # [h, 2w]
    taps = rows[yi]  # [2h, 4, 2w]
    exact = (taps * yw[:, :, None].astype(np.int32)).sum(1, dtype=np.int32)
    out = (exact + (1 << 21)) >> 22
    n_vec = (big_w // 8) * 8
    if n_vec and h >= 4:
        n_vec = big_w
    if n_vec:
        beta = (yw.astype(F32) * F32(1.0 / (_COEF * _COEF))).astype(F32)
        s = taps[:, :, :n_vec].astype(F32)
        acc = s[:, 3] * beta[:, 3, None]
        for k in (2, 1, 0):
            acc = s[:, k] * beta[:, k, None] + acc
        out[:, :n_vec] = np.rint(acc)
    return np.clip(out, 0, 255).astype(np.uint8)


# -- INTER_AREA -------------------------------------------------------------


@lru_cache(maxsize=4096)
def area_table(ssize: int, dsize: int, scale: float):
    """OpenCV's decimation table as (taps [dsize,K] source index, weights
    [dsize,K] float32, 0 past a row's own taps), each row's taps in OpenCV's
    order: the partial head cell, the whole cells, the partial tail cell."""
    fsx1 = np.arange(dsize) * scale
    fsx2 = fsx1 + scale
    cell = np.minimum(scale, ssize - fsx1)
    sx2 = np.minimum(np.floor(fsx2).astype(np.int64), ssize - 1)
    sx1 = np.minimum(np.ceil(fsx1).astype(np.int64), sx2)
    head = (sx1 - fsx1) > 1e-3
    tail = (fsx2 - sx2) > 1e-3
    whole = sx2 - sx1
    count = head + whole + tail
    j = np.arange(int(count.max()))[None, :]
    mid = j - head[:, None]
    idx = np.where(mid < whole[:, None], sx1[:, None] + mid, sx2[:, None])
    idx = np.where((j == 0) & head[:, None], sx1[:, None] - 1, idx)
    wts = np.where(mid < whole[:, None], (1.0 / cell).astype(F32)[:, None], F32(0))
    wts = np.where((j == 0) & head[:, None], ((sx1 - fsx1) / cell).astype(F32)[:, None], wts)
    tail_w = (np.minimum(np.minimum(fsx2 - sx2, 1.0), cell) / cell).astype(F32)
    wts = np.where((mid == whole[:, None]) & tail[:, None], tail_w[:, None], wts)
    live = j < count[:, None]
    return np.where(live, idx, 0), np.where(live, wts, F32(0)).astype(F32)


def _accumulate(values: np.ndarray, idx, wts, axis_first: bool) -> np.ndarray:
    """Sum of ``values`` taps times weights along the last axis (or the
    first when ``axis_first``) in tap order, float32, as OpenCV adds them."""
    acc = None
    for j in range(idx.shape[1]):
        # a row past its own taps has weight 0 there: adding 0 is exact
        term = values[idx[:, j]] * wts[:, j, None] if axis_first else values[:, idx[:, j]] * wts[None, :, j]
        acc = term if acc is None else acc + term
    return acc


@lru_cache(maxsize=4096)
def _linear_area_table(ssize: int, dsize: int, scale: float, inv_scale: float):
    """Taps [dsize,2], 11-bit weights [dsize,2] and the border mask of
    OpenCV's linear route for INTER_AREA on a growing axis."""
    d = np.arange(dsize)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv_scale).astype(F32)
    f = np.where(f <= 0, F32(0), (f - np.floor(f).astype(F32)).astype(F32))
    at_end = s + 1 >= ssize
    past = at_end & (s >= ssize - 1)
    f = np.where(past, F32(0), f).astype(F32)
    s = np.where(past, ssize - 1, s)
    border = np.zeros(dsize, bool)
    if at_end.any():
        border[int(np.argmax(at_end)) :] = True
    idx = np.stack([s, np.minimum(s + 1, ssize - 1)], 1)
    wts = np.stack([np.rint((F32(1) - f) * F32(_COEF)), np.rint(f * F32(_COEF))], 1).astype(np.int64)
    return idx, wts, border


def resize_area(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=INTER_AREA)`` for
    a 2-D uint8 image, growing or shrinking each axis."""
    h, w = image.shape
    if (h, w) == (height, width):
        return image.copy()
    inv_x, inv_y = width / w, height / h
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if sx >= 1 and sy >= 1:
        ix, iy = int(np.rint(sx)), int(np.rint(sy))
        eps = float(np.finfo(float).eps)
        if abs(sx - ix) < eps and abs(sy - iy) < eps:
            blocks = image[: height * iy, : width * ix].astype(np.int64)
            blocks = blocks.reshape(height, iy, width, ix).sum((1, 3))
            if ix == 2 and iy == 2:
                return ((blocks + 2) >> 2).astype(np.uint8)
            out = np.rint(blocks.astype(F32) * F32(1.0 / (ix * iy)))
            return np.clip(out, 0, 255).astype(np.uint8)
        xt, yt = area_table(w, width, sx), area_table(h, height, sy)
        rows = _accumulate(image.astype(F32), *xt, axis_first=False)  # [h, width]
        out = _accumulate(rows, *yt, axis_first=True)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    xi, xw, xb = _linear_area_table(w, width, sx, inv_x)
    yi, yw, _ = _linear_area_table(h, height, sy, inv_y)
    src = image.astype(np.int64)
    rows = src[:, xi[:, 0]] * xw[:, 0] + src[:, xi[:, 1]] * xw[:, 1]
    rows[:, xb] = src[:, xi[xb, 0]] * _COEF
    s0, s1 = rows[yi[:, 0]] >> 4, rows[yi[:, 1]] >> 4
    t = ((s0 * yw[:, 0, None]) >> 16) + ((s1 * yw[:, 1, None]) >> 16)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)


# -- connected components, blur, rotation -----------------------------------------


def connected_components_with_stats(binary: np.ndarray) -> Tuple[int, np.ndarray]:
    """(label count, stats [n,5] int32 of x, y, width, height, area) of
    ``cv2.connectedComponentsWithStats(binary, 8)``, labels in OpenCV's
    order; label 0 is the background."""
    fg = binary != 0
    h, w = fg.shape
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    stats = np.zeros((n + 1, 5), np.int32)
    rr, cc = np.nonzero(~fg)
    if rr.size:
        stats[0] = (cc.min(), rr.min(), cc.max() - cc.min() + 1, rr.max() - rr.min() + 1, rr.size)
    else:
        stats[0] = (-1, np.iinfo(np.int32).max, 0, 0, 0)
    if n == 0:
        return 1, stats
    rr, cc = np.nonzero(fg)
    lbl = lab[rr, cc]
    big = np.iinfo(np.int64).max
    first = np.full(n + 1, big, np.int64)
    np.minimum.at(first, lbl, (rr // 2) * ((w + 1) // 2) + cc // 2)
    x0, y0 = np.full(n + 1, w, np.int64), np.full(n + 1, h, np.int64)
    x1, y1 = np.full(n + 1, -1, np.int64), np.full(n + 1, -1, np.int64)
    np.minimum.at(x0, lbl, cc)
    np.maximum.at(x1, lbl, cc)
    np.minimum.at(y0, lbl, rr)
    np.maximum.at(y1, lbl, rr)
    area = np.bincount(lbl, minlength=n + 1)
    order = np.argsort(first[1:], kind="stable") + 1
    stats[1:] = np.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1, area], 1)[order]
    return n + 1, stats


def gaussian_blur3(image: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(image, (3, 3), 0)`` for a 2-D uint8 image."""
    p = np.pad(image.astype(np.int32), 1, mode="reflect")
    rows = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
    return ((rows[:-2] + 2 * rows[1:-1] + rows[2:] + 8) >> 4).astype(np.uint8)


def rotation_matrix2d(center, angle_deg: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` (the centre is single precision there)."""
    cx, cy = float(F32(center[0])), float(F32(center[1]))
    a = angle_deg * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array(
        [[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]],
        np.float64,
    )


def _fma(a, b, c) -> np.ndarray:
    """Single-rounding float32 a*b + c: the float64 product is exact and the
    sum's one tie case is settled by its exact error (TwoSum)."""
    a = np.asarray(a, F32).astype(np.float64)
    b = np.asarray(b, F32).astype(np.float64)
    c = np.asarray(c, F32).astype(np.float64)
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.astype(F32)
    above = r.astype(np.float64) > s
    lo = np.where(above, np.nextafter(r, F32(-np.inf)), r)
    hi = np.where(above, r, np.nextafter(r, F32(np.inf)))
    tie = s == (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    return np.where(tie & (err > 0), hi, np.where(tie & (err < 0), lo, r)).astype(F32)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    m = m.astype(np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine_linear(image: np.ndarray, m: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(image, m, size, flags=INTER_LINEAR)`` (zero border)
    for a 2-D uint8 image; ``size`` is (width, height)."""
    width, height = size
    mi = _invert_affine(m).astype(F32)
    xs = np.broadcast_to(np.arange(width, dtype=F32)[None, :], (height, width))
    ys = np.broadcast_to(np.arange(height, dtype=F32)[:, None], (height, width))
    n_vec = (width // 16) * 16
    v, t = np.s_[:, :n_vec], np.s_[:, n_vec:]
    sx = np.empty((height, width), F32)
    sy = np.empty((height, width), F32)
    sx[v] = _fma(xs[v], mi[0], (ys[v] * mi[1]).astype(F32) + mi[2])
    sy[v] = _fma(xs[v], mi[3], (ys[v] * mi[4]).astype(F32) + mi[5])
    sx[t] = _fma(xs[t], mi[0], (ys[t] * mi[1]).astype(F32)) + mi[2]
    sy[t] = _fma(xs[t], mi[3], (ys[t] * mi[4]).astype(F32)) + mi[5]
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - ix.astype(F32)).astype(F32), (sy - iy.astype(F32)).astype(F32)
    h, w = image.shape
    src = image.astype(F32)

    def pixel(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], F32(0)).astype(F32)

    p00, p01 = pixel(iy, ix), pixel(iy, ix + 1)
    p10, p11 = pixel(iy + 1, ix), pixel(iy + 1, ix + 1)
    top = _fma(fx, p01 - p00, p00)
    bottom = _fma(fx, p11 - p10, p10)
    out = _fma(fy, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)

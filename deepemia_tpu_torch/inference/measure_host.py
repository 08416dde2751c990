"""Exact host measurements: native contour kernels and the reference
formulas.

Each connected component (8-connected, scipy) of an instance mask is traced
by the native outer-contour kernel (``native/measure.cpp``: cv2's
algorithms), then measured: polygon area and perimeter, minimum-area
rectangle, least-squares ellipse, and optionally contrast percentiles of the
gray image under the mask. Rows follow ``measure.CSV_HEADER``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.ndimage as ndi

from deepemia_tpu_torch import native
from deepemia_tpu_torch.ops import cv


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of OpenCV's INTER_AREA along one axis for a
    downscale (src >= dst): each output cell averages the source cells it
    covers, partial cells by their covered fraction (OpenCV's
    ``computeResizeAreaTab``, its float32 weights included)."""
    idx, wts = cv.area_table(src, dst, 1.0 / (dst / src))
    out = np.zeros((dst, src), np.float64)
    np.add.at(out, (np.arange(dst)[:, None], idx), wts)
    return out


def resize_area(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Downscale a [H,W] float32 image to (height, width) as
    ``cv2.resize(image, (width, height), interpolation=cv2.INTER_AREA)``
    does (sums in float64 here, in float32 there)."""
    h, w = image.shape
    if height > h or width > w:
        raise ValueError(f"resize_area downscales only: {h}x{w} -> {height}x{width}")
    out = _area_weights(h, height) @ image.astype(np.float64) @ _area_weights(w, width).T
    return out.astype(np.float32)


def measure_mask_host(
    mask: np.ndarray,
    gray: Optional[np.ndarray] = None,
    measure_contrast: bool = False,
) -> List[Dict[str, float]]:
    """Measurements for every external contour of one binary mask.

    Returns a list (one dict per connected component) of raw pixel-space
    quantities: area, perimeter, rect dims, ellipse axes/eccentricity,
    contrast percentiles.
    """
    out: List[Dict[str, float]] = []
    labels, n = ndi.label(mask, structure=np.ones((3, 3)))
    for comp in range(1, n + 1):
        m = labels == comp
        pts = native.trace_outer_contour(m)
        if len(pts) < 2:
            continue
        area, perim = native.polygon_area_perimeter(pts)
        rect_w, rect_h = native.min_area_rect(pts)
        ell = native.fit_ellipse(pts)
        major, minor, ecc = ell if ell else (0.0, 0.0, 0.0)
        d10 = d50 = d90 = None
        if measure_contrast and gray is not None:
            vals = gray[m]
            if vals.size:
                hist, edges = np.histogram(
                    vals, bins=256, range=(0, 255), density=True
                )
                cdf = np.cumsum(hist)
                cdf /= max(cdf[-1], 1e-9)
                d10 = float(np.interp(0.10, cdf, edges[:-1]))
                d50 = float(np.interp(0.50, cdf, edges[:-1]))
                d90 = float(np.interp(0.90, cdf, edges[:-1]))
        out.append(
            {
                "area": area,
                "perimeter": perim,
                "rect_w": rect_w,
                "rect_h": rect_h,
                "major_axis": major,
                "minor_axis": minor,
                "eccentricity": ecc,
                "contrast_d10": d10,
                "contrast_d50": d50,
                "contrast_d90": d90,
            }
        )
    return out


def _row_from_meas(
    meas: Dict[str, float],
    scale: float,
    instance_id: int,
    image_name: str,
    cls: int,
    class_names: List[str],
    um_pix: float,
    psum: str,
) -> List:
    """One CSV row in the reference schema; ``scale`` converts window-frame
    pixel quantities back to native image pixels (1.0 for full-resolution
    masks)."""
    inv = 1.0 / scale
    a = meas["area"] * inv * inv
    p = meas["perimeter"] * inv
    dim_a = meas["rect_w"] * inv
    dim_b = meas["rect_h"] * inv
    aspect = (
        max(dim_a, dim_b) / min(dim_a, dim_b) if min(dim_a, dim_b) > 0 else 0.0
    )
    cname = class_names[cls] if cls < len(class_names) else f"class_{cls}"
    return [
        f"{image_name}_{instance_id}",
        cls,
        cname,
        meas["major_axis"] * inv * um_pix,
        meas["minor_axis"] * inv * um_pix,
        meas["eccentricity"],
        min(dim_a, dim_b) * um_pix,
        max(dim_a, dim_b) * um_pix,
        float(np.sqrt(4.0 * a / np.pi)) * um_pix,
        aspect,
        (4.0 * np.pi * a / (p * p)) * um_pix if p > 0 else 0.0,
        p * um_pix,
        max(dim_a, dim_b) * um_pix,
        1.0 / aspect if aspect > 0 else 0.0,
        (2.0 * np.sqrt(np.pi * a) / p) * um_pix if p > 0 else 0.0,
        meas["contrast_d10"],
        meas["contrast_d50"],
        meas["contrast_d90"],
        psum,
        image_name,
    ]


def measurement_rows_host(
    masks: np.ndarray,
    classes: np.ndarray,
    valid: np.ndarray,
    image_name: str,
    class_names: List[str],
    um_pix: float,
    psum: str,
    image_area: float,
    gray: Optional[np.ndarray] = None,
    measure_contrast: bool = False,
) -> List[List]:
    """CSV rows from full-resolution host masks: the per-contour adaptive
    gate min_area = max(5, image_area·5e-6·0.05), one row per surviving
    contour, instance numbers counting the valid masks."""
    rows: List[List] = []
    min_area = max(5.0, image_area * 0.000005 * 0.05)
    instance_id = 0
    for i in range(len(masks)):
        if not valid[i]:
            continue
        instance_id += 1
        for meas in measure_mask_host(masks[i], gray, measure_contrast):
            if meas["area"] < min_area:
                continue
            rows.append(
                _row_from_meas(
                    meas, 1.0, instance_id, image_name, int(classes[i]),
                    class_names, um_pix, psum,
                )
            )
    return rows


def measurement_rows_host_windows(
    windows: np.ndarray,  # [K,S,S] bool crops at native (or reduced) scale
    origins: np.ndarray,  # [K,2] window origin (x, y) in SCALED coords
    scales: np.ndarray,  # [K] window scale (1.0 = native pixels)
    classes: np.ndarray,
    valid: np.ndarray,
    image_name: str,
    class_names: List[str],
    um_pix: float,
    psum: str,
    image_area: float,
    gray: Optional[np.ndarray] = None,
    measure_contrast: bool = False,
) -> List[List]:
    """Same rows as ``measurement_rows_host`` from per-instance window crops
    instead of full-resolution [K,H,W] masks (O(K·S²) instead of O(K·H·W)).
    Instances larger than the window are measured at their shrink-to-fit
    scale and rescaled (area 1/s², lengths 1/s); contrast percentiles then
    use an intensity crop resized by :func:`resize_area`."""
    rows: List[List] = []
    min_area = max(5.0, image_area * 0.000005 * 0.05)
    s_win = windows.shape[-1]
    instance_id = 0
    for i in range(len(windows)):
        if not valid[i]:
            continue
        instance_id += 1
        g = None
        if measure_contrast and gray is not None:
            s = float(scales[i])
            ox, oy = origins[i]
            x0 = int(np.floor(ox / s))
            y0 = int(np.floor(oy / s))
            ext = int(np.ceil(s_win / s))
            crop = np.zeros((ext, ext), np.float32)
            sy0, sx0 = max(y0, 0), max(x0, 0)
            sy1 = min(y0 + ext, gray.shape[0])
            sx1 = min(x0 + ext, gray.shape[1])
            if sy1 > sy0 and sx1 > sx0:
                crop[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = gray[
                    sy0:sy1, sx0:sx1
                ]
            g = (
                crop
                if ext == s_win
                else resize_area(crop, s_win, s_win)
            )
        for meas in measure_mask_host(windows[i], g, measure_contrast):
            s = float(scales[i])
            if meas["area"] / (s * s) < min_area:
                continue
            rows.append(
                _row_from_meas(
                    meas, s, instance_id, image_name, int(classes[i]),
                    class_names, um_pix, psum,
                )
            )
    return rows

"""Measurement rows in the reference CSV schema, and the device
measurement backend.

``CSV_HEADER`` and :func:`measurement_rows` format per-instance
measurements (raw pixel units) into rows, with the reference's quirks kept
for CSV parity: C. Length is the *min* rectangle side and C. Width the
*max*; Circularity and Sphericity are multiplied by um_pix; Chord length is
perimeter·um_pix. The pipeline measures with the exact host backend
(``measure_host.py``) unless the configuration asks for
``measurement_backend: device``, which runs
:func:`measure_instances_device` (``ops/morphometrics.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from deepemia_tpu_torch.inference.detections import InstanceSet
from deepemia_tpu_torch.ops import morphometrics as mm
from deepemia_tpu_torch.ops.image import to_grayscale
from deepemia_tpu_torch.ops.masks import paste_masks

# crop pixels measured at once (a chunk of instances whose crops, padded to
# the chunk's largest, hold at most this many pixels; one instance larger
# than this is measured alone, so the peak follows its crop, never H·W·90)
MEASURE_BUDGET = 1 << 23

CSV_HEADER = [
    "Instance_ID",
    "Class",
    "Class_Name",
    "Major axis length",
    "Minor axis length",
    "Eccentricity",
    "C. Length",
    "C. Width",
    "Circular eq. diameter",
    "Aspect ratio",
    "Circularity",
    "Chord length",
    "Ferret diameter",
    "Roundness",
    "Sphericity",
    "Contrast d10",
    "Contrast d50",
    "Contrast d90",
    "Detected scale bar",
    "File name",
]


def measurement_crops(inst: InstanceSet, hw) -> np.ndarray:
    """[K,4] int64 (x0, y0, x1, y1) on the host: each instance's box widened
    by one mask texel plus 1 px on each side, clipped to the image. The
    paste fades to zero half a texel past the box, so the crop holds the
    whole mask with at least one false pixel around it where it does not
    meet the image edge."""
    h, w = hw
    b = inst.boxes.float()
    r = inst.mask_probs.shape[-1]
    tx = (b[:, 2] - b[:, 0]).clamp(min=1e-4) / r + 1.0
    ty = (b[:, 3] - b[:, 1]).clamp(min=1e-4) / r + 1.0
    crops = torch.stack([
        torch.floor(b[:, 0] - tx).clamp(0, w), torch.floor(b[:, 1] - ty).clamp(0, h),
        torch.ceil(b[:, 2] + tx).clamp(0, w), torch.ceil(b[:, 3] + ty).clamp(0, h),
    ], dim=1)
    return crops.long().cpu().numpy()


def measure_instances_device(
    inst: InstanceSet,
    image: torch.Tensor,
    measure_contrast: bool = False,
    mask_threshold: float = 0.5,
    budget: int = MEASURE_BUDGET,
) -> Dict[str, torch.Tensor]:
    """Measure every instance of one image on its device -> {name: [K]}
    (raw pixel units; the keys of ``morphometrics.measure_mask``).

    Each valid instance is pasted inside its crop (:func:`measurement_crops`)
    at the whole image's sample coordinates and measured there, in chunks
    of similar crop sizes under ``budget`` pixels; instances with ``valid``
    False, or crops of no pixels, keep the values of an empty mask.
    ``image`` is the [H,W,3] BGR micrograph (read only for the contrast)."""
    h, w = int(image.shape[0]), int(image.shape[1])
    dev = inst.boxes.device
    k = inst.capacity
    gray = to_grayscale(image.to(dev)) if measure_contrast else None
    empty = torch.zeros((1, 1, 1), dtype=torch.bool, device=dev)
    zero = torch.zeros((1, 2), dtype=torch.long, device=dev)
    base = mm.measure_batch(empty, zero, (h, w), None if gray is None else empty.float())
    out = {name: v.expand(k).clone() for name, v in base.items()}
    crops = measurement_crops(inst, (h, w))
    valid = inst.valid.cpu().numpy()
    sizes = (crops[:, 3] - crops[:, 1]) * (crops[:, 2] - crops[:, 0])
    todo = [i for i in np.argsort(sizes, kind="stable") if valid[i] and sizes[i] > 0]
    start = 0
    while start < len(todo):
        end, hc, wc = start, 0, 0
        while end < len(todo):
            i = todo[end]
            nh, nw = max(hc, crops[i, 3] - crops[i, 1]), max(wc, crops[i, 2] - crops[i, 0])
            if end > start and (end - start + 1) * nh * nw > budget:
                break
            hc, wc, end = nh, nw, end + 1
        idx = torch.as_tensor(np.asarray(todo[start:end]), dtype=torch.long, device=dev)
        origin = torch.as_tensor(crops[todo[start:end], :2], dtype=torch.long, device=dev)
        masks = paste_masks(inst.mask_probs[idx], inst.boxes[idx], int(hc), int(wc), mask_threshold, origin=origin)
        masks &= mm.inside_image(masks.shape, origin, (h, w))
        crop_gray = None
        if gray is not None:
            ys = (origin[:, 1, None] + torch.arange(int(hc), device=dev)[None]).clamp(0, h - 1)
            xs = (origin[:, 0, None] + torch.arange(int(wc), device=dev)[None]).clamp(0, w - 1)
            crop_gray = gray[ys[:, :, None], xs[:, None, :]]
        res = mm.measure_batch(masks, origin, (h, w), crop_gray)
        for name, v in res.items():
            out[name][idx] = v
        start = end
    return out


def measurement_rows(
    measures: Dict[str, np.ndarray],
    inst: InstanceSet,
    image_name: str,
    class_names: List[str],
    um_pix: float,
    psum: str,
    image_area: float,
    min_area_floor: float = 5.0,
    valid: np.ndarray | None = None,
    classes: np.ndarray | None = None,
) -> List[List]:
    """Per-instance measurements ({key: [K] array}) -> CSV rows: the
    adaptive area gate min_area = max(5, image_area·5e-6·0.05) and the
    reference formulas. ``valid`` / ``classes`` already on the host may be
    passed to skip reading them from ``inst``."""
    rows: List[List] = []
    min_area = max(min_area_floor, image_area * 0.000005 * 0.05)
    if valid is None:
        valid = inst.valid.cpu().numpy()
    if classes is None:
        classes = inst.classes.cpu().numpy()
    get = lambda k: np.asarray(measures[k])  # noqa: E731

    area = get("area")
    perim = get("perimeter")
    rect_w = get("rect_w")
    rect_h = get("rect_h")
    major = get("major_axis")
    minor = get("minor_axis")
    ecc = get("eccentricity")
    d10, d50, d90 = get("contrast_d10"), get("contrast_d50"), get("contrast_d90")

    instance_id = 0
    for i in range(len(valid)):
        if not valid[i]:
            continue
        instance_id += 1
        if area[i] < min_area:
            continue
        dim_a, dim_b = float(rect_w[i]), float(rect_h[i])
        aspect = (
            max(dim_a, dim_b) / min(dim_a, dim_b)
            if min(dim_a, dim_b) > 0
            else 0.0
        )
        p = float(perim[i])
        a = float(area[i])
        cls = int(classes[i])
        cname = (
            class_names[cls] if cls < len(class_names) else f"class_{cls}"
        )
        rows.append(
            [
                f"{image_name}_{instance_id}",
                cls,
                cname,
                float(major[i]) * um_pix,
                float(minor[i]) * um_pix,
                float(ecc[i]),
                min(dim_a, dim_b) * um_pix,  # C. Length: min side
                max(dim_a, dim_b) * um_pix,  # C. Width: max side
                float(np.sqrt(4.0 * a / np.pi)) * um_pix,
                aspect,
                (4.0 * np.pi * a / (p * p)) * um_pix if p > 0 else 0.0,
                p * um_pix,  # Chord length: the perimeter
                max(dim_a, dim_b) * um_pix,  # Feret
                1.0 / aspect if aspect > 0 else 0.0,
                (2.0 * np.sqrt(np.pi * a) / p) * um_pix if p > 0 else 0.0,
                float(d10[i]) if d10 is not None else None,
                float(d50[i]) if d50 is not None else None,
                float(d90[i]) if d90 is not None else None,
                psum,
                image_name,
            ]
        )
    return rows

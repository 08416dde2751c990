"""Measurement rows in the reference CSV schema.

``CSV_HEADER`` and :func:`measurement_rows` format per-instance
measurements (raw pixel units) into rows, with the reference's quirks kept
for CSV parity: C. Length is the *min* rectangle side and C. Width the
*max*; Circularity and Sphericity are multiplied by um_pix; Chord length is
perimeter·um_pix. The pipeline measures with the exact host backend
(``measure_host.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from deepemia_tpu_torch.inference.detections import InstanceSet

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

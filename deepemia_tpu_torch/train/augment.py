"""Train-time augmentation on the host (the JAX package's
``train/augment.py``): H-flip p=0.5, V-flip p=0.5, rotation within +-20
degrees and brightness 0.8-1.2, drawn in that order from the caller's
generator and returned as one 3x3 affine on (x, y, 1) pixel coordinates
plus the brightness factor, so the loader warps the image once and fills
each polygon once at the final resolution. ``ops.cv.rotation_matrix2d``
stands in for ``cv2.getRotationMatrix2D``. Boxes come from the final masks,
which is exact under flips and rotations.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from deepemia_tpu_torch.ops.cv import rotation_matrix2d


def sample_augment_affine(
    h: int,
    w: int,
    rng: np.random.Generator,
    rotation_deg: float = 20.0,
    brightness_range: Tuple[float, float] = (0.8, 1.2),
) -> Tuple[np.ndarray, float]:
    """(3x3 float64 affine, brightness factor) for an h x w image."""
    m = np.eye(3)
    if rng.random() < 0.5:  # horizontal flip: x' = (w-1) - x
        m = np.array([[-1, 0, w - 1], [0, 1, 0], [0, 0, 1]], np.float64) @ m
    if rng.random() < 0.5:  # vertical flip
        m = np.array([[1, 0, 0], [0, -1, h - 1], [0, 0, 1]], np.float64) @ m
    angle = float(rng.uniform(-rotation_deg, rotation_deg))
    rot = np.eye(3)
    rot[:2] = rotation_matrix2d((w / 2.0, h / 2.0), angle, 1.0)
    m = rot @ m
    factor = float(rng.uniform(*brightness_range))
    return m, factor


def boxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """[N,H,W] -> [N,4] XYXY float32 tight bounds (x1, y1 exclusive); an
    empty mask gives zeros."""
    masks = np.asarray(masks)
    n, h, w = masks.shape
    out = np.zeros((n, 4), np.float32)
    if not n:
        return out
    rows = masks.any(axis=2)  # [N,H]
    cols = masks.any(axis=1)  # [N,W]
    nonempty = rows.any(axis=1)
    y0 = rows.argmax(axis=1)
    y1 = h - rows[:, ::-1].argmax(axis=1)
    x0 = cols.argmax(axis=1)
    x1 = w - cols[:, ::-1].argmax(axis=1)
    out[:, 0] = np.where(nonempty, x0, 0)
    out[:, 1] = np.where(nonempty, y0, 0)
    out[:, 2] = np.where(nonempty, x1, 0)
    out[:, 3] = np.where(nonempty, y1, 0)
    return out

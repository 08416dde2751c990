"""Anchor generation for the FPN levels: one size per level p2..p6
(32..512), aspect ratios (0.5, 1, 2), centred on the level's grid cells.
Anchors are enumerated cell-major, then by aspect (h, w, a order)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

LEVELS: Tuple[str, ...] = ("p2", "p3", "p4", "p5", "p6")
STRIDES: Dict[str, int] = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
SIZES: Dict[str, float] = {"p2": 32, "p3": 64, "p4": 128, "p5": 256, "p6": 512}
ASPECT_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
NUM_ANCHORS_PER_CELL = len(ASPECT_RATIOS)


def cell_anchors(size: float, ratios: Sequence[float] = ASPECT_RATIOS) -> np.ndarray:
    """[A,4] XYXY anchors centred at (0,0): area size², w = size·sqrt(1/r),
    h = w·r."""
    out = []
    area = size * size
    for r in ratios:
        w = float(np.sqrt(area / r))
        h = w * r
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.array(out, dtype=np.float32)


def level_anchors(level: str, feat_h: int, feat_w: int, device=None) -> torch.Tensor:
    """[H·W·A, 4] anchors for one level of spatial size (feat_h, feat_w)."""
    stride = STRIDES[level]
    base = cell_anchors(SIZES[level])
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    anchors = (shifts + base[None]).reshape(-1, 4)
    return torch.from_numpy(anchors).to(device)


def all_anchors(
    feat_shapes: Dict[str, Tuple[int, int]], device=None
) -> Dict[str, torch.Tensor]:
    """Per-level anchors for {level: (H, W)} feature shapes."""
    return {
        lv: level_anchors(lv, h, w, device) for lv, (h, w) in feat_shapes.items()
    }

"""Tile-grid math, tile extraction, and tile -> global box mapping.

Offsets step by ``tile_size·(1−overlap)`` from 0 while below the image
extent; edge tiles extend past the border and are zero-padded.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class TileGrid(NamedTuple):
    offsets: np.ndarray  # [T, 2] int32 (x, y) top-left corners
    tile_size: int
    stride: int
    image_hw: Tuple[int, int]

    @property
    def num_tiles(self) -> int:
        return len(self.offsets)


def compute_tile_grid(
    height: int, width: int, tile_size: int, overlap_ratio: float
) -> TileGrid:
    stride = max(int(tile_size * (1.0 - overlap_ratio)), 1)
    ys = list(range(0, height, stride))
    xs = list(range(0, width, stride))
    offsets = np.array([(x, y) for y in ys for x in xs], dtype=np.int32).reshape(-1, 2)
    return TileGrid(offsets, tile_size, stride, (height, width))


def extract_tiles(image: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[H,W,C] -> [T, ts, ts, C]; out-of-bounds regions zero-padded."""
    ts = grid.tile_size
    h, w = grid.image_hw
    pad_h = max(int(grid.offsets[:, 1].max()) + ts - h, 0) if grid.num_tiles else 0
    pad_w = max(int(grid.offsets[:, 0].max()) + ts - w, 0) if grid.num_tiles else 0
    padded = F.pad(image, (0, 0, 0, pad_w, 0, pad_h))
    return torch.stack([padded[y : y + ts, x : x + ts] for x, y in grid.offsets.tolist()])


def tile_boxes_to_global(
    boxes: torch.Tensor, tile_offsets: torch.Tensor, scale: float = 1.0
) -> torch.Tensor:
    """boxes [T,N,4] on tiles upscaled by ``scale``, tile_offsets [T,2]
    (x, y) -> global XYXY boxes [T,N,4]."""
    b = boxes / scale
    off = tile_offsets.to(b.dtype)
    return b + torch.cat([off, off], dim=-1)[:, None, :]

"""Mask ops of the serving path: paste, max-pool downsample, mask IoU by a
matrix product on flattened 0/1 masks, and the tile edge test."""

from __future__ import annotations

import torch


def downsample_masks(masks: torch.Tensor, stride: int) -> torch.Tensor:
    """Max-pool downsample [N,H,W] by ``stride`` (keeps thin structures)."""
    if stride == 1:
        return masks
    n, h, w = masks.shape
    hp, wp = h - h % stride, w - w % stride
    m = masks[:, :hp, :wp].reshape(n, hp // stride, stride, wp // stride, stride)
    return m.any(dim=4).any(dim=2)


def mask_iou_matrix(a: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Pairwise mask IoU [N,M]: with 0/1 inputs ``A @ Bᵀ`` counts the
    intersection exactly (float32 products, no TF32)."""
    a = downsample_masks(a, stride)
    b = downsample_masks(b, stride)
    af = a.reshape(a.shape[0], -1).float()
    bf = b.reshape(b.shape[0], -1).float()
    inter = af @ bf.T
    union = af.sum(dim=1)[:, None] + bf.sum(dim=1)[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def paste_masks(
    mask_probs: torch.Tensor,
    boxes: torch.Tensor,
    height: int,
    width: int,
    threshold: float = 0.5,
) -> torch.Tensor:
    """Paste RoI mask probabilities [N,R,R] over boxes [N,4] into
    [N,height,width] bool masks: every pixel centre samples the R×R grid
    bilinearly with ``grid_sample(align_corners=False,
    padding_mode='zeros')`` semantics (Detectron2's paste), then the
    threshold applies."""
    n, r, _ = mask_probs.shape
    dev = mask_probs.device
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bw = (x1 - x0).clamp(min=1e-4)
    bh = (y1 - y0).clamp(min=1e-4)
    gx = (xs[None, :] - x0[:, None]) / bw[:, None] * r - 0.5  # [N,W]
    gy = (ys[None, :] - y0[:, None]) / bh[:, None] * r - 0.5  # [N,H]

    def sample_axis(g):
        i0f = torch.floor(g)
        frac = g - i0f
        i0 = i0f.long()
        v0 = ((i0 >= 0) & (i0 <= r - 1)).to(mask_probs.dtype)
        v1 = ((i0 + 1 >= 0) & (i0 + 1 <= r - 1)).to(mask_probs.dtype)
        return i0.clamp(0, r - 1), (i0 + 1).clamp(0, r - 1), frac, v0, v1

    yx0, yx1, fy, vy0, vy1 = sample_axis(gy)  # [N,H]
    xx0, xx1, fx, vx0, vx1 = sample_axis(gx)  # [N,W]

    def rows(idx):  # [N,H] -> [N,H,R]
        return torch.gather(mask_probs, 1, idx[:, :, None].expand(-1, -1, r))

    def cols(m, idx):  # m [N,H,R], idx [N,W] -> [N,H,W]
        return torch.gather(m, 2, idx[:, None, :].expand(-1, m.shape[1], -1))

    top = rows(yx0) * vy0[:, :, None]
    bot = rows(yx1) * vy1[:, :, None]
    rowmix = top * (1 - fy[:, :, None]) + bot * fy[:, :, None]
    left = cols(rowmix, xx0) * vx0[:, None, :]
    right = cols(rowmix, xx1) * vx1[:, None, :]
    vals = left * (1 - fx[:, None, :]) + right * fx[:, None, :]
    return vals >= threshold


def is_edge_mask(boxes: torch.Tensor, tile_size: int, overlap_ratio: float) -> torch.Tensor:
    """[N,4] tile-local boxes -> [N] bool: the box reaches into the overlap
    margin (width tile_size·overlap/2)."""
    edge = tile_size * overlap_ratio / 2.0
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    return (y0 < edge) | (y1 > tile_size - edge) | (x0 < edge) | (x1 > tile_size - edge)

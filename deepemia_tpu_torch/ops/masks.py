"""Mask ops of the serving path: paste, max-pool downsample, mask IoU and
containment by a matrix product on flattened 0/1 masks, the tile edge test,
and the morphology of the postprocess (erosion and dilation with a square
element, hole filling, connected components). Every op takes a batch of
masks and runs on the device the masks lie on."""

from __future__ import annotations

from typing import Optional

import torch


def mask_bboxes(masks: torch.Tensor) -> torch.Tensor:
    """[N,H,W] bool -> [N,4] XYXY float32 boxes (x1/y1 exclusive: max index
    + 1); empty masks give zeros."""
    n, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.int32, device=masks.device)
    xs = torch.arange(w, dtype=torch.int32, device=masks.device)
    any_row = masks.any(dim=2)  # [N,H]
    any_col = masks.any(dim=1)  # [N,W]
    big = 1 << 30
    y0 = torch.where(any_row, ys, big).amin(dim=1)
    y1 = torch.where(any_row, ys, -1).amax(dim=1) + 1
    x0 = torch.where(any_col, xs, big).amin(dim=1)
    x1 = torch.where(any_col, xs, -1).amax(dim=1) + 1
    box = torch.stack([x0, y0, x1, y1], dim=1).float()
    return torch.where(any_row.any(dim=1)[:, None], box, 0.0)


def mask_areas(masks: torch.Tensor) -> torch.Tensor:
    """[N,H,W] -> [N] foreground pixel counts (float32)."""
    return masks.float().sum(dim=(1, 2))


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


def mask_containment_matrix(child: torch.Tensor, parent: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """[N,M]: the fraction of each child mask that lies inside each parent
    mask (intersection / child area; 0 for an empty child)."""
    cf = downsample_masks(child, stride).reshape(child.shape[0], -1).float()
    pf = downsample_masks(parent, stride).reshape(parent.shape[0], -1).float()
    inter = cf @ pf.T
    areas = cf.sum(dim=1)[:, None]
    return torch.where(areas > 0, inter / areas, torch.zeros_like(inter))


def paste_masks(
    mask_probs: torch.Tensor,
    boxes: torch.Tensor,
    height: int,
    width: int,
    threshold: float = 0.5,
    origin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paste RoI mask probabilities [N,R,R] over boxes [N,4] into
    [N,height,width] bool masks: every pixel centre samples the R×R grid
    bilinearly with ``grid_sample(align_corners=False,
    padding_mode='zeros')`` semantics (Detectron2's paste), then the
    threshold applies. With ``origin`` [N,2] (x, y) the result is each
    instance's height x width crop at that pixel of the image, sampled at
    the same float32 coordinates as the whole image's paste."""
    n, r, _ = mask_probs.shape
    dev = mask_probs.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None]
    if origin is not None:
        ys = ys + origin[:, 1:2].float()
        xs = xs + origin[:, 0:1].float()
    ys, xs = ys + 0.5, xs + 0.5
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bw = (x1 - x0).clamp(min=1e-4)
    bh = (y1 - y0).clamp(min=1e-4)
    gx = (xs - x0[:, None]) / bw[:, None] * r - 0.5  # [N,W]
    gy = (ys - y0[:, None]) / bh[:, None] * r - 0.5  # [N,H]

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


def _shifted(x: torch.Tensor, fill, offsets) -> torch.Tensor:
    """The stack over ``offsets`` (dy, dx) of x[..., i+dy, j+dx], with
    ``fill`` outside: [len(offsets), ...x.shape]."""
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    h, w = x.shape[-2], x.shape[-1]
    pad = torch.nn.functional.pad(x, (r, r, r, r), value=fill) if r else x
    return torch.stack([pad[..., r + dy : r + dy + h, r + dx : r + dx + w] for dy, dx in offsets])


def _square(radius: int):
    return [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)]


_CROSS = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]


def binary_dilate(masks: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Dilation of [..., H, W] bool masks by a (2r+1)² square; outside the
    frame is background."""
    return _shifted(masks.bool(), False, _square(radius)).any(dim=0)


def binary_erode(masks: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Erosion of [..., H, W] bool masks by a (2r+1)² square; outside the
    frame is background, so foreground touching the frame's edge erodes."""
    return _shifted(masks.bool(), False, _square(radius)).all(dim=0)


def fill_holes(masks: torch.Tensor, check_every: int = 8) -> torch.Tensor:
    """Fill interior holes of [..., H, W] bool masks (scipy
    ``binary_fill_holes``, 4-connectivity): the background reachable from
    the frame's border by 4-connected steps stays background, the rest
    becomes foreground. The flood grows by one cross-shaped step at a time
    until no mask of the batch changes, tested every ``check_every`` steps
    (extra steps past the fixpoint change nothing)."""
    masks = masks.bool()
    comp = ~masks
    flood = torch.zeros_like(masks)
    flood[..., 0, :] = True
    flood[..., -1, :] = True
    flood[..., :, 0] = True
    flood[..., :, -1] = True
    flood &= comp
    while True:
        before = flood
        for _ in range(check_every):
            flood = _shifted(flood, False, _CROSS).any(dim=0) & comp
        if torch.equal(flood, before):
            break
    return masks | (comp & ~flood)


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label the 8-connected components of [..., H, W] bool masks: int64
    labels, 0 for background, each component carrying the smallest
    flattened index + 1 of its pixels (min-label propagation over a 3x3
    window to the fixpoint)."""
    h, w = mask.shape[-2], mask.shape[-1]
    idx = torch.arange(1, h * w + 1, device=mask.device).reshape(h, w).expand(mask.shape)
    big = h * w + 2
    labels = torch.where(mask, idx, big)
    while True:
        new = torch.where(mask, _shifted(labels, big, _square(1)).amin(dim=0), big)
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(mask, labels, 0)


def num_components(mask: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool -> [...] int32 count of 8-connected components (a
    component's root is the pixel whose label is its own index + 1)."""
    h, w = mask.shape[-2], mask.shape[-1]
    idx = torch.arange(1, h * w + 1, device=mask.device).reshape(h, w)
    roots = (connected_components(mask) == idx) & mask
    return roots.sum(dim=(-2, -1)).to(torch.int32)


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 8-connected component of each [..., H, W] bool
    mask (every component of the largest size, on a tie)."""
    h, w = mask.shape[-2], mask.shape[-1]
    labels = connected_components(mask).reshape(-1, h * w)
    counts = labels.new_zeros((labels.shape[0], h * w + 1)).scatter_add_(1, labels, torch.ones_like(labels))
    counts[:, 0] = 0  # background
    size = torch.gather(counts, 1, labels).reshape(mask.shape)
    best = size.reshape(-1, h * w).amax(dim=1).reshape(mask.shape[:-2] + (1, 1))
    return mask & (size == best)

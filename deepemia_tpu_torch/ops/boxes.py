"""Box geometry and exact greedy NMS on padded tensors.

Box convention: XYXY float32 ``[x0, y0, x1, y1]``. Every function keeps the
padded shapes of its inputs and carries validity as a bool mask, as the JAX
package does. The NMS functions also take a leading batch dimension, so the
serving path can suppress many independent sets (pyramid levels, tiles) in
one pass.
"""

from __future__ import annotations

import math

import torch

SCALE_CLAMP = math.log(1000.0 / 16)  # Detectron2's Box2BoxTransform default


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [...]. Areas of XYXY boxes (clamped at 0)."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def pairwise_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4], [..., M, 4] -> [..., N, M] intersection areas."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4], [..., M, 4] -> [..., N, M] IoU (0 where the union is 0)."""
    inter = pairwise_intersection(a, b)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp XYXY boxes to image bounds."""
    x0 = boxes[..., 0].clamp(0, width)
    y0 = boxes[..., 1].clamp(0, height)
    x1 = boxes[..., 2].clamp(0, width)
    y1 = boxes[..., 3].clamp(0, height)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def apply_deltas(
    boxes: torch.Tensor,
    deltas: torch.Tensor,
    weights=(10.0, 10.0, 5.0, 5.0),
    scale_clamp: float = SCALE_CLAMP,
) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas onto boxes (Detectron2
    Box2BoxTransform: weights (10,10,5,5) for the RoI heads, (1,1,1,1) for
    the RPN)."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=scale_clamp)
    dh = (deltas[..., 3] / wh).clamp(max=scale_clamp)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w,
            pred_ctr_y + 0.5 * pred_h,
        ],
        dim=-1,
    )


def stable_topk(key: torch.Tensor, k: int):
    """Top-``k`` along the last axis with ties broken by the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_mask_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold,
    valid: torch.Tensor | None = None,
    iou: torch.Tensor | None = None,
    block_size: int = 512,
) -> torch.Tensor:
    """Exact greedy NMS over B independent padded sets.

    boxes [B,N,4], scores [B,N] -> keep [B,N] bool. Semantics of
    torchvision's NMS: score-descending greedy order with ties broken by the
    lower index, a strict ``>`` IoU threshold (a scalar, or per-row [B,N]
    where the keeper's threshold applies), and rows with ``valid`` False
    never kept and never suppressing. ``iou`` [B,N,N] replaces the box IoU
    (mask-level dedup passes a mask IoU).

    Block-fixpoint form: rows are put in score-rank order and processed in
    ``block_size`` chunks. Inside a chunk the recurrence
    ``kept[i] = free[i] and no higher-ranked kept j has iou[j,i] > thr[j]``
    is iterated to its fixpoint, which is exact because a suppression chain
    inside a chunk is at most ``block_size`` deep; the chunk's keepers then
    suppress every later row. Each sweep ends with one host read of the
    convergence flag.
    """
    bsz, n = scores.shape
    dev = scores.device
    if n == 0:
        return torch.zeros((bsz, 0), dtype=torch.bool, device=dev)
    if valid is None:
        valid = torch.ones((bsz, n), dtype=torch.bool, device=dev)
    thr = torch.as_tensor(iou_threshold, dtype=torch.float32, device=dev)
    thr = thr.expand(bsz, n) if thr.ndim < 2 else thr

    block = max(8, min(block_size, n))
    key = torch.where(valid, scores.float(), float("-inf"))
    order = torch.argsort(-key, dim=-1, stable=True)  # [B,N]
    if iou is None:
        boxes_r = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        iou_r = box_iou_matrix(boxes_r, boxes_r)
    else:
        iou_r = torch.gather(iou, 1, order[..., None].expand(-1, -1, n))
        iou_r = torch.gather(iou_r, 2, order[:, None, :].expand(-1, n, -1))
    valid_r = torch.gather(valid, 1, order)
    thr_r = torch.gather(thr, 1, order)

    pad = (-n) % block
    if pad:
        iou_r = torch.nn.functional.pad(iou_r, (0, pad, 0, pad))
        valid_r = torch.nn.functional.pad(valid_r, (0, pad))
        thr_r = torch.nn.functional.pad(thr_r, (0, pad))
    m = n + pad
    col = torch.arange(m, device=dev)
    ext_suppressed = torch.zeros((bsz, m), dtype=torch.bool, device=dev)
    kept_r = torch.zeros((bsz, m), dtype=torch.bool, device=dev)
    for start in range(0, m, block):
        stop = start + block
        v_b = valid_r[:, start:stop]
        rows = (
            (iou_r[:, start:stop] > thr_r[:, start:stop, None])
            & v_b[:, :, None]
            & valid_r[:, None, :]
            & (col[None, None, :] > col[start:stop, None])
        )  # [B,block,m]
        sup_bb = rows[:, :, start:stop]
        free = v_b & ~ext_suppressed[:, start:stop]
        kept = free
        prev = torch.zeros_like(free)
        sweeps = 0
        while sweeps < block and bool((kept != prev).any()):
            s = (sup_bb & kept[:, :, None]).any(dim=1)
            kept, prev = free & ~s, kept
            sweeps += 1
        kept_r[:, start:stop] = kept
        ext_suppressed |= (rows & kept[:, :, None]).any(dim=1)
    keep = torch.zeros((bsz, n), dtype=torch.bool, device=dev)
    return keep.scatter(1, order, kept_r[:, :n])


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold,
    valid: torch.Tensor | None = None,
    iou: torch.Tensor | None = None,
    block_size: int = 512,
) -> torch.Tensor:
    """Greedy NMS on one padded set: boxes [N,4], scores [N] -> keep [N]
    bool (see :func:`nms_mask_batched`)."""
    thr = torch.as_tensor(iou_threshold, dtype=torch.float32, device=scores.device)
    return nms_mask_batched(
        boxes[None],
        scores[None],
        thr[None] if thr.ndim == 1 else thr,
        valid=None if valid is None else valid[None],
        iou=None if iou is None else iou[None],
        block_size=block_size,
    )[0]


def batched_nms_mask_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    iou_threshold,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Class-aware NMS over B sets [B,N,...]: boxes of different classes
    never suppress each other (each set's boxes are shifted by
    ``class * 2 * (max |coord| + 1)``)."""
    if boxes.shape[1] == 0:
        return torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    extent = boxes.abs().amax(dim=(1, 2)) + 1.0  # [B]
    offsets = classes.to(boxes.dtype) * extent[:, None] * 2.0
    shifted = boxes + offsets[..., None]
    return nms_mask_batched(shifted, scores, iou_threshold, valid=valid)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    iou_threshold,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Class-aware NMS on one padded set: [N,4], [N], [N] -> keep [N]."""
    return batched_nms_mask_batched(
        boxes[None],
        scores[None],
        classes[None],
        iou_threshold,
        valid=None if valid is None else valid[None],
    )[0]

"""Region Proposal Network: the shared head and padded proposal selection.

``select_proposals_batched`` follows Detectron2's find_top_rpn_proposals on
padded tensors: per-level top-k by objectness, delta decode with weights
(1,1,1,1), clip, the ``w,h > min_size`` gate, NMS per level, and a global
top-k that returns a ``valid`` mask instead of a ragged set. All images of
a batch and all levels go through one batched NMS.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepemia_tpu_torch.config.constants import StaticShapes
from deepemia_tpu_torch.models.anchors import LEVELS, NUM_ANCHORS_PER_CELL
from deepemia_tpu_torch.ops import boxes as box_ops


class RPNHead(nn.Module):
    """Shared 3x3 conv + objectness / delta 1x1 predictors, applied per
    level. Returns NHWC-ordered maps: logits {lv: [B,H,W,A]}, deltas
    {lv: [B,H,W,A*4]} (anchor-major, then coordinate)."""

    def __init__(self, in_channels: int = 256, num_anchors: int = NUM_ANCHORS_PER_CELL):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, feats: Dict[str, torch.Tensor]):
        logits, regs = {}, {}
        for lv, x in feats.items():
            t = F.relu(self.conv(x))
            logits[lv] = self.objectness_logits(t).permute(0, 2, 3, 1)
            regs[lv] = self.anchor_deltas(t).permute(0, 2, 3, 1)
        return logits, regs


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [..., K, 4]
    scores: torch.Tensor  # [..., K] objectness (sigmoid)
    valid: torch.Tensor  # [..., K] bool


def select_proposals_batched(
    logits: Dict[str, torch.Tensor],
    regs: Dict[str, torch.Tensor],
    anchors: Dict[str, torch.Tensor],
    image_hw: Tuple[int, int],
    pre_nms_topk: int = StaticShapes.PRE_NMS_TOPK_TEST,
    post_nms_topk: int = StaticShapes.POST_NMS_TOPK_TEST,
    nms_threshold: float = 0.7,
    min_size: float = 0.0,
) -> Proposals:
    """Proposals for a batch of images: logits {lv: [B,H,W,A]}, regs
    {lv: [B,H,W,A*4]}, anchors {lv: [H*W*A, 4]} -> Proposals [B,K,...]."""
    all_boxes, all_scores, all_valid = [], [], []
    for lv in LEVELS:
        if lv not in logits:
            continue
        bsz = logits[lv].shape[0]
        score = logits[lv].reshape(bsz, -1).float()  # [B,H*W*A]
        delta = regs[lv].reshape(bsz, -1, 4).float()
        k = min(pre_nms_topk, score.shape[1])
        top_scores, idx = box_ops.stable_topk(score, k)
        sel_delta = torch.gather(delta, 1, idx[..., None].expand(-1, -1, 4))
        boxes = box_ops.apply_deltas(
            anchors[lv][idx], sel_delta, weights=(1.0, 1.0, 1.0, 1.0)
        )
        boxes = box_ops.clip_boxes(boxes, image_hw[0], image_hw[1])
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        all_boxes.append(boxes)
        all_scores.append(top_scores)
        all_valid.append((w > min_size) & (h > min_size))

    k_max = max(s.shape[1] for s in all_scores)

    def _pad(x, fill):
        p = k_max - x.shape[1]
        if not p:
            return x
        pad = [0, 0] * (x.ndim - 2) + [0, p]
        return F.pad(x, pad, value=fill)

    boxes_l = torch.stack([_pad(b, 0.0) for b in all_boxes], dim=1)  # [B,L,k,4]
    scores_l = torch.stack([_pad(s, float("-inf")) for s in all_scores], dim=1)
    valid_l = torch.stack([_pad(v, False) for v in all_valid], dim=1)
    bsz, n_lv = scores_l.shape[:2]

    # levels never suppress each other: one NMS per (image, level)
    keep = box_ops.nms_mask_batched(
        boxes_l.reshape(bsz * n_lv, k_max, 4),
        scores_l.reshape(bsz * n_lv, k_max),
        nms_threshold,
        valid=valid_l.reshape(bsz * n_lv, k_max),
    ).reshape(bsz, n_lv * k_max)

    boxes = boxes_l.reshape(bsz, n_lv * k_max, 4)
    scores = scores_l.reshape(bsz, n_lv * k_max)
    sel_scores = torch.where(keep, scores, float("-inf"))
    k = min(post_nms_topk, boxes.shape[1])
    top, idx = box_ops.stable_topk(sel_scores, k)
    return Proposals(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        scores=torch.sigmoid(top),
        valid=torch.isfinite(top),
    )


def select_proposals(
    logits: Dict[str, torch.Tensor],
    regs: Dict[str, torch.Tensor],
    anchors: Dict[str, torch.Tensor],
    image_hw: Tuple[int, int],
    pre_nms_topk: int = StaticShapes.PRE_NMS_TOPK_TEST,
    post_nms_topk: int = StaticShapes.POST_NMS_TOPK_TEST,
    nms_threshold: float = 0.7,
    min_size: float = 0.0,
) -> Proposals:
    """Proposals for ONE image: logits {lv: [H,W,A]}, regs {lv: [H,W,A*4]}
    -> Proposals [K,...]."""
    p = select_proposals_batched(
        {k: v[None] for k, v in logits.items()},
        {k: v[None] for k, v in regs.items()},
        anchors,
        image_hw,
        pre_nms_topk,
        post_nms_topk,
        nms_threshold,
        min_size,
    )
    return Proposals(p.boxes[0], p.scores[0], p.valid[0])

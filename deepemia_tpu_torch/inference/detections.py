"""Padded detection sets and the merge / dedup steps of the serving path.

``InstanceSet`` is a fixed-capacity set of tensors with a validity mask,
as in the JAX package, so tile merging and dedup never change shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from deepemia_tpu_torch.ops import boxes as box_ops
from deepemia_tpu_torch.ops import masks as mask_ops


class InstanceSet(NamedTuple):
    """boxes [K,4] global XYXY; scores [K]; classes [K] int32; valid [K]
    bool; mask_probs [K,R,R] RoI-frame mask probabilities."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    mask_probs: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.boxes.shape[0]


def empty_instances(capacity: int, mask_res: int = 28, device=None) -> InstanceSet:
    return InstanceSet(
        boxes=torch.zeros((capacity, 4), dtype=torch.float32, device=device),
        scores=torch.zeros((capacity,), dtype=torch.float32, device=device),
        classes=torch.zeros((capacity,), dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        mask_probs=torch.zeros((capacity, mask_res, mask_res), dtype=torch.float32, device=device),
    )


def concat_instances(sets: Sequence[InstanceSet], capacity: int) -> InstanceSet:
    """Concatenate padded sets and keep the top-``capacity`` by score (ties
    to the earlier row), padding up to ``capacity``."""
    cat = InstanceSet(*(torch.cat(list(f)) for f in zip(*sets)))
    keyed = torch.where(cat.valid, cat.scores, float("-inf"))
    top, idx = box_ops.stable_topk(keyed, min(capacity, keyed.shape[0]))
    ok = torch.isfinite(top)
    out = InstanceSet(
        boxes=cat.boxes[idx],
        scores=torch.where(ok, top, 0.0),
        classes=cat.classes[idx],
        valid=ok,
        mask_probs=cat.mask_probs[idx],
    )
    pad = capacity - out.capacity
    if pad > 0:
        out = InstanceSet(
            boxes=F.pad(out.boxes, (0, 0, 0, pad)),
            scores=F.pad(out.scores, (0, pad)),
            classes=F.pad(out.classes, (0, pad)),
            valid=F.pad(out.valid, (0, pad)),
            mask_probs=F.pad(out.mask_probs, (0, 0, 0, 0, 0, pad)),
        )
    return out


def filter_instances(inst: InstanceSet, keep: torch.Tensor) -> InstanceSet:
    """Invalidate rows where ``keep`` is False (no compaction)."""
    return inst._replace(valid=inst.valid & keep)


def lowres_masks(inst: InstanceSet, image_hw, stride: int, threshold: float = 0.5) -> torch.Tensor:
    """All instance masks pasted on a stride-downsampled global grid:
    [K, ceil(H/stride), ceil(W/stride)] bool."""
    h, w = image_hw
    gh, gw = -(-h // stride), -(-w // stride)
    pasted = mask_ops.paste_masks(inst.mask_probs, inst.boxes / float(stride), gh, gw, threshold)
    return pasted & inst.valid[:, None, None]


def dedup_by_mask_iou(
    inst: InstanceSet,
    image_hw,
    iou_threshold: float,
    stride: int = 8,
    class_aware: bool = True,
) -> InstanceSet:
    """Greedy score-ordered dedup on mask IoU: one low-res paste, one
    matrix product, one greedy NMS."""
    lm = lowres_masks(inst, image_hw, stride)
    iou = mask_ops.mask_iou_matrix(lm, lm)
    if class_aware:
        same = inst.classes[:, None] == inst.classes[None, :]
        iou = torch.where(same, iou, 0.0)
    keep = box_ops.nms_mask(inst.boxes, inst.scores, iou_threshold, valid=inst.valid, iou=iou)
    return filter_instances(inst, keep)

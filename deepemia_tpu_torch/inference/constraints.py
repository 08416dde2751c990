"""Spatial constraints between detected classes as masked matrix ops.

Config format: ``{enabled, containment_threshold, overlap_rules: {class:
{allow_overlap, max_iou_threshold}}, containment_rules: {child_class:
parent_class}}``. Overlap rules keep the higher-scored instance of a
same-class pair whose mask IoU exceeds the class's ``max_iou_threshold``;
containment rules drop child instances whose best containment in a
surviving parent-class mask (intersection / child area) is below the
threshold. One low-resolution paste feeds both matrices.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from deepemia_tpu_torch.inference.detections import InstanceSet, filter_instances, lowres_masks
from deepemia_tpu_torch.ops import boxes as box_ops
from deepemia_tpu_torch.ops import masks as mask_ops


class ConstraintSpec(NamedTuple):
    """Array-encoded constraint configuration for C classes."""

    enabled: bool
    overlap_max_iou: np.ndarray  # [C] float32, 1.0 = unconstrained
    containment_parent: np.ndarray  # [C] int32, -1 = no rule
    containment_threshold: float


def spec_from_config(constraints_cfg: Optional[Dict[str, Any]], num_classes: int) -> ConstraintSpec:
    """Parse the constraints config into arrays. Class keys may be ints or
    'class_N' strings."""
    cfg = constraints_cfg or {}
    overlap = np.ones((num_classes,), np.float32)
    parent = np.full((num_classes,), -1, np.int32)

    def class_id(key) -> int:
        return key if isinstance(key, int) else int(str(key).replace("class_", ""))

    for key, rule in (cfg.get("overlap_rules") or {}).items():
        c = class_id(key)
        if 0 <= c < num_classes and isinstance(rule, dict):
            max_iou = float(rule.get("max_iou_threshold", 0.5))
            if rule.get("allow_overlap", True) and max_iou >= 0.9:
                continue  # unconstrained
            overlap[c] = max_iou
    for child, par in (cfg.get("containment_rules") or {}).items():
        c = class_id(child)
        if 0 <= c < num_classes:
            parent[c] = class_id(par)
    return ConstraintSpec(
        enabled=bool(cfg.get("enabled", False)),
        overlap_max_iou=overlap,
        containment_parent=parent,
        containment_threshold=float(cfg.get("containment_threshold", 0.95)),
    )


def apply_spatial_constraints(inst: InstanceSet, image_hw, spec: ConstraintSpec, stride: int = 8) -> InstanceSet:
    """Overlap rules, then containment rules; identity when disabled."""
    if not spec.enabled:
        return inst
    dev = inst.boxes.device
    cls = inst.classes.long()
    lm = lowres_masks(inst, (int(image_hw[0]), int(image_hw[1])), stride)
    iou = mask_ops.mask_iou_matrix(lm, lm)

    overlap_thr = torch.as_tensor(spec.overlap_max_iou, device=dev)[cls]
    same_class = cls[:, None] == cls[None, :]
    keep = box_ops.nms_mask(
        inst.boxes, inst.scores, overlap_thr, valid=inst.valid, iou=torch.where(same_class, iou, 0.0)
    )
    inst = filter_instances(inst, keep)

    parent_of = torch.as_tensor(spec.containment_parent, device=dev).long()[cls]
    lm = lm & inst.valid[:, None, None]
    cont = mask_ops.mask_containment_matrix(lm, lm)  # [K,K] child x parent
    is_parent = (cls[None, :] == parent_of[:, None]) & inst.valid[None, :]
    best = torch.where(is_parent, cont, 0.0).amax(dim=1)
    keep = (parent_of < 0) | (best >= spec.containment_threshold)
    return filter_instances(inst, keep)

"""Weighted ensemble of several checkpoints (R101 and R50), the JAX
package's ``inference/ensemble.py``.

Every member's tile engine runs on the image in turn, on the one device;
the later members keep only the classes of ``secondary_class_filter`` when
given; each member's scores are multiplied by its weight; the sets are
concatenated to the capacity and deduplicated by class-aware mask IoU. A
member that raises is logged and skipped, as the JAX package does; the
names of the members that ran are returned beside the merged set, so a
caller can tell a one-member result from a full one.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deepemia_tpu_torch.inference.detections import (
    InstanceSet,
    concat_instances,
    dedup_by_mask_iou,
    empty_instances,
)
from deepemia_tpu_torch.inference.engine import ClassSettings, TileEngine

log = logging.getLogger("deepemia_tpu_torch.ensemble")


def run_ensemble(
    engines: Sequence[Tuple[str, TileEngine, float]],
    image,
    settings: ClassSettings,
    image_hw,
    dedup_iou: float = 0.4,
    apply_weights: bool = True,
    capacity: Optional[int] = None,
    secondary_class_filter=None,
    upscale=None,
) -> Tuple[InstanceSet, torch.Tensor, List[str]]:
    """Run the (name, engine, weight) members in order and fuse them.

    Returns (merged set, the last member's quality score, names of the
    members that ran). ``secondary_class_filter``: class ids the members
    after the first may contribute (``ensemble_settings.small_classes_only``:
    large classes come from the primary model alone).
    """
    parts: List[InstanceSet] = []
    ran: List[str] = []
    quality = torch.zeros(())
    cap = capacity or max(e.capacity for _, e, _ in engines)
    for member_idx, (name, engine, weight) in enumerate(engines):
        try:
            inst, quality = engine.infer(image, settings, upscale=upscale)
        except Exception as e:  # noqa: BLE001 - a failing member is skipped, as in the JAX package
            log.error("Ensemble member %s failed: %s", name, e)
            continue
        if secondary_class_filter is not None and member_idx > 0:
            allowed = torch.tensor(sorted(secondary_class_filter) or [-1], dtype=torch.int32, device=inst.classes.device)
            keep = (inst.classes[:, None] == allowed[None, :]).any(dim=1)
            inst = inst._replace(valid=inst.valid & keep)
        if apply_weights:
            inst = inst._replace(scores=inst.scores * float(weight))
        parts.append(inst)
        ran.append(name)
    if not parts:
        return empty_instances(cap, device=engines[0][1].device), quality, ran
    merged = concat_instances(parts, cap)
    merged = dedup_by_mask_iou(merged, image_hw, dedup_iou, class_aware=True)
    return merged, quality, ran


def weights_from_config(inference_settings: Dict) -> Dict[str, float]:
    """Member weights by model name (defaults R50 0.6, R101 0.4)."""
    w = inference_settings.get("ensemble_settings", {}).get("weights", {}) or {}
    return {"R50": float(w.get("R50", 0.6)), "R101": float(w.get("R101", 0.4))}

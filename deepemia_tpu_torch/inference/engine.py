"""Tile-based inference engine: one serving schedule for one model.

Per image: the quality score; a whole-image pass (native, downscaled, or
none — ``full_pass_max_dim``); tiles in chunks of ``tile_batch`` — x2
upscale, one batched trunk + FPN + RPN head, then proposals and RoI heads
batched over the chunk; edge filter and tile -> global coordinates; the
merge, per-class thresholds and the mask-IoU dedup.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepemia_tpu_torch import resolve_device
from deepemia_tpu_torch.config.constants import StaticShapes, TileDefaults
from deepemia_tpu_torch.inference.detections import (
    InstanceSet,
    concat_instances,
    dedup_by_mask_iou,
    empty_instances,
    filter_instances,
)
from deepemia_tpu_torch.models.heads import Detections
from deepemia_tpu_torch.models.mask_rcnn import MaskRCNN
from deepemia_tpu_torch.ops import masks as mask_ops
from deepemia_tpu_torch.ops import tiles as tile_ops
from deepemia_tpu_torch.ops.image import (
    adaptive_threshold_scale,
    image_quality_score,
    resize_image,
)


class ClassSettings(NamedTuple):
    """Per-class runtime thresholds, one entry per class."""

    confidence: torch.Tensor  # [C]
    nms_iou: torch.Tensor  # [C]
    min_size: torch.Tensor  # [C] pixels (area)


def class_settings_from_config(
    inference_settings: Dict[str, Any],
    num_classes: int,
    small_classes=None,
    device=None,
) -> ClassSettings:
    """Thresholds from the ``class_specific_settings`` of an inference
    config. With ``small_classes`` given, classes without explicit settings
    get confidence 0.3 / NMS 0.5 when small and 0.5 / 0.7 otherwise."""
    css = inference_settings.get("class_specific_settings", {})
    conf = np.full((num_classes,), 0.5, np.float32)
    nms = np.full((num_classes,), 0.5, np.float32)
    min_size = np.zeros((num_classes,), np.float32)
    for c in range(num_classes):
        s = css.get(f"class_{c}", {})
        if small_classes is None:
            conf_default, nms_default = 0.5, 0.5
        elif c in small_classes:
            conf_default, nms_default = 0.3, 0.5
        else:
            conf_default, nms_default = 0.5, 0.7
        conf[c] = s.get("confidence_threshold", conf_default)
        nms[c] = s.get("iou_threshold", nms_default)
        min_size[c] = s.get("min_size", 0)
    return ClassSettings(
        *(torch.as_tensor(a, device=device) for a in (conf, nms, min_size))
    )


def detections_to_instances(det: Detections) -> InstanceSet:
    return InstanceSet(det.boxes, det.scores, det.classes, det.valid, det.mask_probs)


def apply_class_thresholds(
    inst: InstanceSet, settings: ClassSettings, quality_scale: torch.Tensor
) -> InstanceSet:
    """Confidence gate (scaled by image quality) + min-area gate."""
    cls = inst.classes.long()
    keep = inst.scores >= settings.confidence[cls] * quality_scale
    w = (inst.boxes[:, 2] - inst.boxes[:, 0]).clamp(min=0.0)
    h = (inst.boxes[:, 3] - inst.boxes[:, 1]).clamp(min=0.0)
    area = inst.mask_probs.mean(dim=(1, 2)) * w * h
    keep &= area >= settings.min_size[cls]
    return filter_instances(inst, keep)


def cross_class_dedup(
    inst: InstanceSet, image_hw, iou_threshold: float = 0.7, stride: int = 8
) -> InstanceSet:
    """Class-agnostic mask-IoU dedup pass."""
    return dedup_by_mask_iou(inst, image_hw, iou_threshold, stride=stride, class_aware=False)


def _flatten(inst: InstanceSet) -> InstanceSet:
    """[B,D,...] per-tile sets -> one [B*D,...] set."""
    return InstanceSet(*(t.reshape(-1, *t.shape[2:]) for t in inst))


class TileEngine:
    """Runs the tiled serving path of one model on one device (``cuda``
    unless ``device`` names another; raises when CUDA is absent and the CPU
    was not asked for)."""

    def __init__(
        self,
        model: MaskRCNN,
        tile_size: int = TileDefaults.TILE_SIZE,
        overlap_ratio: float = TileDefaults.OVERLAP_RATIO,
        upscale_factor: float = TileDefaults.UPSCALE_FACTOR,
        edge_filter: bool = True,
        dedup_iou: float = 0.4,
        capacity: int = StaticShapes.MAX_INSTANCES_PER_IMAGE,
        use_tiling: bool = True,
        dedup_stride: int = 8,
        full_pass_max_dim: int = 2048,
        confidence_mode: str = "auto",
        tile_batch: int = 16,
        classes_using_tiling=None,
        device=None,
    ):
        """``full_pass_max_dim``: the whole-image pass runs at native
        resolution up to this long side and downscaled to it beyond; 0
        turns it off (tiles only) unless tiling is off or degenerate, when
        it is the only source of detections. ``classes_using_tiling``
        restricts tile-sourced detections to these class ids."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tile_size = tile_size
        self.overlap_ratio = overlap_ratio
        self.upscale_factor = upscale_factor
        self.edge_filter = edge_filter
        self.dedup_iou = dedup_iou
        self.capacity = capacity
        self.use_tiling = use_tiling
        self.dedup_stride = dedup_stride
        self.full_pass_max_dim = full_pass_max_dim
        self.confidence_mode = confidence_mode
        self.tile_batch = max(1, int(tile_batch))
        self.tiling_classes = (
            None if classes_using_tiling is None else tuple(int(c) for c in classes_using_tiling)
        )

    def _forward(self, image: torch.Tensor) -> InstanceSet:
        return detections_to_instances(self.model(image, score_threshold=0.05))

    def _finish_batch(
        self, inst_b: InstanceSet, offs_b, ok_b, ts: int, scale: float, h: int, w: int
    ) -> InstanceSet:
        """Edge filter + tile -> global coordinates over a [B,D,...] batch
        of per-tile sets. Instances at the global image border are never
        edge-filtered: their tile edge is the image edge."""
        local = inst_b.boxes / scale
        keep = torch.ones(local.shape[:2], dtype=torch.bool, device=local.device)
        if self.edge_filter:
            b, d = local.shape[:2]
            edge = mask_ops.is_edge_mask(local.reshape(-1, 4), ts, self.overlap_ratio)
            gx0 = local[..., 0] + offs_b[:, None, 0]
            gy0 = local[..., 1] + offs_b[:, None, 1]
            gx1 = local[..., 2] + offs_b[:, None, 0]
            gy1 = local[..., 3] + offs_b[:, None, 1]
            at_border = (gx0 <= 2.0) | (gy0 <= 2.0) | (gx1 >= w - 2.0) | (gy1 >= h - 2.0)
            keep = ~edge.reshape(b, d) | at_border
        if self.tiling_classes is not None:
            ids = torch.tensor(self.tiling_classes, dtype=torch.int32, device=local.device)
            keep = keep & (inst_b.classes[..., None] == ids).any(-1)
        gboxes = tile_ops.tile_boxes_to_global(inst_b.boxes, offs_b, scale=scale)
        return inst_b._replace(boxes=gboxes, valid=inst_b.valid & keep & ok_b[:, None])

    @torch.inference_mode()
    def infer(
        self,
        image,
        settings: ClassSettings,
        upscale: Optional[float] = None,
    ) -> Tuple[InstanceSet, torch.Tensor]:
        """[H,W,3] uint8/float BGR image -> (InstanceSet, quality). The image
        moves to the device in its own dtype (uint8 moves 4x less than f32).
        ``upscale`` overrides the tile upscale factor for this call."""
        image = torch.as_tensor(image).to(self.device)
        h, w = int(image.shape[0]), int(image.shape[1])
        ts = self.tile_size
        up = self.upscale_factor if upscale is None else upscale
        ts_up = int(round(ts * up))
        ts_up -= ts_up % 64  # model inputs must be /64 for p6
        grid = tile_ops.compute_tile_grid(h, w, ts, self.overlap_ratio)
        tiling = self.use_tiling and grid.num_tiles > 1
        full_pass = self.full_pass_max_dim > 0 or not tiling
        native_full = max(h, w) <= self.full_pass_max_dim or not tiling

        quality = image_quality_score(image)
        if self.confidence_mode == "manual":
            qscale = torch.ones((), device=self.device)
        else:
            qscale = adaptive_threshold_scale(quality)

        parts = []
        if full_pass and native_full:
            padded = F.pad(image, (0, 0, 0, (-w) % 64, 0, (-h) % 64))
            parts.append(self._forward(padded))
        elif full_pass:
            ds = self.full_pass_max_dim / max(h, w)
            dh = max(64, int(round(h * ds / 64)) * 64)
            dw = max(64, int(round(w * ds / 64)) * 64)
            inst = self._forward(resize_image(image, dh, dw))
            back = torch.tensor([w / dw, h / dh, w / dw, h / dh], device=self.device)
            parts.append(inst._replace(boxes=inst.boxes * back))
        if tiling:
            tiles = tile_ops.extract_tiles(image, grid)
            offsets = torch.as_tensor(grid.offsets, dtype=torch.float32, device=self.device)
            scale = ts_up / ts
            for a in range(0, grid.num_tiles, self.tile_batch):
                tc = tiles[a : a + self.tile_batch].float()
                if ts_up != ts:
                    tc = resize_image(tc, ts_up, ts_up)
                feats = self.model.features_batched(tc)
                det = self.model.detect_batched(feats, (ts_up, ts_up), score_threshold=0.05)
                offs = offsets[a : a + self.tile_batch]
                ok = torch.ones(offs.shape[0], dtype=torch.bool, device=self.device)
                inst_b = self._finish_batch(
                    detections_to_instances(det), offs, ok, ts, scale, h, w
                )
                parts.append(_flatten(inst_b))
        if not parts:
            parts = [empty_instances(self.capacity, device=self.device)]

        merged = concat_instances(parts, self.capacity)
        merged = apply_class_thresholds(merged, settings, qscale)
        stride = max(self.dedup_stride, -(-max(h, w) // 512))
        merged = dedup_by_mask_iou(merged, (h, w), self.dedup_iou, stride=stride, class_aware=True)
        return merged, quality

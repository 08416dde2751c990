"""Multi-scale and iterative inference modes, and the size heuristics.

  * ``run_multiscale_inference``: the engine runs on the image resized to
    each scale of a ladder (geometry rounded to /64), boxes map back by the
    actual resize ratio, and a class-aware mask-IoU dedup merges the scales.
    The image resizes on its device, bilinear without antialiasing.
  * ``iterative_threshold_inference``: one forward pass at the floor
    threshold, then a host walk down a per-class threshold ladder with the
    stopping rules (min_total_masks, min_relative_increase,
    max_consecutive_zero, min_iterations).
  * size heuristics: the average confident-mask area per class over a few
    sample images; classes at or below the median are "small", and classes
    below an absolute area need the tile upscale.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepemia_tpu_torch.inference.detections import (
    InstanceSet,
    concat_instances,
    dedup_by_mask_iou,
    filter_instances,
)
from deepemia_tpu_torch.inference.engine import ClassSettings, TileEngine
from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from deepemia_tpu_torch.parallel import ranks as rank_ops

BASELINE_SCALES = (0.7, 1.0, 1.5, 2.0)
AGGRESSIVE_SCALES = (1.0, 1.5, 2.0, 2.5, 3.0)


def resize_linear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H,W,C] -> float32 [height,width,C]: bilinear, half-pixel centres, no
    antialiasing on downscale (``jax.image.resize(..., "linear",
    antialias=False)``)."""
    x = image.float().permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0)


def run_multiscale_inference(
    engine: TileEngine,
    image,
    settings: ClassSettings,
    scales: Sequence[float] = BASELINE_SCALES,
    dedup_iou: float = 0.4,
    max_scale: float = 3.0,
    upscale=None,
) -> Tuple[InstanceSet, torch.Tensor]:
    """Run the engine at every scale and merge. ``image`` [H,W,3] moves to
    the engine's device once and resizes there for each scale."""
    image = torch.as_tensor(image).to(engine.device)
    h, w = int(image.shape[0]), int(image.shape[1])
    parts: List[InstanceSet] = []
    quality = None
    for s in scales:
        s = min(float(s), max_scale)
        nh = max(64, int(round(h * s / 64)) * 64)
        nw = max(64, int(round(w * s / 64)) * 64)
        inst, quality = engine.infer(resize_linear(image, nh, nw), settings, upscale=upscale)
        sx, sy = w / nw, h / nh
        ratio = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=engine.device)
        parts.append(inst._replace(boxes=inst.boxes * ratio))
    merged = concat_instances(parts, parts[0].capacity)
    merged = dedup_by_mask_iou(merged, (h, w), dedup_iou, class_aware=True)
    return merged, quality


def iterative_threshold_inference(
    inst_at_floor: InstanceSet,
    base_threshold,
    floor_threshold: float = 0.2,
    num_steps: int = 5,
    min_total_masks: int = 10,
    min_relative_increase: float = 0.25,
    max_consecutive_zero: int = 1,
    min_iterations: int = 2,
) -> Tuple[InstanceSet, Dict]:
    """Walk a descending threshold ladder per class over the detections of
    one forward pass at ``floor_threshold``; ``base_threshold`` is a scalar
    or per-class [C]. Returns the instances above each class's final
    threshold and a diagnostic dict."""
    packed = torch.stack(
        [inst_at_floor.scores.float(), inst_at_floor.valid.float(), inst_at_floor.classes.float()]
    ).cpu().numpy()  # one device -> host copy
    scores = packed[0]
    valid = packed[1] != 0.0
    classes = packed[2].astype(np.int32)
    bases = np.atleast_1d(np.asarray(base_threshold, np.float64))
    present = sorted(set(classes[valid].tolist())) or [0]
    final_thr: Dict[int, float] = {}
    history = []
    for c in present:
        base_c = float(bases[c]) if c < len(bases) else float(bases[-1])
        # the ladder descends from the class base; a base at or below the
        # floor keeps everything the engine admitted
        ladder = np.linspace(base_c, min(floor_threshold, base_c), num_steps)
        cls_mask = (classes == c) & valid
        count_prev = 0
        consecutive_zero = 0
        thr_c = float(ladder[0])
        for it, thr in enumerate(ladder):
            count = int((scores[cls_mask] >= thr).sum())
            gained = count - count_prev
            history.append({"class": int(c), "iteration": it, "threshold": float(thr), "count": count})
            thr_c = float(thr)
            if it + 1 >= min_iterations:
                if count >= min_total_masks and gained / max(count_prev, 1) < min_relative_increase:
                    break
                if gained == 0:
                    consecutive_zero += 1
                    if consecutive_zero > max_consecutive_zero:
                        break
                else:
                    consecutive_zero = 0
            count_prev = count
        final_thr[int(c)] = thr_c
    thr_vec = np.array([final_thr.get(int(c), float(bases[-1])) for c in classes], np.float32)
    keep = torch.from_numpy((scores >= thr_vec) & valid).to(inst_at_floor.valid.device)
    return filter_instances(inst_at_floor, keep), {"final_threshold": final_thr, "history": history}


def calculate_average_mask_sizes(
    engine: TileEngine,
    image_paths: Sequence[str],
    settings: ClassSettings,
    confidence: float = 0.7,
    sample_size: int = 5,
) -> Dict[int, float]:
    """Average confident-instance area per class over a small sample of
    images (RoI mask fraction x box area); images OpenCV cannot read
    either are skipped (in a process group, those any rank cannot read),
    and one OpenCV reads that the port does not decode raises."""
    sizes: Dict[int, List[float]] = {}
    for path in list(image_paths)[:sample_size]:
        try:
            img = read_image(str(path))
        except UnsupportedImageError:
            raise
        except (OSError, ValueError):
            img = None
        if not rank_ops.agree(img is not None):
            continue
        inst, _ = engine.infer(img, settings)
        b = inst.boxes
        areas = inst.mask_probs.mean(dim=(1, 2)) * (b[:, 2] - b[:, 0]).clamp(min=0.0) * (b[:, 3] - b[:, 1]).clamp(
            min=0.0
        )
        packed = torch.stack(
            [inst.scores.float(), inst.valid.float(), inst.classes.float(), areas.float()]
        ).cpu().numpy()  # one device -> host copy
        valid = (packed[1] != 0.0) & (packed[0] >= confidence)
        for c, a in zip(packed[2][valid].astype(np.int32), packed[3][valid]):
            sizes.setdefault(int(c), []).append(float(a))
    return {c: float(np.mean(v)) for c, v in sizes.items() if v}


def classes_needing_upscale(class_avg_sizes: Dict[int, float], min_area: float = 1024.0) -> Set[int]:
    """Classes whose average instance area is below an absolute cutoff
    (default 32² px², COCO's small-object bound)."""
    return {c for c, s in class_avg_sizes.items() if s < min_area}


def determine_small_classes(class_avg_sizes: Dict[int, float], threshold_percentile: float = 50) -> Set[int]:
    """Classes at or below the percentile of the average sizes are
    'small'."""
    if not class_avg_sizes:
        return set()
    threshold = np.percentile(list(class_avg_sizes.values()), threshold_percentile)
    return {c for c, s in class_avg_sizes.items() if s <= threshold}

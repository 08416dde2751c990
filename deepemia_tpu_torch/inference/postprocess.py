"""Morphological mask postprocessing on InstanceSets, batched over
instances.

``morphology_postprocess``: every instance's RoI probabilities paste into a
fixed S×S window at native pixel scale (shrink-to-fit for boxes longer than
S-4), holes fill, small classes erode and large classes open with a 3x3
square, a class-aware minimum size gates at native-scale pixel counts, and
the cleaned mask re-encodes to the RoI grid by a single-level RoIAlign (the
plain ``roi_align_level``, as the JAX package does). Objects larger than
the window keep the hole fill and skip the 1-px opening.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import torch

from deepemia_tpu_torch.inference.detections import InstanceSet, filter_instances
from deepemia_tpu_torch.models.roi_align import roi_align_level
from deepemia_tpu_torch.ops import masks as mask_ops


def window_geometry(boxes: torch.Tensor, window: int):
    """Boxes [K,4] -> (scale [K], origin [K,2] (x, y), window boxes [K,4]):
    the shrink-to-fit scale min(1, (S-4)/long side), the integer window
    origin that centres the scaled box, and the box in window coordinates.
    All in float32, as the JAX package computes them (a float64 origin
    moves windows by a pixel)."""
    x0, y0, x1, y1 = boxes.unbind(1)
    bw = (x1 - x0).clamp(min=1e-4)
    bh = (y1 - y0).clamp(min=1e-4)
    long_side = torch.maximum(bw, bh)
    # a true division: ``scalar / tensor`` multiplies by the reciprocal
    scale = (torch.full_like(long_side, window - 4.0) / long_side).clamp(max=1.0)
    ox = torch.floor((x0 + x1) / 2.0 * scale - window / 2.0)
    oy = torch.floor((y0 + y1) / 2.0 * scale - window / 2.0)
    wbox = torch.stack([x0 * scale - ox, y0 * scale - oy, x1 * scale - ox, y1 * scale - oy], dim=1)
    return scale, torch.stack([ox, oy], dim=1), wbox


def morphology_postprocess(
    inst: InstanceSet,
    image_hw: Tuple[int, int],
    small_classes: Optional[Set[int]] = None,
    min_size_small: Optional[float] = None,
    min_size_large: Optional[float] = None,
    mask_threshold: float = 0.5,
    window: int = 128,
    res_out: Optional[int] = None,
) -> InstanceSet:
    """Fill holes; small classes erode only, large classes open; size gate
    small max(3, 5e-6·area) / large max(25, 1e-4·area) unless given.
    ``res_out`` defaults to twice the incoming RoI resolution (at most 64)."""
    h, w = image_hw
    image_area = float(h * w)
    if min_size_small is None or min_size_small <= 0:
        min_size_small = max(3.0, image_area * 0.000005)
    if min_size_large is None or min_size_large <= 0:
        min_size_large = max(25.0, image_area * 0.0001)
    small = small_classes or set()
    if res_out is None:
        res_out = min(2 * inst.mask_probs.shape[-1], 64)
    dev = inst.boxes.device
    n_tab = (max(small) + 2) if small else 2
    is_small_tab = torch.tensor([c in small for c in range(n_tab)], device=dev)
    k = inst.capacity

    scale, _, wbox = window_geometry(inst.boxes, window)
    win = mask_ops.paste_masks(inst.mask_probs, wbox, window, window, mask_threshold)
    win &= inst.valid[:, None, None]
    filled = mask_ops.fill_holes(win)
    eroded = mask_ops.binary_erode(filled, 1)
    opened = mask_ops.binary_dilate(eroded, 1)
    small_flag = is_small_tab[inst.classes.long().clamp(0, n_tab - 1)]
    morphed = torch.where(small_flag[:, None, None], eroded, opened)
    final = torch.where((scale >= 1.0)[:, None, None], morphed, filled)
    size = final.sum(dim=(1, 2)).float() / (scale * scale)
    min_size = torch.where(
        small_flag,
        torch.tensor(min_size_small, dtype=torch.float32, device=dev),
        torch.tensor(min_size_large, dtype=torch.float32, device=dev),
    )
    ok = inst.valid & (size >= min_size)
    new_probs = roi_align_level(
        final.float()[..., None],
        wbox,
        stride=1,
        output_size=int(res_out),
        sampling_ratio=2,
        batch_idx=torch.arange(k, device=dev),
    )[..., 0]
    return filter_instances(inst._replace(mask_probs=new_probs), ok)


def reject_fragmented_masks(
    inst: InstanceSet,
    image_hw: Tuple[int, int],
    max_components: int = 1,
    mask_threshold: float = 0.5,
    chunk: int = 8,
) -> InstanceSet:
    """Invalidate instances whose full-resolution mask has more than
    ``max_components`` 8-connected components, or none. Pastes ``chunk``
    instances at a time."""
    h, w = image_hw
    ok = []
    for s in range(0, inst.capacity, chunk):
        full = mask_ops.paste_masks(inst.mask_probs[s : s + chunk], inst.boxes[s : s + chunk], h, w, mask_threshold)
        full &= inst.valid[s : s + chunk, None, None]
        n = mask_ops.num_components(full)
        ok.append((n <= max_components) & (n > 0))
    keep = torch.cat(ok) if ok else inst.valid
    return filter_instances(inst, keep)

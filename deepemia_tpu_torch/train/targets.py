"""Training target assignment: anchor / proposal matching and static
subsampling (counterpart of the JAX package's ``train/targets.py``).

Detectron2 defaults:

  * RPN matcher: IoU >= 0.7 positive, <= 0.3 negative, in between ignored,
    plus low-quality matches (every GT's best anchors become positive);
  * RoI matcher: IoU >= 0.5 positive, else background (no ignore band);
  * subsampling to fixed counts with a positive fraction: top-k over random
    priorities with validity masks, so every shape is static.

Random priorities come from a ``torch.Generator``; callers may pass the
draws instead (``pos_rand`` / ``neg_rand``), which is how the tests feed
both packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepemia_tpu_torch.ops import boxes as box_ops


class MatchResult(NamedTuple):
    gt_index: torch.Tensor  # [N] best-matching GT row (0 if none), int64
    labels: torch.Tensor  # [N] 1 fg / 0 bg / -1 ignore, int64


def match_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_threshold: float = 0.7,
    neg_threshold: float = 0.3,
    allow_low_quality: bool = True,
) -> MatchResult:
    """Match [N] anchors against padded [G] GT boxes."""
    iou = box_ops.box_iou_matrix(anchors, gt_boxes)  # [N,G]
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best_iou = iou.amax(dim=1)
    gt_index = iou.argmax(dim=1)  # the first of tied maxima, as jnp.argmax
    one, zero = torch.ones_like(gt_index), torch.zeros_like(gt_index)
    labels = torch.where(
        best_iou >= pos_threshold, one, torch.where(best_iou <= neg_threshold, zero, -one)
    )
    if allow_low_quality:
        # every valid GT's best anchor(s) become positive, ties included
        per_gt_best = torch.where(gt_valid, iou.amax(dim=0), -2.0)  # [G]
        is_best = (iou >= per_gt_best[None, :] - 1e-7) & gt_valid[None, :] & (iou > 0)
        labels = torch.where(is_best.any(dim=1), one, labels)
    # no valid GT at all: every anchor is negative
    labels = torch.where(gt_valid.any(), labels, zero)
    return MatchResult(gt_index=gt_index, labels=labels)


def match_proposals(
    proposals: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    iou_threshold: float = 0.5,
) -> MatchResult:
    """RoI-head matching: foreground at IoU >= 0.5, else background."""
    iou = box_ops.box_iou_matrix(proposals, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    return MatchResult(
        gt_index=iou.argmax(dim=1),
        labels=(iou.amax(dim=1) >= iou_threshold).long(),
    )


class SampleResult(NamedTuple):
    idx: torch.Tensor  # [S] sampled row indices
    is_pos: torch.Tensor  # [S] bool
    valid: torch.Tensor  # [S] bool (row takes part in the loss)


def subsample(
    labels: torch.Tensor,
    num_samples: int,
    pos_fraction: float = 0.5,
    extra_valid: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    pos_rand: torch.Tensor | None = None,
    neg_rand: torch.Tensor | None = None,
) -> SampleResult:
    """Sample ``num_samples`` rows with at most ``pos_fraction`` positives
    (Detectron2 subsample_labels), as padded static-width indices.

    labels: 1 fg / 0 bg / -1 ignore. The first ``num_samples *
    pos_fraction`` slots hold positives in random order, the rest
    negatives; a slot is valid only if a real row landed in it. The random
    priorities are ``pos_rand`` / ``neg_rand`` [N] in [0, 1) when given,
    else two draws of ``torch.rand`` from ``generator`` (positives first).
    Ties, including the -inf of rows that cannot be drawn, go to the lower
    index, as ``jax.lax.top_k`` breaks them."""
    n = labels.shape[0]
    dev = labels.device
    ok = torch.ones(n, dtype=torch.bool, device=dev) if extra_valid is None else extra_valid
    if pos_rand is None:
        pos_rand = torch.rand(n, generator=generator, device=dev)
    if neg_rand is None:
        neg_rand = torch.rand(n, generator=generator, device=dev)
    k_pos = int(num_samples * pos_fraction)
    k_neg = num_samples - k_pos
    pos_key = torch.where((labels == 1) & ok, pos_rand, float("-inf"))
    neg_key = torch.where((labels == 0) & ok, neg_rand, float("-inf"))
    k_pos, k_neg = min(k_pos, n), min(k_neg, n)
    pos_vals, pos_idx = box_ops.stable_topk(pos_key, k_pos)
    neg_vals, neg_idx = box_ops.stable_topk(neg_key, k_neg)
    return SampleResult(
        idx=torch.cat([pos_idx, neg_idx]),
        is_pos=torch.cat(
            [torch.ones(k_pos, dtype=torch.bool, device=dev), torch.zeros(k_neg, dtype=torch.bool, device=dev)]
        ),
        valid=torch.cat([torch.isfinite(pos_vals), torch.isfinite(neg_vals)]),
    )

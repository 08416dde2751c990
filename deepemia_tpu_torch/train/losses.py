"""Mask R-CNN training losses over a batch of images, statically shaped
(counterpart of the JAX package's ``train/losses.py``).

RPN objectness BCE + box L1 on sampled anchors, RoI softmax CE +
class-specific box L1, mask BCE on foreground proposals, each over padded
samples with validity masks and normalised by the image's own valid count.
The batch runs as one trunk / FPN / RPN pass and one RoIAlign launch per
stage (RoIs carry their image index); every term keeps its per-image
normaliser, and the batch value of a term is the mean over images — what
the JAX trainer's ``vmap`` over images followed by ``mean`` computes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from deepemia_tpu_torch.config.constants import StaticShapes
from deepemia_tpu_torch.models import anchors as anchor_lib
from deepemia_tpu_torch.models.anchors import LEVELS
from deepemia_tpu_torch.models.mask_rcnn import MaskRCNN
from deepemia_tpu_torch.models.roi_align import roi_align_level
from deepemia_tpu_torch.models.rpn import select_proposals_batched
from deepemia_tpu_torch.ops import boxes as box_ops
from deepemia_tpu_torch.train import targets as T

RPN_BATCH = 256
RPN_POS_FRACTION = 0.5
ROI_BATCH = 512
ROI_POS_FRACTION = 0.25
MASK_ROIS = 128  # = ROI_BATCH * ROI_POS_FRACTION slots (positives first)
MASK_SIZE = StaticShapes.MASK_RESOLUTION
COMPONENTS = ("rpn_cls", "rpn_loc", "cls", "box", "mask")


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1; ``torch.abs`` gives 0). With the
    box regression zeroed, the appended GT rows sit exactly at 0."""
    return torch.where(x >= 0, x, -x)


def smooth_l1(x: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    """Detectron2 smooth_l1_loss (beta = 0: plain L1, the default)."""
    ax = _abs(x)
    if beta <= 0:
        return ax
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # torch.maximum splits the gradient of a tie as jnp.maximum does
    return torch.maximum(logits, torch.zeros_like(logits)) - logits * labels + torch.log1p(
        torch.exp(-_abs(logits))
    )


class Draws(NamedTuple):
    """One image's sampling priorities in [0, 1): anchors (RPN) and
    proposals + GT (RoI heads), for the positive and the negative pick."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_pos: torch.Tensor
    roi_neg: torch.Tensor


def rpn_losses(
    logits: Dict[str, torch.Tensor],
    regs: Dict[str, torch.Tensor],
    anchors: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    num_samples: int = RPN_BATCH,
    generator: torch.Generator | None = None,
    pos_rand: torch.Tensor | None = None,
    neg_rand: torch.Tensor | None = None,
) -> Dict[str, torch.Tensor]:
    """One image: logits {lv: [h,w,A]}, regs {lv: [h,w,A*4]}, anchors
    {lv: [h*w*A,4]}, padded GT [G,4] / [G] -> {rpn_cls, rpn_loc}."""
    flat_logits = torch.cat([logits[lv].reshape(-1) for lv in LEVELS if lv in logits]).float()
    flat_regs = torch.cat([regs[lv].reshape(-1, 4) for lv in LEVELS if lv in regs]).float()
    flat_anchors = torch.cat([anchors[lv] for lv in LEVELS if lv in anchors])

    match = T.match_anchors(flat_anchors, gt_boxes, gt_valid)
    sample = T.subsample(
        match.labels, num_samples, RPN_POS_FRACTION,
        generator=generator, pos_rand=pos_rand, neg_rand=neg_rand,
    )
    s_valid = sample.valid
    normalizer = s_valid.sum().clamp(min=1).float()
    cls_loss = (bce_with_logits(flat_logits[sample.idx], sample.is_pos.float()) * s_valid).sum() / normalizer

    pos = sample.is_pos & s_valid
    delta_targets = box_ops.get_deltas(
        flat_anchors[sample.idx], gt_boxes[match.gt_index[sample.idx]], weights=(1.0, 1.0, 1.0, 1.0)
    )
    loc = (smooth_l1(flat_regs[sample.idx] - delta_targets).sum(dim=-1) * pos).sum() / normalizer
    return {"rpn_cls": cls_loss, "rpn_loc": loc}


class GroundTruth(NamedTuple):
    """Padded GT of a batch: boxes [B,G,4] XYXY float32, classes [B,G]
    int64, valid [B,G] bool, masks [B,G,H,W] bool (full resolution)."""

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: torch.Tensor


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B,N,...], idx [B,K] -> [B,K,...]."""
    idx = idx.reshape(*idx.shape, *([1] * (x.ndim - 2)))
    return torch.gather(x, 1, idx.expand(*idx.shape[:2], *x.shape[2:]))


def gt_mask_targets(masks: torch.Tensor, boxes: torch.Tensor, gt_index: torch.Tensor) -> torch.Tensor:
    """28x28 mask targets: RoIAlign of each RoI's matched GT mask on its box
    (stride 1), thresholded at 0.5. masks [B,G,H,W] bool, boxes [B,M,4],
    gt_index [B,M] -> [B,M,28,28] bool."""
    bsz, g, h, w = masks.shape
    m = boxes.shape[1]
    mask_idx = (torch.arange(bsz, device=boxes.device)[:, None] * g + gt_index).reshape(-1)
    crops = roi_align_level(
        masks.reshape(bsz * g, h, w, 1), boxes.reshape(-1, 4), stride=1,
        output_size=MASK_SIZE, batch_idx=mask_idx,
    )
    return (crops[..., 0] >= 0.5).reshape(bsz, m, MASK_SIZE, MASK_SIZE)


def maskrcnn_loss(
    model: MaskRCNN,
    images: torch.Tensor,
    gt: GroundTruth,
    generators: Sequence[torch.Generator] | None = None,
    draws: Sequence[Draws] | None = None,
    pre_nms_topk: int = StaticShapes.PRE_NMS_TOPK_TRAIN,
    post_nms_topk: int = StaticShapes.POST_NMS_TOPK_TRAIN,
    rpn_batch: int = RPN_BATCH,
    roi_batch: int = ROI_BATCH,
    mask_rois: int = MASK_ROIS,
) -> Dict[str, torch.Tensor]:
    """Training loss of a batch: images [B,H,W,3] raw BGR (uint8 or
    float), padded GT -> {rpn_cls, rpn_loc, cls, box, mask, total}, each
    the mean over images of the per-image term.

    Sampling priorities are ``draws`` (one per image) when given, else
    drawn from ``generators`` (one per image; torch's default generator
    without them): per image, RPN positives, RPN negatives, RoI positives,
    RoI negatives. The static capacities are parameters so that small-shape
    runs stay fast; the defaults are Detectron2's."""
    num_classes = model.num_classes
    bsz, h, w = images.shape[:3]
    dev = images.device

    feats = model.features_batched(images)
    logits, regs = model.rpn_forward(feats)
    anchors = anchor_lib.all_anchors({k: (v.shape[2], v.shape[3]) for k, v in feats.items()}, device=dev)
    proposals = select_proposals_batched(
        logits, regs, anchors, (h, w), pre_nms_topk=pre_nms_topk, post_nms_topk=post_nms_topk
    )
    # proposals are constants of the loss (Detectron2 detaches them); the
    # GT boxes are appended to them
    prop_boxes = torch.cat([proposals.boxes, gt.boxes.float()], dim=1).detach()
    prop_valid = torch.cat([proposals.valid, gt.valid], dim=1)

    rpn_cls, rpn_loc = [], []
    s_idx, s_pos, s_valid, gt_index = [], [], [], []
    for b in range(bsz):
        d = draws[b] if draws is not None else Draws(None, None, None, None)
        gen = generators[b] if generators is not None else None
        rpn = rpn_losses(
            {k: v[b] for k, v in logits.items()}, {k: v[b] for k, v in regs.items()}, anchors,
            gt.boxes[b], gt.valid[b], rpn_batch, gen, d.rpn_pos, d.rpn_neg,
        )
        rpn_cls.append(rpn["rpn_cls"])
        rpn_loc.append(rpn["rpn_loc"])
        match = T.match_proposals(prop_boxes[b], gt.boxes[b], gt.valid[b])
        sample = T.subsample(
            match.labels, roi_batch, ROI_POS_FRACTION, extra_valid=prop_valid[b],
            generator=gen, pos_rand=d.roi_pos, neg_rand=d.roi_neg,
        )
        s_idx.append(sample.idx)
        s_pos.append(sample.is_pos)
        s_valid.append(sample.valid)
        gt_index.append(match.gt_index)
    s_idx, s_pos, s_valid = torch.stack(s_idx), torch.stack(s_pos), torch.stack(s_valid)
    s_boxes = _rows(prop_boxes, s_idx)  # [B,R,4]
    s_gt_idx = _rows(torch.stack(gt_index), s_idx)  # [B,R]
    s_fg = s_pos & s_valid
    normalizer = s_valid.sum(dim=1).clamp(min=1).float()
    r = s_boxes.shape[1]

    scores, deltas = model.box_forward(
        feats, s_boxes.reshape(-1, 4), torch.arange(bsz, device=dev).repeat_interleave(r)
    )
    # classification: foreground -> its GT class, background -> num_classes
    cls_target = torch.where(s_fg, _rows(gt.classes.long(), s_gt_idx), num_classes)
    log_probs = F.log_softmax(scores.float().reshape(bsz, r, -1), dim=-1)
    ce = -log_probs.gather(2, cls_target[..., None])[..., 0]
    cls_loss = (ce * s_valid).sum(dim=1) / normalizer

    # class-specific box regression on foreground rows
    delta_targets = box_ops.get_deltas(s_boxes, _rows(gt.boxes.float(), s_gt_idx))
    sel = cls_target.clamp(0, num_classes - 1)
    per_class = deltas.float().reshape(bsz, r, num_classes, 4)
    picked = per_class.gather(2, sel[..., None, None].expand(bsz, r, 1, 4))[:, :, 0]
    box_loss = (smooth_l1(picked - delta_targets).sum(dim=-1) * s_fg).sum(dim=1) / normalizer

    # mask head on the positives-first slot prefix
    m = min(mask_rois, r)
    m_boxes, m_fg, m_cls = s_boxes[:, :m], s_fg[:, :m], sel[:, :m]
    mask_logits = model.mask_forward(
        feats, m_boxes.reshape(-1, 4), torch.arange(bsz, device=dev).repeat_interleave(m)
    )  # [B*M,num_classes,28,28]
    picked_mask = mask_logits.float().gather(
        1, m_cls.reshape(-1)[:, None, None, None].expand(-1, 1, MASK_SIZE, MASK_SIZE)
    )[:, 0].reshape(bsz, m, MASK_SIZE, MASK_SIZE)
    targets = gt_mask_targets(gt.masks, m_boxes, s_gt_idx[:, :m])
    mask_bce = bce_with_logits(picked_mask, targets.float()).mean(dim=(2, 3))
    mask_loss = (mask_bce * m_fg).sum(dim=1) / m_fg.sum(dim=1).clamp(min=1).float()

    losses = dict(
        rpn_cls=torch.stack(rpn_cls), rpn_loc=torch.stack(rpn_loc),
        cls=cls_loss, box=box_loss, mask=mask_loss,
    )
    total = sum(losses[k] for k in COMPONENTS)
    out = {k: losses[k].mean() for k in COMPONENTS}
    out["total"] = total.mean()
    return out

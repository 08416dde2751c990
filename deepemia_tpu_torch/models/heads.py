"""RoI box and mask heads with padded inference post-processing
(Detectron2's StandardROIHeads / FastRCNNOutputLayers /
MaskRCNNConvUpsampleHead semantics on fixed-capacity tensors).

The batched entry points take a leading image axis: the RoIs of every image
in a tile batch are pooled by one RoIAlign call, run through the heads as
one matrix, and suppressed by one batched NMS.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepemia_tpu_torch.config.constants import StaticShapes
from deepemia_tpu_torch.models.roi_align import roi_align_dispatch
from deepemia_tpu_torch.parallel import ranks as rank_ops
from deepemia_tpu_torch.parallel.mesh import partition_devices
from deepemia_tpu_torch.ops import boxes as box_ops


def block_bounds(size: int, index: int, n: int):
    """(start, stop) of block ``index`` of ``range(size)`` split as
    :func:`partition_devices` splits devices (contiguous, sizes differing
    by at most one, earlier blocks larger)."""
    block = partition_devices(range(size), n)[index]
    return block[0], block[-1] + 1


class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: the identity forward, the
    gradient summed over the model group backward (each rank's block of
    the layer adds its share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return rank_ops.all_reduce(grad, group=ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The output of a row-parallel layer: the blocks' partial products
    summed over the model group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return rank_ops.all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class BoxHead(nn.Module):
    """Flatten (C,H,W order) -> FC 1024 -> FC 1024 (FastRCNNConvFCHead).

    Tensor-parallel after :meth:`shard` (the JAX trainer's ``model`` axis,
    ``_tp_spec_for_path``): each rank of a model group keeps one block of
    fc1's outputs (column-parallel) and the matching block of fc2's inputs
    (row-parallel); fc2's partial products are summed over the group
    before its bias, which is added once. Only the two weight matrices are
    split; the biases stay whole (fc1's block of its bias is used), as
    every other parameter is."""

    # the split parameters and the axis of each that is split
    SPLIT = {"fc1.weight": 0, "fc2.weight": 1}

    def __init__(self, in_channels: int = 256, resolution: int = 7, fc_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_channels * resolution * resolution, fc_dim)
        self.fc2 = nn.Linear(fc_dim, fc_dim)
        self.fc_dim = fc_dim
        self.model_group = None
        self.index, self.n_blocks = 0, 1

    def shard(self, group, index: int, n: int) -> None:
        """Keep block ``index`` of ``n`` (this rank's place in the model
        ``group``) of the two weight matrices, in place. Each split
        parameter is marked ``model_split = "block"``, fc1's bias, whose
        gradient the group's blocks add up, ``"sum"``."""
        self.model_group, self.index, self.n_blocks = group, index, n
        for name in self.SPLIT:
            fc = getattr(self, name.split(".")[0])
            whole = fc.weight
            fc.weight = nn.Parameter(self.block_of(name, whole.detach()).clone(), requires_grad=whole.requires_grad)
            fc.weight.model_split = "block"
        self.fc1.bias.model_split = "sum"

    def _sizes(self):
        return [b - a for a, b in (block_bounds(self.fc_dim, i, self.n_blocks) for i in range(self.n_blocks))]

    def block_of(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole ``name``-shaped tensor (the
        parameter, or its momentum)."""
        a, b = block_bounds(self.fc_dim, self.index, self.n_blocks)
        return whole.narrow(self.SPLIT[name], a, b - a)

    def gather(self, name: str, block: torch.Tensor) -> torch.Tensor:
        """The whole ``name``-shaped tensor from the model group's blocks of
        it (every rank of the group calls this)."""
        dim, sizes = self.SPLIT[name], self._sizes()
        shape = list(block.shape)
        shape[dim] = max(sizes)
        padded = block.new_zeros(shape)
        padded.narrow(dim, 0, block.shape[dim]).copy_(block)
        parts = rank_ops.all_gather(padded, group=self.model_group)
        return torch.cat([t.narrow(dim, 0, n) for t, n in zip(parts, sizes)], dim=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N,7,7,C]
        x = x.permute(0, 3, 1, 2).flatten(1)
        if self.model_group is None:
            return F.relu(self.fc2(F.relu(self.fc1(x))))
        a, b = block_bounds(self.fc_dim, self.index, self.n_blocks)
        h = F.relu(F.linear(_CopyToModel.apply(x, self.model_group), self.fc1.weight, self.fc1.bias[a:b]))
        partial = F.linear(h, self.fc2.weight)
        # summed in float32 whatever autocast computes in
        y = _ReduceFromModel.apply(partial.float(), self.model_group) + self.fc2.bias.float()
        return F.relu(y).to(partial.dtype)


class BoxPredictor(nn.Module):
    """Class logits (num_classes + 1, background last) + per-class deltas."""

    def __init__(self, num_classes: int, in_dim: int = 1024):
        super().__init__()
        self.cls_score = nn.Linear(in_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(in_dim, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """4 3x3 convs + 2x2/2 transposed conv + 1x1 per-class mask logits."""

    def __init__(self, num_classes: int, in_channels: int = 256, conv_dim: int = 256):
        super().__init__()
        cin = in_channels
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", nn.Conv2d(cin, conv_dim, 3, padding=1))
            cin = conv_dim
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N,14,14,C] -> [N,num_classes,28,28] logits."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class Detections(NamedTuple):
    """Padded detections ([..., D] rows with a valid mask)."""

    boxes: torch.Tensor  # [..., D, 4]
    scores: torch.Tensor  # [..., D]
    classes: torch.Tensor  # [..., D] int32
    valid: torch.Tensor  # [..., D] bool
    mask_probs: torch.Tensor  # [..., D, 28, 28] sigmoid probabilities


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B,N,...], idx [B,K] -> [B,K,...]."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.ndim - 2))).expand(
        *idx.shape, *x.shape[2:]))


def fast_rcnn_inference_batched(
    scores: torch.Tensor,
    deltas: torch.Tensor,
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    image_hw,
    score_threshold: float,
    nms_threshold: float = 0.5,
    max_detections: int = StaticShapes.MAX_DETECTIONS,
):
    """Per-class decode + threshold + NMS + top-K over B images.

    scores [B,N,C+1] logits, deltas [B,N,C*4], proposals [B,N,4],
    proposal_valid [B,N] -> (boxes [B,D,4], scores [B,D], classes [B,D]
    int32, valid [B,D])."""
    bsz, n, c1 = scores.shape
    num_classes = c1 - 1
    probs = torch.softmax(scores.float(), dim=-1)[..., :num_classes]
    deltas = deltas.reshape(bsz, n, num_classes, 4).float()
    boxes = box_ops.apply_deltas(proposals[:, :, None, :], deltas)  # [B,N,C,4]
    boxes = box_ops.clip_boxes(boxes, image_hw[0], image_hw[1])

    flat_boxes = boxes.reshape(bsz, n * num_classes, 4)
    flat_scores = probs.reshape(bsz, n * num_classes)
    flat_classes = torch.arange(num_classes, dtype=torch.int32, device=scores.device)
    flat_classes = flat_classes.repeat(n)[None].expand(bsz, -1)
    flat_valid = (flat_scores > score_threshold) & proposal_valid.repeat_interleave(
        num_classes, dim=1
    )

    # keep the NMS matrix small: restrict to the top candidates first
    k = min(max_detections * 8, flat_scores.shape[1])
    cand_scores = torch.where(flat_valid, flat_scores, float("-inf"))
    top_scores, idx = box_ops.stable_topk(cand_scores, k)
    cand_boxes = _take(flat_boxes, idx)
    cand_classes = _take(flat_classes, idx)
    cand_valid = torch.isfinite(top_scores)

    keep = box_ops.batched_nms_mask_batched(
        cand_boxes, top_scores, cand_classes, nms_threshold, valid=cand_valid
    )
    final_scores = torch.where(keep, top_scores, float("-inf"))
    top, didx = box_ops.stable_topk(final_scores, min(max_detections, k))
    ok = torch.isfinite(top)
    return (
        _take(cand_boxes, didx),
        torch.where(ok, top, 0.0),
        _take(cand_classes, didx),
        ok,
    )


def fast_rcnn_inference(
    scores, deltas, proposals, proposal_valid, image_hw, score_threshold,
    nms_threshold: float = 0.5, max_detections: int = StaticShapes.MAX_DETECTIONS,
):
    """One image: scores [N,C+1], deltas [N,C*4], proposals [N,4] ->
    (boxes [D,4], scores [D], classes [D], valid [D])."""
    out = fast_rcnn_inference_batched(
        scores[None], deltas[None], proposals[None], proposal_valid[None],
        image_hw, score_threshold, nms_threshold, max_detections,
    )
    return tuple(t[0] for t in out)


class ROIHeads(nn.Module):
    """Box + mask heads over FPN features. ``adaptive_pooler`` emulates the
    zoo configs' POOLER_SAMPLING_RATIO=0 (see models/roi_align.py)."""

    def __init__(self, num_classes: int, adaptive_pooler: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.adaptive_pooler = adaptive_pooler
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor(num_classes)
        self.mask_head = MaskHead(num_classes)

    def box_forward(self, features, boxes, batch_idx=None):
        """Training box branch: features {p2..p5: [B,H,W,C]} (or [H,W,C]
        without ``batch_idx``), boxes [N,4], batch_idx [N] -> (class logits
        [N,C+1], deltas [N,C*4]). Differentiable in the features; pools
        every row (no ``valid`` mask)."""
        pooled = roi_align_dispatch(
            features, boxes, output_size=7, adaptive_ratio=self.adaptive_pooler,
            batch_idx=batch_idx,
        )
        return self.box_predictor(self.box_head(pooled))

    def mask_forward(self, features, boxes, batch_idx=None):
        """Training mask branch: as :meth:`box_forward` -> mask logits
        [N,num_classes,28,28]."""
        pooled = roi_align_dispatch(
            features, boxes, output_size=14, adaptive_ratio=self.adaptive_pooler,
            batch_idx=batch_idx,
        )
        return self.mask_head(pooled)

    def _pool(self, features, boxes, valid, output_size):
        """boxes [B,K,4], valid [B,K] -> pooled [B*K,out,out,C] in the heads'
        dtype (the RoIAlign writes it directly; its sums run in f32)."""
        bsz, k = boxes.shape[:2]
        batch_idx = torch.arange(bsz, dtype=torch.int32, device=boxes.device)
        return roi_align_dispatch(
            features,
            boxes.reshape(-1, 4),
            output_size=output_size,
            adaptive_ratio=self.adaptive_pooler,
            valid=valid.reshape(-1),
            batch_idx=batch_idx.repeat_interleave(k),
            out_dtype=self.box_head.fc1.weight.dtype,
        )

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposals: torch.Tensor,
        proposal_valid: torch.Tensor,
        image_hw,
        score_threshold: float = 0.05,
        nms_threshold: float = 0.5,
        max_detections: int = StaticShapes.MAX_DETECTIONS,
    ) -> Detections:
        """features {p2..p5: [B,H,W,C]}, proposals [B,N,4], proposal_valid
        [B,N] -> Detections [B,D,...]."""
        bsz, n = proposals.shape[:2]
        pooled = self._pool(features, proposals, proposal_valid, 7)
        scores, deltas = self.box_predictor(self.box_head(pooled))
        b, s, c, v = fast_rcnn_inference_batched(
            scores.reshape(bsz, n, -1),
            deltas.reshape(bsz, n, -1),
            proposals,
            proposal_valid,
            image_hw,
            score_threshold,
            nms_threshold,
            max_detections,
        )
        d = b.shape[1]
        mask_logits = self.mask_head(self._pool(features, b, v, 14))  # [B*D,C,28,28]
        sel = c.reshape(-1).long()[:, None, None, None].expand(-1, 1, *mask_logits.shape[2:])
        m = torch.gather(mask_logits, 1, sel)[:, 0]
        return Detections(
            boxes=b,
            scores=s,
            classes=c,
            valid=v,
            mask_probs=torch.sigmoid(m.float()).reshape(bsz, d, *m.shape[1:]),
        )

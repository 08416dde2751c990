"""Mask R-CNN R50/R101-FPN with Detectron2 parameter names.

Public methods keep the JAX package's layouts: images [H,W,3] raw BGR
pixels (0-255), features {level: [h,w,C]}, padded ``Detections``. The
``*_batched`` methods take a leading tile axis and are what the tile engine
runs: the trunk and FPN run NCHW in ``channels_last`` memory format, so the
pyramid arrives NHWC in memory, the layout the RoIAlign kernel reads.

``quant_backbone`` (``none``, ``trunk`` or ``full``, as the JAX package's
``MaskRCNN``) serves the ResNet trunk, and with ``full`` the FPN too, with
int8 convs (``models/quant.py``); the same state dict loads in every mode
(``data/models.py:load_model`` quantizes after loading).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

from deepemia_tpu_torch import resolve_device
from deepemia_tpu_torch.config.constants import StaticShapes
from deepemia_tpu_torch.models import anchors as anchor_lib
from deepemia_tpu_torch.models.fpn import FPNBackbone
from deepemia_tpu_torch.models.heads import Detections, ROIHeads
from deepemia_tpu_torch.models.quant import quantize_backbone
from deepemia_tpu_torch.models.rpn import RPNHead, select_proposals_batched
from deepemia_tpu_torch.ops.image import normalize_bgr

POOLED = ("p2", "p3", "p4", "p5")


class MaskRCNN(nn.Module):
    """R{depth}-FPN Mask R-CNN. Inputs must be divisible by 64."""

    def __init__(self, depth: int = 50, num_classes: int = 2, adaptive_pooler: bool = True):
        super().__init__()
        self.depth = depth
        self.num_classes = num_classes
        self.backbone = FPNBackbone(depth)
        self.proposal_generator = nn.ModuleDict({"rpn_head": RPNHead()})
        self.roi_heads = ROIHeads(num_classes, adaptive_pooler=adaptive_pooler)
        self.quant_backbone = "none"

    @property
    def dtype(self) -> torch.dtype:
        return self.proposal_generator["rpn_head"].conv.weight.dtype

    def quantize(self, mode: str, weights=None) -> "MaskRCNN":
        """Serve the backbone's convs of ``mode`` in int8, quantized from
        ``weights`` (a float32 state dict) or the model's own weights."""
        if mode != "none":
            if self.quant_backbone != "none":
                raise ValueError(f"the backbone is already quantized ({self.quant_backbone})")
            quantize_backbone(self, mode, weights)
            self.quant_backbone = mode
        return self

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] raw BGR -> [B,3,H,W] channels_last, mean-subtracted, in
        the compute dtype."""
        x = normalize_bgr(images).to(self.dtype)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def features_batched(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B,H,W,3] -> {p2..p6: [B,C,h,w]} (channels_last)."""
        return self.backbone(self.normalize(images))

    def features(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[H,W,3] -> {p2..p6: [h,w,C]}."""
        feats = self.features_batched(image[None])
        return {k: v[0].permute(1, 2, 0) for k, v in feats.items()}

    # -- training sub-forwards over a batch of pyramids {lv: [B,C,h,w]} ----

    def rpn_forward(self, feats: Dict[str, torch.Tensor]):
        """-> per-level (objectness {lv: [B,h,w,A]}, deltas {lv: [B,h,w,A*4]})."""
        return self.proposal_generator["rpn_head"](feats)

    def box_forward(self, feats: Dict[str, torch.Tensor], boxes, batch_idx):
        """Boxes [N,4] of images ``batch_idx`` [N] -> (class logits, deltas)."""
        return self.roi_heads.box_forward(
            {k: feats[k].permute(0, 2, 3, 1) for k in POOLED}, boxes, batch_idx
        )

    def mask_forward(self, feats: Dict[str, torch.Tensor], boxes, batch_idx):
        """Boxes [N,4] of images ``batch_idx`` [N] -> mask logits
        [N,num_classes,28,28]."""
        return self.roi_heads.mask_forward(
            {k: feats[k].permute(0, 2, 3, 1) for k in POOLED}, boxes, batch_idx
        )

    def detect_batched(
        self,
        feats: Dict[str, torch.Tensor],
        image_hw: Tuple[int, int],
        score_threshold: float = 0.05,
        nms_threshold: float = 0.5,
        proposal_topk: int = StaticShapes.POST_NMS_TOPK_TEST,
        max_detections: int = StaticShapes.MAX_DETECTIONS,
    ) -> Detections:
        """RPN + RoI heads on a batch of pyramids {lv: [B,C,h,w]} ->
        Detections [B,D,...]."""
        logits, regs = self.proposal_generator["rpn_head"](feats)
        shapes = {k: (v.shape[2], v.shape[3]) for k, v in feats.items()}
        anchors = anchor_lib.all_anchors(shapes, device=logits["p2"].device)
        proposals = select_proposals_batched(
            logits, regs, anchors, image_hw, post_nms_topk=proposal_topk
        )
        return self.roi_heads(
            {k: feats[k].permute(0, 2, 3, 1) for k in POOLED},
            proposals.boxes,
            proposals.valid,
            image_hw,
            score_threshold=score_threshold,
            nms_threshold=nms_threshold,
            max_detections=max_detections,
        )

    def detect_from_features(
        self, feats: Dict[str, torch.Tensor], image_hw, **kwargs
    ) -> Detections:
        """One image's pyramid {lv: [h,w,C]} -> Detections [D,...]."""
        nchw = {
            k: v.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
            for k, v in feats.items()
        }
        det = self.detect_batched(nchw, image_hw, **kwargs)
        return Detections(*(t[0] for t in det))

    def forward(self, image: torch.Tensor, **kwargs) -> Detections:
        """[H,W,3] raw BGR -> Detections [D,...]."""
        h, w = image.shape[0], image.shape[1]
        det = self.detect_batched(self.features_batched(image[None]), (h, w), **kwargs)
        return Detections(*(t[0] for t in det))


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: LeCun-normal convs / linears (std
    1/sqrt(fan_in)), zero biases, identity frozen norms."""
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith(".norm.weight"):
                p.fill_(1.0)
            elif p.ndim == 1:
                p.zero_()
            else:
                # ConvTranspose2d weights are [I,O,kh,kw]; the rest [O,I,...]
                fan_in = p.shape[0 if ".deconv." in name else 1] * math.prod(p.shape[2:])
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))


def build_model(
    backbone: str = "R50",
    num_classes: int = 2,
    use_bf16: bool = True,
    device=None,
    seed: int = 0,
    quant_backbone: str = "none",
) -> MaskRCNN:
    """Mask R-CNN with seeded random weights on ``device`` (``cuda`` unless
    the caller passes another), in bf16 or f32, its backbone int8 per
    ``quant_backbone`` (quantized from the float32 weights). Load trained
    or converted weights into a float model with ``load_state_dict``
    (``data/models.py:load_model`` loads and then quantizes)."""
    dev = resolve_device(device)
    model = MaskRCNN(depth=101 if "101" in backbone else 50, num_classes=num_classes)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.quantize(quant_backbone)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    return model.to(device=dev, dtype=dtype).eval().requires_grad_(False)


def build_train_model(
    backbone: str = "R50", num_classes: int = 2, device=None, seed: int = 0
) -> MaskRCNN:
    """Mask R-CNN for training on ``device`` (``cuda`` unless the caller
    passes another): seeded random float32 master weights, every parameter
    trainable (``train/trainer.py`` freezes the early trunk when it
    fine-tunes). The compute dtype is the caller's autocast (bf16 in
    training on the card)."""
    dev = resolve_device(device)
    model = MaskRCNN(depth=101 if "101" in backbone else 50, num_classes=num_classes)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev).train().requires_grad_(True)

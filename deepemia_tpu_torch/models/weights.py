"""Weight bridge: the JAX package's Flax parameter tree -> this package's
state dict.

The port's modules carry Detectron2's parameter names, so the result is a
Detectron2-named state dict that loads into :class:`MaskRCNN` with
``load_state_dict(strict=True)``. Conventions:

  * Flax Conv kernel [kh,kw,I,O]      -> torch Conv2d [O,I,kh,kw]
  * Flax Dense kernel [I,O]           -> torch Linear [O,I]
  * Deconv2x2 kernel [2,2,I,O]        -> torch ConvTranspose2d [I,O,2,2]
  * FrozenBatchNorm scale/bias        -> the per-channel affine weight/bias
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deepemia_tpu_torch.models.resnet import STAGE_BLOCKS


def _a(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv(w) -> np.ndarray:
    return np.transpose(_a(w), (3, 2, 0, 1))


def _deconv(w) -> np.ndarray:
    return np.transpose(_a(w), (2, 3, 0, 1))


def _dense(w) -> np.ndarray:
    return np.transpose(_a(w), (1, 0))


def params_from_jax(tree: Dict[str, Any], depth: int = 50) -> Dict[str, torch.Tensor]:
    """Flax Mask R-CNN parameters (nested dicts of arrays, with or without
    the top-level ``params`` key) -> Detectron2-named {name: float32
    tensor}."""
    p = tree.get("params", tree)
    sd: Dict[str, np.ndarray] = {}

    bu = "backbone.bottom_up"
    bb = p["backbone"]
    sd[f"{bu}.stem.conv1.weight"] = _conv(bb["stem_conv"]["kernel"])
    sd[f"{bu}.stem.conv1.norm.weight"] = _a(bb["stem_norm"]["scale"])
    sd[f"{bu}.stem.conv1.norm.bias"] = _a(bb["stem_norm"]["bias"])
    for stage_idx, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        s = stage_idx + 2
        for b in range(n_blocks):
            blk = bb[f"res{s}_block{b}"]
            d2 = f"{bu}.res{s}.{b}"
            for i in (1, 2, 3):
                sd[f"{d2}.conv{i}.weight"] = _conv(blk[f"conv{i}"]["kernel"])
                sd[f"{d2}.conv{i}.norm.weight"] = _a(blk[f"norm{i}"]["scale"])
                sd[f"{d2}.conv{i}.norm.bias"] = _a(blk[f"norm{i}"]["bias"])
            if "shortcut" in blk:
                sd[f"{d2}.shortcut.weight"] = _conv(blk["shortcut"]["kernel"])
                sd[f"{d2}.shortcut.norm.weight"] = _a(blk["shortcut_norm"]["scale"])
                sd[f"{d2}.shortcut.norm.bias"] = _a(blk["shortcut_norm"]["bias"])

    fpn = p["fpn"]
    for lvl in (2, 3, 4, 5):
        lat, out = fpn[f"lateral_res{lvl}"], fpn[f"output_p{lvl}"]
        sd[f"backbone.fpn_lateral{lvl}.weight"] = _conv(lat["kernel"])
        sd[f"backbone.fpn_lateral{lvl}.bias"] = _a(lat["bias"])
        sd[f"backbone.fpn_output{lvl}.weight"] = _conv(out["kernel"])
        sd[f"backbone.fpn_output{lvl}.bias"] = _a(out["bias"])

    rh = "proposal_generator.rpn_head"
    rpn = p["rpn_head"]
    for src, dst in (
        ("conv", "conv"),
        ("objectness", "objectness_logits"),
        ("anchor_deltas", "anchor_deltas"),
    ):
        sd[f"{rh}.{dst}.weight"] = _conv(rpn[src]["kernel"])
        sd[f"{rh}.{dst}.bias"] = _a(rpn[src]["bias"])

    roi = p["roi_heads"]
    for fc in ("fc1", "fc2"):
        sd[f"roi_heads.box_head.{fc}.weight"] = _dense(roi["box_head"][fc]["kernel"])
        sd[f"roi_heads.box_head.{fc}.bias"] = _a(roi["box_head"][fc]["bias"])
    for nm in ("cls_score", "bbox_pred"):
        layer = roi["box_predictor"][nm]
        sd[f"roi_heads.box_predictor.{nm}.weight"] = _dense(layer["kernel"])
        sd[f"roi_heads.box_predictor.{nm}.bias"] = _a(layer["bias"])
    mh = roi["mask_head"]
    for i in (1, 2, 3, 4):
        sd[f"roi_heads.mask_head.mask_fcn{i}.weight"] = _conv(mh[f"mask_fcn{i}"]["kernel"])
        sd[f"roi_heads.mask_head.mask_fcn{i}.bias"] = _a(mh[f"mask_fcn{i}"]["bias"])
    sd["roi_heads.mask_head.deconv.weight"] = _deconv(mh["deconv"]["kernel"])
    sd["roi_heads.mask_head.deconv.bias"] = _a(mh["deconv"]["bias"])
    sd["roi_heads.mask_head.predictor.weight"] = _conv(mh["predictor"]["kernel"])
    sd["roi_heads.mask_head.predictor.bias"] = _a(mh["predictor"]["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}

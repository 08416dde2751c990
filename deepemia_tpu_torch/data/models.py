"""Trained-model discovery and loading.

Checkpoints live under ``split_dir/<dataset>/rcnn_r{50,101}/``. Three
formats load into the port's :class:`MaskRCNN` (Detectron2 parameter
names, ``load_state_dict(strict=True)``):

  * ``model_final_{r50,r101}.pt`` written by the port's trainer
    (``{"model": state_dict, "backbone", "num_classes"}``);
  * Detectron2 ``.pth`` files (``torch.save`` of ``{"model": ...}``, frozen
    batch norms with running statistics, folded here into the affine norm);
  * Detectron2 model-zoo ``.pkl`` files (pickled ``{"model": {name:
    ndarray}}``).

The JAX package's Orbax directories are a TPU artefact and do not load.
"""

from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from deepemia_tpu_torch.models.mask_rcnn import MaskRCNN, build_model

BN_EPS = 1e-5  # FrozenBatchNorm2d default
# buffers a Detectron2 model may save that the port computes itself
_NOT_PARAMETERS = re.compile(r"^(pixel_mean|pixel_std|proposal_generator\.anchor_generator\..*)$")


def get_trained_model_paths(split_dir: str, dataset_name: str) -> Dict[str, str]:
    """{'R50': path, 'R101': path} for the checkpoints that exist, the first
    candidate of each directory winning."""
    base = Path(os.path.expanduser(split_dir)) / dataset_name
    found: Dict[str, str] = {}
    for rcnn, sub in (("R50", "rcnn_r50"), ("R101", "rcnn_r101")):
        d = base / sub
        if not d.is_dir():
            continue
        suffix = rcnn.lower()
        for cand in (
            d / f"model_final_{suffix}.pt",
            d / f"model_final_{suffix}.pth",
            d / "model_final.pth",
            d / f"model_final_{suffix}.pkl",
            d / "model_final.pkl",
        ):
            if cand.exists():
                found[rcnn] = str(cand)
                break
    return found


def _read_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            obj = pickle.load(f, encoding="latin1")
        sd = obj.get("model", obj)
        return {k: np.asarray(v) for k, v in sd.items() if isinstance(v, np.ndarray)}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj)
    return {k: v.detach().float().numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _fold_norms(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Frozen batch norms with running statistics -> the affine norm:
    scale = w / sqrt(var + eps), bias = b - mean * scale."""
    out = {}
    for k, v in sd.items():
        if k.endswith((".running_mean", ".running_var")) or _NOT_PARAMETERS.match(k):
            continue
        prefix, _, leaf = k.rpartition(".")
        var = sd.get(f"{prefix}.running_var")
        if var is not None and leaf in ("weight", "bias"):
            scale = sd[f"{prefix}.weight"] / np.sqrt(var + BN_EPS)
            v = scale if leaf == "weight" else v - sd[f"{prefix}.running_mean"] * scale
        out[k] = v
    return out


def infer_depth(sd: Dict[str, np.ndarray]) -> int:
    """R50 vs R101 from the number of res4 blocks."""
    blocks = {
        int(m.group(1))
        for k in sd
        if (m := re.match(r"backbone\.bottom_up\.res4\.(\d+)\.conv1\.weight", k))
    }
    if not blocks:
        raise ValueError("no res4 blocks found in checkpoint")
    return 101 if max(blocks) + 1 == 23 else 50


def load_model(
    path: str,
    num_classes: Optional[int] = None,
    use_bf16: bool = True,
    device=None,
) -> MaskRCNN:
    """A checkpoint -> the port's model in eval mode on ``device`` (``cuda``
    unless the caller passes another), bf16 or float32. Raises when the
    checkpoint's class count differs from ``num_classes``."""
    path = os.path.expanduser(path)
    if not path.endswith((".pt", ".pth", ".pkl")):
        raise ValueError(f"Unrecognized checkpoint format: {path}")
    sd = _fold_norms(_read_state_dict(path))
    w = sd.get("roi_heads.box_predictor.cls_score.weight")
    if w is None:
        raise ValueError(f"{path}: cls_score.weight missing from checkpoint")
    ckpt_classes = int(w.shape[0]) - 1  # + background
    if num_classes and num_classes != ckpt_classes:
        raise ValueError(f"{path}: checkpoint has {ckpt_classes} classes, dataset expects {num_classes}")
    model = build_model(
        f"R{infer_depth(sd)}", num_classes=ckpt_classes, use_bf16=use_bf16, device=device
    )
    dtype = next(model.parameters()).dtype
    model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype) for k, v in sd.items()}, strict=True
    )
    return model

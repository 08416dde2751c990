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
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from deepemia_tpu_torch.models.mask_rcnn import MaskRCNN, build_model
from deepemia_tpu_torch.models.weights import fold_norms, infer_depth, load_torch_state_dict


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


def load_model(
    path: str,
    num_classes: Optional[int] = None,
    use_bf16: bool = True,
    device=None,
    quant_backbone: str = "none",
) -> MaskRCNN:
    """A checkpoint -> the port's model in eval mode on ``device`` (``cuda``
    unless the caller passes another), bf16 or float32, its backbone int8
    per ``quant_backbone`` (``none``, ``trunk`` or ``full``). Raises when
    the checkpoint's class count differs from ``num_classes``."""
    path = os.path.expanduser(path)
    if not path.endswith((".pt", ".pth", ".pkl")):
        raise ValueError(f"Unrecognized checkpoint format: {path}")
    sd = fold_norms(load_torch_state_dict(path))
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
    f32 = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
    model.load_state_dict({k: v.to(dtype) for k, v in f32.items()}, strict=True)
    # from the float32 checkpoint, not the model's bf16 copy: the JAX
    # package quantizes its float32 parameters
    return model.quantize(quant_backbone, f32)

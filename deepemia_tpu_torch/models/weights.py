"""Checkpoints and weights: Detectron2 files, the zoo fine-tune overlay,
and the bridge from the JAX package's Flax parameter tree.

The port's modules carry Detectron2's parameter names, so a Detectron2
state dict loads into :class:`MaskRCNN` by name once its frozen batch
norms are folded into the affine norm (``fold_norms``).

- ``load_torch_state_dict``: a ``.pth`` (``torch.save`` of ``{"model":
  ...}``) or a zoo ``.pkl`` (pickled ``{"model": {name: ndarray}}``) ->
  {name: ndarray}.
- ``is_caffe2_names`` / ``remap_caffe2_names``: Caffe2-era backbone
  pickles (MSRA ``R-50.pkl``) renamed to Detectron2's names.
- ``load_pretrained_params``: the zoo fine-tune path of training (the JAX
  package's ``models/weights.py:load_pretrained_params``): every
  checkpoint tensor whose name and shape match the seeded model's is
  copied in; the rest (an 81-class head against a ``num_classes`` head)
  keep the seeded initialisation, and are logged as skipped. As in the
  JAX package, a section (``SECTIONS``) is copied only when every tensor
  its converter reads is in the file; a section with one missing keeps the
  seeded initialisation whole.
- ``params_from_jax``: Flax parameters -> Detectron2-named tensors:

  * Flax Conv kernel [kh,kw,I,O]      -> torch Conv2d [O,I,kh,kw]
  * Flax Dense kernel [I,O]           -> torch Linear [O,I]
  * Deconv2x2 kernel [2,2,I,O]        -> torch ConvTranspose2d [I,O,2,2]
  * FrozenBatchNorm scale/bias        -> the per-channel affine weight/bias
"""

from __future__ import annotations

import logging
import pickle
import re
from typing import Any, Dict

import numpy as np
import torch

from deepemia_tpu_torch.models.resnet import STAGE_BLOCKS
from deepemia_tpu_torch.utils.exceptions import ModelLoadError

log = logging.getLogger("deepemia_tpu_torch.weights")

BN_EPS = 1e-5  # FrozenBatchNorm2d default
# buffers a Detectron2 model may save that the port computes itself
_NOT_PARAMETERS = re.compile(r"^(pixel_mean|pixel_std|proposal_generator\.anchor_generator\..*)$")
# the sections of a Mask R-CNN state dict, by name prefix
SECTIONS = (
    ("backbone", "backbone.bottom_up."),
    ("fpn", "backbone.fpn_"),
    ("rpn_head", "proposal_generator.rpn_head."),
    ("box_head", "roi_heads.box_head."),
    ("box_predictor", "roi_heads.box_predictor."),
    ("mask_head", "roi_heads.mask_head."),
)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A Detectron2 checkpoint -> {name: ndarray}: ``.pkl`` files are
    unpickled (latin-1, as the zoo writes them), anything else goes through
    ``torch.load``; floating tensors come back as float32."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            obj = pickle.load(f, encoding="latin1")
        sd = obj.get("model", obj) if isinstance(obj, dict) else obj
        return {k: np.asarray(v) for k, v in sd.items() if isinstance(v, np.ndarray)}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            out[k] = (v.float() if v.is_floating_point() else v).numpy()
        elif isinstance(v, np.ndarray):
            out[k] = v
    return out


def fold_norms(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Frozen batch norms with running statistics -> the affine norm:
    scale = w / sqrt(var + eps), bias = b - mean * scale; the buffers the
    port computes itself are dropped."""
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


def infer_depth(sd) -> int:
    """R50 vs R101 from the number of res4 blocks of a state dict."""
    blocks = {
        int(m.group(1)) for k in sd if (m := re.match(r"backbone\.bottom_up\.res4\.(\d+)\.conv1\.weight", k))
    }
    if not blocks:
        raise ModelLoadError("no res4 blocks found in checkpoint")
    return 101 if max(blocks) + 1 == 23 else 50


_C2_KEY = re.compile(r"^(conv1_w|res_conv1_bn_[sb]|res\d+_\d+_branch[12].*)$")


def is_caffe2_names(sd: Dict[str, np.ndarray]) -> bool:
    """True for Caffe2-era ImageNet backbone pickles (``conv1_w``,
    ``res2_0_branch2a_w``, ``..._bn_s`` names)."""
    return any(_C2_KEY.match(k) for k in sd)


def remap_caffe2_names(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Caffe2 backbone keys -> Detectron2 names (the renaming of
    Detectron2's ``c2_model_loading.py``); the fused BN scale/bias pairs
    become affine norm weights; other keys (the fc1000 head) are dropped:

      conv1_w                    -> backbone.bottom_up.stem.conv1.weight
      res_conv1_bn_{s,b}         -> backbone.bottom_up.stem.conv1.norm.{weight,bias}
      resS_B_branch2{a,b,c}_w    -> backbone.bottom_up.resS.B.conv{1,2,3}.weight
      resS_B_branch2{x}_bn_{s,b} -> ...conv{i}.norm.{weight,bias}
      resS_B_branch1_w           -> ...resS.B.shortcut.weight
      resS_B_branch1_bn_{s,b}    -> ...shortcut.norm.{weight,bias}
    """
    bu = "backbone.bottom_up"
    branch = {"a": 1, "b": 2, "c": 3}
    bn_suffix = {"s": "weight", "b": "bias"}
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k == "conv1_w":
            out[f"{bu}.stem.conv1.weight"] = v
        elif m := re.match(r"^res_conv1_bn_([sb])$", k):
            out[f"{bu}.stem.conv1.norm.{bn_suffix[m.group(1)]}"] = v
        elif m := re.match(r"^res(\d+)_(\d+)_branch2([abc])_w$", k):
            st, b, x = m.groups()
            out[f"{bu}.res{st}.{b}.conv{branch[x]}.weight"] = v
        elif m := re.match(r"^res(\d+)_(\d+)_branch2([abc])_bn_([sb])$", k):
            st, b, x, sb = m.groups()
            out[f"{bu}.res{st}.{b}.conv{branch[x]}.norm.{bn_suffix[sb]}"] = v
        elif m := re.match(r"^res(\d+)_(\d+)_branch1_w$", k):
            st, b = m.groups()
            out[f"{bu}.res{st}.{b}.shortcut.weight"] = v
        elif m := re.match(r"^res(\d+)_(\d+)_branch1_bn_([sb])$", k):
            st, b, sb = m.groups()
            out[f"{bu}.res{st}.{b}.shortcut.norm.{bn_suffix[sb]}"] = v
        else:
            log.debug("Dropping non-backbone Caffe2 key %r", k)
    return out


def _section_names(target, prefix: str, sd) -> list:
    """The model tensors of the section at ``prefix`` that the JAX
    package's converter reads: all of them, except that a block's shortcut
    is read only where the file has its weight."""
    return [k for k in target if k.startswith(prefix)
            and (".shortcut." not in k or f"{k.split('.shortcut.')[0]}.shortcut.weight" in sd)]


def load_pretrained_params(path: str, model: torch.nn.Module) -> Dict[str, Any]:
    """Overlay a Detectron2 checkpoint (full model in Detectron2 names, or
    a Caffe2-era backbone pickle) onto ``model`` in place: in every section
    whose tensors are all in the file, each tensor whose shape matches is
    copied; a mismatched one (a class-count head) keeps the model's
    initialisation. Raises ``ModelLoadError`` when the checkpoint's depth is
    not the model's.

    -> {'sections': [sections copied], 'used': tensors copied, 'skipped':
    [(name, checkpoint shape, model shape)]}."""
    sd = load_torch_state_dict(path)
    if is_caffe2_names(sd):
        sd = remap_caffe2_names(sd)
        log.info("Remapped Caffe2-era backbone names in %s", path)
    sd = fold_norms(sd)
    target = model.state_dict()
    depth, want = infer_depth(sd), infer_depth(target)
    if depth != want:
        raise ModelLoadError(f"Checkpoint {path} is R{depth} but the model is R{want}")
    used, skipped, merged, sections = 0, [], {}, []
    for sec, prefix in SECTIONS:
        names = _section_names(target, prefix, sd)
        missing = [k for k in names if k not in sd]
        if missing:
            log.debug("Checkpoint lacks %s of section %r: left at init", missing[0], sec)
            continue
        sections.append(sec)
        for name in names:
            value = sd[name]
            if tuple(value.shape) != tuple(target[name].shape):
                skipped.append((name, tuple(value.shape), tuple(target[name].shape)))
                continue
            merged[name] = torch.from_numpy(np.asarray(value, np.float32)).to(target[name].dtype)
            used += 1
    model.load_state_dict(merged, strict=False)
    for name, cs, ts in skipped:
        log.info("Pretrained init: skipped %s (checkpoint %s vs model %s)", name, cs, ts)
    log.info("Pretrained init from %s: sections %s, %d tensors loaded, %d skipped", path, sections, used, len(skipped))
    return {"sections": sections, "used": used, "skipped": skipped}


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

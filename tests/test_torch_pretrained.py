"""Port parity: the zoo fine-tune path (``deepemia_tpu_torch/models/
weights.py:load_pretrained_params``) against the JAX package's on a
synthetic Detectron2 zoo pickle with 81-class heads and frozen-BN running
statistics, and on a Caffe2-era backbone pickle: the same tensors used and
skipped (JAX paths mapped to Detectron2 names), the copied weights equal to
the JAX package's folded ones; a file lacking a tensor of a section
leaves that section at its initialisation in both; a depth mismatch raises; and ``train`` on a
``.pkl`` fine-tunes with the stem and ``res2`` left as loaded."""

import pickle
import re
import shutil

import numpy as np
import pytest
import torch

import deepemia_tpu.models.weights as jax_w
from deepemia_tpu.models.mask_rcnn import build_model as jax_build_model
from deepemia_tpu_torch.models import weights as port_w
from deepemia_tpu_torch.models.mask_rcnn import build_train_model
from deepemia_tpu_torch.train import trainer as pt_tr
from deepemia_tpu_torch.utils.exceptions import ModelLoadError
from test_torch_trainer import CFG, loader_batches
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_path_to_d2(params):
    """{'a/b/kernel': Detectron2 name}: params_from_jax on a tree whose
    leaves hold their own index."""
    paths = [p for p, _ in _flat(params["params"])]
    tree = {}
    for i, (path, leaf) in enumerate(_flat(params["params"])):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.full(np.shape(leaf), i, np.float32)
    return {"/".join(paths[int(v.flatten()[0])]): k for k, v in port_w.params_from_jax(tree).items()}


def zoo_state_dict(params, seed=0):
    """A Detectron2 zoo state dict from the JAX tiny model: running
    statistics on every frozen BN, and COCO's 81-class box and mask heads."""
    rng = np.random.default_rng(seed)
    sd = jax_w.export_detectron2_state_dict(params, 50)
    for k in [k for k in sd if k.endswith(".norm.weight")]:
        prefix = k[: -len(".weight")]
        n = sd[k].shape[0]
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    sd["roi_heads.box_predictor.cls_score.weight"] = rng.normal(0, 0.01, (81, 1024)).astype(np.float32)
    sd["roi_heads.box_predictor.cls_score.bias"] = np.zeros(81, np.float32)
    sd["roi_heads.box_predictor.bbox_pred.weight"] = rng.normal(0, 0.001, (320, 1024)).astype(np.float32)
    sd["roi_heads.box_predictor.bbox_pred.bias"] = np.zeros(320, np.float32)
    sd["roi_heads.mask_head.predictor.weight"] = rng.normal(0, 0.001, (80, 256, 1, 1)).astype(np.float32)
    sd["roi_heads.mask_head.predictor.bias"] = np.zeros(80, np.float32)
    sd["pixel_mean"] = np.array([103.53, 116.28, 123.675], np.float32).reshape(3, 1, 1)
    return sd


def caffe2_backbone(sd):
    """The backbone of a Detectron2 state dict in Caffe2 names (MSRA R-50.pkl
    layout, affine BN, with the fc1000 head)."""
    out = {"fc1000_w": np.zeros((1000, 2048), np.float32)}
    branch = {"1": "a", "2": "b", "3": "c"}
    for k, v in sd.items():
        if k == "backbone.bottom_up.stem.conv1.weight":
            out["conv1_w"] = v
        elif m := re.match(r"backbone\.bottom_up\.stem\.conv1\.norm\.(weight|bias)$", k):
            out[f"res_conv1_bn_{'s' if m.group(1) == 'weight' else 'b'}"] = v
        elif m := re.match(r"backbone\.bottom_up\.res(\d)\.(\d+)\.conv(\d)\.weight$", k):
            out[f"res{m.group(1)}_{m.group(2)}_branch2{branch[m.group(3)]}_w"] = v
        elif m := re.match(r"backbone\.bottom_up\.res(\d)\.(\d+)\.conv(\d)\.norm\.(weight|bias)$", k):
            out[f"res{m.group(1)}_{m.group(2)}_branch2{branch[m.group(3)]}_bn_{'s' if m.group(4) == 'weight' else 'b'}"] = v
        elif m := re.match(r"backbone\.bottom_up\.res(\d)\.(\d+)\.shortcut\.weight$", k):
            out[f"res{m.group(1)}_{m.group(2)}_branch1_w"] = v
        elif m := re.match(r"backbone\.bottom_up\.res(\d)\.(\d+)\.shortcut\.norm\.(weight|bias)$", k):
            out[f"res{m.group(1)}_{m.group(2)}_branch1_bn_{'s' if m.group(3) == 'weight' else 'b'}"] = v
    return out


def _write(path, sd):
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "Detectron2 Model Zoo"}, f, protocol=2)
    return str(path)


@pytest.fixture(scope="module")
def names(tiny_r50):
    return jax_path_to_d2(tiny_r50[1])


def _compare(tmp_path, sd, tiny_r50, names):
    path = _write(tmp_path / "zoo.pkl", sd)
    jax_params, ref = jax_w.load_pretrained_params(path, jax_build_model("R50", 2, use_bf16=False), 2,
                                                   init_hw=(64, 64), seed=0)
    model = build_train_model("R50", 2, device="cpu", seed=0)
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    got = port_w.load_pretrained_params(path, model)
    assert got["used"] == ref["used"] and got["sections"] == ref["sections"]
    assert sorted(n for n, _, _ in got["skipped"]) == sorted(names[p] for p, _, _ in ref["skipped"])
    ref_skipped = sorted(ref["skipped"], key=lambda t: names[t[0]])
    for (name, cs, ts), (_, rcs, rts) in zip(sorted(got["skipped"]), ref_skipped):
        assert np.prod(cs) == np.prod(rcs) and np.prod(ts) == np.prod(rts), name
    # copied tensors hold the JAX package's folded values; skipped and
    # absent ones keep the seeded initialisation
    want = port_w.params_from_jax(jax_params)
    state = model.state_dict()
    # the tensors the JAX package converts (whole sections only), less those
    # its overlay skipped
    in_file = jax_w.remap_caffe2_names(sd) if jax_w.is_caffe2_names(sd) else sd
    converted, _ = jax_w.convert_partial_state_dict(in_file, 50)
    used = {names["/".join(p)] for p, _ in _flat(converted["params"])} - {n for n, _, _ in got["skipped"]}
    assert len(used) == got["used"]
    for k in state:
        if k in used:
            torch.testing.assert_close(state[k], want[k], rtol=1e-6, atol=1e-7, msg=k)
        else:
            assert torch.equal(state[k], seeded[k]), k
    return got


def test_zoo_pickle_matches_jax(tmp_path, tiny_r50, names):
    got = _compare(tmp_path, zoo_state_dict(tiny_r50[1]), tiny_r50, names)
    assert sorted(n for n, _, _ in got["skipped"]) == [
        "roi_heads.box_predictor.bbox_pred.bias", "roi_heads.box_predictor.bbox_pred.weight",
        "roi_heads.box_predictor.cls_score.bias", "roi_heads.box_predictor.cls_score.weight",
        "roi_heads.mask_head.predictor.bias", "roi_heads.mask_head.predictor.weight"]
    assert got["sections"] == ["backbone", "fpn", "rpn_head", "box_head", "box_predictor", "mask_head"]


def test_caffe2_backbone_matches_jax(tmp_path, tiny_r50, names):
    c2 = caffe2_backbone(jax_w.export_detectron2_state_dict(tiny_r50[1], 50))
    assert port_w.is_caffe2_names(c2) and jax_w.is_caffe2_names(c2)
    remapped = port_w.remap_caffe2_names(c2)
    assert sorted(remapped) == sorted(jax_w.remap_caffe2_names(c2))
    got = _compare(tmp_path, c2, tiny_r50, names)
    assert got["sections"] == ["backbone"] and not got["skipped"]


@pytest.mark.parametrize("drop", [
    ("backbone.fpn_output3.bias", "roi_heads.mask_head.mask_fcn2.weight"),
    ("backbone.bottom_up.res3.0.shortcut.weight",),
    ("backbone.bottom_up.res4.1.conv2.norm.bias",),
], ids=["fpn_and_mask_head", "shortcut_weight", "backbone_norm"])
def test_partial_section_matches_jax(tmp_path, tiny_r50, names, drop):
    """A file that lacks a tensor of a section: the JAX package leaves that
    whole section at its initialisation (a block's shortcut norm goes with
    its weight), and so does the port."""
    sd = zoo_state_dict(tiny_r50[1])
    for k in drop:
        del sd[k]
    got = _compare(tmp_path, sd, tiny_r50, names)
    lacking = {"backbone.fpn_": "fpn", "roi_heads.mask_head.": "mask_head", "backbone.bottom_up.res4": "backbone"}
    gone = {sec for k in drop for pre, sec in lacking.items() if k.startswith(pre)}
    assert set(got["sections"]) == {"backbone", "fpn", "rpn_head", "box_head", "box_predictor", "mask_head"} - gone


def test_depth_mismatch_raises(tmp_path, tiny_r50):
    sd = zoo_state_dict(tiny_r50[1])
    for b in range(6, 23):  # res4 of R101
        sd[f"backbone.bottom_up.res4.{b}.conv1.weight"] = sd["backbone.bottom_up.res4.0.conv1.weight"]
    path = _write(tmp_path / "r101.pkl", sd)
    with pytest.raises(ModelLoadError, match="is R101 but the model is R50"):
        port_w.load_pretrained_params(path, build_train_model("R50", 2, device="cpu"))


def test_train_fine_tunes_from_a_zoo_pickle(tmp_path, tiny_r50):
    """``init_checkpoint`` ending in .pkl goes through the overlay: the
    81-class heads are re-initialised at the seeded model's values, the
    stem and res2 stay as loaded through a step, the heads train."""
    path = _write(tmp_path / "zoo.pkl", zoo_state_dict(tiny_r50[1]))
    loaded = build_train_model("R50", 2, device="cpu", seed=0)
    port_w.load_pretrained_params(path, loaded)
    before = {k: v.clone() for k, v in loaded.state_dict().items()}
    cfg = pt_tr.TrainConfig(checkpoint_every=10, base_lr=0.01, **dict(CFG, warmup_iters=0))
    final, metrics = pt_tr.train_on_batches(loader_batches(1, seed=2), 2, str(tmp_path / "tune"), cfg,
                                            init_checkpoint=path, max_steps_override=1, device="cpu")
    assert np.isfinite(metrics["total"])
    after = torch.load(final, map_location="cpu")["model"]
    frozen = [k for k in after if k.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2."))]
    assert frozen and all(torch.equal(after[k], before[k]) for k in frozen)
    assert not torch.equal(after["roi_heads.box_predictor.cls_score.weight"],
                           before["roi_heads.box_predictor.cls_score.weight"])
    shutil.rmtree(tmp_path / "tune")  # ~0.5 GB of weights

"""Port parity of the whole inference pipeline: the JAX and the port
``InferencePipeline`` on the golden fixture (zoo-format checkpoint with
deterministic heads, one 128² micrograph with a scale bar), postprocessing
on, multiscale at two scales, on the CPU in float32.

The RLE CSV must be equal string for string; the measurement CSV must have
the same rows, every number within 1e-4 relative (the two frameworks sum
convolutions in other orders, which moves a contour vertex only when a
mask probability sits within ~1e-6 of the threshold)."""

import csv
import json
import os
import pickle
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from deepemia_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from deepemia_tpu.inference.scalebar import detect_scale_bar
from deepemia_tpu.models.weights import export_detectron2_state_dict
from deepemia_tpu_torch.inference.measure import CSV_HEADER
from deepemia_tpu_torch.inference.pipeline import InferencePipeline, run_inference
from deepemia_tpu_torch.ops.rle import rle_decode

torch.set_num_threads(4)

REL_TOL = 1e-4


@pytest.fixture()
def golden(tmp_home, tmp_path, tiny_r50):
    """The golden fixture of tests/test_pipeline_golden.py with
    postprocessing on, two multiscale scales and damped RPN deltas and mask
    logits."""
    from deepemia_tpu.config import get_config

    _, params = tiny_r50
    sd = export_detectron2_state_dict(params, 50)
    sd["proposal_generator.rpn_head.objectness_logits.bias"] = np.full_like(
        sd["proposal_generator.rpn_head.objectness_logits.bias"], 4.0
    )
    for k in (
        "roi_heads.box_predictor.bbox_pred.weight",
        "roi_heads.box_predictor.bbox_pred.bias",
        "roi_heads.box_predictor.cls_score.weight",
        "roi_heads.box_predictor.cls_score.bias",
    ):
        sd[k] = np.zeros_like(sd[k])
    sd["roi_heads.mask_head.predictor.bias"] = np.full_like(sd["roi_heads.mask_head.predictor.bias"], 4.0)
    # random RPN deltas (|d| ~ 4e2) and mask logits amplify the two
    # frameworks' float32 rounding (3e-5 of a pixel value after the 1.5x
    # resize) into 1e-2 px box moves that shift the integer window origins
    # of the postprocess; damped as in tests/test_torch_heads.py:sane_geometry
    for k, f in (("proposal_generator.rpn_head.anchor_deltas.weight", 1e-2), ("roi_heads.mask_head.predictor.weight", 1e-1)):
        sd[k] = sd[k] * f

    cfg = get_config()
    paths = cfg["paths"]
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Path(os.path.expanduser(paths["category_json"])).write_text(
        json.dumps({"zds": [str(img_dir), str(img_dir), ["particle", "pore"]]})
    )
    split_dir = Path(os.path.expanduser(paths["split_dir"]))
    split_dir.mkdir(parents=True, exist_ok=True)
    (split_dir / "zds_split.json").write_text(json.dumps({"train": [], "test": []}))
    ckpt = split_dir / "zds" / "rcnn_r50" / "model_final_r50.pkl"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    with open(ckpt, "wb") as f:
        pickle.dump({"model": sd, "__author__": "Detectron2 Model Zoo"}, f, protocol=2)

    inf_dir = tmp_path / "INFERENCE"
    inf_dir.mkdir()
    im = np.full((128, 128, 3), 30, np.uint8)
    cv2.circle(im, (40, 50), 16, (220, 220, 220), -1)
    cv2.rectangle(im, (60, 118), (109, 120), (255, 255, 255), -1)
    cv2.putText(im, "2 um", (60, 112), cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1, cv2.LINE_AA)
    cv2.imwrite(str(inf_dir / "micro.png"), im)

    cfg["scale_bar_rois"] = {
        "default": {"x_start_factor": 0.3, "y_start_factor": 0.7, "width_factor": 0.7, "height_factor": 0.3}
    }
    cfg["scalebar_thresholds"]["min_line_length"] = 30
    cfg["scalebar_thresholds"]["edge_margin_factor"] = 0.0
    inf = cfg["inference_settings"]
    inf["use_tile_based_inference"] = False
    inf["use_class_specific_inference"] = False
    inf["ensemble_settings"] = {"enabled": False}
    inf["postprocessing"] = {"enabled": True}
    inf["multiscale_settings"]["baseline_scales"] = [1.0, 1.5]
    return {"cfg": cfg, "split_dir": str(split_dir), "inf_dir": str(inf_dir), "tmp": tmp_path, "image": im}


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_pipeline_matches_jax(golden):
    cfg = golden["cfg"]
    common = dict(config=cfg, use_bf16=False, default_threshold=0.2)
    ref = JaxPipeline("zds", golden["split_dir"], output_dir=str(golden["tmp"] / "jax"), **common).run(
        golden["inf_dir"], visualize=False
    )
    psum, um_pix = detect_scale_bar(cv2.imread(str(Path(golden["inf_dir"]) / "micro.png")), cfg, "zds")
    assert psum == "2"
    pipe = InferencePipeline(
        "zds", golden["split_dir"], output_dir=str(golden["tmp"] / "port"),
        scale_bar=lambda img: (psum, um_pix), device="cpu", **common,
    )
    assert pipe.use_multiscale and pipe.postproc_enabled
    got = pipe.run(golden["inf_dir"])
    assert got["processed"] == ref["processed"] == ["micro.png"] and not got["failed"]
    assert {"decode", "scalebar", "engine", "postprocess", "rle", "rle_rows", "measurements", "csv"} <= set(got["stages"])

    ref_rle, got_rle = _rows(ref["rle_csv"]), _rows(got["rle_csv"])
    assert len(got_rle) > 1 and got_rle == ref_rle
    for _, enc in got_rle[1:]:
        vals = [int(t) for t in enc.split()]
        assert rle_decode(vals, (128, 128)).sum() == sum(vals[1::2])

    ref_m, got_m = _rows(ref["measurements_csv"]), _rows(got["measurements_csv"])
    assert got_m[0] == ref_m[0] == CSV_HEADER
    assert len(got_m) == len(ref_m) > 1
    for g, r in zip(got_m[1:], ref_m[1:]):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            assert abs(fa - fb) <= REL_TOL * max(abs(fb), 1e-12), (a, b)


def test_pipeline_refuses_what_is_not_ported(golden):
    cfg = golden["cfg"]
    kw = dict(config=cfg, use_bf16=False, device="cpu")
    with pytest.raises(ValueError, match="scale-bar OCR is not ported"):
        InferencePipeline("zds", golden["split_dir"], **kw)
    sb = lambda img: ("0", 1.0)  # noqa: E731
    pipe = InferencePipeline("zds", golden["split_dir"], scale_bar=sb, **kw)
    with pytest.raises(NotImplementedError, match="visualize"):
        pipe.run(golden["inf_dir"], visualize=True)
    for key, value, match in (
        ("quantized_inference", "trunk", "quantized_inference"),
        ("measurement_backend", "device", "device measurement backend"),
    ):
        bad = {**cfg, "performance": {**cfg["performance"], key: value}}
        with pytest.raises(NotImplementedError, match=match):
            InferencePipeline("zds", golden["split_dir"], scale_bar=sb, config=bad, use_bf16=False, device="cpu")
    r101 = Path(golden["split_dir"]) / "zds" / "rcnn_r101"
    r101.mkdir()
    (r101 / "model_final_r101.pkl").write_bytes(
        (Path(golden["split_dir"]) / "zds" / "rcnn_r50" / "model_final_r50.pkl").read_bytes()
    )
    ens = {**cfg, "inference_settings": {**cfg["inference_settings"], "ensemble_settings": {"enabled": True}}}
    with pytest.raises(NotImplementedError, match="ensemble"):
        InferencePipeline("zds", golden["split_dir"], scale_bar=sb, config=ens, use_bf16=False, device="cpu")


def test_unreadable_image_is_isolated(golden, tmp_path):
    """A file the decoder refuses (LZW TIFF) lands in ``failed``; the other
    images go on to both CSVs."""
    folder = tmp_path / "mixed"
    folder.mkdir()
    (folder / "a.png").write_bytes((Path(golden["inf_dir"]) / "micro.png").read_bytes())
    cv2.imwrite(str(folder / "b.tif"), golden["image"])  # cv2 writes LZW TIFF by default
    cfg = {**golden["cfg"], "performance": {**golden["cfg"]["performance"], "use_bf16": False}}
    res = run_inference(
        "zds", golden["split_dir"], scale_bar=lambda img: ("0", 1.0), image_folder=str(folder),
        output_dir=str(tmp_path / "out"), config=cfg, device="cpu",
    )
    assert res["processed"] == ["a.png"] and res["failed"] == ["b.tif"]
    rle = _rows(res["rle_csv"])
    assert len(rle) > 1 and {r[0] for r in rle[1:]} == {"a.png"}

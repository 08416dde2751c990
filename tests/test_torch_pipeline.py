"""Port parity of the whole inference pipeline: the JAX and the port
``InferencePipeline`` on the golden fixture (zoo-format checkpoint with
deterministic heads, one 128² micrograph with a scale bar), postprocessing
on, multiscale at two scales, on the CPU in float32.

The RLE CSV must be equal string for string; the measurement CSV must have
the same rows, every number within 1e-4 relative (the two frameworks sum
convolutions in other orders, which moves a contour vertex only when a
mask probability sits within ~1e-6 of the threshold). Both pipelines read
the scale bar themselves; the default ``run_inference`` runs the ensemble
of an R101 and an R50 checkpoint under the user's config file and dataset
YAML."""

import csv
import json
import os
import pickle
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

import deepemia_tpu_torch.config.config as port_cfg
from deepemia_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from deepemia_tpu.inference.pipeline import run_inference as jax_run_inference
from deepemia_tpu.inference.scalebar import detect_scale_bar
from deepemia_tpu.models.weights import export_detectron2_state_dict
from deepemia_tpu_torch.inference.measure import CSV_HEADER
from deepemia_tpu_torch.inference.pipeline import InferencePipeline, run_inference
from deepemia_tpu_torch.ops.rle import rle_decode
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(4)

REL_TOL = 1e-4


def _zoo_state_dict(params):
    """A zoo-format state dict with deterministic heads (see ``golden``)."""
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
    return sd


def _write_checkpoint(path, sd):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "Detectron2 Model Zoo"}, f, protocol=2)


@pytest.fixture()
def golden(tmp_home, tmp_path, tiny_r50):
    """The golden fixture of tests/test_pipeline_golden.py with
    postprocessing on, two multiscale scales and damped RPN deltas and mask
    logits."""
    from deepemia_tpu.config import get_config

    port_cfg._default_store = None
    _, params = tiny_r50
    sd = _zoo_state_dict(params)

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
    _write_checkpoint(split_dir / "zds" / "rcnn_r50" / "model_final_r50.pkl", sd)

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
    yield {"cfg": cfg, "split_dir": str(split_dir), "inf_dir": str(inf_dir), "tmp": tmp_path, "image": im}
    port_cfg._default_store = None


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_pipeline_matches_jax(golden):
    _pipeline_matches_jax(golden, golden["cfg"], "")


def test_pipeline_matches_jax_int8_trunk(golden):
    """``quantized_inference: trunk``: both packages serve the ResNet trunk
    in int8 (the port through the plain version of K4 on the CPU)."""
    cfg = golden["cfg"]
    cfg = {**cfg, "performance": {**cfg["performance"], "quantized_inference": "trunk"}}
    pipe = _pipeline_matches_jax(golden, cfg, "_int8")
    assert pipe.quant_backbone == "trunk" and pipe.engine.model.quant_backbone == "trunk"


def _pipeline_matches_jax(golden, cfg, tag):
    common = dict(config=cfg, use_bf16=False, default_threshold=0.2)
    ref = JaxPipeline("zds", golden["split_dir"], output_dir=str(golden["tmp"] / f"jax{tag}"), **common).run(
        golden["inf_dir"], visualize=False
    )
    psum, um_pix = detect_scale_bar(cv2.imread(str(Path(golden["inf_dir"]) / "micro.png")), cfg, "zds")
    assert psum == "2"
    pipe = InferencePipeline("zds", golden["split_dir"], output_dir=str(golden["tmp"] / f"port{tag}"), device="cpu",
                             **common)
    assert pipe.use_multiscale and pipe.postproc_enabled and not pipe.use_ensemble
    got = pipe.run(golden["inf_dir"], visualize=False)
    assert got["processed"] == ref["processed"] == ["micro.png"] and not got["failed"]
    assert got["scale_bars"] == {"micro.png": (psum, um_pix)} and got["members"] == {"micro.png": ["R50"]}
    assert {"decode", "scalebar", "engine", "postprocess", "rle", "rle_rows", "measurements", "csv"} <= set(got["stages"])

    _assert_csvs_match(got, ref, (128, 128))
    return pipe


def _assert_csvs_match(got, ref, hw):
    ref_rle, got_rle = _rows(ref["rle_csv"]), _rows(got["rle_csv"])
    assert len(got_rle) > 1 and got_rle == ref_rle
    for _, enc in got_rle[1:]:
        vals = [int(t) for t in enc.split()]
        assert rle_decode(vals, hw).sum() == sum(vals[1::2])

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


def test_pipeline_refuses_what_is_not_ported(golden, caplog):
    """Every serving option is ported now: ``quantized_inference`` trunk and
    full serve int8 backbones, and an unknown value warns and serves
    ``none``, as the JAX package does; the device measurement backend
    builds too."""
    from deepemia_tpu_torch.models.quant import Int8Conv2d

    cfg = golden["cfg"]
    for value, n_int8 in (("trunk", 53), ("full", 61), ("int4", 0)):
        q = {**cfg, "performance": {**cfg["performance"], "quantized_inference": value}}
        caplog.clear()
        pipe = InferencePipeline("zds", golden["split_dir"], config=q, use_bf16=False, device="cpu")
        assert pipe.quant_backbone == (value if n_int8 else "none")
        assert sum(isinstance(m, Int8Conv2d) for m in pipe.engine.model.modules()) == n_int8
        assert ("Unknown quantized_inference" in caplog.text) == (n_int8 == 0)
    ok = {**cfg, "performance": {**cfg["performance"], "measurement_backend": "device"}}
    pipe = InferencePipeline("zds", golden["split_dir"], config=ok, use_bf16=False, device="cpu")
    assert pipe.measurement_backend == "device"


def test_default_run_inference_with_ensemble_matches_jax(golden):
    """Scale-bar OCR and the ensemble are ported: with an R101 and an R50
    checkpoint, the user's config file and a dataset YAML, both packages'
    default ``run_inference`` (no config, no scale-bar reader passed) read
    the bar, run both members (R101 first) and write matching CSVs."""
    from deepemia_tpu.models.mask_rcnn import build_model as jax_build_model
    from deepemia_tpu.models.mask_rcnn import init_params

    # the "R101" member: an R50-depth network from another seed (the R101
    # network is held to the JAX package in tests/test_torch_r101.py)
    params = init_params(jax_build_model("R50", num_classes=2, use_bf16=False), (64, 64), seed=1)
    sd = _zoo_state_dict(params)
    # mask logits 4 +- ~0.3: this member's masks keep clear of the 0.5
    # threshold, where the frameworks' float32 sums could flip a pixel
    sd["roi_heads.mask_head.predictor.weight"] = sd["roi_heads.mask_head.predictor.weight"] * 1e-1
    _write_checkpoint(Path(golden["split_dir"]) / "zds" / "rcnn_r101" / "model_final_r101.pkl", sd)
    cfg = golden["cfg"]
    base = {k: v for k, v in cfg.items() if k not in ("scale_bar_rois", "inference_settings")}
    base["performance"] = {**cfg["performance"], "use_bf16": False}
    base["inference_settings"] = {**cfg["inference_settings"], "ensemble_settings": {"enabled": False}}
    home = Path(cfg["paths"]["dataset_configs_dir"]).parent
    (home / "config.yaml").write_text(yaml.safe_dump(base, sort_keys=False))
    (home / "datasets").mkdir(exist_ok=True)
    (home / "datasets" / "zds.yaml").write_text(yaml.safe_dump({
        "scale_bar_roi": cfg["scale_bar_rois"]["default"],
        "inference_overrides": {"ensemble_settings": {"enabled": True, "small_classes_only": True}},
    }))
    jax_cfg_mod = __import__("deepemia_tpu.config.config", fromlist=["get_store"])
    jax_cfg_mod.get_store().invalidate()
    ref = jax_run_inference("zds", golden["split_dir"], golden["inf_dir"], str(golden["tmp"] / "jax_ens"), visualize=False)
    got = run_inference("zds", golden["split_dir"], golden["inf_dir"], str(golden["tmp"] / "port_ens"), device="cpu",
                        visualize=False)
    assert got["processed"] == ref["processed"] == ["micro.png"] and not got["failed"]
    assert got["members"] == {"micro.png": ["R101", "R50"]}
    assert got["scale_bars"]["micro.png"][0] == "2"
    assert "zds" in port_cfg.get_config("zds")["scale_bar_rois"]
    _assert_csvs_match(got, ref, (128, 128))


def test_unreadable_image_is_isolated(golden, tmp_path):
    """A file the decoder cannot read (a TIFF cut off inside its header)
    lands in ``failed``; the other images go on to both CSVs."""
    folder = tmp_path / "mixed"
    folder.mkdir()
    (folder / "a.png").write_bytes((Path(golden["inf_dir"]) / "micro.png").read_bytes())
    (folder / "b.tif").write_bytes(b"II*\x00\x08\x00\x00\x00\x0c\x00\x00\x01")
    cfg = {**golden["cfg"], "performance": {**golden["cfg"]["performance"], "use_bf16": False}}
    res = run_inference(
        "zds", golden["split_dir"], image_folder=str(folder),
        output_dir=str(tmp_path / "out"), config=cfg, device="cpu",
    )
    assert res["processed"] == ["a.png"] and res["failed"] == ["b.tif"]
    rle = _rows(res["rle_csv"])
    assert len(rle) > 1 and {r[0] for r in rle[1:]} == {"a.png"}


@pytest.fixture()
def large(golden, tiny_r50, request):
    """A 224² micrograph with a blob and a scale bar, in a folder of its
    own, one scale, and the golden checkpoint with every box widened and
    heightened 15x (the box regression's bias: dw = dh = log 15 after
    Detectron2's weights 5, 5), so that instances reach past the 192 px
    measurement window. ``request.param`` may give the bar's label and the
    class names, (label, names)."""
    label, names = getattr(request, "param", ("2 um", ["particle", "pore"]))
    paths = golden["cfg"]["paths"]
    cats = Path(os.path.expanduser(paths["category_json"]))
    info = json.loads(cats.read_text())
    info["zds"][2] = names
    cats.write_text(json.dumps(info))
    sd = _zoo_state_dict(tiny_r50[1])
    bias = sd["roi_heads.box_predictor.bbox_pred.bias"]
    bias[2::4] = bias[3::4] = 5.0 * np.log(15.0)
    _write_checkpoint(Path(golden["split_dir"]) / "zds" / "rcnn_r50" / "model_final_r50.pkl", sd)
    im = np.full((224, 224, 3), 30, np.uint8)
    cv2.ellipse(im, (112, 100), (100, 60), 10, 0, 360, (200, 200, 200), -1)
    cv2.circle(im, (40, 180), 10, (230, 230, 230), -1)
    cv2.rectangle(im, (105, 206), (190, 209), (255, 255, 255), -1)
    cv2.putText(im, label, (120, 198), cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1, cv2.LINE_AA)
    folder = golden["tmp"] / "LARGE"
    folder.mkdir()
    cv2.imwrite(str(folder / "large.png"), im)
    cfg = golden["cfg"]
    cfg["inference_settings"]["multiscale_settings"]["baseline_scales"] = [1.0]
    return {**golden, "inf_dir": str(folder), "image": im, "label": label, "names": names}


def _text_region(hw, rle_rows, debug, psum):
    """The text boxes of an overlay: each kept instance's ID at its
    centroid and the scale-bar reading."""
    from deepemia_tpu_torch.inference import viz

    labels = []
    for i, (_, enc) in enumerate(rle_rows, 1):
        m = rle_decode([int(t) for t in enc.split()], hw)
        ys, xs = np.nonzero(m)
        if ys.size:
            labels.append((str(i), (int(xs.mean()), int(ys.mean())), 0.5))
    if debug["line"]:
        labels.append((f"scale: {psum} ({debug['text']!r})", (debug["line"][0], max(debug["line"][1] - 6, 12)), 0.45))
    region = np.zeros(hw, bool)
    for text, org, scale in labels:
        x0, y0, x1, y1 = viz.text_box(text, org, scale)
        region[max(y0, 0) : max(y1, 0), max(x0, 0) : max(x1, 0)] = True
    return region


@pytest.mark.parametrize("large", [("2 um", ["particle", "pore"]), ("2 µm", ["partícula", "póro µ"])],
                         indirect=True, ids=["ascii", "latin1"])
def test_run_with_overlays_matches_jax(large):
    """``visualize`` with instance IDs and the scale-bar drawing: the same
    CSVs as the JAX package (measured on the full-resolution masks, one
    instance wider than 192 px), the same bit-packed masks from the same
    instances, overlays equal outside the text boxes and within
    ``tests/test_torch_viz.py``'s TEXT_TOL inside them, the legend and the
    ETA file written; with an ASCII label and class names, and with a 'µm'
    label and non-ASCII class names."""
    from deepemia_tpu.inference.detections import InstanceSet as JaxInstanceSet
    from deepemia_tpu_torch.inference.detections import InstanceSet
    from deepemia_tpu_torch.inference.scalebar import detect_scale_bar as pt_detect
    from test_torch_viz import TEXT_TOL

    cfg = large["cfg"]
    common = dict(config=cfg, use_bf16=False, default_threshold=0.2)
    eta = {k: str(large["tmp"] / f"eta_{k}.json") for k in ("jax", "port")}
    jax_pipe = JaxPipeline("zds", large["split_dir"], output_dir=str(large["tmp"] / "jax_v"), **common)
    ref = jax_pipe.run(large["inf_dir"], visualize=True, eta_file=eta["jax"], draw_ids=True, draw_scalebar=True)
    pipe = InferencePipeline("zds", large["split_dir"], output_dir=str(large["tmp"] / "port_v"), device="cpu", **common)
    got = pipe.run(large["inf_dir"], eta_file=eta["port"], draw_ids=True, draw_scalebar=True)
    assert got["processed"] == ref["processed"] == ["large.png"] and not got["failed"]
    assert {"mask_export", "rle", "measurements", "overlay", "png"} <= set(got["stages"])
    _assert_csvs_match(got, ref, (224, 224))
    rle = _rows(got["rle_csv"])[1:]
    widths = [np.ptp(np.nonzero(rle_decode([int(t) for t in e.split()], (224, 224)))[1]) + 1 for _, e in rle]
    assert max(widths) > 192, widths

    psum, um_pix, debug = pt_detect(large["image"], cfg, "zds", return_debug=True)
    assert psum == "2" and debug["line"] is not None
    assert ("µ" in debug["text"]) == ("µ" in large["label"])
    for name in ("large.png_predictions.png", "class_legend.png"):
        a = cv2.imread(str(large["tmp"] / "port_v" / name))
        b = cv2.imread(str(large["tmp"] / "jax_v" / name))
        assert a is not None and a.shape == b.shape, name
        if name == "class_legend.png":
            from deepemia_tpu_torch.inference import viz

            region = np.zeros(a.shape[:2], bool)
            for i, n in enumerate(large["names"]):
                x0, y0, x1, y1 = viz.text_box(f"{i}: {n}", (48, i * 30 + 20), 0.55)
                region[y0:y1, x0:x1] = True
        else:
            region = _text_region((224, 224), rle, debug, psum)
        np.testing.assert_array_equal(a[~region], b[~region])
        assert int(np.abs(a.astype(int) - b.astype(int))[region].max(initial=0)) <= TEXT_TOL
    for k in ("jax", "port"):
        data = json.loads(Path(eta[k]).read_text())
        assert data["inference"]["average_time_per_image"] > 0

    # the bit-packed export of one instance set, the same in both packages
    rng = np.random.default_rng(0)
    k = 11
    boxes = np.sort(rng.uniform(-20, 240, (k, 2, 2)), axis=1).reshape(k, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    arrays = dict(boxes=boxes, scores=rng.random(k).astype(np.float32), classes=np.zeros(k, np.int32),
                  valid=rng.random(k) < 0.8, mask_probs=rng.random((k, 28, 28)).astype(np.float32))
    for hw in ((224, 224), (61, 77)):
        inst = InstanceSet(**{n: torch.from_numpy(v) for n, v in arrays.items()})
        packed, _ = pipe._packed_masks(inst, hw)
        ref_masks = jax_pipe._full_masks(JaxInstanceSet(**arrays), hw)
        np.testing.assert_array_equal(packed, np.packbits(ref_masks, axis=-1))
        crops, origins = pipe._mask_crops(inst, hw)  # each mask within its bounding box
        for m, c, (x0, y0) in zip(ref_masks, crops, origins):
            whole = np.zeros(hw, bool)
            whole[y0 : y0 + c.shape[0], x0 : x0 + c.shape[1]] = c
            np.testing.assert_array_equal(whole, m)
            assert c.size == 0 or (c[0].any() and c[-1].any() and c[:, 0].any() and c[:, -1].any())


def test_device_measurement_backend_matches_jax(golden):
    """``measurement_backend: device``: the measurement CSV of the JAX
    package's device backend, every number to 1e-4 relative."""
    cfg = {**golden["cfg"], "performance": {**golden["cfg"]["performance"], "measurement_backend": "device"}}
    common = dict(config=cfg, use_bf16=False, default_threshold=0.2)
    ref = JaxPipeline("zds", golden["split_dir"], output_dir=str(golden["tmp"] / "jax_d"), **common).run(
        golden["inf_dir"], visualize=False
    )
    got = InferencePipeline("zds", golden["split_dir"], output_dir=str(golden["tmp"] / "port_d"), device="cpu",
                            **common).run(golden["inf_dir"], visualize=False)
    assert got["processed"] == ref["processed"] == ["micro.png"]
    _assert_csvs_match(got, ref, (128, 128))

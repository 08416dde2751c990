"""The port's command line against the JAX package's: the same options,
dests, choices and defaults (the port adds ``--device``); ``--task
inference --device cpu`` end to end on a tiny home against ``python
main.py`` (``JAX_PLATFORMS=cpu``) on a home built the same way, both in
subprocesses: the same exit code and the same files out, the RLE CSV
equal and the measurement CSV to 1e-4 relative; ``--task prepare``, then
``train --max-iter 2``, then ``evaluate --visualize`` with ``--device cpu``
on a 3-image 64² dataset (the split file, the final weights, metrics.csv
with the JAX evaluator's metric names, the ETA store); ``--chips 2`` with
``--device cpu`` (two tile shards on the CPU for inference; train runs with
it); ``--cleanup`` within its allowed bases."""

import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml
from sklearn.model_selection import train_test_split as sk_train_test_split

import deepemia_tpu_torch.config.config as port_cfg
import deepemia_tpu_torch.data.datasets as port_ds
import deepemia_tpu_torch.train.workflow as port_wf
import deepemia_tpu_torch.utils.logging_utils as pt_logging
from deepemia_tpu.cli.main import build_parser as jax_build_parser
from deepemia_tpu.train.evaluator import evaluate_predictions as jax_evaluate_predictions
from deepemia_tpu_torch.cli import main as cli
from deepemia_tpu_torch.config.config import default_config
from deepemia_tpu_torch.train.trainer import TrainConfig
from test_torch_datasets import make_dataset
from test_torch_pipeline import _assert_csvs_match, _write_checkpoint, _zoo_state_dict
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def restored_logging():
    """The package logger (handlers, level, propagation, configured flag)
    as it was before the block: the CLI configures it in process, and a
    later test file in the same worker counts its handlers."""
    logger = logging.getLogger("deepemia_tpu_torch")
    saved = (list(logger.handlers), logger.level, logger.propagate, pt_logging._configured)
    try:
        yield
    finally:
        for h in logger.handlers:
            if h not in saved[0]:
                h.close()
        logger.handlers[:], logger.level, logger.propagate = saved[:3]
        pt_logging._configured = saved[3]


@pytest.fixture(autouse=True)
def _package_logging():
    with restored_logging():
        yield


def _actions(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, tuple(a.choices) if a.choices else None, a.type, a.required,
                 a.nargs, type(a).__name__)
        for a in parser._actions
    }


def test_parser_matches_jax():
    ref, got = _actions(jax_build_parser()), _actions(cli.build_parser())
    assert set(got) - set(ref) == {"device"}
    assert got["device"][:3] == (("--device",), "cuda", ("cuda", "cpu"))
    for dest in ref:
        assert got[dest] == ref[dest], dest
    args = cli.build_parser().parse_args(["--task", "inference", "--dataset_name", "d", "--id", "--no-upload"])
    assert (args.draw_id, args.upload, args.download, args.visualize, args.threshold, args.device) == (
        True, False, True, False, 0.65, "cuda")


def make_home(home: Path, sd) -> Path:
    """A framework home: config.yaml (one scale, no tiling, class-specific
    inference and the ensemble off), dataset_info.json, an R50 checkpoint
    with its (empty) split file and DATASET/INFERENCE with one 128²
    micrograph with a scale bar."""
    cfg = default_config(home)
    cfg["scale_bar_rois"]["default"] = {"x_start_factor": 0.3, "y_start_factor": 0.7, "width_factor": 0.7,
                                        "height_factor": 0.3}
    cfg["scalebar_thresholds"]["min_line_length"] = 30
    cfg["scalebar_thresholds"]["edge_margin_factor"] = 0.0
    cfg["performance"]["use_bf16"] = False
    inf = cfg["inference_settings"]
    inf["use_tile_based_inference"] = False
    inf["use_class_specific_inference"] = False
    inf["ensemble_settings"] = {"enabled": False}
    inf["multiscale_settings"]["baseline_scales"] = [1.0]
    (home / "config").mkdir(parents=True)
    (home / "config" / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    folder = home / "DATASET" / "INFERENCE"
    folder.mkdir(parents=True)
    (home / "dataset_info.json").write_text(json.dumps({"zds": [str(folder), str(folder), ["particle", "pore"]]}))
    _write_checkpoint(home / "split_dir" / "zds" / "rcnn_r50" / "model_final_r50.pkl", sd)
    (home / "split_dir" / "zds_split.json").write_text(json.dumps({"train": [], "test": []}))
    im = np.full((128, 128, 3), 30, np.uint8)
    cv2.circle(im, (40, 50), 16, (220, 220, 220), -1)
    cv2.rectangle(im, (60, 118), (109, 120), (255, 255, 255), -1)
    cv2.putText(im, "2 um", (60, 112), cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 255), 1, cv2.LINE_AA)
    cv2.imwrite(str(folder / "micro.tif"), im)  # OpenCV's default TIFF: LZW
    return home


def _run(cmd, home):
    env = {**os.environ, "DEEPEMIA_TPU_HOME": str(home), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(ROOT)}
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


FLAGS = ["--task", "inference", "--dataset_name", "zds", "--threshold", "0.2", "--visualize", "--id",
         "--draw-scalebar", "--no-download", "--no-upload"]


def test_inference_task_matches_the_jax_cli(tmp_path, tiny_r50):
    sd = _zoo_state_dict(tiny_r50[1])
    homes = {k: make_home(tmp_path / k, sd) for k in ("jax", "port")}
    ref = _run([sys.executable, "main.py", *FLAGS, "--no-gpu-check"], homes["jax"])
    got = _run([sys.executable, "-m", "deepemia_tpu_torch.cli.main", *FLAGS, "--device", "cpu"], homes["port"])
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert got.returncode == ref.returncode, got.stderr[-3000:]
    outs = {k: h / "output" for k, h in homes.items()}
    names = sorted(p.name for p in outs["port"].iterdir())
    assert names == sorted(p.name for p in outs["jax"].iterdir()) == [
        "R50_flip_results.csv", "class_legend.png", "measurements_results.csv", "micro.tif_predictions.png"]
    res = {k: {"rle_csv": str(o / "R50_flip_results.csv"), "measurements_csv": str(o / "measurements_results.csv")}
           for k, o in outs.items()}
    _assert_csvs_match(res["port"], res["jax"], (128, 128))
    for name in ("micro.tif_predictions.png", "class_legend.png"):
        a, b = (cv2.imread(str(o / name)) for o in (outs["port"], outs["jax"]))
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
    for h in homes.values():
        assert json.loads((h / "config" / "eta_data.json").read_text())["inference"]["average_time_per_image"] > 0
    assert "CPU" in got.stderr and "ETA" in got.stderr


def test_quantized_reaches_the_config(tmp_path, tiny_r50, monkeypatch):
    """``--quantized trunk`` sets ``performance.quantized_inference``, as the
    JAX CLI does: the pipeline serves the int8 trunk (all 53 ResNet convs)
    and the run writes its CSVs."""
    from deepemia_tpu_torch.inference import pipeline as port_pipeline
    from deepemia_tpu_torch.models.quant import Int8Conv2d

    home = make_home(tmp_path / "home", _zoo_state_dict(tiny_r50[1]))
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(home))
    monkeypatch.setattr(port_cfg, "_default_store", None)
    seen = []
    init = port_pipeline.InferencePipeline.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append((self.config["performance"]["quantized_inference"], self.quant_backbone,
                     sum(isinstance(m, Int8Conv2d) for m in self.engine.model.modules())))

    monkeypatch.setattr(port_pipeline.InferencePipeline, "__init__", spy)
    with pytest.raises(SystemExit) as e:
        cli.cli_entry([*FLAGS, "--quantized", "trunk", "--device", "cpu"])
    assert e.value.code == 0
    assert seen == [("trunk", "trunk", 53)]
    assert len(list((home / "output").rglob("measurements_results.csv"))) == 1
    port_cfg._default_store = None


# small proposal and sample capacities keep a CPU training step at 64² near 1 s
SMALL_CAPS = dict(pre_nms_topk=128, post_nms_topk=64, rpn_batch=64, roi_batch=64, mask_rois=16)


@pytest.fixture(scope="module")
def dataset_home(tmp_path_factory):
    """A home with a 3-image 64² dataset (DATASET/zds), its dataset_info
    entry and a config.yaml that trains at 64² with 8 GT slots and one
    loader worker, in float32; then ``--task prepare``, ``train --rcnn 50
    --max-iter 2 --chips 2`` and ``evaluate --rcnn 50 --visualize``, each with
    ``--device cpu --no-download --no-upload`` -> (home, exit codes, what
    the run left in ``rcnn_r50/``: the checkpoint names and the final
    weights' backbone, class count and class-head shape; the weight files
    themselves, ~0.5 GB, are removed)."""
    home = tmp_path_factory.mktemp("dataset_home")
    cfg = default_config(home)
    cfg["performance"]["use_bf16"] = False
    cfg["train"] = {"train_size": 64, "max_instances": 8, "loader_workers": 1}
    (home / "config").mkdir()
    (home / "config" / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    root = make_dataset(home / "DATASET" / "zds", 3, seed=12, size=(64, 64), classes=("particle", "pore"))
    (home / "dataset_info.json").write_text(json.dumps({"zds": [root, root, ["particle", "pore"]]}))
    rcs = {}
    with pytest.MonkeyPatch.context() as mp, restored_logging():
        mp.setenv("DEEPEMIA_TPU_HOME", str(home))
        mp.setattr(port_cfg, "_default_store", None)
        mp.setattr(port_wf, "TrainConfig", lambda **kw: TrainConfig(loss_caps=SMALL_CAPS, **kw))
        port_ds.catalog_clear()
        for task in (["prepare"], ["train", "--rcnn", "50", "--max-iter", "2", "--chips", "2"],
                     ["evaluate", "--rcnn", "50", "--visualize"]):
            with pytest.raises(SystemExit) as e:
                cli.cli_entry(["--task", *task, "--dataset_name", "zds", "--no-download", "--no-upload",
                               "--device", "cpu"])
            rcs[task[0]] = e.value.code
        port_ds.catalog_clear()
    port_cfg._default_store = None
    out = home / "split_dir" / "zds" / "rcnn_r50"
    trained = {"ckpts": sorted(p.name for p in (out / "ckpts").iterdir())}
    final = torch.load(out / "model_final_r50.pt", map_location="cpu")
    trained.update(backbone=final["backbone"], num_classes=final["num_classes"],
                   cls_shape=tuple(final["model"]["roi_heads.box_predictor.cls_score.weight"].shape))
    shutil.rmtree(out / "ckpts")
    (out / "model_final_r50.pt").unlink()
    return home, rcs, trained


def test_prepare_task_writes_the_split(dataset_home):
    home, rcs, _ = dataset_home
    assert rcs["prepare"] == 0
    split = json.loads((home / "split_dir" / "zds_split.json").read_text())
    train, test = sk_train_test_split(["img0.json", "img1.json", "img2.json"], test_size=0.2, random_state=42)
    assert split == {"train": train, "test": test} and len(test) == 1


def test_train_task_writes_the_final_weights(dataset_home):
    _, rcs, trained = dataset_home
    assert rcs["train"] == 0
    assert trained == {"ckpts": ["step_00000002.pt"], "backbone": "R50", "num_classes": 2, "cls_shape": (3, 1024)}


def test_evaluate_task_writes_metrics(dataset_home):
    home, rcs, _ = dataset_home
    assert rcs["evaluate"] == 0
    out = home / "output" / "zds" / "eval_r50"
    test = json.loads((home / "split_dir" / "zds_split.json").read_text())["test"]
    assert sorted(p.name for p in out.iterdir()) == [test[0].replace(".json", ".png_eval.png"), "metrics.csv"]
    with open(out / "metrics.csv") as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    sample = [{"pred_boxes": np.zeros((0, 4)), "pred_scores": np.zeros(0), "pred_classes": np.zeros(0, int),
               "pred_masks": np.zeros((0, 8, 8), bool), "gt_boxes": np.array([[0, 0, 4, 4]] * 2, np.float32),
               "gt_classes": np.array([0, 1]), "gt_masks": np.ones((2, 8, 8), bool)}]  # every class has GT
    names = sorted([*jax_evaluate_predictions(sample, 2), "eval_seconds", "num_images"])
    assert rows[0] == ["metric", "value"] and [r[0] for r in rows[1:]] == names
    values = dict(rows[1:])
    assert float(values["num_images"]) == 1 and float(values["eval_seconds"]) > 0
    eta = json.loads((home / "config" / "eta_data.json").read_text())
    assert set(eta) >= {"prepare", "train", "evaluate"}


def test_chips_above_1_run_on_the_cpu(tmp_path, tiny_r50, monkeypatch):
    """``--chips 2 --device cpu`` exits 0. Inference shards every image's
    tile grid (a 2x2 grid of 96 px tiles, two chunks) over two CPU shards
    and writes its CSVs."""
    from deepemia_tpu_torch.inference import pipeline as port_pipeline

    home = make_home(tmp_path / "home", _zoo_state_dict(tiny_r50[1]))
    cfg = yaml.safe_load((home / "config" / "config.yaml").read_text())
    cfg["inference_settings"]["use_tile_based_inference"] = True
    cfg["inference_settings"]["tile_settings"].update(tile_size=96, upscale_factor=1.0, tile_batch_size=2)
    (home / "config" / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(home))
    monkeypatch.setattr(port_cfg, "_default_store", None)
    seen = []
    init = port_pipeline.InferencePipeline.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append((self.config["performance"]["inference_chips"], self.tile_devices, self.engine.devices))

    monkeypatch.setattr(port_pipeline.InferencePipeline, "__init__", spy)
    with pytest.raises(SystemExit) as e:
        cli.cli_entry([*FLAGS, "--chips", "2", "--device", "cpu"])
    assert e.value.code == 0
    assert seen == [(2, [torch.device("cpu")] * 2, [torch.device("cpu")] * 2)]
    assert len((home / "output" / "measurements_results.csv").read_text().splitlines()) > 1
    port_cfg._default_store = None


def test_inference_without_a_dataset_name_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        cli.cli_entry(["--task", "inference"])
    assert e.value.code == 2 and "--dataset_name is required" in capsys.readouterr().err


def test_cleanup_stays_inside_its_bases(tmp_path, tiny_r50, monkeypatch):
    """After the upload, ``--cleanup`` removes the output and INFERENCE
    folders through the path guard and nothing else; an output folder
    configured outside the allowed bases survives."""
    home = make_home(tmp_path / "home", _zoo_state_dict(tiny_r50[1]))
    monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(home))
    monkeypatch.setattr(port_cfg, "_default_store", None)
    before = {p for p in home.rglob("*") if p.is_file()}
    with pytest.raises(SystemExit) as e:
        cli.cli_entry([*FLAGS[:-1], "--upload", "--cleanup", "--device", "cpu"])
    assert e.value.code == 0
    assert not (home / "output").exists() and not (home / "DATASET" / "INFERENCE").exists()
    archived = list((home / "bucket" / "Archive").rglob("measurements_results.csv"))
    assert len(archived) == 1
    kept = {p for p in home.rglob("*") if p.is_file()}
    assert {p for p in before if "DATASET" not in p.parts} <= kept
    port_cfg._default_store = None


def test_setup_task_writes_what_the_jax_setup_writes(tmp_path, monkeypatch):
    """``--task setup`` on the port's store and on the JAX package's, with
    the same answers: the same config.yaml but for the home's paths."""
    import deepemia_tpu.config.config as jax_cfg
    from deepemia_tpu.cli.main import cli_entry as jax_cli_entry

    answers = ["bkt", "0.6", "", "0.9", "", "120", "", "true"]
    written = {}
    for name, entry, store_mod in (("jax", jax_cli_entry, jax_cfg), ("port", cli.cli_entry, port_cfg)):
        home = tmp_path / name
        monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(home))
        monkeypatch.setattr(store_mod, "_default_store", None)
        feed = iter(answers)
        monkeypatch.setattr("builtins.input", lambda prompt="": next(feed))
        with pytest.raises(SystemExit) as e:
            entry(["--task", "setup"])
        assert e.value.code == 0
        written[name] = yaml.safe_load((home / "config" / "config.yaml").read_text())
    for cfg in written.values():
        cfg.pop("paths")
    assert written["port"] == written["jax"]
    assert written["port"]["bucket"] == "bkt" and written["port"]["measure_contrast_distribution"] is True
    assert written["port"]["scale_bar_rois"]["default"]["x_start_factor"] == 0.6
    port_cfg._default_store = None

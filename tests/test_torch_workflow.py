"""Port parity: the task workflows (``deepemia_tpu_torch/train/workflow.py``)
against the JAX package's: the HPO candidates and rung schedule (halving,
the tiny-budget fall-back and random search, with ``train`` and
``evaluate_model`` replaced as tests/test_train_eval.py replaces them), the
hyperparameter resolution and write-back, the training configs
``train_on_dataset`` builds from the config file, and ``evaluate_model`` on
the same weights and the same two test records (the same detection
counts, metrics within ``METRIC_TOL``)."""

import contextlib
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import deepemia_tpu.config.config as jax_cfg
import deepemia_tpu.data.datasets as jax_ds
import deepemia_tpu.train.workflow as jax_wf
import deepemia_tpu_torch.config.config as port_cfg
import deepemia_tpu_torch.data.datasets as port_ds
import deepemia_tpu_torch.train.workflow as port_wf
from deepemia_tpu_torch.utils.exceptions import TrainingError
from test_torch_datasets import make_dataset
from test_torch_pipeline import _write_checkpoint, _zoo_state_dict
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(4)

# evaluate_model on the same weights: XLA's and torch's float32 rounding
# move box corners by ~1e-4 px and scores by ~1e-6; neither moves a
# detection across the 0.45 threshold or a match, so AP and AR (percent)
# agree to METRIC_TOL
BOX_TOL_PX = 1e-3
SCORE_TOL = 1e-5
METRIC_TOL = 1e-6


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    """One framework home per package (the env var points at the port's
    while the port runs; the stores are reset around each use)."""
    monkeypatch.setattr(jax_cfg, "_default_store", None)
    monkeypatch.setattr(port_cfg, "_default_store", None)
    yield {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    jax_cfg._default_store = None
    port_cfg._default_store = None


def _fake_hpo(wf, calls, ap_of):
    state = {}

    def fake_train(records, nc, out_dir, cfg, max_steps_override=None, resume=True, **kw):
        trial = int(out_dir.rsplit("_t", 1)[1])
        calls.append((trial, max_steps_override, resume, cfg.base_lr, cfg.ims_per_batch, cfg.warmup_iters,
                      cfg.gamma, cfg.augment, cfg.train_size, cfg.checkpoint_every))
        os.makedirs(out_dir, exist_ok=True)
        state[f"{out_dir}/ckpt"] = trial
        return f"{out_dir}/ckpt", {"total": 1.0}

    def fake_eval(dataset_name, split_dir, rcnn=50, config=None, checkpoint=None, visualize=True, **kw):
        trial = state[checkpoint]
        steps = [c[1] for c in calls if c[0] == trial][-1]
        return {"segm/AP": ap_of(trial, steps)}

    return fake_train, fake_eval


@pytest.mark.parametrize("strategy, n_trials, budget", [("halving", 6, 200), ("halving", 3, 40), ("random", 3, 100),
                                                        ("halving", 2, 400)])
def test_hpo_schedule_matches_jax(homes, monkeypatch, tmp_path, strategy, n_trials, budget):
    """The same candidates, rungs, resumes and winner; the winner written
    to config.yaml and the dataset YAML as the JAX package writes it; no
    trial directory left."""
    got = {}
    for tag, wf, cfg_mod in (("jax", jax_wf, jax_cfg), ("port", port_wf, port_cfg)):
        monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(homes[tag]))
        cfg_mod._default_store = None
        calls = []
        fake_train, fake_eval = _fake_hpo(wf, calls, lambda trial, steps: trial + (50.0 if steps == budget else 0.0))
        monkeypatch.setattr(wf, "train", fake_train)
        monkeypatch.setattr(wf, "evaluate_model", fake_eval)
        monkeypatch.setattr(wf, "read_dataset_info", lambda p: {"ds": ["/x", "/x", ["a", "b"]]})
        monkeypatch.setattr(wf, "register_datasets", lambda *a, **k: ["a", "b"])
        monkeypatch.setattr(wf, "_registered_records", lambda *a: [{"file_name": "x", "annotations": [1]}])
        split = tmp_path / tag / "split"
        best = wf.optimize_hyperparameters("ds", str(split), backbone="R50", n_trials=n_trials,
                                           config=cfg_mod.get_config(), max_steps_override=budget, strategy=strategy,
                                           augment=True)
        store = cfg_mod.get_store()
        store.invalidate()
        ds_yaml = yaml.safe_load((store.dataset_config_dir / "ds.yaml").read_text())
        got[tag] = (calls, best, store.load()["rcnn_hyperparameters"]["best"], ds_yaml)
        assert not list(split.glob("ds/hpo_r50_t*"))
    assert got["port"] == got["jax"]
    calls = got["port"][0]
    if strategy == "halving" and n_trials == 6:
        assert [c[1] for c in calls] == [50] * 6 + [200] * 2 and [c[0] for c in calls[6:]] == [5, 4]
    else:
        assert [c[1:3] for c in calls] == [(budget, False)] * n_trials
    assert got["port"][2]["R50"] == got["port"][1]["params"] == got["port"][3]["rcnn_hyperparameters"]["best_R50"]


def test_hpo_candidates_match_jax_draws():
    cands = port_wf.hpo_candidates(8, seed=3)
    rng = np.random.default_rng(3)
    for c in cands:  # the JAX package's inline sampler, draw for draw
        assert c["base_lr"] == float(np.exp(rng.uniform(np.log(1e-5), np.log(1e-2))))
        assert c["ims_per_batch"] == int(rng.choice([2, 4, 8]))
        assert c["warmup_iters"] == int(rng.integers(500, 2001))
        assert c["gamma"] == float(rng.uniform(0.05, 0.2))
        assert c["batch_size_per_image"] == int(rng.choice([32, 64, 128]))
    assert port_wf.HPO_SEARCH_SPACE == jax_wf.HPO_SEARCH_SPACE


def test_hyperparameter_resolution_matches_jax(homes, monkeypatch):
    cfg = {"rcnn_hyperparameters": {"default": {"R50": {"base_lr": 1e-3, "gamma": 0.1}},
                                    "best": {"R50": {"base_lr": 5e-4, "gamma": None}}}}
    for backbone in ("R50", "R101"):
        assert port_wf.load_rcnn_hyperparameters(cfg, backbone) == jax_wf.load_rcnn_hyperparameters(cfg, backbone)
    written = {}
    for tag, wf, cfg_mod in (("jax", jax_wf, jax_cfg), ("port", port_wf, port_cfg)):
        monkeypatch.setenv("DEEPEMIA_TPU_HOME", str(homes[tag]))
        cfg_mod._default_store = None
        store = cfg_mod.get_store()
        store.create_dataset_config("ds")
        wf.save_best_rcnn_hyperparameters("R101", {"base_lr": 0.002, "ims_per_batch": 4}, "ds")
        wf.save_best_rcnn_hyperparameters("R50", {"base_lr": 0.001}, None)
        merged = cfg_mod.get_config("ds")
        written[tag] = (yaml.safe_load((store.dataset_config_dir / "ds.yaml").read_text()),
                        merged["rcnn_hyperparameters"]["best"],
                        wf.load_rcnn_hyperparameters(merged, "R101", "ds"))
    assert written["port"] == written["jax"]
    assert written["port"][2]["base_lr"] == 0.002 and written["port"][2]["ims_per_batch"] == 4


def test_train_on_dataset_configs_match_jax(homes, monkeypatch, tmp_path):
    """The training config of each backbone from the config file's
    ``train`` section and the dataset's best parameters (the TPU-only
    fields aside), the records, class count and output directory."""
    root = make_dataset(tmp_path / "data", 5, seed=6)
    seen = {}
    for tag, wf, cfg_mod in (("jax", jax_wf, jax_cfg), ("port", port_wf, port_cfg)):
        cfg = cfg_mod.default_config(homes[tag])
        cfg["train"] = {"train_size": 96, "max_instances": 16, "resize_mode": "range", "min_size_range": [64, 80],
                        "max_size": 120, "loader_workers": 1, "grad_clip_norm": 5.0, "roi_backend": "auto",
                        "steps_per_dispatch": 4, "pretrained_weights": {"R101": "/zoo/r101.pkl"}}
        cfg["rcnn_hyperparameters"]["best"] = {"R50": {"base_lr": 0.004, "ims_per_batch": 4}}
        os.makedirs(homes[tag], exist_ok=True)
        with open(cfg["paths"]["category_json"], "w") as f:
            json.dump({"ds": [root, root, ["a", "b"]]}, f)
        got = []
        monkeypatch.setattr(wf, "train", lambda records, nc, out, c, **kw: got.append((records, nc, out, c, kw)) or (
            f"{out}/final", {"total": 2.0}))
        monkeypatch.setattr(wf, "evaluate_model", lambda *a, **k: {"segm/AP": 1.0})
        split = cfg["paths"]["split_dir"]
        os.makedirs(split)
        res = wf.train_on_dataset("ds", split, rcnn=0, augment=True, config=cfg, max_steps_override=7)
        seen[tag] = (got, res)
        for mod in (jax_ds, port_ds):
            mod.catalog_clear()
    (jgot, jres), (pgot, pres) = seen["jax"], seen["port"]
    assert [b for b in pres] == [b for b in jres] == ["R50", "R101"]
    for (jr, jnc, jout, jc, jkw), (pr, pnc, pout, pc, pkw) in zip(jgot, pgot):
        assert pr == jr and pnc == jnc == 2 and os.path.relpath(pout, homes["port"]) == os.path.relpath(jout, homes["jax"])
        assert pkw["max_steps_override"] == jkw["max_steps_override"] == 7
        for field in ("backbone", "base_lr", "ims_per_batch", "warmup_iters", "gamma", "augment", "train_size",
                      "resize_mode", "min_size_range", "max_size", "max_instances", "loader_workers", "use_bf16",
                      "init_checkpoint", "grad_clip_norm", "checkpoint_every", "seed", "zero_init_residual"):
            assert getattr(pc, field) == getattr(jc, field), field
    assert pgot[0][3].base_lr == 0.004 and pgot[1][3].init_checkpoint == "/zoo/r101.pkl"
    assert pres["R50"]["train/total"] == 2.0 and pres["R50"]["segm/AP"] == 1.0


def test_evaluate_model_matches_jax(homes, monkeypatch, tmp_path, tiny_r50):
    """The same zoo weights (the tiny R50 of the JAX tests, class logits
    favouring class 0) and the same two test records through both
    packages' ``evaluate_model`` on the CPU."""
    root = make_dataset(tmp_path / "data", 2, seed=8, size=(96, 128))
    sd = _zoo_state_dict(tiny_r50[1])
    rng = np.random.default_rng(0)
    sd["roi_heads.box_predictor.cls_score.weight"] = rng.normal(0, 1e-3, (3, 1024)).astype(np.float32)
    sd["roi_heads.box_predictor.cls_score.bias"] = np.array([3.0, 1.0, 0.0], np.float32)
    per_image, metrics = {}, {}
    for tag, wf, cfg_mod in (("jax", jax_wf, jax_cfg), ("port", port_wf, port_cfg)):
        cfg = cfg_mod.default_config(homes[tag])
        cfg["performance"]["use_bf16"] = False
        os.makedirs(homes[tag])
        with open(cfg["paths"]["category_json"], "w") as f:
            json.dump({"ds": [root, root, ["a", "b"]]}, f)
        split = homes[tag] / "split_dir"
        split.mkdir()
        (split / "ds_split.json").write_text(json.dumps({"train": [], "test": ["img0.json", "img1.json"]}))
        _write_checkpoint(split / "ds" / "rcnn_r50" / "model_final_r50.pkl", sd)
        real = wf.evaluate_predictions
        monkeypatch.setattr(wf, "evaluate_predictions", lambda pi, nc, real=real, tag=tag: (
            per_image.__setitem__(tag, pi), real(pi, nc))[1])
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=cfg, visualize=True, **kw)
        out = homes[tag] / "output" / "ds" / "eval_r50"
        assert sorted(p.name for p in out.iterdir()) == ["img0.png_eval.png", "img1.png_eval.png", "metrics.csv"]
        for mod in (jax_ds, port_ds):
            mod.catalog_clear()
    counts = [[len(d["pred_boxes"]) for d in per_image[t]] for t in ("jax", "port")]
    assert counts[1] == counts[0] and sum(counts[0]) > 0
    for a, b in zip(per_image["jax"], per_image["port"]):
        np.testing.assert_array_equal(b["gt_masks"], a["gt_masks"])
        # detections pair up one to one (near-equal scores may come in
        # another order): same class, corners within BOX_TOL_PX, scores
        # within SCORE_TOL
        dist = np.abs(b["pred_boxes"][:, None] - a["pred_boxes"][None]).max(-1)
        pair = dist.argmin(1)
        assert sorted(pair) == list(range(len(pair)))
        assert (dist[np.arange(len(pair)), pair] <= BOX_TOL_PX).all()
        np.testing.assert_array_equal(b["pred_classes"], a["pred_classes"][pair])
        np.testing.assert_allclose(b["pred_scores"], a["pred_scores"][pair], rtol=0, atol=SCORE_TOL)
    assert set(metrics["port"]) == set(metrics["jax"])
    for k, v in metrics["jax"].items():
        if k == "eval_seconds":
            continue
        w = metrics["port"][k]
        assert (math.isnan(v) and math.isnan(w)) or abs(w - v) <= METRIC_TOL * max(1.0, abs(v)), (k, w, v)
    with open(homes["port"] / "output" / "ds" / "eval_r50" / "metrics.csv") as f:
        names = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    assert names == sorted(metrics["jax"])
    for home in homes.values():  # ~0.2 GB of weights each
        (home / "split_dir" / "ds" / "rcnn_r50" / "model_final_r50.pkl").unlink()


@pytest.mark.parametrize("free_gb, refused", [(4.9, True), (5.0, False)])
def test_training_needs_5_gb_free(tmp_path, monkeypatch, free_gb, refused):
    """``train_on_dataset`` (``--task train``) refuses to start below 5 GB
    free on the split directory's filesystem, as the JAX package's does,
    before it reads any dataset: a nearly full disk fails every training
    task at once (the fault that ``torch_tmp_weights.drop_weights`` keeps
    the port's own tests clear of)."""
    usage = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(shutil, "disk_usage", lambda path: usage._replace(free=int(free_gb * 1e9)))

    def registered(*args):
        raise LookupError("past the check")

    monkeypatch.setattr(port_wf, "_register", registered)
    with pytest.raises(TrainingError if refused else LookupError,
                       match=f"Insufficient disk space: {free_gb} GB free" if refused else "past the check"):
        port_wf.train_on_dataset("zds", str(tmp_path), config={"train": {}})
    with pytest.raises(Exception, match="Insufficient disk space") if refused else contextlib.nullcontext():
        jax_wf.check_disk_space(str(tmp_path))

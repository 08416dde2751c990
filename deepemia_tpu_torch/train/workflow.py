"""Task-level training and evaluation (the JAX package's
``train/workflow.py``):

  * hyperparameters resolved default -> global best -> dataset best, and
    the HPO winner written back into ``config.yaml`` and the dataset's YAML
    through the port's ``ConfigStore``;
  * ``train_on_dataset``: the disk-space preflight, registration, optional
    HPO, training per backbone, evaluation after it, and the final weights
    ``split_dir/<ds>/rcnn_r{50,101}/model_final_r{50,101}.pt``, where
    ``data/models.get_trained_model_paths`` finds them;
  * ``evaluate_model``: the test split through ``TileEngine(use_tiling=
    False)`` at threshold 0.45, masks pasted at full resolution, COCO-style
    bbox and segm AP (``train/evaluator.py``), ``metrics.csv`` and optional
    overlays (``inference/viz.py``);
  * ``optimize_hyperparameters``: seeded successive halving (every
    candidate trains a short rung of max(50, budget // 4) steps, the top
    third resume to the full budget) or flat random search over the same
    space, maximising segm AP; trial directories are removed in
    ``finally``.

Entry points run on ``cuda`` unless ``device`` names another; training
runs data-parallel over the host's GPUs (``trainer.py``). In a process
group that a launcher started (``torchrun``), every rank trains and rank 0
alone evaluates; the HPO search runs in one process, which starts the
ranks of each trial itself. Left out:
nothing of the JAX module; the TPU-only training fields it sets
(``roi_backend``, ``steps_per_dispatch``, ``donate_buffers``) have no
counterpart in the port's ``TrainConfig``.
"""

from __future__ import annotations

import csv
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from deepemia_tpu_torch.config.config import ConfigStore, get_config, get_store
from deepemia_tpu_torch.data.datasets import (
    catalog_get,
    rasterize_annotations,
    read_dataset_info,
    register_datasets,
)
from deepemia_tpu_torch.train.evaluator import evaluate_predictions
from deepemia_tpu_torch.train.trainer import TrainConfig, process_group, train
from deepemia_tpu_torch.utils.exceptions import TrainingError

log = logging.getLogger("deepemia_tpu_torch.workflow")

HPO_SEARCH_SPACE = {
    # the reference's Optuna search space
    "base_lr": ("loguniform", 1e-5, 1e-2),
    "ims_per_batch": ("categorical", [2, 4, 8]),
    "warmup_iters": ("int", 500, 2000),
    "gamma": ("float", 0.05, 0.2),
    "batch_size_per_image": ("categorical", [32, 64, 128]),
}


def check_disk_space(path: str, required_gb: float = 5.0) -> None:
    """Raise ``TrainingError`` when the output filesystem has less than
    ``required_gb`` free."""
    usage = shutil.disk_usage(os.path.expanduser(path))
    free_gb = usage.free / 1e9
    if free_gb < required_gb:
        raise TrainingError(
            f"Insufficient disk space: {free_gb:.1f} GB free, {required_gb:.1f} GB required",
            details={"path": path},
        )


def load_rcnn_hyperparameters(config: dict, backbone: str, dataset_name: Optional[str] = None) -> Dict[str, float]:
    """Defaults, overridden by the best found (global, or the dataset's,
    which the config merge puts under ``rcnn_hyperparameters.best``)."""
    rh = config.get("rcnn_hyperparameters", {})
    params = dict(rh.get("default", {}).get(backbone, {}))
    best = rh.get("best", {}).get(backbone, {})
    params.update({k: v for k, v in best.items() if v is not None})
    return params


def save_best_rcnn_hyperparameters(
    backbone: str,
    params: Dict[str, float],
    dataset_name: Optional[str] = None,
    store: Optional[ConfigStore] = None,
) -> None:
    """Write HPO winners into ``config.yaml`` (``rcnn_hyperparameters.best``)
    and, with a dataset name, into the dataset's YAML
    (``rcnn_hyperparameters.best_<backbone>``)."""
    import yaml

    store = store or get_store()
    cfg = store.load()
    cfg.setdefault("rcnn_hyperparameters", {}).setdefault("best", {})[backbone] = dict(params)
    store.save(cfg)
    if dataset_name:
        ds_path = store.dataset_config_dir / f"{dataset_name}.yaml"
        ds_cfg = {}
        if ds_path.exists():
            ds_cfg = yaml.safe_load(ds_path.read_text()) or {}
        ds_cfg.setdefault("rcnn_hyperparameters", {})[f"best_{backbone}"] = dict(params)
        ds_path.parent.mkdir(parents=True, exist_ok=True)
        ds_path.write_text(yaml.safe_dump(ds_cfg, sort_keys=False))
        store.invalidate()
    log.info("Saved best %s hyperparameters%s", backbone, f" for {dataset_name}" if dataset_name else "")


def _registered_records(dataset_name: str, split: str) -> List[dict]:
    return catalog_get(f"{dataset_name}_{split}")


def _register(config: dict, dataset_name: str) -> List[str]:
    paths = config["paths"]
    info = read_dataset_info(paths["category_json"])
    return register_datasets(
        info, dataset_name, paths["split_dir"], paths["category_json"], paths.get("local_dataset_root", "~")
    )


def train_on_dataset(
    dataset_name: str,
    split_dir: str,
    rcnn: int = 0,
    augment: bool = False,
    optimize: bool = False,
    n_trials: int = 10,
    config: Optional[dict] = None,
    max_steps_override: Optional[int] = None,
    train_size: Optional[int] = None,
    use_bf16: Optional[bool] = None,
    init_checkpoint: Optional[str] = None,
    hpo_strategy: str = "halving",
    device=None,
) -> Dict[str, Dict[str, float]]:
    """Train the requested backbones (rcnn: 0 = both, 50, 101), evaluate
    each on the test split, and leave the final weights where inference
    finds them -> {backbone: {'checkpoint', 'train/<loss>', metrics}}.

    ``init_checkpoint`` (or ``train.pretrained_weights.<backbone>`` in the
    config) fine-tunes from zoo weights, re-initialising class-count heads
    that do not match."""
    config = config or get_config(dataset_name)
    rank, world = process_group()
    if optimize and world > 1:
        raise TrainingError(f"the HPO search runs in one process, not in a process group of {world} ranks: it "
                            "starts each trial's ranks itself")
    check_disk_space(split_dir)
    class_names = _register(config, dataset_name)
    train_records = _registered_records(dataset_name, "train")
    backbones = {0: ["R50", "R101"], 50: ["R50"], 101: ["R101"]}[rcnn]
    if use_bf16 is None:
        use_bf16 = bool(config.get("performance", {}).get("use_bf16", True))
    section = config.get("train", {})
    if train_size is None:
        train_size = int(section.get("train_size", 512))

    results: Dict[str, Dict[str, float]] = {}
    for backbone in backbones:
        if optimize:
            best = optimize_hyperparameters(
                dataset_name, split_dir, backbone=backbone, augment=augment, n_trials=n_trials, config=config,
                max_steps_override=max_steps_override or 200, train_size=train_size, strategy=hpo_strategy,
                device=device,
            )
            hp = best["params"]
        else:
            hp = load_rcnn_hyperparameters(config, backbone, dataset_name)
        out_dir = os.path.join(os.path.expanduser(split_dir), dataset_name, f"rcnn_{backbone.lower()}")
        pretrained = init_checkpoint or section.get("pretrained_weights", {}).get(backbone, "")
        cfg = TrainConfig(
            backbone=backbone,
            base_lr=float(hp.get("base_lr", 0.00025)),
            ims_per_batch=int(hp.get("ims_per_batch", 2)),
            warmup_iters=int(hp.get("warmup_iters", 1000)),
            gamma=float(hp.get("gamma", 0.1)),
            augment=augment,
            train_size=train_size,
            resize_mode=str(section.get("resize_mode", "fixed")),
            min_size_range=tuple(section.get("min_size_range", [640, 800])),
            max_size=int(section.get("max_size", 1333)),
            max_instances=int(section.get("max_instances", 64)),
            loader_workers=int(section.get("loader_workers", 2)),
            use_bf16=use_bf16,
            init_checkpoint=pretrained or None,
            grad_clip_norm=float(section.get("grad_clip_norm", 0)) or None,
        )
        log.info("Training %s on %s: %s%s", backbone, dataset_name, hp,
                 f" (fine-tuning from {pretrained})" if pretrained else "")
        ckpt, train_metrics = train(
            train_records, len(class_names), out_dir, cfg, max_steps_override=max_steps_override, device=device
        )
        if rank > 0:  # rank 0 evaluates
            results[backbone] = {"checkpoint": ckpt, **{f"train/{k}": v for k, v in train_metrics.items()}}
            continue
        eval_metrics = evaluate_model(
            dataset_name, split_dir, rcnn=int(backbone[1:]), config=config, visualize=False, device=device
        )
        results[backbone] = {
            "checkpoint": ckpt,
            **{f"train/{k}": v for k, v in train_metrics.items()},
            **eval_metrics,
        }
    return results


def hpo_candidates(n_trials: int, seed: int = 0) -> List[Dict[str, float]]:
    """``n_trials`` draws from ``HPO_SEARCH_SPACE``, in the JAX package's
    order, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def sample() -> Dict[str, float]:
        out = {}
        for name, spec in HPO_SEARCH_SPACE.items():
            kind = spec[0]
            if kind == "loguniform":
                out[name] = float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
            elif kind == "categorical":
                out[name] = int(rng.choice(spec[1]))
            elif kind == "int":
                out[name] = int(rng.integers(spec[1], spec[2] + 1))
            else:
                out[name] = float(rng.uniform(spec[1], spec[2]))
        return out

    return [sample() for _ in range(n_trials)]


def optimize_hyperparameters(
    dataset_name: str,
    split_dir: str,
    backbone: str = "R50",
    augment: bool = False,
    n_trials: int = 10,
    config: Optional[dict] = None,
    max_steps_override: int = 200,
    train_size: int = 512,
    seed: int = 0,
    strategy: str = "halving",
    device=None,
) -> Dict:
    """HPO over ``HPO_SEARCH_SPACE`` maximising segm AP; the winner is
    saved with :func:`save_best_rcnn_hyperparameters` -> {'value': AP,
    'params': {...}}.

    ``strategy='halving'``: every candidate trains a rung of max(50,
    budget // 4) steps, the top third resume their own checkpoints to the
    full budget, and the best full-budget AP wins; a budget too small for
    two rungs, fewer than 3 trials or ``strategy='random'`` run every
    candidate once at the full budget."""
    config = config or get_config(dataset_name)
    class_names = _register(config, dataset_name)
    train_records = _registered_records(dataset_name, "train")

    def trial_dir(trial: int) -> str:
        return os.path.join(os.path.expanduser(split_dir), dataset_name, f"hpo_{backbone.lower()}_t{trial}")

    def run_trial(trial: int, hp: Dict, steps: int, resume: bool) -> float:
        """Train (or continue) one candidate to ``steps`` steps -> its AP,
        -1 when the trial fails."""
        cfg = TrainConfig(
            backbone=backbone,
            base_lr=hp["base_lr"],
            ims_per_batch=hp["ims_per_batch"],
            warmup_iters=min(hp["warmup_iters"], steps // 2),
            gamma=hp["gamma"],
            augment=augment,
            train_size=train_size,
            checkpoint_every=steps,
        )
        try:
            ckpt, _ = train(
                train_records, len(class_names), trial_dir(trial), cfg, max_steps_override=steps, resume=resume,
                device=device,
            )
            metrics = evaluate_model(
                dataset_name, split_dir, rcnn=int(backbone[1:]), config=config, checkpoint=ckpt, visualize=False,
                device=device,
            )
            ap = metrics.get("segm/AP", metrics.get("bbox/AP", 0.0))
        except Exception as e:  # noqa: BLE001 - one failed trial does not end the search
            log.error("HPO trial %d failed: %s", trial, e, exc_info=True)
            ap = -1.0
        if not np.isfinite(ap):
            ap = -1.0
        log.info("HPO trial %d @%d steps: AP=%.2f params=%s", trial, steps, ap, hp)
        return float(ap)

    best = {"value": -1.0, "params": {}}
    candidates = hpo_candidates(n_trials, seed)
    try:
        # below ~67 steps rung 0 would reach the budget and the promotion
        # would resume past the end: plain full-budget trials instead
        rung0 = max(50, max_steps_override // 4)
        if strategy == "halving" and n_trials >= 3 and rung0 < max_steps_override:
            scored = [(run_trial(i, hp, rung0, resume=False), i) for i, hp in enumerate(candidates)]
            n_keep = max(1, -(-n_trials // 3))
            survivors = sorted(scored, key=lambda t: -t[0])[:n_keep]
            log.info("HPO halving: rung 0 done (%d steps), promoting %d/%d", rung0, n_keep, n_trials)
            for _, i in survivors:
                ap = run_trial(i, candidates[i], max_steps_override, resume=True)
                if ap > best["value"]:
                    best = {"value": ap, "params": candidates[i]}
        else:
            for i, hp in enumerate(candidates):
                ap = run_trial(i, hp, max_steps_override, resume=False)
                if ap > best["value"]:
                    best = {"value": ap, "params": hp}
    finally:
        for i in range(n_trials):
            shutil.rmtree(trial_dir(i), ignore_errors=True)
    if best["params"]:
        save_best_rcnn_hyperparameters(backbone, best["params"], dataset_name)
    return best


def evaluate_model(
    dataset_name: str,
    split_dir: str,
    rcnn: int = 50,
    threshold: float = 0.45,
    config: Optional[dict] = None,
    checkpoint: Optional[str] = None,
    visualize: bool = True,
    output_dir: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """Evaluate a trained model on the test split: one whole-image forward
    per image at ``threshold``, COCO-style bbox and segm AP,
    ``<output_dir>/<ds>/eval_r<rcnn>/metrics.csv`` and, with ``visualize``,
    one ``<image>_eval.png`` overlay per image. An image OpenCV cannot read
    either (missing, corrupt, or refused by both) is skipped, as the JAX
    package skips it; one OpenCV reads that the port does not decode
    (``UnsupportedImageError``) raises."""
    from deepemia_tpu_torch import resolve_device
    from deepemia_tpu_torch.data.models import get_trained_model_paths, load_model
    from deepemia_tpu_torch.inference import viz
    from deepemia_tpu_torch.inference.detections import bucket_size, compact_instances, slice_instances
    from deepemia_tpu_torch.inference.engine import ClassSettings, TileEngine
    from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
    from deepemia_tpu_torch.ops.masks import paste_masks

    dev = resolve_device(device)
    config = config or get_config(dataset_name)
    paths = config["paths"]
    num_classes = len(_register(config, dataset_name))

    if checkpoint is None:
        model_paths = get_trained_model_paths(split_dir, dataset_name)
        key = f"R{rcnn}"
        if key not in model_paths:
            raise TrainingError(f"No trained {key} model for {dataset_name}", details={"available": list(model_paths)})
        checkpoint = model_paths[key]
    use_bf16 = bool(config.get("performance", {}).get("use_bf16", True))
    model = load_model(checkpoint, num_classes, use_bf16, device=dev)
    engine = TileEngine(model, use_tiling=False, device=dev)
    settings = ClassSettings(
        confidence=torch.full((num_classes,), threshold, device=dev),
        nms_iou=torch.full((num_classes,), 0.5, device=dev),
        min_size=torch.zeros((num_classes,), device=dev),
    )

    records = _registered_records(dataset_name, "test")
    out_dir = Path(os.path.expanduser(output_dir or paths["output_dir"])) / dataset_name / f"eval_r{rcnn}"
    out_dir.mkdir(parents=True, exist_ok=True)

    per_image = []
    t0 = time.perf_counter()
    for rec in records:
        try:
            img = read_image(rec["file_name"])
        except UnsupportedImageError:
            raise  # OpenCV reads it: skipping would score fewer images than the JAX package
        except (OSError, ValueError) as e:
            log.warning("Unreadable test image %s — skipped (%s)", rec["file_name"], e)
            continue
        hw = (img.shape[0], img.shape[1])
        inst, _ = engine.infer(img, settings)
        inst = compact_instances(inst)
        n = int(inst.valid.sum())
        inst = slice_instances(inst, bucket_size(n, inst.capacity))
        masks = (paste_masks(inst.mask_probs, inst.boxes, hw[0], hw[1]) & inst.valid[:, None, None]).cpu().numpy()
        valid = inst.valid.cpu().numpy()
        classes = inst.classes.cpu().numpy()[valid]
        per_image.append(
            {
                "pred_boxes": inst.boxes.float().cpu().numpy()[valid],
                "pred_scores": inst.scores.float().cpu().numpy()[valid],
                "pred_classes": classes,
                "pred_masks": masks[valid],
                "gt_boxes": np.array([o["bbox"] for o in rec["annotations"]], np.float32).reshape(-1, 4),
                "gt_classes": np.array([o["category_id"] for o in rec["annotations"]], np.int32),
                "gt_masks": rasterize_annotations(rec),
            }
        )
        if visualize:
            overlay = viz.render_overlay(img, list(masks[valid]), classes)
            viz.save_png(out_dir / f"{Path(rec['file_name']).name}_eval.png", overlay)

    metrics = evaluate_predictions(per_image, num_classes)
    metrics["eval_seconds"] = time.perf_counter() - t0
    metrics["num_images"] = len(per_image)

    with open(out_dir / "metrics.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "value"])
        for k, v in sorted(metrics.items()):
            w.writerow([k, v])
    log.info("Evaluation of %s R%d: %s", dataset_name, rcnn,
             {k: round(v, 2) for k, v in metrics.items() if isinstance(v, float)})
    return metrics

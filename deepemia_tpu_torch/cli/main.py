"""The port's command line: ``python -m deepemia_tpu_torch.cli.main --task
{setup,prepare,train,evaluate,inference} ...``.

The JAX package's flag set, names and defaults (``deepemia_tpu/cli/main.py``),
plus ``--device {cuda,cpu}`` (default ``cuda``), the torch form of the JAX
CLI's ``JAX_PLATFORMS`` switch. Every task runs as the JAX package's:
``prepare`` (the dataset sync and the train/test split file), ``train``
(registration, ``--augment``, ``--optimize`` with ``--n-trials`` and
``--hpo-strategy``, ``--max-iter``, ``--pretrained-weights``, evaluation
after training, and ``--cleanup`` of the local dataset), ``evaluate``
(COCO metrics on the test split, ``--visualize`` overlays), ``inference``
(the ETA estimate, the ``dataset_info.json`` and ``INFERENCE/`` sync, the
pipeline with ``--threshold``, ``--visualize``, ``--id``,
``--draw-scalebar`` and ``--profile``, the selective upload and the
path-guarded ``--cleanup``) and ``setup`` (the interactive setup on the
port's config store); prepare, train and evaluate update the ETA store.
``--quantized {none,trunk,full}`` sets ``performance.quantized_inference``
(int8 serving of the backbone). Every task but setup logs the device it
runs on, with or without ``--no-gpu-check``, and inference the launches of
the CUDA kernels it ran (RoIAlign K1, the int8 conv K4 and quantizer K5).
``--chips`` sets ``performance.inference_chips``: the GPUs inference shards
each image's tile grid over (0, the default, for all; with ``--device
cpu``, that many shards on the CPU). ``--task train`` trains data-parallel
on every GPU of the host (``train/trainer.py``). Under a launcher
(``torchrun``, or ``DEEPEMIA_DISTRIBUTED=1`` with its variables) the task
starts ``torch.distributed`` first (``utils/device.py:
maybe_init_distributed``): ``train`` trains as a rank of the group,
``inference`` shards each image's tile grid over the devices of every rank
(``--chips`` then counts those), and ``prepare`` and ``evaluate`` run on
rank 0 while the other ranks wait for it and exit 0. Rank 0 alone writes
the results and uploads them (the JAX package writes the same files from
every process).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from deepemia_tpu_torch.config.config import get_config, get_store
from deepemia_tpu_torch.parallel import ranks as rank_ops
from deepemia_tpu_torch.utils.device import check_accelerator_availability, maybe_init_distributed
from deepemia_tpu_torch.utils.eta import estimate_eta, update_eta_data
from deepemia_tpu_torch.utils.exceptions import PipelineError
from deepemia_tpu_torch.utils.logging_utils import setup_logging, system_logger
from deepemia_tpu_torch.utils.storage import storage_from_config

log = logging.getLogger("deepemia_tpu_torch.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepemia",
        description="deepEMIA (PyTorch / CUDA): electron microscopy image analysis",
        formatter_class=argparse.RawTextHelpFormatter,
    )
    p.add_argument(
        "--task",
        required=True,
        choices=["prepare", "train", "evaluate", "inference", "setup"],
        help=(
            "prepare: split dataset and register\n"
            "train: train segmentation models (R50/R101/combo)\n"
            "evaluate: COCO metrics on the test split\n"
            "inference: tile-based inference + measurements\n"
            "setup: first-time configuration"
        ),
    )
    p.add_argument("--dataset_name", help="Dataset name from dataset_info.json")
    p.add_argument("--threshold", type=float, default=0.65,
                   help="Detection confidence threshold for inference [default 0.65]")
    p.add_argument("--dataset_format", default="json", choices=["json", "coco"])
    p.add_argument("--visualize", action="store_true", default=False)
    p.add_argument("--download", action=argparse.BooleanOptionalAction, default=True,
                   help="Sync data from the artifact store before the task")
    p.add_argument("--upload", action=argparse.BooleanOptionalAction, default=True,
                   help="Upload results to the artifact store after the task")
    p.add_argument("--id", dest="draw_id", action="store_true", default=False)
    p.add_argument("--rcnn", default="101", choices=["50", "101", "combo"])
    p.add_argument("--augment", action="store_true")
    p.add_argument("--optimize", action="store_true", help="Run HPO search")
    p.add_argument("--n-trials", type=int, default=10)
    p.add_argument("--hpo-strategy", default="halving", choices=["halving", "random"],
                   help="successive halving (default) or flat random search")
    p.add_argument("--max-iter", type=int, default=None, help="Override auto training schedule length")
    p.add_argument("--pretrained-weights", default=None, metavar="PATH",
                   help=("Fine-tune from a zoo/pretrained checkpoint (Detectron2 .pth/.pkl or Caffe2 backbone pickle; "
                         "class-count heads are re-initialized), or a checkpoint of this package. Defaults to "
                         "train.pretrained_weights.<backbone> from config"))
    p.add_argument("--verbosity", default="info", choices=["debug", "info", "warning", "error"])
    p.add_argument("--no-gpu-check", action="store_true", help="Skip the CUDA preflight (automated runs)")
    p.add_argument("--draw-scalebar", action="store_true", default=False)
    p.add_argument("--cleanup", action="store_true",
                   help="Delete local datasets/results after a successful upload (path-guarded)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="Capture a torch.profiler trace of the task into DIR")
    p.add_argument("--chips", type=int, default=None,
                   help="Devices for tile-sharded inference (default: config performance.inference_chips; "
                        "0 = all local)")
    p.add_argument("--quantized", choices=["none", "trunk", "full"], default=None,
                   help="Int8 backbone serving: trunk = int8 ResNet, full = ResNet + FPN")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the task runs [default cuda; cpu only when asked for]")
    return p


def setup_config_interactive() -> None:
    """First-run interactive setup: the bucket, the default scale-bar ROI
    and thresholds, and the contrast measurement, written to the store's
    ``config.yaml``."""
    store = get_store()
    path = store.config_path
    print("=== deepEMIA Setup ===")
    if path.exists():
        if input(f"Config exists at {path}. Overwrite? (y/n): ").strip().lower() != "y":
            print("Setup cancelled.")
            return
        path.unlink()
    store.invalidate()
    cfg = store.load()  # writes the defaults
    cfg["bucket"] = input("Artifact bucket name (empty = local store): ").strip()
    print("\nScale bar ROI (Enter for defaults):")
    roi = cfg["scale_bar_rois"]["default"]
    for key, default in (("x_start_factor", 0.7), ("y_start_factor", 0.05), ("width_factor", 1.0),
                         ("height_factor", 0.05)):
        val = input(f"  {key} [{default}]: ").strip()
        roi[key] = float(val) if val else default
    print("\nScale bar thresholds:")
    thr = cfg["scalebar_thresholds"]
    for key in ("intensity", "proximity"):
        val = input(f"  {key} [{thr[key]}]: ").strip()
        if val:
            thr[key] = float(val)
    cfg["measure_contrast_distribution"] = input("\nmeasure_contrast_distribution [false]: ").strip().lower() == "true"
    store.save(cfg)
    print(f"Configuration written to {path}")


def _try_download(storage, name: str, target: Path) -> None:
    try:
        storage.download_dataset(name, target)
    except Exception as e:  # noqa: BLE001 - a local copy may serve
        if target.exists():
            log.warning("Using local copy of %s (download failed: %s)", name, e)
        else:
            log.warning("No data for %s (download failed: %s)", name, e)


def run_task(args) -> int:
    setup_logging(None, args.verbosity)
    maybe_init_distributed(args.device)  # several processes, when a launcher set them up
    if args.task == "setup":
        setup_config_interactive()
        return 0
    lead = rank_ops.is_lead()  # the rank that writes the task's records
    if not args.dataset_name:
        print("--dataset_name is required for this task", file=sys.stderr)
        return 2
    if rank_ops.rank_world()[1] > 1 and args.task in ("prepare", "evaluate"):
        # one rank's work: rank 0 does it, the others wait for it
        dev = torch.device(args.device)
        if not lead:
            rank_ops.barrier(dev)
            return 0
        try:
            return _run(args, lead)
        finally:
            rank_ops.barrier(dev)
    return _run(args, lead)


def _run(args, lead: bool) -> int:
    """The task (not setup) on this rank; ``lead`` writes its records."""
    cfg = get_config(args.dataset_name)
    paths = cfg["paths"]
    setup_logging(paths.get("logs_dir"), args.verbosity)
    storage = storage_from_config(cfg)
    eta_file = paths["eta_file"]
    if not args.no_gpu_check:
        check_accelerator_availability(args.device)
    dev = torch.device(args.device)
    system_logger.info("Task %s runs on %s: %s", args.task, dev, "the CPU" if dev.type == "cpu" else
                       torch.cuda.get_device_name(dev) if torch.cuda.is_available() else "no CUDA device found")

    category_json = Path(os.path.expanduser(paths["category_json"]))
    if args.download:
        try:
            storage.download_file("dataset_info.json", category_json)
        except Exception as e:  # noqa: BLE001 - the local file may serve
            if not category_json.exists():
                log.error("dataset_info.json unavailable: %s", e)
                return 1
            log.warning("Using local dataset_info.json (sync failed: %s)", e)

    ds_root = Path(os.path.expanduser(paths.get("local_dataset_root", "~")))
    dataset_dir = ds_root / "DATASET" / args.dataset_name
    split_dir = os.path.expanduser(paths["split_dir"])
    t_start = time.time()
    rc = 0

    if args.task == "prepare":
        if args.download:
            _try_download(storage, args.dataset_name, dataset_dir)
        from deepemia_tpu_torch.data.datasets import read_dataset_info, split_dataset

        info = read_dataset_info(paths["category_json"])
        if args.dataset_name not in info:
            log.error("Dataset %s not in dataset_info.json", args.dataset_name)
            return 1
        img_dir, label_dir, _ = info[args.dataset_name]
        split_dataset(label_dir if os.path.isdir(os.path.expanduser(label_dir)) else img_dir, args.dataset_name,
                      split_dir)
        update_eta_data(eta_file, "prepare", time.time() - t_start)

    elif args.task == "train":
        if args.download:
            _try_download(storage, args.dataset_name, dataset_dir)
        from deepemia_tpu_torch.train.workflow import train_on_dataset

        rcnn = {"combo": 0, "50": 50, "101": 101}[args.rcnn]
        results = train_on_dataset(
            args.dataset_name, split_dir, rcnn=rcnn, augment=args.augment, optimize=args.optimize,
            n_trials=args.n_trials, config=cfg, max_steps_override=args.max_iter,
            init_checkpoint=args.pretrained_weights, hpo_strategy=args.hpo_strategy, device=args.device,
        )
        for backbone, metrics in results.items():
            system_logger.info("%s: segm AP %.2f bbox AP %.2f", backbone, metrics.get("segm/AP", float("nan")),
                               metrics.get("bbox/AP", float("nan")))
        if args.cleanup and lead:
            from deepemia_tpu_torch.utils.safe_ops import safe_remove_files

            safe_remove_files([str(dataset_dir)], allowed_bases=[str(ds_root / "DATASET")])
            log.info("Deleted local dataset after training (--cleanup)")
        if lead:
            update_eta_data(eta_file, "train", time.time() - t_start)

    elif args.task == "evaluate":
        from deepemia_tpu_torch.train.workflow import evaluate_model

        rcnn = 101 if args.rcnn in ("101", "combo") else 50
        evaluate_model(args.dataset_name, split_dir, rcnn=rcnn, threshold=0.45, config=cfg, visualize=args.visualize,
                       device=args.device)
        update_eta_data(eta_file, "evaluate", time.time() - t_start)

    elif args.task == "inference":
        from deepemia_tpu_torch.inference.pipeline import InferencePipeline
        from deepemia_tpu_torch.utils.profiling import trace

        inference_dir = ds_root / "DATASET" / "INFERENCE"
        if args.download:
            _try_download(storage, "INFERENCE", inference_dir)
        n_images = len(list(inference_dir.glob("*"))) if inference_dir.exists() else 0
        system_logger.info("ETA: ~%.0fs for %d images", estimate_eta(eta_file, "inference", max(n_images, 1)),
                           n_images)
        if args.chips is not None:
            cfg.setdefault("performance", {})["inference_chips"] = args.chips
        if args.quantized is not None:
            cfg.setdefault("performance", {})["quantized_inference"] = args.quantized
        pipe = InferencePipeline(args.dataset_name, split_dir, config=cfg, default_threshold=args.threshold,
                                 device=args.device)
        with trace(args.profile):
            result = pipe.run(str(inference_dir), visualize=args.visualize, eta_file=eta_file, draw_ids=args.draw_id,
                              draw_scalebar=args.draw_scalebar)
        from deepemia_tpu_torch.kernels import int8_conv, int8_quant, roi_align

        system_logger.info("CUDA kernel launches: roi_align_fwd %d, int8_conv %d, int8_quant %d",
                           roi_align.counter.launches, int8_conv.counter.launches, int8_quant.counter.launches)
        if args.upload and lead:
            try:
                storage.upload_inference_results(Path(result["output_dir"]))
                if args.cleanup:
                    from deepemia_tpu_torch.utils.safe_ops import safe_remove_files

                    removed = safe_remove_files(
                        [result["output_dir"], str(inference_dir)],
                        allowed_bases=[paths["output_dir"], str(ds_root / "DATASET")],
                    )
                    log.info("Cleaned up %d local paths after upload", len(removed))
            except Exception as e:  # noqa: BLE001 - the results stay on disk
                log.error("Result upload failed: %s", e)
        rc = 0 if not result["failed"] else 1

    system_logger.info("Task %s finished in %.1fs", args.task, time.time() - t_start)
    return rc


def cli_entry(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    try:
        rc = run_task(args)
    except PipelineError as e:
        print(f"error: {e}", file=sys.stderr)
        rc = 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        rc = 130
    finally:
        if dist.is_initialized():  # the group maybe_init_distributed started
            dist.destroy_process_group()
    raise SystemExit(rc)


if __name__ == "__main__":
    cli_entry()

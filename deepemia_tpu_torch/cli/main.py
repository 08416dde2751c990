"""The port's command line: ``python -m deepemia_tpu_torch.cli.main --task
{setup,prepare,train,evaluate,inference} ...``.

The JAX package's flag set, names and defaults (``deepemia_tpu/cli/main.py``),
plus ``--device {cuda,cpu}`` (default ``cuda``), the torch form of the JAX
CLI's ``JAX_PLATFORMS`` switch. ``--task inference`` runs as the JAX
package's: the ETA estimate, the ``dataset_info.json`` and ``INFERENCE/``
sync, the pipeline with ``--threshold``, ``--visualize``, ``--id``,
``--draw-scalebar`` and ``--profile``, the selective upload and the
path-guarded ``--cleanup``. ``--task setup`` runs the interactive setup on
the port's config store. Not ported yet, and refused with exit code 2 and
the ROADMAP item named: ``--task prepare/train/evaluate`` (A5),
``--quantized`` other than ``none`` (A6), ``--chips`` above 1 (A8).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path
from typing import Optional

from deepemia_tpu_torch.config.config import get_config, get_store
from deepemia_tpu_torch.utils.device import check_accelerator_availability
from deepemia_tpu_torch.utils.eta import estimate_eta
from deepemia_tpu_torch.utils.exceptions import PipelineError
from deepemia_tpu_torch.utils.logging_utils import setup_logging, system_logger
from deepemia_tpu_torch.utils.storage import storage_from_config

log = logging.getLogger("deepemia_tpu_torch.cli")

# tasks that wait for training from a dataset (ROADMAP A5)
NOT_PORTED = ("prepare", "train", "evaluate")


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
                   help="Fine-tune from a pretrained checkpoint")
    p.add_argument("--verbosity", default="info", choices=["debug", "info", "warning", "error"])
    p.add_argument("--no-gpu-check", action="store_true", help="Skip the CUDA preflight (automated runs)")
    p.add_argument("--draw-scalebar", action="store_true", default=False)
    p.add_argument("--cleanup", action="store_true",
                   help="Delete local datasets/results after a successful upload (path-guarded)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="Capture a torch.profiler trace of the task into DIR")
    p.add_argument("--chips", type=int, default=None,
                   help="Devices for tile-sharded inference (the port runs on one: None, 0 or 1)")
    p.add_argument("--quantized", choices=["none", "trunk", "full"], default=None,
                   help="Int8 backbone serving (the port serves none)")
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


def _refusal(args) -> Optional[str]:
    """Why the port cannot run these arguments yet, or None."""
    if args.task in NOT_PORTED:
        return f"--task {args.task} is not ported to the PyTorch package yet: ROADMAP A5 (training from a dataset)"
    if args.chips not in (None, 0, 1):
        return f"--chips {args.chips}: tile sharding across GPUs is not ported (ROADMAP A8); the port runs on one"
    if args.quantized not in (None, "none"):
        return f"--quantized {args.quantized}: int8 serving is not ported (ROADMAP A6)"
    return None


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
    if args.task == "setup":
        setup_config_interactive()
        return 0
    refusal = _refusal(args)
    if refusal:
        print(f"error: {refusal}", file=sys.stderr)
        return 2
    if not args.dataset_name:
        print("--dataset_name is required for this task", file=sys.stderr)
        return 2

    cfg = get_config(args.dataset_name)
    paths = cfg["paths"]
    setup_logging(paths.get("logs_dir"), args.verbosity)
    storage = storage_from_config(cfg)
    eta_file = paths["eta_file"]
    if not args.no_gpu_check:
        check_accelerator_availability(args.device)

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
    split_dir = os.path.expanduser(paths["split_dir"])
    t_start = time.time()

    from deepemia_tpu_torch.inference.pipeline import InferencePipeline
    from deepemia_tpu_torch.utils.profiling import trace

    inference_dir = ds_root / "DATASET" / "INFERENCE"
    if args.download:
        _try_download(storage, "INFERENCE", inference_dir)
    n_images = len(list(inference_dir.glob("*"))) if inference_dir.exists() else 0
    system_logger.info("ETA: ~%.0fs for %d images", estimate_eta(eta_file, "inference", max(n_images, 1)), n_images)
    pipe = InferencePipeline(args.dataset_name, split_dir, config=cfg, default_threshold=args.threshold,
                             device=args.device)
    with trace(args.profile):
        result = pipe.run(str(inference_dir), visualize=args.visualize, eta_file=eta_file, draw_ids=args.draw_id,
                          draw_scalebar=args.draw_scalebar)
    if args.upload:
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
    system_logger.info("Task %s finished in %.1fs", args.task, time.time() - t_start)
    return 0 if not result["failed"] else 1


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
    raise SystemExit(rc)


if __name__ == "__main__":
    cli_entry()

"""End-to-end inference pipeline: a folder of micrographs -> the
measurements CSV and the RLE CSV.

Per image: decode (prefetched by a thread pool, with the upload to the
card started there), the scale bar read on the host, then on the device
the ensemble of every trained checkpoint (R101 before R50, one after the
other), or else the multiscale (or single-scale) tile engine of the one
checkpoint, morphology postprocess, cross-class dedup,
spatial constraints and compaction to a power-of-2 bucket; the run-length
encoding of every instance on the device, read back in one packed copy;
per-instance mask windows read back for the exact native measurements on
the host; rows streamed to ``measurements_results.csv``, RLE rows to
``R50_flip_results.csv`` (the reference's file name for any model). A
failing image is logged and listed in ``failed``; the others go on.

The configuration is the dataset's (``get_config(dataset_name)``: the
user's ``config.yaml`` with the dataset YAML merged) unless the caller
passes one. Not ported yet, and raising ``NotImplementedError``: overlays
(``visualize=True``), int8 serving (``quantized_inference``) and the
device measurement backend.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepemia_tpu_torch import resolve_device
from deepemia_tpu_torch.config.config import get_config
from deepemia_tpu_torch.data.datasets import dataset_class_names, read_dataset_info
from deepemia_tpu_torch.data.models import get_trained_model_paths, load_model
from deepemia_tpu_torch.inference import measure as measure_lib
from deepemia_tpu_torch.inference.constraints import apply_spatial_constraints, spec_from_config
from deepemia_tpu_torch.inference.detections import (
    InstanceSet,
    bucket_size,
    compact_instances,
    slice_instances,
)
from deepemia_tpu_torch.inference.engine import TileEngine, class_settings_from_config, cross_class_dedup
from deepemia_tpu_torch.inference.ensemble import run_ensemble, weights_from_config
from deepemia_tpu_torch.inference.measure_host import measurement_rows_host_windows
from deepemia_tpu_torch.inference.postprocess import morphology_postprocess, window_geometry
from deepemia_tpu_torch.inference.scalebar import detect_scale_bar
from deepemia_tpu_torch.ops.image import read_image, to_grayscale
from deepemia_tpu_torch.ops.masks import paste_masks
from deepemia_tpu_torch.ops.rle import rle_encode, rle_encode_batch, rle_encode_windowed, rle_to_string
from deepemia_tpu_torch.utils.profiling import StageTimers

log = logging.getLogger("deepemia_tpu_torch.pipeline")

IMAGE_EXTS = (".tif", ".tiff", ".png", ".jpg", ".jpeg", ".bmp")
# full-resolution pastes of the device RLE hold at most this many pixels at once
PASTE_BUDGET = 1 << 25


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMAGE_EXTS)


def _load_image(path: str, device: torch.device):
    """Decode, and start the upload to ``device`` (a pinned copy on CUDA,
    so the next image's upload overlaps this image's compute)."""
    img = read_image(path)
    if device.type == "cuda":
        return img, torch.from_numpy(img).pin_memory().to(device, non_blocking=True)
    return img, torch.from_numpy(img)


class InferencePipeline:
    """Builds the engines once, then processes folders of micrographs.

    ``config`` defaults to ``get_config(dataset_name)``. Each image's scale
    bar is read by :func:`detect_scale_bar`. ``device`` is ``cuda`` unless
    the caller names another (raises when CUDA is absent)."""

    def __init__(
        self,
        dataset_name: str,
        split_dir: str,
        output_dir: Optional[str] = None,
        config: Optional[dict] = None,
        use_bf16: Optional[bool] = None,
        default_threshold: Optional[float] = None,
        device=None,
    ):
        """``default_threshold`` applies to every class when
        ``use_class_specific_inference`` is off."""
        self.device = resolve_device(device)
        self.dataset_name = dataset_name
        self.config = config or get_config(dataset_name)
        self.split_dir = os.path.expanduser(split_dir)
        paths = self.config["paths"]
        self.output_dir = Path(os.path.expanduser(output_dir or paths["output_dir"]))
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.inf = self.config.get("inference_settings", {})
        perf = self.config.get("performance", {})
        self.use_bf16 = perf.get("use_bf16", True) if use_bf16 is None else use_bf16
        self.max_workers = int(perf.get("max_worker_threads", 3))
        self.parallel_loading = bool(perf.get("enable_parallel_image_loading", True))
        self.inference_batch = int(perf.get("inference_batch_size", 1))
        self.stream_measurements = bool(perf.get("stream_measurements_to_csv", True))
        backend = perf.get("measurement_backend", "host")
        if backend != "host":
            raise NotImplementedError(
                f"measurement_backend {backend!r} is not ported yet (ROADMAP: the device "
                "measurement backend); use 'host'"
            )
        quant = str(perf.get("quantized_inference", "none") or "none")
        if quant != "none":
            raise NotImplementedError(f"quantized_inference {quant!r} is not ported; use 'none'")

        self.class_names = dataset_class_names(read_dataset_info(paths["category_json"]), dataset_name)
        self.num_classes = len(self.class_names)
        self._default_threshold = default_threshold
        self._set_settings(None)
        sc = self.inf.get("spatial_constraints") or {}
        self.constraints = spec_from_config(sc.get(dataset_name) or sc.get("default"), self.num_classes)

        model_paths = get_trained_model_paths(self.split_dir, dataset_name)
        if not model_paths:
            raise FileNotFoundError(f"No trained models for dataset {dataset_name} under {self.split_dir}")
        ts = self.inf.get("tile_settings", {})
        self.mask_threshold = float(self.inf.get("mask_threshold", 0.5))
        self.measurement_window = int(self.inf.get("measurement_window", 192))
        engine_kw = dict(
            tile_size=int(ts.get("tile_size", 512)),
            overlap_ratio=float(ts.get("overlap_ratio", 0.1)),
            upscale_factor=float(ts.get("upscale_factor", 2.0)),
            edge_filter=bool(ts.get("edge_filter_enabled", True)),
            use_tiling=bool(self.inf.get("use_tile_based_inference", True)),
            confidence_mode=str(self.inf.get("confidence_mode", "auto")),
            tile_batch=int(ts.get("tile_batch_size", 16)),
            full_pass_max_dim=int(ts.get("full_pass_max_dim", 2048)),
            dedup_stride=int(ts.get("dedup_stride", 8)),
            classes_using_tiling=ts.get("classes_using_tiling"),
        )
        cap = int(ts.get("instance_capacity", 0) or 0)
        if cap > 0:
            engine_kw["capacity"] = cap
        # one engine per checkpoint, in name order: R101 before R50, and the
        # first is the primary model (size heuristic, multiscale, large classes)
        weights = weights_from_config(self.inf)
        self.engines: List[Tuple[str, TileEngine, float]] = []
        for name, path in sorted(model_paths.items()):
            model = load_model(path, self.num_classes, self.use_bf16, device=self.device)
            self.engines.append((name, TileEngine(model, device=self.device, **engine_kw), weights.get(name, 1.0)))
            log.info("Loaded %s from %s", name, path)
        self.engine = self.engines[0][1]
        es = self.inf.get("ensemble_settings", {})
        self.use_ensemble = bool(es.get("enabled", True)) and len(self.engines) > 1
        self.ensemble_small_only = bool(es.get("small_classes_only", True))
        # names of the members that ran on the last image
        self.members_ran: List[str] = [self.engines[0][0]]

        # class-conditional upscale: tiles run at native resolution when the
        # size heuristic, on a sample with detections, finds no class below
        # an absolute area (default 32² px²)
        self.class_conditional_upscale = bool(ts.get("class_conditional_upscale", True))
        self.upscale_small_area = float(ts.get("upscale_small_area", 1024.0))
        self.configured_upscale = float(ts.get("upscale_factor", 2.0))
        self._heuristic_valid = False
        self.upscale_classes: set = set()
        pp = self.inf.get("postprocessing", {}) or {}
        self.postproc_enabled = bool(pp.get("enabled", True))
        self.postproc_min_small = float(pp.get("min_size_small", 0) or 0)
        self.postproc_min_large = float(pp.get("min_size_large", 0) or 0)
        self.size_heuristic_sample = int(pp.get("size_heuristic_sample", 5))
        self.small_classes: set = set()
        self._heuristics_done = False
        css = self.inf.get("class_specific_settings", {}) or {}
        self.use_multiscale = any(isinstance(s, dict) and s.get("use_multiscale") for s in css.values())
        ms = self.inf.get("multiscale_settings", {}) or {}
        self.multiscale_scales = tuple(ms.get("baseline_scales", [0.7, 1.0, 1.5, 2.0]))
        self.multiscale_max = float(ms.get("max_scale", 3.0))
        self.use_iterative = bool(self.inf.get("use_iterative_inference", False))
        self.iterative_cfg = self.inf.get("iterative_stopping", {}) or {}

    # ------------------------------------------------------------------

    def _set_settings(self, small_classes) -> None:
        """Per-class thresholds; the default threshold overrides every class
        when class-specific inference is off."""
        self.settings = class_settings_from_config(self.inf, self.num_classes, small_classes, device=self.device)
        if self._default_threshold is not None and not self.inf.get("use_class_specific_inference", True):
            self.settings = self.settings._replace(
                confidence=torch.full((self.num_classes,), float(self._default_threshold), device=self.device)
            )

    def ensure_size_heuristics(self, image_folder: str, images) -> None:
        """Average mask size per class over up to ``size_heuristic_sample``
        images: sets the small classes (postprocess policy and thresholds)
        and whether tiles need the upscale."""
        if self._heuristics_done:
            return
        self._heuristics_done = True
        needed_for_settings = self.num_classes >= 2 and (
            self.postproc_enabled or (self.use_ensemble and self.ensemble_small_only)
        )
        needed_for_upscale = self.class_conditional_upscale and self.configured_upscale > 1
        if not (needed_for_settings or needed_for_upscale) or not images:
            return
        from deepemia_tpu_torch.inference.multiscale import (
            calculate_average_mask_sizes,
            classes_needing_upscale,
            determine_small_classes,
        )

        sample = [os.path.join(image_folder, n) for n in images[: self.size_heuristic_sample]]
        sizes = calculate_average_mask_sizes(self.engine, sample, self.settings)
        # a sample without confident detections establishes nothing: keep
        # the configured upscale
        self._heuristic_valid = bool(sizes)
        self.upscale_classes = classes_needing_upscale(sizes, self.upscale_small_area)
        if needed_for_settings and sizes:
            self.small_classes = determine_small_classes(sizes)
            self._set_settings(self.small_classes)
        log.info(
            "Size heuristic: small classes %s, upscale classes %s (avg sizes %s, upscale cutoff %.0f px^2)",
            sorted(self.small_classes), sorted(self.upscale_classes),
            {c: round(s, 1) for c, s in sizes.items()}, self.upscale_small_area,
        )

    def _infer_one(self, image, timers: StageTimers) -> Tuple[InstanceSet, torch.Tensor]:
        hw = (int(image.shape[0]), int(image.shape[1]))
        settings = self.settings
        upscale = None
        if self.class_conditional_upscale and self._heuristic_valid and not self.upscale_classes:
            upscale = 1.0
        floor = float(self.iterative_cfg.get("floor_threshold", 0.2))
        if self.use_iterative:
            # one pass down to the floor threshold; the ladder picks the cut
            settings = settings._replace(confidence=torch.clamp(settings.confidence, max=floor))
        with timers.time("engine"):
            if self.use_ensemble:
                inst, quality, self.members_ran = run_ensemble(
                    self.engines, image, settings, hw, dedup_iou=0.4,
                    secondary_class_filter=self.small_classes if self.ensemble_small_only else None,
                    upscale=upscale,
                )
            elif self.use_multiscale:
                from deepemia_tpu_torch.inference.multiscale import run_multiscale_inference

                inst, quality = run_multiscale_inference(
                    self.engine, image, settings, scales=self.multiscale_scales,
                    max_scale=self.multiscale_max, upscale=upscale,
                )
            else:
                inst, quality = self.engine.infer(image, settings, upscale=upscale)
        if self.use_iterative:
            from deepemia_tpu_torch.inference.multiscale import iterative_threshold_inference

            inst, diag = iterative_threshold_inference(
                inst,
                base_threshold=self.settings.confidence.cpu().numpy(),
                floor_threshold=floor,
                min_total_masks=int(self.iterative_cfg.get("min_total_masks", 10)),
                min_relative_increase=float(self.iterative_cfg.get("min_relative_increase", 0.25)),
                max_consecutive_zero=int(self.iterative_cfg.get("max_consecutive_zero", 1)),
                min_iterations=int(self.iterative_cfg.get("min_iterations", 2)),
            )
            log.debug("iterative inference: %s", diag)
        with timers.time("postprocess"):
            if self.postproc_enabled:
                # compact to a power-of-2 bucket first, so the window
                # morphology pays for about the real count
                inst = compact_instances(inst)
                inst = slice_instances(inst, bucket_size(int(inst.valid.sum()), inst.capacity))
                inst = morphology_postprocess(
                    inst, hw, small_classes=self.small_classes,
                    min_size_small=self.postproc_min_small or None,
                    min_size_large=self.postproc_min_large or None,
                    mask_threshold=self.mask_threshold,
                )
            inst = cross_class_dedup(inst, hw, iou_threshold=0.7)
            inst = apply_spatial_constraints(inst, hw, self.constraints)
            inst = compact_instances(inst)
            inst = slice_instances(inst, bucket_size(int(inst.valid.sum()), inst.capacity))
        return inst, quality

    def _device_rle(self, inst: InstanceSet, hw):
        """(starts, lengths, n_runs, max_runs) for every instance, on the
        device, from pastes of a few instances at a time (peak memory about
        ``PASTE_BUDGET`` pixels): the windowed encoder above 2048², the
        full-image encoder up to it."""
        h, w = hw
        # a run starts at most once per column and boundary crossing; 4x the
        # long side covers realistic blob outlines
        max_runs = min(h * w // 2 + 1, 4 * max(h, w))
        windowed = h * w > 2048 * 2048 and min(h, w) >= 512
        chunk = max(1, PASTE_BUDGET // ((512 * 512) if windowed else (h * w)))
        parts = []
        for s in range(0, inst.capacity, chunk):
            p, b, v = inst.mask_probs[s : s + chunk], inst.boxes[s : s + chunk], inst.valid[s : s + chunk]
            if windowed:
                parts.append(rle_encode_windowed(p, b, v, hw, max_runs=max_runs, threshold=self.mask_threshold))
            else:
                m = paste_masks(p, b, h, w, self.mask_threshold) & v[:, None, None]
                parts.append(rle_encode_batch(m, max_runs=max_runs))
        starts, lengths, n_runs = (torch.cat(t) for t in zip(*parts))
        return starts, lengths, n_runs, max_runs

    def _device_rle_one(self, inst: InstanceSet, i: int, hw) -> List[int]:
        """Exact full-resolution RLE of one instance on the device, for a
        mask over the batch capacity; a mask over even this capacity (h·w/2
        runs, a checkerboard) is encoded on the host."""
        h, w = hw
        max_runs_1 = min(h * w // 2 + 1, 16 * max(h, w))
        m = paste_masks(inst.mask_probs[i : i + 1], inst.boxes[i : i + 1], h, w, self.mask_threshold)
        st, ln, nr = rle_encode_batch(m & inst.valid[i], max_runs=max_runs_1)
        packed = torch.cat([st[0], ln[0], nr]).cpu().numpy()
        n = int(packed[-1])
        if n >= max_runs_1:
            return rle_encode(self._full_mask_one(inst, i, hw))
        pairs = np.empty(2 * n, np.int64)
        pairs[0::2] = packed[:n]
        pairs[1::2] = packed[max_runs_1 : max_runs_1 + n]
        return pairs.tolist()

    def _full_mask_one(self, inst: InstanceSet, i: int, hw) -> np.ndarray:
        """[H,W] bool of one instance on the host."""
        m = paste_masks(inst.mask_probs[i : i + 1], inst.boxes[i : i + 1], hw[0], hw[1], self.mask_threshold)
        return (m[0] & inst.valid[i]).cpu().numpy()

    def _mask_windows(self, inst: InstanceSet, window: int = 192):
        """Per-instance [K,S,S] bool crops at native pixel scale
        (shrink-to-fit for longer boxes), window origins [K,2] (x, y in
        scaled coordinates) and scales [K], on the host."""
        scale, origin, wbox = window_geometry(inst.boxes, window)
        wins = paste_masks(inst.mask_probs, wbox, window, window, self.mask_threshold)
        wins &= inst.valid[:, None, None]
        geom = torch.cat([origin, scale[:, None]], dim=1).cpu().numpy()
        return wins.cpu().numpy(), geom[:, :2], geom[:, 2]

    # ------------------------------------------------------------------

    def _rle_rows(self, name: str, inst: InstanceSet, kept: List[int], hw, packed, max_runs) -> List[Tuple[str, str]]:
        """RLE CSV rows of the ``kept`` instances from the packed run table
        [K, 2·max_runs+1] (starts, lengths, n_runs)."""
        rows = []
        for i in kept:
            n = int(packed[i, -1])
            if n >= max_runs:
                log.info("Mask %d over the device RLE batch capacity (%d): single-instance re-encode", i, max_runs)
                rows.append((name, rle_to_string(self._device_rle_one(inst, i, hw))))
                continue
            pairs = np.empty(2 * n, np.int64)
            pairs[0::2] = packed[i, :n]
            pairs[1::2] = packed[i, max_runs : max_runs + n]
            rows.append((name, rle_to_string(pairs.tolist())))
        return rows

    @torch.inference_mode()
    def run(self, image_folder: str, visualize: bool = False) -> Dict[str, object]:
        """Process every image in ``image_folder``; returns the artefact
        paths, the processed and failed image names and the stage timers'
        summary."""
        if visualize:
            raise NotImplementedError("overlays (visualize=True) are not ported yet (ROADMAP: overlays)")
        image_folder = os.path.expanduser(image_folder)
        images = sorted(f for f in os.listdir(image_folder) if is_image_file(f))
        if not images:
            log.warning("No images found in %s", image_folder)
        timers = StageTimers(self.device)
        with timers.time("size_heuristic"):
            self.ensure_size_heuristics(image_folder, images)
        rle_rows: List[Tuple[str, str]] = []
        meas_csv = self.output_dir / "measurements_results.csv"
        rle_csv = self.output_dir / "R50_flip_results.csv"
        measure_contrast = self.config.get("measure_contrast_distribution", False)
        processed, failed, seconds = [], [], []
        scale_bars: Dict[str, Tuple[str, float]] = {}
        members: Dict[str, List[str]] = {}

        # bounded prefetch: a few decoded images (and their uploads) ahead
        pool = ThreadPoolExecutor(max_workers=self.max_workers) if self.parallel_loading else None
        depth = max(2, self.max_workers, self.inference_batch)
        loads = {}
        next_submit = 0

        def submit(upto: int):
            nonlocal next_submit
            while next_submit < min(upto, len(images)):
                nm = images[next_submit]
                loads[nm] = pool.submit(_load_image, os.path.join(image_folder, nm), self.device)
                next_submit += 1

        try:
            if pool:
                submit(depth)
            with open(meas_csv, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(measure_lib.CSV_HEADER)
                for idx, name in enumerate(images):
                    t0 = time.perf_counter()
                    try:
                        with timers.time("decode"):
                            if pool:
                                submit(idx + 1 + depth)
                                img, img_dev = loads.pop(name).result()
                            else:
                                img, img_dev = _load_image(os.path.join(image_folder, name), self.device)
                        hw = (img.shape[0], img.shape[1])
                        with timers.time("scalebar"):
                            psum, um_pix, _ = detect_scale_bar(img, self.config, self.dataset_name, return_debug=True)
                        scale_bars[name] = (psum, um_pix)
                        inst, quality = self._infer_one(img_dev, timers)
                        members[name] = list(self.members_ran)
                        with timers.time("rle"):
                            # one packed copy of the two columns the host reads
                            vc = torch.stack([inst.valid.to(torch.int32), inst.classes.to(torch.int32)]).cpu().numpy()
                            valid, cls_host = vc[0] != 0, vc[1]
                            kept = [i for i in range(len(valid)) if valid[i]]
                            starts, lengths, n_runs, max_runs = self._device_rle(inst, hw)
                            # one packed device -> host copy
                            packed = torch.cat([starts, lengths, n_runs[:, None]], dim=1).cpu().numpy()
                        with timers.time("rle_rows"):
                            rle_rows.extend(self._rle_rows(name, inst, kept, hw, packed, max_runs))
                        with timers.time("measurements"):
                            gray = to_grayscale(torch.from_numpy(img)).numpy() if measure_contrast else None
                            wins, origins, scales = self._mask_windows(inst, self.measurement_window)
                            rows = measurement_rows_host_windows(
                                wins, origins, scales, cls_host, valid, name, self.class_names,
                                um_pix, psum, float(hw[0] * hw[1]), gray=gray, measure_contrast=measure_contrast,
                            )
                        with timers.time("csv"):
                            writer.writerows(rows)
                            if self.stream_measurements:
                                f.flush()
                        processed.append(name)
                        seconds.append(time.perf_counter() - t0)
                        log.info("%s: %d instances, quality %.2f, %.2fs", name, len(kept), float(quality), seconds[-1])
                    except Exception as e:  # noqa: BLE001 - per-image isolation
                        failed.append(name)
                        log.error("Image %s failed: %s", name, e, exc_info=True)
        finally:
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)

        with timers.time("csv"):
            with open(rle_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["ImageId", "EncodedPixels"])
                w.writerows(rle_rows)
        timers.log_summary("inference-profile")
        if failed:
            log.warning("Images not processed: %s", failed)
        else:
            log.info("All %d images processed", len(processed))
        return {
            "measurements_csv": str(meas_csv),
            "rle_csv": str(rle_csv),
            "output_dir": str(self.output_dir),
            "processed": processed,
            "failed": failed,
            "seconds_per_image": seconds,
            "stages": timers.summary(),
            "scale_bars": scale_bars,
            "members": members,
        }


def run_inference(
    dataset_name: str,
    split_dir: str,
    image_folder: Optional[str] = None,
    output_dir: Optional[str] = None,
    config: Optional[dict] = None,
    device=None,
) -> Dict[str, object]:
    """Module-level entry point: the config defaults to
    ``get_config(dataset_name)`` and ``image_folder`` to
    ``<local_dataset_root>/DATASET/INFERENCE``."""
    cfg = config or get_config(dataset_name)
    pipeline = InferencePipeline(dataset_name, split_dir, output_dir, cfg, device=device)
    folder = image_folder or os.path.join(
        os.path.expanduser(cfg["paths"].get("local_dataset_root", "~")), "DATASET", "INFERENCE"
    )
    return pipeline.run(folder)

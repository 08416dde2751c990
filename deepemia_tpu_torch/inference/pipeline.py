"""End-to-end inference pipeline: a folder of micrographs -> the
measurements CSV, the RLE CSV and (with ``visualize``) the overlays.

Per image: decode (prefetched by a thread pool, with the upload to the
card started there), the scale bar read on the host, then on the device
the ensemble of every trained checkpoint (R101 before R50, one after the
other), or else the multiscale (or single-scale) tile engine of the one
checkpoint, morphology postprocess, cross-class dedup,
spatial constraints and compaction to a power-of-2 bucket. Then, with
``visualize`` (the default, as in the JAX package): every instance's
full-resolution mask pasted and bit-packed on the device, read back in one
copy a chunk and unpacked within its bounding box, RLE rows and exact
native measurements from those masks (equal to the whole image's), and
``<name>_predictions.png`` (with instance IDs and the scale-bar debug
drawing on request) and ``class_legend.png``; without it: the run-length
encoding of every instance on the device, read back in one packed copy,
and per-instance mask windows for the native measurements. With
``measurement_backend: device`` the measurements are
``measure.measure_instances_device`` on the device, read back in one packed
copy. Rows stream to ``measurements_results.csv``, RLE rows to
``R50_flip_results.csv`` (the reference's file name for any model). A
failing image is logged and listed in ``failed``; the others go on. With
an ``eta_file`` the run's seconds per image update its running average.

The configuration is the dataset's (``get_config(dataset_name)``: the
user's ``config.yaml`` with the dataset YAML merged) unless the caller
passes one. ``performance.quantized_inference`` (``trunk`` or ``full``)
serves every checkpoint's backbone in int8 (``models/quant.py``, kernel K4
on the card); an unknown value logs a warning and serves ``none``, as the
JAX package does.

Across GPUs (``deepemia_tpu/inference/pipeline.py:273-318``):
``performance.inference_chips`` (0, the default, for every local GPU) sets
the devices every engine shards its tile grid over; with
``ensemble_member_parallel`` (default on) and at least as many devices as
members, each member takes its own contiguous group of them and the members
run at once, one thread each. On the CPU, ``inference_chips`` n runs n
shards (the JAX package's virtual CPU devices). One device is the
one-device path.

In a process group (``deepemia_tpu/inference/pipeline.py:270-309``, under
``torchrun``): every rank runs the whole pipeline over the same images.
The ranks first agree on the sorted image list (``PipelineError`` naming
the first difference otherwise) and, for each image, on whether every
rank read it (one all-reduce; a file one rank cannot read is skipped by
all). Every engine shards each image's tile grid over the devices of every
rank (``parallel/mesh.py:global_devices``, rank order, cut to
``inference_chips``), and the members of an ensemble share them and run
in turn, as the JAX package's do across processes. Every rank then holds
the same results; rank 0 alone writes the CSVs, the overlays and the ETA.
"""

from __future__ import annotations

import contextlib
import csv
import itertools
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
from deepemia_tpu_torch.inference import viz
from deepemia_tpu_torch.inference.ensemble import run_ensemble, weights_from_config
from deepemia_tpu_torch.inference.measure_host import measurement_rows_host, measurement_rows_host_windows
from deepemia_tpu_torch.inference.postprocess import morphology_postprocess, window_geometry
from deepemia_tpu_torch.inference.scalebar import detect_scale_bar
from deepemia_tpu_torch.models.quant import QUANT_MODES
from deepemia_tpu_torch.parallel import mesh
from deepemia_tpu_torch.parallel import ranks as rank_ops
from deepemia_tpu_torch.ops.image import read_image, to_grayscale
from deepemia_tpu_torch.ops.masks import paste_masks
from deepemia_tpu_torch.ops.rle import (
    rle_encode,
    rle_encode_batch,
    rle_encode_crop,
    rle_encode_windowed,
    rle_to_string,
)
from deepemia_tpu_torch.utils.eta import update_eta_data
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
        # in a process group rank 0 writes the results, the others nothing
        self.lead = rank_ops.is_lead()
        if self.lead:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self.inf = self.config.get("inference_settings", {})
        perf = self.config.get("performance", {})
        self.use_bf16 = perf.get("use_bf16", True) if use_bf16 is None else use_bf16
        self.max_workers = int(perf.get("max_worker_threads", 3))
        self.parallel_loading = bool(perf.get("enable_parallel_image_loading", True))
        self.inference_batch = int(perf.get("inference_batch_size", 1))
        self.stream_measurements = bool(perf.get("stream_measurements_to_csv", True))
        # host: the native exact contours; device: measure_instances_device
        self.measurement_backend = perf.get("measurement_backend", "host")
        self.quant_backbone = str(perf.get("quantized_inference", "none") or "none")
        if self.quant_backbone not in QUANT_MODES:
            log.warning("Unknown quantized_inference=%r; using 'none'", self.quant_backbone)
            self.quant_backbone = "none"

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
        es = self.inf.get("ensemble_settings", {})
        self.tile_devices = self._choose_tile_devices(perf, self.device)
        enabled = bool(es.get("enabled", True)) and bool(perf.get("ensemble_member_parallel", True))
        groups = self._member_groups(self.tile_devices, len(model_paths), enabled)
        # members on disjoint groups run at once (ensemble.run_ensemble)
        self.member_parallel = groups is not None
        self.engines: List[Tuple[str, TileEngine, float]] = []
        for (name, path), group in zip(sorted(model_paths.items()), groups or itertools.repeat(self.tile_devices)):
            model = load_model(path, self.num_classes, self.use_bf16, device=self._own_device(group),
                               quant_backbone=self.quant_backbone)
            self.engines.append((name, TileEngine(model, device=group, **engine_kw), weights.get(name, 1.0)))
            log.info("Loaded %s from %s", name, path)
        self.engine = self.engines[0][1]
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

    @staticmethod
    def _choose_tile_devices(perf: dict, device: torch.device) -> List:
        """The devices every engine shards its tile grid over:
        ``performance.inference_chips`` of the local GPUs from ``device``'s
        index on (0 = all), or n shards on the CPU; ``[device]`` when one is
        in play. In a process group: the first ``inference_chips`` (0 = all)
        of every rank's devices, as ``(rank, device)`` pairs in rank order
        (a rank's own: ``mesh.owned_devices`` of the host's GPUs, or its
        CPU)."""
        n_chips = int(perf.get("inference_chips", 0) or 0)
        if rank_ops.rank_world()[1] > 1:
            mine = mesh.owned_devices(mesh.local_devices()) if device.type == "cuda" else [device]
            every = mesh.global_devices(mine)
            want = len(every) if n_chips <= 0 else min(n_chips, len(every))
            log.info("Tile-sharded inference across %d devices of %d ranks", want, len({r for r, _ in every}))
            return every[:want]
        if device.type == "cpu":
            return [device] * max(1, n_chips)
        local = mesh.local_devices()[device.index or 0:]
        want = len(local) if n_chips <= 0 else min(n_chips, len(local))
        if want <= 1:
            return [device]
        log.info("Tile-sharded inference across %d devices", want)
        return mesh.tile_devices(want, local)

    @staticmethod
    def _member_groups(devices: List[torch.device], n_members: int, enabled: bool) -> Optional[List[List]]:
        """Each member's devices, disjoint contiguous groups of ``devices``,
        when member-parallel ensembling applies (enabled, several members,
        at least as many devices); None when every member shards over all
        of ``devices``, as in a process group, where the JAX rule shares
        the mesh."""
        if not (enabled and n_members > 1 and len(devices) >= n_members) or rank_ops.rank_world()[1] > 1:
            return None
        groups = mesh.partition_devices(devices, n_members)
        log.info("Member-parallel ensemble: %d members on disjoint device groups %s", n_members,
                 [len(g) for g in groups])
        return groups

    def _own_device(self, group: List) -> torch.device:
        """Where this rank keeps an engine's model: the first device of
        ``group`` (pairs in a process group) that it runs, else its own
        device."""
        if not isinstance(group[0], tuple):
            return group[0]
        rank = rank_ops.rank_world()[0]
        return next((d for r, d in group if r == rank), self.device)

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
                    upscale=upscale, parallel=self.member_parallel,
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

    def _packed_masks(self, inst: InstanceSet, hw) -> Tuple[np.ndarray, np.ndarray]:
        """([K,H,ceil(W/8)] uint8, [K,4] int64) on the host: every
        instance's full-resolution mask, pasted a few at a time (peak about
        ``PASTE_BUDGET`` pixels) and bit-packed on the device, 8 pixels a
        byte in ``np.unpackbits`` order (MSB first), so the one copy to the
        host is 8x smaller than the masks; and each mask's pixel bounding
        box (x0, y0, x1, y1), end exclusive (x1 <= x0 for an empty mask)."""
        h, w = hw
        wp = w + (-w) % 8
        dev = inst.boxes.device
        weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=dev)
        ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
        chunk = max(1, PASTE_BUDGET // (h * w))
        out = torch.empty((inst.capacity, h, wp // 8), dtype=torch.uint8, device=dev)
        boxes = []
        for s in range(0, inst.capacity, chunk):
            p, b, v = inst.mask_probs[s : s + chunk], inst.boxes[s : s + chunk], inst.valid[s : s + chunk]
            m = paste_masks(p, b, h, w, self.mask_threshold) & v[:, None, None]
            rows, cols = m.any(2), m.any(1)
            boxes.append(torch.stack([
                torch.where(cols, xs, w).amin(1), torch.where(rows, ys, h).amin(1),
                torch.where(cols, xs + 1, 0).amax(1), torch.where(rows, ys + 1, 0).amax(1),
            ], dim=1))
            if wp != w:
                m = torch.nn.functional.pad(m, (0, wp - w))
            bits = m.view(m.shape[0], h, wp // 8, 8).to(torch.int32)
            out[s : s + chunk] = (bits * weights).sum(-1).to(torch.uint8)
        # one copy of the packed masks, one of the boxes
        return out.cpu().numpy(), torch.cat(boxes).cpu().numpy()

    def _mask_crops(self, inst: InstanceSet, hw) -> Tuple[List[np.ndarray], np.ndarray]:
        """Each instance's full-resolution mask cut to its pixel bounding
        box, from :meth:`_packed_masks` (only the box's bytes are
        unpacked): ([K] [h,w] bool crops, [K,2] origins (x, y))."""
        packed, boxes = self._packed_masks(inst, hw)
        crops = []
        for i, (x0, y0, x1, y1) in enumerate(boxes.tolist()):
            if x1 <= x0:
                crops.append(np.zeros((0, 0), bool))
                continue
            b0 = x0 // 8
            bits = np.unpackbits(packed[i, y0:y1, b0 : (x1 + 7) // 8], axis=-1)
            crops.append(bits[:, x0 - 8 * b0 : x1 - 8 * b0].astype(bool))
        return crops, boxes[:, :2]

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
    def run(
        self,
        image_folder: str,
        visualize: bool = True,
        eta_file: Optional[str] = None,
        draw_ids: bool = False,
        draw_scalebar: bool = False,
    ) -> Dict[str, object]:
        """Process every image in ``image_folder``; returns the artefact
        paths, the processed and failed image names and the stage timers'
        summary. ``visualize`` writes each image's overlay (instance IDs with
        ``draw_ids``, the scale-bar ROI and line with ``draw_scalebar``) and
        the class legend, and measures the full-resolution masks."""
        image_folder = os.path.expanduser(image_folder)
        images = sorted(f for f in os.listdir(image_folder) if is_image_file(f))
        rank_ops.same_on_every_rank(images, f"the sorted image list of {image_folder}")
        if not images:
            log.warning("No images found in %s", image_folder)
        t_start = time.perf_counter()
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
            with open(meas_csv, "w", newline="") if self.lead else contextlib.nullcontext() as f:
                writer = csv.writer(f) if self.lead else None
                if writer:
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
                            psum, um_pix, sb_debug = detect_scale_bar(img, self.config, self.dataset_name, return_debug=True)
                        unread = None
                    except Exception as e:  # noqa: BLE001 - per-image isolation
                        # the JAX pipeline skips an image cv2.imread returns None for; this one
                        # skips any it cannot read, RefusedImageError and UnsupportedImageError
                        # alike, and logs the error that names the form
                        unread = e
                    # in a process group every rank goes on with the image or none does
                    if not rank_ops.agree(unread is None):
                        failed.append(name)
                        if unread is not None:
                            log.error("Image %s failed: %s", name, unread, exc_info=unread)
                        else:
                            log.error("Image %s skipped: another rank could not read it", name)
                        continue
                    try:
                        scale_bars[name] = (psum, um_pix)
                        inst, quality = self._infer_one(img_dev, timers)
                        members[name] = list(self.members_ran)
                        # one packed copy of the two columns the host reads
                        vc = torch.stack([inst.valid.to(torch.int32), inst.classes.to(torch.int32)]).cpu().numpy()
                        valid, cls_host = vc[0] != 0, vc[1]
                        kept = [i for i in range(len(valid)) if valid[i]]
                        if self.lead:
                            masks = origins = None
                            if visualize:
                                with timers.time("mask_export"):
                                    masks, origins = self._mask_crops(inst, hw)
                                with timers.time("rle"):
                                    rle_rows.extend(
                                        (name, rle_to_string(rle_encode_crop(masks[i], origins[i], hw[0])))
                                        for i in kept
                                    )
                            else:
                                with timers.time("rle"):
                                    starts, lengths, n_runs, max_runs = self._device_rle(inst, hw)
                                    # one packed device -> host copy
                                    packed = torch.cat([starts, lengths, n_runs[:, None]], dim=1).cpu().numpy()
                                with timers.time("rle_rows"):
                                    rle_rows.extend(self._rle_rows(name, inst, kept, hw, packed, max_runs))
                            with timers.time("measurements"):
                                rows = self._measurement_rows(
                                    name, inst, img, img_dev, masks, origins, cls_host, valid, um_pix, psum,
                                    measure_contrast,
                                )
                            with timers.time("csv"):
                                writer.writerows(rows)
                                if self.stream_measurements:
                                    f.flush()
                            if visualize:
                                with timers.time("overlay"):
                                    overlay = viz.render_overlay(
                                        img, [masks[i] for i in kept], [int(cls_host[i]) for i in kept],
                                        draw_ids=draw_ids, origins=[origins[i] for i in kept],
                                    )
                                    if draw_scalebar:
                                        viz.draw_scalebar_debug(overlay, sb_debug, psum)
                                with timers.time("png"):
                                    viz.save_png(self.output_dir / f"{name}_predictions.png", overlay)
                        processed.append(name)
                        seconds.append(time.perf_counter() - t0)
                        log.info("%s: %d instances, quality %.2f, %.2fs", name, len(kept), float(quality), seconds[-1])
                    except Exception as e:  # noqa: BLE001 - per-image isolation
                        failed.append(name)
                        log.error("Image %s failed: %s", name, e, exc_info=True)
        finally:
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)

        if self.lead:
            with timers.time("csv"):
                with open(rle_csv, "w", newline="") as f:
                    w = csv.writer(f)
                    w.writerow(["ImageId", "EncodedPixels"])
                    w.writerows(rle_rows)
            if visualize:
                viz.save_png(self.output_dir / "class_legend.png", viz.render_legend(self.class_names))
        timers.log_summary("inference-profile")
        if failed:
            log.warning("Images not processed: %s", failed)
        else:
            log.info("All %d images processed", len(processed))
        if eta_file and processed and self.lead:
            update_eta_data(eta_file, "inference", time.perf_counter() - t_start, num_images=len(processed))
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

    def _measurement_rows(self, name, inst, img, img_dev, masks, origins, cls_host, valid, um_pix, psum,
                          measure_contrast):
        """One image's measurement rows: the device backend, or the native
        host measurements of the full-resolution masks (the crops exported
        for the overlay, at ``origins``) or of the per-instance windows."""
        area = float(img.shape[0] * img.shape[1])
        if self.measurement_backend == "device":
            measures = measure_lib.measure_instances_device(
                inst, img_dev, measure_contrast=measure_contrast, mask_threshold=self.mask_threshold
            )
            keys = sorted(measures)
            # one packed device -> host copy of the columns
            packed = torch.stack([measures[k].float() for k in keys]).cpu().numpy()
            return measure_lib.measurement_rows(
                {k: packed[j] for j, k in enumerate(keys)}, inst, name, self.class_names, um_pix, psum, area,
                valid=valid, classes=cls_host,
            )
        gray = to_grayscale(torch.from_numpy(img)).numpy() if measure_contrast else None
        if masks is not None:
            return measurement_rows_host(
                masks, cls_host, valid, name, self.class_names, um_pix, psum, area,
                gray=gray, measure_contrast=measure_contrast, origins=origins,
            )
        wins, origins, scales = self._mask_windows(inst, self.measurement_window)
        return measurement_rows_host_windows(
            wins, origins, scales, cls_host, valid, name, self.class_names, um_pix, psum, area,
            gray=gray, measure_contrast=measure_contrast,
        )


def run_inference(
    dataset_name: str,
    split_dir: str,
    image_folder: Optional[str] = None,
    output_dir: Optional[str] = None,
    config: Optional[dict] = None,
    device=None,
    visualize: bool = True,
) -> Dict[str, object]:
    """Module-level entry point: the config defaults to
    ``get_config(dataset_name)`` and ``image_folder`` to
    ``<local_dataset_root>/DATASET/INFERENCE``; the run updates the
    configured ETA file."""
    cfg = config or get_config(dataset_name)
    pipeline = InferencePipeline(dataset_name, split_dir, output_dir, cfg, device=device)
    folder = image_folder or os.path.join(
        os.path.expanduser(cfg["paths"].get("local_dataset_root", "~")), "DATASET", "INFERENCE"
    )
    return pipeline.run(folder, visualize=visualize, eta_file=cfg["paths"]["eta_file"])

"""Tile-based inference engine: one serving schedule for one model.

Per image: the quality score; a whole-image pass (native, downscaled, or
none — ``full_pass_max_dim``); tiles in chunks of ``tile_batch`` — x2
upscale, one batched trunk + FPN + RPN head, then proposals and RoI heads
batched over the chunk; edge filter and tile -> global coordinates; the
merge, per-class thresholds and the mask-IoU dedup.

Across devices (the JAX engine's ``shard_map`` over the ``tile`` axis,
``deepemia_tpu/inference/engine.py:392-414``): given a list of devices,
the engine keeps one replica of the model on each distinct device that
gets a block of a grid, splits the grid's ``tile_batch`` chunks into contiguous blocks in tile order (sizes
differing by at most one chunk, earlier blocks larger) and runs each block
in a thread of its own, with its device current. The whole-image pass runs
meanwhile on the first device, where the blocks' results come back, in
tile order, for the merge, the thresholds and the dedup. The unit is the
chunk, not the tile (as in the JAX package's split serving, which hands each
device one chunk a step, ``engine.py:539-562``): every chunk is the one the
one-device engine runs, so the result is the one-device engine's, bit for
bit on the same device.

Across the ranks of a process group (the JAX engine on a mesh that spans
processes, ``engine.py:700-745``): the list holds ``(rank, device)``
pairs, every rank's devices in rank order (``parallel/mesh.py:
global_devices``), and every rank runs ``infer`` on the same image. The
chunks split into blocks over that list as above; each rank runs the
blocks of its own devices, in threads. The rank of the first device, the
lead, runs the whole-image pass meanwhile; the blocks' sets, padded to
fixed shapes, are gathered there in rank order (which is tile order), the
lead merges them as one process does, and the merged set and the quality
score are broadcast, so every rank returns the lead's result, the
one-device engine's bit for bit. A rank that owns no device of the list
takes no block and still joins the collectives. A rank whose blocks fail
says so in the exchange, and the lead whether its merge failed, so that
every rank raises for that image rather than waiting.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepemia_tpu_torch import resolve_device
from deepemia_tpu_torch.config.constants import StaticShapes, TileDefaults
from deepemia_tpu_torch.inference.detections import (
    InstanceSet,
    concat_instances,
    dedup_by_mask_iou,
    empty_instances,
    filter_instances,
)
from deepemia_tpu_torch.models.heads import Detections
from deepemia_tpu_torch.models.mask_rcnn import MaskRCNN
from deepemia_tpu_torch.ops import masks as mask_ops
from deepemia_tpu_torch.ops import tiles as tile_ops
from deepemia_tpu_torch.ops.image import (
    adaptive_threshold_scale,
    image_quality_score,
    resize_image,
)
from deepemia_tpu_torch.parallel import ranks as rank_ops
from deepemia_tpu_torch.parallel.mesh import partition_devices


class ClassSettings(NamedTuple):
    """Per-class runtime thresholds, one entry per class."""

    confidence: torch.Tensor  # [C]
    nms_iou: torch.Tensor  # [C]
    min_size: torch.Tensor  # [C] pixels (area)


def class_settings_from_config(
    inference_settings: Dict[str, Any],
    num_classes: int,
    small_classes=None,
    device=None,
) -> ClassSettings:
    """Thresholds from the ``class_specific_settings`` of an inference
    config. With ``small_classes`` given, classes without explicit settings
    get confidence 0.3 / NMS 0.5 when small and 0.5 / 0.7 otherwise."""
    css = inference_settings.get("class_specific_settings", {})
    conf = np.full((num_classes,), 0.5, np.float32)
    nms = np.full((num_classes,), 0.5, np.float32)
    min_size = np.zeros((num_classes,), np.float32)
    for c in range(num_classes):
        s = css.get(f"class_{c}", {})
        if small_classes is None:
            conf_default, nms_default = 0.5, 0.5
        elif c in small_classes:
            conf_default, nms_default = 0.3, 0.5
        else:
            conf_default, nms_default = 0.5, 0.7
        conf[c] = s.get("confidence_threshold", conf_default)
        nms[c] = s.get("iou_threshold", nms_default)
        min_size[c] = s.get("min_size", 0)
    return ClassSettings(
        *(torch.as_tensor(a, device=device) for a in (conf, nms, min_size))
    )


def detections_to_instances(det: Detections) -> InstanceSet:
    return InstanceSet(det.boxes, det.scores, det.classes, det.valid, det.mask_probs)


def apply_class_thresholds(
    inst: InstanceSet, settings: ClassSettings, quality_scale: torch.Tensor
) -> InstanceSet:
    """Confidence gate (scaled by image quality) + min-area gate."""
    cls = inst.classes.long()
    keep = inst.scores >= settings.confidence[cls] * quality_scale
    w = (inst.boxes[:, 2] - inst.boxes[:, 0]).clamp(min=0.0)
    h = (inst.boxes[:, 3] - inst.boxes[:, 1]).clamp(min=0.0)
    area = inst.mask_probs.mean(dim=(1, 2)) * w * h
    keep &= area >= settings.min_size[cls]
    return filter_instances(inst, keep)


def cross_class_dedup(
    inst: InstanceSet, image_hw, iou_threshold: float = 0.7, stride: int = 8
) -> InstanceSet:
    """Class-agnostic mask-IoU dedup pass."""
    return dedup_by_mask_iou(inst, image_hw, iou_threshold, stride=stride, class_aware=False)


def _flatten(inst: InstanceSet) -> InstanceSet:
    """[B,D,...] per-tile sets -> one [B*D,...] set."""
    return InstanceSet(*(t.reshape(-1, *t.shape[2:]) for t in inst))


def move_instances(inst: InstanceSet, device) -> InstanceSet:
    """``inst`` on ``device`` (itself when it lies there)."""
    return InstanceSet(*(t.to(device) for t in inst))


# a packed InstanceSet row: box (4), score, class, valid, then the R x R mask
_PACKED = 7


def pack_instances(inst: InstanceSet) -> torch.Tensor:
    """[K, 7 + R*R] float32, every field exact (class ids below 2**24)."""
    return torch.cat([inst.boxes.float(), inst.scores.float()[:, None], inst.classes.float()[:, None],
                      inst.valid.float()[:, None], inst.mask_probs.float().flatten(1)], dim=1)


def unpack_instances(rows: torch.Tensor) -> InstanceSet:
    """The inverse of :func:`pack_instances`."""
    r = int(round((rows.shape[1] - _PACKED) ** 0.5))
    return InstanceSet(rows[:, :4], rows[:, 4], rows[:, 5].to(torch.int32), rows[:, 6] != 0,
                       rows[:, _PACKED:].reshape(-1, r, r))


def _device_key(device: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name one GPU: the key of a replica."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def current_device(device: torch.device):
    """A context in which ``device`` is the thread's current CUDA device (a
    no-op for the CPU)."""
    return torch.cuda.device(device if device.type == "cuda" else -1)


class TileEngine:
    """Runs the tiled serving path of one model on one device (``cuda``
    unless ``device`` names another; raises when CUDA is absent and the CPU
    was not asked for), or with its tile grid sharded across a list of
    devices."""

    def __init__(
        self,
        model: MaskRCNN,
        tile_size: int = TileDefaults.TILE_SIZE,
        overlap_ratio: float = TileDefaults.OVERLAP_RATIO,
        upscale_factor: float = TileDefaults.UPSCALE_FACTOR,
        edge_filter: bool = True,
        dedup_iou: float = 0.4,
        capacity: int = StaticShapes.MAX_INSTANCES_PER_IMAGE,
        use_tiling: bool = True,
        dedup_stride: int = 8,
        full_pass_max_dim: int = 2048,
        confidence_mode: str = "auto",
        tile_batch: int = 16,
        classes_using_tiling=None,
        device=None,
    ):
        """``full_pass_max_dim``: the whole-image pass runs at native
        resolution up to this long side and downscaled to it beyond; 0
        turns it off (tiles only) unless tiling is off or degenerate, when
        it is the only source of detections. ``classes_using_tiling``
        restricts tile-sourced detections to these class ids. ``device``
        may be a list: the tile shards' devices (one may repeat), the first
        the engine's ``device``, where the results merge; a list of one is
        the one-device engine. Inside a process group the list may hold
        ``(rank, device)`` pairs, every rank's devices: this rank's
        ``device`` is then the first of its own, or, when it owns none of
        the list, the one the model lies on."""
        entries = list(device) if isinstance(device, list) else [device]
        pairs = [e if isinstance(e, tuple) else (None, e) for e in entries]
        self.rank, self.world = rank_ops.rank_world() if pairs[0][0] is not None else (0, 1)
        # the rank running each device's block (this one outside a group)
        self.ranks: List[int] = [self.rank if r is None else r for r, _ in pairs]
        self.devices: List[torch.device] = [resolve_device(d) for _, d in pairs]
        self.lead = self.ranks[0] == self.rank
        mine = [d for r, d in zip(self.ranks, self.devices) if r == self.rank]
        self.device = mine[0] if mine else next(model.parameters()).device
        self.model = model.to(self.device)
        # one replica a distinct device that gets a block of a grid, the
        # int8 tables included (built at its first block, _replica)
        self.replicas: Dict[torch.device, MaskRCNN] = {_device_key(self.device): self.model}
        self.tile_size = tile_size
        self.overlap_ratio = overlap_ratio
        self.upscale_factor = upscale_factor
        self.edge_filter = edge_filter
        self.dedup_iou = dedup_iou
        self.capacity = capacity
        self.use_tiling = use_tiling
        self.dedup_stride = dedup_stride
        self.full_pass_max_dim = full_pass_max_dim
        self.confidence_mode = confidence_mode
        self.tile_batch = max(1, int(tile_batch))
        self.tiling_classes = (
            None if classes_using_tiling is None else tuple(int(c) for c in classes_using_tiling)
        )

    def _forward(self, image: torch.Tensor) -> InstanceSet:
        return detections_to_instances(self.model(image, score_threshold=0.05))

    def _replica(self, device: torch.device) -> MaskRCNN:
        """The model on ``device``: a copy of it made there at the first
        call."""
        key = _device_key(device)
        if key not in self.replicas:
            self.replicas[key] = copy.deepcopy(self.model).to(device)
        return self.replicas[key]

    def _run_chunks(self, device, chunks, tiles, offsets, ts, ts_up, h, w) -> List[InstanceSet]:
        """The flat per-tile sets of the ``(start, stop)`` tile chunks on
        ``device``, its replica of the model, in order."""
        model = self.replicas[_device_key(device)]
        scale = ts_up / ts
        out = []
        for a, b in chunks:
            tc = tiles[a:b].to(device, non_blocking=True).float()
            if ts_up != ts:
                tc = resize_image(tc, ts_up, ts_up)
            feats = model.features_batched(tc)
            det = model.detect_batched(feats, (ts_up, ts_up), score_threshold=0.05)
            offs = offsets[a:b].to(device, non_blocking=True)
            ok = torch.ones(offs.shape[0], dtype=torch.bool, device=device)
            out.append(_flatten(self._finish_batch(detections_to_instances(det), offs, ok, ts, scale, h, w)))
        return out

    def _run_shard(self, device, chunks, tiles, offsets, ts, ts_up, h, w) -> List[InstanceSet]:
        """:meth:`_run_chunks` on a shard's own thread: its device current,
        inference mode (a thread's own), the sets moved to the engine's
        device."""
        with current_device(device), torch.inference_mode():
            sets = self._run_chunks(device, chunks, tiles, offsets, ts, ts_up, h, w)
            return [move_instances(s, self.device) for s in sets]

    def _finish_batch(
        self, inst_b: InstanceSet, offs_b, ok_b, ts: int, scale: float, h: int, w: int
    ) -> InstanceSet:
        """Edge filter + tile -> global coordinates over a [B,D,...] batch
        of per-tile sets. Instances at the global image border are never
        edge-filtered: their tile edge is the image edge."""
        local = inst_b.boxes / scale
        keep = torch.ones(local.shape[:2], dtype=torch.bool, device=local.device)
        if self.edge_filter:
            b, d = local.shape[:2]
            edge = mask_ops.is_edge_mask(local.reshape(-1, 4), ts, self.overlap_ratio)
            gx0 = local[..., 0] + offs_b[:, None, 0]
            gy0 = local[..., 1] + offs_b[:, None, 1]
            gx1 = local[..., 2] + offs_b[:, None, 0]
            gy1 = local[..., 3] + offs_b[:, None, 1]
            at_border = (gx0 <= 2.0) | (gy0 <= 2.0) | (gx1 >= w - 2.0) | (gy1 >= h - 2.0)
            keep = ~edge.reshape(b, d) | at_border
        if self.tiling_classes is not None:
            ids = torch.tensor(self.tiling_classes, dtype=torch.int32, device=local.device)
            keep = keep & (inst_b.classes[..., None] == ids).any(-1)
        gboxes = tile_ops.tile_boxes_to_global(inst_b.boxes, offs_b, scale=scale)
        return inst_b._replace(boxes=gboxes, valid=inst_b.valid & keep & ok_b[:, None])

    def _merge(self, parts: List[InstanceSet], settings: ClassSettings, qscale, h: int, w: int) -> InstanceSet:
        """The parts (whole-image pass first, then the tiles in order)
        concatenated to the capacity, the class thresholds, the dedup."""
        if not parts:
            parts = [empty_instances(self.capacity, device=self.device)]
        merged = concat_instances(parts, self.capacity)
        merged = apply_class_thresholds(merged, settings, qscale)
        stride = max(self.dedup_stride, -(-max(h, w) // 512))
        return dedup_by_mask_iou(merged, (h, w), self.dedup_iou, stride=stride, class_aware=True)

    def _exchange(self, full: List[InstanceSet], tile_sets: List[InstanceSet], err: Optional[BaseException],
                  quality, settings, qscale, h: int, w: int) -> Tuple[InstanceSet, torch.Tensor]:
        """This rank's part of the group's merge: the header (whether its
        work ran, its tile rows, its row width) to every rank, its blocks'
        rows gathered on the lead, the lead's merged set and quality
        broadcast back."""
        rows = pack_instances(InstanceSet(*(torch.cat(f) for f in zip(*tile_sets)))) if tile_sets else None
        res = (tile_sets or full)[0].mask_probs.shape[-1] if tile_sets or full else 0
        header = torch.tensor([int(err is None), 0 if rows is None else rows.shape[0], _PACKED + res * res],
                              dtype=torch.int64)
        heads = torch.stack(rank_ops.all_gather(header)).tolist()
        failed = [r for r, (ok, _, _) in enumerate(heads) if not ok]
        if failed:
            raise RuntimeError(f"the tile work failed on rank(s) {failed} of {self.world}") from err
        width = max(wd for _, _, wd in heads)
        most = max(1, max(n for _, n, _ in heads))
        buf = torch.zeros((most, width), dtype=torch.float32, device=self.device)
        if rows is not None:
            buf[: rows.shape[0]] = rows
        lead = self.ranks[0]
        gathered = rank_ops.gather(buf, dst=lead)
        out = torch.zeros((self.capacity * width + 2,), dtype=torch.float32, device=self.device)
        if self.lead:
            try:
                sets = [unpack_instances(g[:n]) for g, (_, n, _) in zip(gathered, heads) if n]
                merged = self._merge(full + sets, settings, qscale, h, w)
                out = torch.cat([pack_instances(merged).flatten(), quality.float().reshape(1),
                                 torch.ones(1, device=self.device)])
            except Exception as e:  # noqa: BLE001 - every rank raises it below
                err = e
        out = rank_ops.broadcast(out, src=lead)
        if out[-1] == 0:
            raise RuntimeError(f"the merge failed on the lead, rank {lead}") from err
        return unpack_instances(out[:-2].reshape(self.capacity, width)), out[-2].clone()

    @torch.inference_mode()
    def infer(
        self,
        image,
        settings: ClassSettings,
        upscale: Optional[float] = None,
    ) -> Tuple[InstanceSet, torch.Tensor]:
        """[H,W,3] uint8/float BGR image -> (InstanceSet, quality). The image
        moves to the device in its own dtype (uint8 moves 4x less than f32).
        ``upscale`` overrides the tile upscale factor for this call. Inside
        a process group every rank calls it on the same image, and every
        rank returns the same result."""
        h, w = int(image.shape[0]), int(image.shape[1])
        ts = self.tile_size
        up = self.upscale_factor if upscale is None else upscale
        ts_up = int(round(ts * up))
        ts_up -= ts_up % 64  # model inputs must be /64 for p6
        grid = tile_ops.compute_tile_grid(h, w, ts, self.overlap_ratio)
        tiling = self.use_tiling and grid.num_tiles > 1
        full_pass = self.full_pass_max_dim > 0 or not tiling
        native_full = max(h, w) <= self.full_pass_max_dim or not tiling

        full: List[InstanceSet] = []
        tile_sets: List[InstanceSet] = []
        quality = qscale = None
        err = None
        pool = None
        try:
            image = torch.as_tensor(image).to(self.device)
            settings = ClassSettings(*(t.to(self.device) for t in settings))
            quality = image_quality_score(image)
            if self.confidence_mode == "manual":
                qscale = torch.ones((), device=self.device)
            else:
                qscale = adaptive_threshold_scale(quality)
            if tiling:
                tiles = tile_ops.extract_tiles(image, grid)
                offsets = torch.as_tensor(grid.offsets, dtype=torch.float32, device=self.device)
                chunks = [(a, min(a + self.tile_batch, grid.num_tiles))
                          for a in range(0, grid.num_tiles, self.tile_batch)]
                # a block a device (fewer when the grid has fewer chunks); this
                # rank runs those of its own devices
                blocks = [(dev, block) for r, dev, block in
                          zip(self.ranks, self.devices, partition_devices(chunks, len(self.devices)))
                          if r == self.rank]
            sharded = tiling and len(self.devices) > 1
            if sharded:
                pool = ThreadPoolExecutor(max_workers=max(1, len(blocks)), thread_name_prefix="tile-shard")
                # the shards start first, so the whole-image pass below runs beside them
                for dev, _ in blocks:
                    self._replica(dev)
                shards = [pool.submit(self._run_shard, dev, block, tiles, offsets, ts, ts_up, h, w)
                          for dev, block in blocks]
            if full_pass and self.lead:
                if native_full:
                    padded = F.pad(image, (0, 0, 0, (-w) % 64, 0, (-h) % 64))
                    full.append(self._forward(padded))
                else:
                    ds = self.full_pass_max_dim / max(h, w)
                    dh = max(64, int(round(h * ds / 64)) * 64)
                    dw = max(64, int(round(w * ds / 64)) * 64)
                    inst = self._forward(resize_image(image, dh, dw))
                    back = torch.tensor([w / dw, h / dh, w / dw, h / dh], device=self.device)
                    full.append(inst._replace(boxes=inst.boxes * back))
            if sharded:
                for shard in shards:
                    tile_sets.extend(shard.result())
            elif tiling:
                for dev, block in blocks:  # the one device's, when it is this rank's
                    tile_sets.extend(self._run_chunks(dev, block, tiles, offsets, ts, ts_up, h, w))
        except Exception as e:  # noqa: BLE001 - in a group the other ranks must hear of it
            if self.world == 1:
                raise
            err = e
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        if self.world > 1:
            return self._exchange(full, tile_sets, err, quality, settings, qscale, h, w)
        return self._merge(full + tile_sets, settings, qscale, h, w), quality

"""Training data loader: records -> fixed-shape batches (the JAX package's
``data/loader.py``).

Per sample: decode (``ops.image.read_image`` for ``cv2.imread``), one
composed affine (augmentation, then the resize scale) applied once to the
image (``ops.cv.warp_affine_linear``, OpenCV's bilinear warp bit for bit)
and to the polygon coordinates, the brightness factor
(``ops.cv.convert_scale_abs``), masks filled at the final resolution
(``ops.cv.fill_poly``), boxes from the masks, GT padded to a fixed
capacity; the image stays uint8 and the masks are bit-packed along W.
Producer threads assemble whole batches, each into a bounded queue of its
own; batch i is worker i mod W's, so the sequence is fixed by the seed for
any worker count (every rank of a data-parallel run makes the same global
batches).

Unreadable images: the JAX loader skips any file OpenCV cannot read. This
one skips a file that is missing or corrupt, or in a form OpenCV refuses
too (``RefusedImageError``: hierarchical and 12-bit JPEG, the TIFF
compressions OpenCV's libtiff is built without, and the like), and raises
for one that OpenCV reads and ``read_image`` does not decode
(``UnsupportedImageError``: JPEG 2000, AVIF): skipping it would train on
fewer images than the JAX package does.

With ``workers=1`` the batch sequence is the JAX loader's for the same seed
(with several, the JAX loader's order follows its threads' timing).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from deepemia_tpu_torch.ops.cv import convert_scale_abs, fill_poly, warp_affine_linear
from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from deepemia_tpu_torch.train.augment import boxes_from_masks, sample_augment_affine

log = logging.getLogger("deepemia_tpu_torch.loader")


def prepare_sample(
    record: dict,
    train_size: int,
    max_instances: int,
    augment: bool,
    rng: np.random.Generator,
    resize_mode: str = "fixed",
    min_size_range=(640, 800),
    max_size: int = 1333,
) -> Optional[Dict[str, np.ndarray]]:
    """One record -> fixed-shape arrays, or None for an image OpenCV
    cannot read either (missing, corrupt, or refused by both).

    ``resize_mode='fixed'``: the long side scaled to ``train_size`` (square
    canvas). ``'range'``: Detectron2's training resize (short side drawn
    from ``min_size_range``, long side capped at ``max_size``) inside the
    ``train_size`` canvas: scale = min(chosen/short, max_size/long,
    train_size/long)."""
    try:
        img = read_image(record["file_name"])
    except UnsupportedImageError as e:
        raise UnsupportedImageError(f"training image {e}") from None
    except (OSError, ValueError) as e:
        log.warning("Unreadable image: %s (%s)", record["file_name"], e)
        return None
    annos = record["annotations"]
    classes = np.array([o["category_id"] for o in annos], np.int32)

    h, w = img.shape[:2]
    geo = np.eye(3)
    brightness = None
    if augment and annos:
        geo, brightness = sample_augment_affine(h, w, rng)

    if resize_mode == "range":
        lo, hi = int(min_size_range[0]), int(min_size_range[-1])
        chosen = int(rng.integers(lo, hi + 1)) if hi > lo else lo
        scale = min(chosen / min(h, w), max_size / max(h, w), train_size / max(h, w))
    else:
        scale = train_size / max(h, w)
    # cv2.resize's pixel-centre convention: dst = s*src + (s-1)/2
    off = (scale - 1.0) / 2.0
    geo = np.array([[scale, 0, off], [0, scale, off], [0, 0, 1]], np.float64) @ geo

    canvas = warp_affine_linear(img, geo[:2], (train_size, train_size))
    if brightness is not None:
        canvas = convert_scale_abs(canvas, brightness)

    if annos:
        masks = np.zeros((len(annos), train_size, train_size), np.uint8)
        for i, obj in enumerate(annos):
            for poly in obj["segmentation"]:
                pts = np.asarray(poly, np.float64).reshape(-1, 2)
                pts = pts @ geo[:2, :2].T + geo[:2, 2]
                fill_poly(masks[i], np.round(pts).astype(np.int32), 1)
        masks = masks.astype(bool)
        boxes = boxes_from_masks(masks)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        masks, boxes, classes = masks[keep], boxes[keep], classes[keep]
    else:
        masks = np.zeros((0, train_size, train_size), bool)
        boxes = np.zeros((0, 4), np.float32)

    g = max_instances
    n = min(len(boxes), g)
    if train_size % 8:
        raise ValueError(f"train_size must be a multiple of 8, got {train_size}")
    out = {
        "image": canvas,
        "gt_boxes": np.zeros((g, 4), np.float32),
        "gt_classes": np.zeros((g,), np.int32),
        "gt_valid": np.zeros((g,), bool),
        "gt_masks": np.zeros((g, train_size, train_size // 8), np.uint8),
    }
    if n:
        out["gt_boxes"][:n] = boxes[:n]
        out["gt_classes"][:n] = classes[:n]
        out["gt_valid"][:n] = True
        out["gt_masks"][:n] = np.packbits(masks[:n], axis=-1)
    return out


class TrainLoader:
    """Infinite shuffled batch iterator with background prefetch.

    ``workers`` producer threads each draw from their own permutation
    stream (seed + 1000003 * worker) and assemble whole batches into their
    own queue; the consumer takes the workers' batches in turn, so the
    batch sequence is fixed by the seed. Call ``close()`` when done: it
    stops and joins every worker."""

    def __init__(
        self,
        records: List[dict],
        batch_size: int,
        train_size: int = 512,
        max_instances: int = 64,
        augment: bool = False,
        seed: int = 0,
        prefetch: int = 4,
        filter_empty: bool = True,
        resize_mode: str = "fixed",
        min_size_range=(640, 800),
        max_size: int = 1333,
        workers: int = 2,
    ):
        if filter_empty:  # Detectron2's DATALOADER.FILTER_EMPTY_ANNOTATIONS
            records = [r for r in records if r.get("annotations")]
        if not records:
            raise ValueError("No records with annotations to train on")
        self.records = records
        self.batch_size = batch_size
        self.train_size = train_size
        self.max_instances = max_instances
        self.augment = augment
        self.resize_mode = resize_mode
        self.min_size_range = min_size_range
        self.max_size = max_size
        n_workers = max(1, workers)
        self._qs: List["queue.Queue"] = [queue.Queue(maxsize=max(1, -(-prefetch // n_workers)))
                                         for _ in range(n_workers)]
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(
                target=self._producer, args=(np.random.default_rng(seed + 1000003 * wid), self._qs[wid]), daemon=True
            )
            for wid in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    def _producer(self, rng: np.random.Generator, q: "queue.Queue"):
        try:
            self._produce_loop(rng, q)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer through the queue
            log.error("Train loader producer failed: %s", e, exc_info=True)
            self._error = e
            for other in self._qs:  # wake the consumer, whichever queue it waits on
                try:
                    other.put(None, timeout=1.0)
                except queue.Full:
                    pass

    def _produce_loop(self, rng: np.random.Generator, q: "queue.Queue"):
        order = rng.permutation(len(self.records))
        pos = 0
        while not self._stop.is_set():
            samples = []
            consecutive_failures = 0
            while len(samples) < self.batch_size:
                if pos >= len(order):
                    order = rng.permutation(len(self.records))
                    pos = 0
                rec = self.records[order[pos]]
                pos += 1
                s = prepare_sample(
                    rec, self.train_size, self.max_instances, self.augment, rng, self.resize_mode,
                    self.min_size_range, self.max_size,
                )
                if s is not None:
                    samples.append(s)
                    consecutive_failures = 0
                else:
                    consecutive_failures += 1
                    if consecutive_failures > 2 * len(self.records):
                        raise RuntimeError("no readable training samples: every record failed to load/prepare")
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            # a timed put, so that a worker parked on a full queue sees
            # close() within 0.5 s
            while True:
                try:
                    q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in itertools.count():
            item = self._qs[i % len(self._qs)].get()
            if item is None or self._error is not None:
                raise RuntimeError(f"training data producer failed: {self._error}") from self._error
            yield item

    def close(self):
        self._stop.set()
        # drain so producers parked in put() find a free slot, then join
        # each (their timed puts re-check the stop flag every 0.5 s)
        deadline = time.time() + 5.0
        for t in self._threads:
            while t.is_alive() and time.time() < deadline:
                for q in self._qs:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                t.join(timeout=0.05)

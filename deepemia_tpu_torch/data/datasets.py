"""Dataset split, registration and annotation parsing (the JAX package's
``data/datasets.py``).

- ``split_dataset``: the deterministic 80/20 split of the label files,
  persisted to ``{split_dir}/{name}_split.json``. The JAX package calls
  scikit-learn's ``train_test_split(files, test_size, random_state=42)``;
  this module computes what it returns (``ShuffleSplit``: ceil(test_size *
  n) test files, the first of ``RandomState(seed).permutation(n)``, the
  rest for training, in that order), so split files users already have
  stay valid, and raises ``ValueError`` as it does when the training part
  would be empty.
- A small in-process catalog in place of Detectron2's DatasetCatalog and
  MetadataCatalog; registration of COCO-layout and per-image-JSON datasets;
  per-image records with XYXY_ABS boxes (polygons with the +0.5 pixel
  offset, ellipses expanded to 64-point polygons).
- ``rasterize_annotations``: the polygons as masks, through
  ``ops.cv.fill_poly`` (OpenCV's ``fillPoly``, bit for bit).

Left out: nothing of the JAX module.
"""

from __future__ import annotations

import json
import logging
import math
import os
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from deepemia_tpu_torch.ops.cv import fill_poly
from deepemia_tpu_torch.utils.exceptions import DataError

log = logging.getLogger("deepemia_tpu_torch.datasets")


# -- catalogs ------------------------------------------------------------------

_DATASETS: Dict[str, Callable[[], List[dict]]] = {}
_METADATA: Dict[str, dict] = {}


def catalog_register(name: str, loader: Callable[[], List[dict]], **metadata):
    _DATASETS[name] = loader
    _METADATA.setdefault(name, {}).update(metadata)


def catalog_get(name: str) -> List[dict]:
    if name not in _DATASETS:
        raise DataError(f"Dataset '{name}' is not registered")
    return _DATASETS[name]()


def catalog_metadata(name: str) -> dict:
    return _METADATA.get(name, {})


def catalog_clear():
    _DATASETS.clear()
    _METADATA.clear()


# -- split ---------------------------------------------------------------------


def train_test_split(items: Sequence, test_size: float = 0.2, seed: int = 42) -> Tuple[list, list]:
    """scikit-learn's ``train_test_split(items, test_size=test_size,
    random_state=seed)`` for a float ``test_size`` in (0, 1): (train,
    test)."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, the resulting train set will be empty"
        )
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def split_dataset(
    img_dir: str,
    dataset_name: str,
    split_dir: str,
    test_size: float = 0.2,
    seed: int = 42,
) -> Tuple[List[str], List[str]]:
    """Deterministic train/test split of the ``.json`` label files in
    ``img_dir``, persisted to ``{split_dir}/{dataset_name}_split.json``."""
    label_files = sorted(f for f in os.listdir(os.path.expanduser(img_dir)) if f.endswith(".json"))
    if not label_files:
        raise DataError(f"No .json label files found in {img_dir}")
    train_files, test_files = train_test_split(label_files, test_size, seed)
    sd = Path(os.path.expanduser(split_dir))
    sd.mkdir(parents=True, exist_ok=True)
    split_file = sd / f"{dataset_name}_split.json"
    with open(split_file, "w") as f:
        json.dump({"train": train_files, "test": test_files}, f)
    log.info("Split saved: %s (%d train / %d test)", split_file, len(train_files), len(test_files))
    return train_files, test_files


def read_dataset_info(file_path: str) -> Dict[str, tuple]:
    """{dataset: (img_dir, label_dir, [class names])} from the category
    JSON."""
    with open(os.path.expanduser(file_path)) as f:
        data = json.load(f)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in data.items()}


def dataset_class_names(dataset_info: Dict[str, tuple], dataset_name: str) -> List[str]:
    """The class names of ``dataset_name``; raises ``KeyError`` for a
    dataset the category file does not list."""
    if dataset_name not in dataset_info:
        raise KeyError(f"Dataset '{dataset_name}' not found in dataset_info")
    return list(dataset_info[dataset_name][2])


# -- annotation parsing --------------------------------------------------------


def ellipse_to_polygon(
    cx: float, cy: float, rx: float, ry: float, angle_deg: float, segments: int = 64
) -> List[float]:
    """An ellipse -> flat [x0, y0, x1, y1, ...] polygon of ``segments``
    points: radii truncated to whole pixels, rotated by ``angle_deg``,
    every coordinate with the +0.5 pixel-centre offset."""
    rx_i, ry_i = int(rx), int(ry)
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    x = rx_i * np.cos(t)
    y = ry_i * np.sin(t)
    rad = np.deg2rad(angle_deg)
    xr = x * np.cos(rad) - y * np.sin(rad) + cx + 0.5
    yr = x * np.sin(rad) + y * np.cos(rad) + cy + 0.5
    out = np.empty(2 * segments)
    out[0::2] = xr
    out[1::2] = yr
    return out.tolist()


def parse_instance_json(
    json_path: str,
    img_dir: str,
    image_id: int,
    category_name_to_id: Dict[str, int],
) -> dict:
    """One per-image label JSON -> a record {file_name, image_id, height,
    width, annotations: [{bbox XYXY_ABS, bbox_mode, segmentation,
    category_id}]}. Instances of unknown classes or types are skipped with
    a warning."""
    with open(json_path) as f:
        ann = json.load(f)
    record = {
        "file_name": os.path.join(img_dir, ann["metadata"]["name"]),
        "image_id": image_id,
        "height": ann["metadata"]["height"],
        "width": ann["metadata"]["width"],
    }
    objs = []
    for inst in ann.get("instances", []):
        name = inst.get("className")
        if name not in category_name_to_id:
            log.warning("Category name not found: %s", name)
            continue
        kind = inst.get("type")
        if kind == "ellipse":
            poly = ellipse_to_polygon(inst["cx"], inst["cy"], inst["rx"], inst["ry"], inst["angle"])
        elif kind == "polygon":
            pts = inst["points"]
            px = list(pts[0:-1:2]) + [pts[0]]
            py = list(pts[1:-1:2]) + [pts[-1]]
            poly = []
            for x, y in zip(px, py):
                poly.extend([x + 0.5, y + 0.5])
        else:
            log.warning("Unknown instance type %r — skipped", kind)
            continue
        xs, ys = poly[0::2], poly[1::2]
        objs.append(
            {
                "bbox": [min(xs), min(ys), max(xs), max(ys)],
                "bbox_mode": "XYXY_ABS",
                "segmentation": [poly],
                "category_id": category_name_to_id[name],
            }
        )
    record["annotations"] = objs
    return record


def get_split_dicts(
    img_dir: str,
    label_dir: str,
    files: Sequence[str],
    category_json: str,
    category_key: str,
) -> List[dict]:
    """Records for a list of label files."""
    info = read_dataset_info(category_json)
    if category_key not in info:
        raise DataError(f"Category key '{category_key}' not found in {category_json}")
    name_to_id = {n: i for i, n in enumerate(info[category_key][2])}
    return [
        parse_instance_json(os.path.join(label_dir, f), img_dir, i, name_to_id) for i, f in enumerate(files)
    ]


def load_coco_json(json_path: str, image_root: str):
    """A COCO instances JSON -> (records, class names in category-id
    order). RLE segmentations are skipped."""
    with open(json_path) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_id_to_contiguous = {c["id"]: i for i, c in enumerate(cats)}
    anns_by_image: Dict[int, List[dict]] = {}
    for a in coco.get("annotations", []):
        anns_by_image.setdefault(a["image_id"], []).append(a)
    records = []
    for img in coco.get("images", []):
        objs = []
        for a in anns_by_image.get(img["id"], []):
            x, y, w, h = a["bbox"]  # COCO XYWH
            seg = a.get("segmentation", [])
            if isinstance(seg, dict):
                continue
            objs.append(
                {
                    "bbox": [x, y, x + w, y + h],
                    "bbox_mode": "XYXY_ABS",
                    "segmentation": seg,
                    "category_id": cat_id_to_contiguous[a["category_id"]],
                }
            )
        records.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "image_id": img["id"],
                "height": img["height"],
                "width": img["width"],
                "annotations": objs,
            }
        )
    return records, [c["name"] for c in cats]


def register_datasets(
    dataset_info: Dict[str, tuple],
    dataset_name: str,
    split_dir: str,
    category_json: str,
    local_dataset_root: str = "~",
    test_size: float = 0.2,
    dataset_format: str = "json",
) -> List[str]:
    """Register ``{name}_train`` and ``{name}_test`` in the catalog (the
    split file is made when missing) -> the class names."""
    if dataset_format == "coco":
        base = os.path.join(os.path.expanduser(local_dataset_root), "DATASET", dataset_name)
        names_holder = {}

        def make_loader(split):
            def load():
                recs, names = load_coco_json(
                    os.path.join(base, "annotations", f"instances_{split}.json"), os.path.join(base, split)
                )
                names_holder["names"] = names
                return recs

            return load

        for split in ("train", "test"):
            catalog_register(f"{dataset_name}_{split}", make_loader(split))
        catalog_get(f"{dataset_name}_test")  # once, for the class names
        names = names_holder.get("names", [])
        for split in ("train", "test"):
            _METADATA.setdefault(f"{dataset_name}_{split}", {})["thing_classes"] = names
        return names

    if dataset_format != "json":
        raise DataError(f"Unknown dataset_format: {dataset_format}")
    if dataset_name not in dataset_info:
        raise DataError(f"Dataset '{dataset_name}' not found in dataset_info")
    img_dir, label_dir, thing_classes = dataset_info[dataset_name]
    img_dir = os.path.expanduser(img_dir)
    label_dir = os.path.expanduser(label_dir)

    split_file = Path(os.path.expanduser(split_dir)) / f"{dataset_name}_split.json"
    if split_file.exists():
        with open(split_file) as f:
            split_data = json.load(f)
    else:
        train, test = split_dataset(
            label_dir if os.path.isdir(label_dir) else img_dir, dataset_name, split_dir, test_size
        )
        split_data = {"train": train, "test": test}

    for split in ("train", "test"):
        catalog_register(
            f"{dataset_name}_{split}",
            lambda s=split: get_split_dicts(img_dir, label_dir, split_data[s], category_json, dataset_name),
            thing_classes=list(thing_classes),
        )
    log.info("Registered %s train/test (%d classes)", dataset_name, len(thing_classes))
    return list(thing_classes)


def rasterize_annotations(record: dict) -> np.ndarray:
    """A record's polygon segmentations -> [N,H,W] bool masks (each
    polygon's points rounded to whole pixels and filled as OpenCV's
    ``fillPoly`` fills them)."""
    h, w = record["height"], record["width"]
    masks = np.zeros((len(record["annotations"]), h, w), np.uint8)
    for i, obj in enumerate(record["annotations"]):
        for poly in obj["segmentation"]:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            fill_poly(masks[i], np.round(pts).astype(np.int32), 1)
    return masks.astype(bool)

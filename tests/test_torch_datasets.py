"""Port parity: the dataset split, registration and annotation parsing of
``deepemia_tpu_torch/data/datasets.py`` against the JAX package's (records
and split files equal), the split against scikit-learn's
``train_test_split``, and ``ops.cv.fill_poly`` against ``cv2.fillPoly`` bit
for bit on random polygons (concave, partly or far outside the image,
degenerate, ellipses)."""

import json
import os

import cv2
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_train_test_split

import deepemia_tpu.data.datasets as jax_ds
import deepemia_tpu_torch.data.datasets as port_ds
from deepemia_tpu.utils.exceptions import DataError as JaxDataError
from deepemia_tpu_torch.ops.cv import fill_poly
from deepemia_tpu_torch.utils.exceptions import DataError

torch.set_num_threads(2)


def make_dataset(root, n, seed=0, size=(96, 128), ext=".png", classes=("a", "b")):
    """``n`` grey micrographs (written by OpenCV) with per-image label JSONs
    in the reference format: 2-5 instances each, ellipses and polygons
    (some reaching past the image), alternating classes. -> root."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    h, w = size
    for i in range(n):
        img = np.clip(rng.normal(90, 15, (h, w)), 0, 255).astype(np.uint8)
        inst = []
        for j in range(int(rng.integers(2, 6))):
            cls = classes[j % len(classes)]
            if rng.random() < 0.5:
                cx, cy = rng.uniform(5, w - 5), rng.uniform(5, h - 5)
                rx, ry, ang = rng.uniform(3, w / 6), rng.uniform(3, h / 6), rng.uniform(0, 180)
                inst.append(dict(type="ellipse", className=cls, cx=cx, cy=cy, rx=rx, ry=ry, angle=ang))
                cv2.ellipse(img, (int(cx), int(cy)), (int(rx), int(ry)), ang, 0, 360, 200, -1)
            else:
                k = int(rng.integers(3, 8))
                pts = np.stack([rng.uniform(-5, w + 5, k), rng.uniform(-5, h + 5, k)], 1)
                inst.append(dict(type="polygon", className=cls, points=pts.ravel().tolist()))
        name = f"img{i}{ext}"
        cv2.imwrite(os.path.join(root, name), img)
        with open(os.path.join(root, f"img{i}.json"), "w") as f:
            json.dump({"metadata": {"name": name, "height": h, "width": w}, "instances": inst}, f)
    return str(root)


@pytest.mark.parametrize("first", [2, 26, 51, 76])
def test_split_matches_sklearn(first):
    for n in range(first, first + 25):
        items = [f"f{i:03d}.json" for i in range(n)]
        want = sk_train_test_split(items, test_size=0.2, random_state=42)
        assert list(port_ds.train_test_split(items, 0.2, 42)) == [list(want[0]), list(want[1])], n


@pytest.mark.parametrize("n", [2, 7, 10, 33])
def test_split_file_matches_jax(tmp_path, n):
    labels = tmp_path / "labels"
    labels.mkdir()
    for i in range(n):
        (labels / f"m{i}.json").write_text("{}")
    (labels / "notes.txt").write_text("")
    ref = jax_ds.split_dataset(str(labels), "ds", str(tmp_path / "jax"))
    got = port_ds.split_dataset(str(labels), "ds", str(tmp_path / "port"))
    assert got == ref
    assert (tmp_path / "port" / "ds_split.json").read_text() == (tmp_path / "jax" / "ds_split.json").read_text()
    assert len(got[1]) == int(np.ceil(0.2 * n)) and len(got[0]) + len(got[1]) == n


def test_split_of_one_file_raises_as_sklearn_does(tmp_path):
    (tmp_path / "only.json").write_text("{}")
    with pytest.raises(ValueError, match="train set will be empty"):
        jax_ds.split_dataset(str(tmp_path), "ds", str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="train set will be empty"):
        port_ds.split_dataset(str(tmp_path), "ds", str(tmp_path / "port"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(DataError, match="No .json label files"):
        port_ds.split_dataset(str(tmp_path / "empty"), "ds", str(tmp_path / "port"))


def test_ellipse_to_polygon_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        args = (*rng.uniform(0, 500, 2), *rng.uniform(0, 80, 2), rng.uniform(-180, 180))
        assert port_ds.ellipse_to_polygon(*args) == jax_ds.ellipse_to_polygon(*args)


def _info(tmp_path, root, classes=("a", "b")):
    path = tmp_path / "dataset_info.json"
    path.write_text(json.dumps({"ds": [root, root, list(classes)]}))
    return str(path)


def test_json_records_match_jax(tmp_path):
    """parse_instance_json, get_split_dicts and the registered catalogs
    (with a class the category file lacks and an unknown instance type)."""
    root = make_dataset(tmp_path / "ds", 6, seed=1, classes=("a", "b", "zzz"))
    with open(os.path.join(root, "img0.json")) as f:
        label = json.load(f)
    label["instances"].append({"type": "circle", "className": "a"})
    with open(os.path.join(root, "img0.json"), "w") as f:
        json.dump(label, f)
    info_path = _info(tmp_path, root)
    for mod in (jax_ds, port_ds):
        mod.catalog_clear()
    names = {}
    for tag, mod in (("jax", jax_ds), ("port", port_ds)):
        info = mod.read_dataset_info(info_path)
        names[tag] = mod.register_datasets(info, "ds", str(tmp_path / tag), info_path)
    assert names["port"] == names["jax"] == ["a", "b"]
    for split in ("train", "test"):
        ref, got = jax_ds.catalog_get(f"ds_{split}"), port_ds.catalog_get(f"ds_{split}")
        assert got == ref and len(got) == {"train": 4, "test": 2}[split]
        assert port_ds.catalog_metadata(f"ds_{split}") == jax_ds.catalog_metadata(f"ds_{split}")
    files = sorted(f for f in os.listdir(root) if f.endswith(".json"))
    ids = {"a": 0, "b": 1}
    for i, f in enumerate(files):
        p = os.path.join(root, f)
        assert port_ds.parse_instance_json(p, root, i, ids) == jax_ds.parse_instance_json(p, root, i, ids)
    assert port_ds.get_split_dicts(root, root, files, info_path, "ds") == jax_ds.get_split_dicts(
        root, root, files, info_path, "ds")
    with pytest.raises(DataError, match="not registered"):
        port_ds.catalog_get("nope")
    with pytest.raises(JaxDataError, match="not registered"):
        jax_ds.catalog_get("nope")
    for mod, err in ((jax_ds, JaxDataError), (port_ds, DataError)):
        with pytest.raises(err, match="not found in dataset_info"):
            mod.register_datasets({}, "ds", str(tmp_path / "x"), info_path)
        mod.catalog_clear()


def test_coco_records_match_jax(tmp_path):
    base = tmp_path / "DATASET" / "cds"
    rng = np.random.default_rng(5)
    for split in ("train", "test"):
        (base / split).mkdir(parents=True)
        images, anns = [], []
        for i in range(3):
            images.append({"id": 10 + i, "file_name": f"{split}{i}.png", "height": 64, "width": 80})
            for j in range(3):
                x, y = rng.uniform(0, 40, 2)
                seg = [[x, y, x + 10, y, x + 10, y + 8, x, y + 8]] if j < 2 else {"counts": "x", "size": [64, 80]}
                anns.append({"id": len(anns), "image_id": 10 + i, "category_id": [7, 3][j % 2],
                             "bbox": [x, y, 10, 8], "segmentation": seg})
        (base / "annotations").mkdir(exist_ok=True)
        coco = {"images": images, "annotations": anns,
                "categories": [{"id": 7, "name": "pore"}, {"id": 3, "name": "particle"}]}
        (base / "annotations" / f"instances_{split}.json").write_text(json.dumps(coco))
    ann = str(base / "annotations" / "instances_train.json")
    assert port_ds.load_coco_json(ann, str(base / "train")) == tuple(jax_ds.load_coco_json(ann, str(base / "train")))
    for mod in (jax_ds, port_ds):
        mod.catalog_clear()
    got = port_ds.register_datasets({}, "cds", str(tmp_path), "", str(tmp_path), dataset_format="coco")
    ref = jax_ds.register_datasets({}, "cds", str(tmp_path), "", str(tmp_path), dataset_format="coco")
    assert got == ref == ["particle", "pore"]
    for split in ("train", "test"):
        assert port_ds.catalog_get(f"cds_{split}") == jax_ds.catalog_get(f"cds_{split}")
        assert port_ds.catalog_metadata(f"cds_{split}") == jax_ds.catalog_metadata(f"cds_{split}")
    with pytest.raises(DataError, match="Unknown dataset_format"):
        port_ds.register_datasets({}, "cds", str(tmp_path), "", dataset_format="xml")
    for mod in (jax_ds, port_ds):
        mod.catalog_clear()


def test_rasterize_annotations_matches_jax(tmp_path):
    root = make_dataset(tmp_path / "ds", 4, seed=2)
    files = sorted(f for f in os.listdir(root) if f.endswith(".json"))
    for i, f in enumerate(files):
        rec = jax_ds.parse_instance_json(os.path.join(root, f), root, i, {"a": 0, "b": 1})
        want = jax_ds.rasterize_annotations(rec)
        got = port_ds.rasterize_annotations(rec)
        assert got.dtype == bool and np.array_equal(got, want) and want.any()


def _polygons(kind, rng, h, w):
    n = int(rng.integers(1, 14))
    if kind == "concave":  # random vertex order: concave and self-intersecting
        return np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    if kind == "partly_outside":
        return np.stack([rng.integers(-20, w + 20, n), rng.integers(-20, h + 20, n)], 1)
    if kind == "far_outside":
        return np.stack([rng.integers(-300, w + 300, n), rng.integers(-300, h + 300, n)], 1)
    if kind == "degenerate":  # points on one line, repeated points, single points
        p = rng.integers(-3, max(h, w) + 3, 2)
        return p + np.arange(n)[:, None] * rng.integers(-2, 3, 2)
    if kind == "convex":
        pts = np.stack([rng.integers(-10, w + 10, n + 3), rng.integers(-10, h + 10, n + 3)], 1)
        return cv2.convexHull(pts.astype(np.int32)).reshape(-1, 2)
    # ellipse polygons as the dataset's ellipses make them, some past the edges
    poly = port_ds.ellipse_to_polygon(rng.uniform(-5, w + 5), rng.uniform(-5, h + 5), rng.uniform(0, 40),
                                      rng.uniform(0, 40), rng.uniform(0, 360))
    return np.round(np.asarray(poly).reshape(-1, 2))


KINDS = ["concave", "partly_outside", "far_outside", "degenerate", "convex", "ellipse"]


@pytest.mark.parametrize("kind", KINDS)
def test_fill_poly_matches_opencv(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(2, 90, 2))
        pts = _polygons(kind, rng, h, w).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = fill_poly(np.zeros((h, w), np.uint8), pts)
        assert np.array_equal(got, want), (kind, h, w, pts.tolist())


def test_fill_poly_large_shapes_and_value():
    rng = np.random.default_rng(9)
    for i in range(40):
        h, w = (int(v) for v in rng.integers(200, 600, 2))
        pts = _polygons(("far_outside", "ellipse", "concave")[i % 3], rng, h, w).astype(np.int32)
        if i % 3 == 1:
            pts = (pts - [w // 2, h // 2]) * 6 + [w // 2, h // 2]
        want = np.full((h, w), 3, np.uint8)
        cv2.fillPoly(want, [pts.astype(np.int32)], 7)
        got = fill_poly(np.full((h, w), 3, np.uint8), pts, 7)
        assert np.array_equal(got, want), i

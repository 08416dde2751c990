"""Port parity: the training data loader (``deepemia_tpu_torch/data/loader.py``)
and augmentation (``train/augment.py``) against the JAX package's, array for
array: ``prepare_sample`` with augmentation on and off and both resize modes,
a one-worker ``TrainLoader`` sequence of three batches, the augmentation
affine and ``boxes_from_masks``; missing or corrupt images are skipped as
the JAX loader skips them, a JPEG record gives the JAX loader's sample, so
does a PGM record, and a file OpenCV refuses too (a hierarchical JPEG) is
skipped as the JAX loader skips it, while one OpenCV reads and
``read_image`` does not decode (AVIF) raises rather than be skipped.
The colour
warp and ``convertScaleAbs`` the loader uses are held to OpenCV in
``tests/test_torch_cv.py``."""

import os
import threading

import cv2
import numpy as np
import pytest
import torch

import deepemia_tpu.data.datasets as jax_ds
import deepemia_tpu.data.loader as jax_loader
import deepemia_tpu.train.augment as jax_aug
import deepemia_tpu_torch.data.loader as port_loader
import deepemia_tpu_torch.train.augment as port_aug
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = make_dataset(tmp_path_factory.mktemp("loader") / "ds", 5, seed=4, size=(96, 128))
    files = sorted(f for f in os.listdir(root) if f.endswith(".json"))
    return [jax_ds.parse_instance_json(os.path.join(root, f), root, i, {"a": 0, "b": 1}) for i, f in enumerate(files)]


def _assert_samples_equal(got, want, tag):
    assert (got is None) == (want is None), tag
    if want is None:
        return
    assert set(got) == set(want), tag
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (tag, k)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("mode", ["fixed", "range"])
def test_prepare_sample_matches_jax(records, augment, mode):
    for i, rec in enumerate(records):
        args = (64, 8, augment)
        kw = dict(resize_mode=mode, min_size_range=(40, 56), max_size=100)
        want = jax_loader.prepare_sample(rec, *args, np.random.default_rng(i), **kw)
        got = port_loader.prepare_sample(rec, *args, np.random.default_rng(i), **kw)
        _assert_samples_equal(got, want, (i, augment, mode))
        assert got["gt_valid"].any()


def test_one_worker_sequence_matches_jax(records):
    loaders = [mod.TrainLoader(records, 2, 64, 8, augment=True, seed=11, workers=1, resize_mode="range",
                               min_size_range=(48, 64), max_size=96)
               for mod in (jax_loader, port_loader)]
    try:
        streams = [iter(ld) for ld in loaders]
        for step in range(3):
            want, got = next(streams[0]), next(streams[1])
            _assert_samples_equal(got, want, step)
            assert got["image"].shape == (2, 64, 64, 3) and got["gt_masks"].shape == (2, 8, 64, 8)
    finally:
        for ld in loaders:
            ld.close()
    assert not any(t.is_alive() for t in loaders[1]._threads)


def test_close_joins_every_worker(records):
    before = threading.active_count()
    loader = port_loader.TrainLoader(records, 2, 64, 8, augment=True, seed=1, workers=3, prefetch=1)
    next(iter(loader))
    loader.close()
    assert not any(t.is_alive() for t in loader._threads)
    assert threading.active_count() == before


def test_augment_affine_and_boxes_match_jax():
    for seed in range(20):
        h, w = 40 + seed, 90 - seed
        m_ref, f_ref = jax_aug.sample_augment_affine(h, w, np.random.default_rng(seed))
        m_got, f_got = port_aug.sample_augment_affine(h, w, np.random.default_rng(seed))
        assert f_got == f_ref
        np.testing.assert_array_equal(m_got, m_ref)
    rng = np.random.default_rng(0)
    masks = rng.random((6, 20, 30)) < 0.02
    masks[2] = False
    assert np.array_equal(port_aug.boxes_from_masks(masks), jax_aug.boxes_from_masks(masks))
    assert port_aug.boxes_from_masks(np.zeros((0, 5, 5), bool)).shape == (0, 4)


def test_missing_and_corrupt_images_are_skipped(records, tmp_path):
    corrupt = tmp_path / "bad.png"
    png = cv2.imencode(".png", np.zeros((20, 20), np.uint8))[1].tobytes()
    corrupt.write_bytes(png[: len(png) // 2])
    for path in (str(tmp_path / "missing.png"), str(corrupt)):
        rec = dict(records[0], file_name=path)
        assert jax_loader.prepare_sample(rec, 64, 8, False, np.random.default_rng(0)) is None
        assert port_loader.prepare_sample(rec, 64, 8, False, np.random.default_rng(0)) is None


def test_jpeg_raises_naming_a7(records, tmp_path):
    """A JPEG record (the first record's image, written as JPEG) gives the
    JAX loader's sample, with and without augmentation, and its batch; so
    does the same file with its frame marked arithmetic-coded (SOF9), which
    both readers decode alike. A coding OpenCV refuses too (the
    hierarchical SOF5, which ``read_image`` names) is skipped by both
    loaders alike: ``prepare_sample`` gives None, and a loader over it and
    a readable record gives the JAX loader's batch."""
    jpg = tmp_path / "micro.jpg"
    cv2.imwrite(str(jpg), cv2.imread(records[0]["file_name"]), [cv2.IMWRITE_JPEG_QUALITY, 85])
    rec = dict(records[0], file_name=str(jpg))
    for augment in (False, True):
        want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(0))
        got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(0))
        assert want is not None
        _assert_samples_equal(got, want, augment)
    _assert_first_batches_equal([rec, records[1]])

    data = bytearray(jpg.read_bytes())
    data[data.index(b"\xff\xc0") + 1] = 0xC9
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(bytes(data))
    rec = dict(records[0], file_name=str(arith))
    want = jax_loader.prepare_sample(rec, 64, 8, False, np.random.default_rng(0))
    assert want is not None
    _assert_samples_equal(port_loader.prepare_sample(rec, 64, 8, False, np.random.default_rng(0)), want, False)
    data[data.index(b"\xff\xc9") + 1] = 0xC5
    hierarchical = tmp_path / "hierarchical.jpg"
    hierarchical.write_bytes(bytes(data))
    assert cv2.imread(str(hierarchical), cv2.IMREAD_COLOR) is None
    with pytest.raises(RefusedImageError, match="SOF5"):
        read_image(str(hierarchical))
    rec = dict(records[0], file_name=str(hierarchical))
    assert jax_loader.prepare_sample(rec, 64, 8, False, np.random.default_rng(0)) is None
    assert port_loader.prepare_sample(rec, 64, 8, False, np.random.default_rng(0)) is None
    _assert_first_batches_equal([rec, records[1]])


def _assert_first_batches_equal(recs):
    loaders = [mod.TrainLoader(recs, 2, 64, 8, augment=True, seed=3, workers=1) for mod in (jax_loader, port_loader)]
    try:
        _assert_samples_equal(next(iter(loaders[1])), next(iter(loaders[0])), "batch")
    finally:
        for ld in loaders:
            ld.close()


def test_pgm_record_matches_jax(records, tmp_path):
    """A record whose image is a binary PGM (gray, as cv2 writes it) and
    one whose image is an ASCII PPM give the JAX loader's samples and
    batch."""
    img = cv2.imread(records[0]["file_name"])
    pgm, ppm = tmp_path / "micro.pgm", tmp_path / "micro.ppm"
    cv2.imwrite(str(pgm), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    cv2.imwrite(str(ppm), img, [cv2.IMWRITE_PXM_BINARY, 0])
    for path in (pgm, ppm):
        rec = dict(records[0], file_name=str(path))
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(0))
            assert want is not None
            _assert_samples_equal(port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(0)), want,
                                  (path.name, augment))
    _assert_first_batches_equal([dict(records[0], file_name=str(pgm)), records[1]])


def test_what_opencv_reads_and_the_port_does_not_raises(records, tmp_path):
    """An AVIF file in a form OpenCV reads and the port does not decode
    (the AV1 writer's frame with film grain; its frame with delta loop
    filter levels and cv2's speed-4 frame with loop restoration until the
    port applied them) raises ``UnsupportedImageError`` naming it in
    ``prepare_sample`` and fails a ``TrainLoader``, where skipping it would
    train on fewer images than the JAX package."""
    avif = tmp_path / "micro.avif"
    cdef = os.path.join(os.path.dirname(__file__), "data", "torch_avif_cdef_fixtures.npz")
    avif.write_bytes(np.load(cdef)["refused-film-grain-420-8/file"].tobytes())
    assert cv2.imread(str(avif), cv2.IMREAD_COLOR) is not None
    rec = dict(records[0], file_name=str(avif))
    with pytest.raises(UnsupportedImageError, match="AVIF"):
        port_loader.prepare_sample(rec, 64, 8, False, np.random.default_rng(0))
    loader = port_loader.TrainLoader([rec], 2, 64, 8, workers=1)
    try:
        with pytest.raises(RuntimeError, match="AVIF"):
            next(iter(loader))
    finally:
        loader.close()

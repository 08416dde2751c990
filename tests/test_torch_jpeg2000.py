"""JPEG 2000 and the TIFF forms of C11 against the JAX package's reader
(``deepemia_tpu.inference.pipeline._load_image``, which is
``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with OpenJPEG 2.5), bit
for bit: every entry of ``tests/data/torch_jpeg2000_fixtures.npz`` (files
from Pillow's encoder, ``cv2.imwrite`` and the numpy writer of
``tools/make_torch_jpeg2000_fixtures.py``: every code-block style, SOP and
EPH, POC, PPM and PPT, RGN, the quantisation styles, tiles and tile-parts,
precisions 1 to 16, the JP2 colour boxes, cut and damaged copies; a
palette TIFF with extra samples, CMYK and YCbCr in separate planes, YCbCr
with predictor 2) reads as cv2 reads it here and as the committed array
says, or raises where cv2 returns None; a High-Throughput codestream is
refused by name; and the JAX loader and the port's give equal batches on
a dataset of JP2 frames, skipping the frame cv2 refuses."""

import hashlib
import importlib.util
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import deepemia_tpu.data.datasets as jax_ds
import deepemia_tpu.data.loader as jax_loader
import deepemia_tpu_torch.data.loader as port_loader
from deepemia_tpu.inference.pipeline import _load_image
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_jpeg2000_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})
_spec = importlib.util.spec_from_file_location("make_torch_jpeg2000_fixtures",
                                               ROOT / "tools" / "make_torch_jpeg2000_fixtures.py")
jx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jx)


def reference(path):
    """What the JAX package reads: ``cv2.imread``'s BGR array, or None."""
    got = _load_image(str(path))
    return None if got is None else got[0]


def _committed(name, ref):
    """Whether cv2's array here is the one the fixture file holds."""
    if f"{name}/none" in FIXTURES.files:
        return ref is None
    if ref is None:
        return False
    if f"{name}/bgr" in FIXTURES.files:
        return np.array_equal(ref, FIXTURES[f"{name}/bgr"])
    return hashlib.sha256(ref.tobytes()).hexdigest() == FIXTURES[f"{name}/sha256"].tobytes().decode()


@pytest.mark.parametrize("name", NAMES)
def test_fixture_reads_as_opencv(tmp_path, name):
    """Each fixture: cv2 here reads it as when it was written (or refuses
    it again), and the port reads it to the same array bit for bit, or
    refuses it with a ``ValueError`` that is not ``UnsupportedImageError``
    (``RefusedImageError`` for a form OpenCV refuses by rule)."""
    path = tmp_path / ("f" + FIXTURES[f"{name}/ext"].tobytes().decode())
    path.write_bytes(FIXTURES[f"{name}/file"].tobytes())
    ref = reference(path)
    assert _committed(name, ref), name
    if ref is None:
        with pytest.raises(ValueError) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError), (name, e.value)
    else:
        got = read_image(str(path))
        assert got.dtype == np.uint8 and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


REFUSED_BY_RULE = ("pil-signed", "pil-raw-gray", "np-gray-1bit", "np-rgb-7bit", "np-offset", "np-subsampled",
                   "np-raw-2", "np-five-components", "np-cmyk", "np-esycc", "np-sycc-1", "np-icc-gray",
                   "np-pclr-index-4bit", "c11-palette-planes", "c11-palette-extra-4bit", "c11-cmyk-planes-16",
                   "c11-ycbcr-planes-22", "c11-lab-planes")


@pytest.mark.parametrize("name", REFUSED_BY_RULE)
def test_forms_opencv_refuses_are_refused_by_name(tmp_path, name):
    """The forms OpenCV refuses by rule (signed, a precision below 8, an
    image offset, subsampling, the component counts and colour spaces it
    does not convert; the TIFF planes libtiff's RGBA reader does not put)
    raise ``RefusedImageError``, so that readers skip them as the JAX
    package does."""
    path = tmp_path / ("f" + FIXTURES[f"{name}/ext"].tobytes().decode())
    path.write_bytes(FIXTURES[f"{name}/file"].tobytes())
    assert reference(path) is None
    with pytest.raises(RefusedImageError):
        read_image(str(path))


def test_high_throughput_codestream_is_named(tmp_path):
    """Code-blocks in the HT style (Part 15), which OpenJPEG decodes with
    its HT decoder, raise ``UnsupportedImageError`` naming the form; a CAP
    marker or a jph brand over Part 1 code-blocks reads as OpenCV reads it
    (the np-cap-part15 and np-jph-brand fixtures)."""
    path = tmp_path / "ht.j2k"
    path.write_bytes(jx.encode(jx.micrograph(13, 17, 3), style=0x40))
    with pytest.raises(UnsupportedImageError, match="High-Throughput JPEG 2000"):
        read_image(str(path))


def test_numpy_writer_is_lossless(tmp_path):
    """The numpy writer's reversible path round-trips (the fixtures that
    use it test the decoder, not only agreement with cv2)."""
    img = jx.micrograph(21, 27, 7)
    path = tmp_path / "w.jp2"
    path.write_bytes(jx.jp2(jx.encode(img, style=1 | 4 | 8 | 32, layers=3, sop=True, eph=True, tile=(16, 12),
                                      tileparts=2, ppt=True), 16))
    np.testing.assert_array_equal(read_image(str(path)), img[..., ::-1])


@pytest.fixture(scope="module")
def jp2_records(tmp_path_factory):
    """Five records whose images are JP2 files of the dataset's PNGs:
    reversible, irreversible, tiled, 16-bit gray and (the third) a signed
    component, which cv2 refuses."""
    root = make_dataset(tmp_path_factory.mktemp("jp2") / "ds", 5, seed=17, size=(48, 64))
    for i in range(5):
        bgr = cv2.imread(os.path.join(root, f"img{i}.png"))
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        data = [jx._pillow(rgb), jx._pillow(rgb, irreversible=True), jx._pillow(bgr[..., 0], signed=True),
                jx._pillow(rgb, tile_size=(32, 32)), jx._pillow_i16(bgr[..., 1].astype(np.int64) * 257)][i]
        Path(root, f"img{i}.png").write_bytes(data)
    files = sorted(f for f in os.listdir(root) if f.endswith(".json"))
    return [jax_ds.parse_instance_json(os.path.join(root, f), root, i, {"a": 0, "b": 1}) for i, f in enumerate(files)]


def test_loaders_read_jp2_frames_as_jax(jp2_records):
    """The JAX loader and the port's get the same JP2 records: equal
    samples, the refused frame skipped by both, and equal first batches."""
    assert cv2.imread(jp2_records[2]["file_name"]) is None
    for i, rec in enumerate(jp2_records):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert (got is None) == (want is None) == (i == 2), i
            if want is not None:
                assert set(got) == set(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)
    loaders = [mod.TrainLoader(jp2_records, 2, 64, 8, augment=True, seed=3, workers=1)
               for mod in (jax_loader, port_loader)]
    try:
        want, got = next(iter(loaders[0])), next(iter(loaders[1]))
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    finally:
        for ld in loaders:
            ld.close()

"""Orientation in the port's ``read_image`` against ``cv2.imread``: a PNG's
``eXIf`` chunk (the bare TIFF structure, before or after the image data,
either byte order, all eight orientations and values outside them) turns
the raster as OpenCV 5.0 turns it; a TIFF's Orientation tag (274) turns it
the same way: the expected raster is ``cv2.imread`` of the same pixels
written without the tag, through the mapping the PNG cases hold to
OpenCV. OpenCV 5.0 itself returns None for a TIFF whose orientation
transposes (5-8) and mirrors each tile in place, not the image, for 2 and
3 in a tiled TIFF; where it reads the tag otherwise (1-4 in strips, 1 and
4 in tiles) it agrees with the port."""

import importlib.util
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from deepemia_tpu_torch.ops.image import read_image

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("make_torch_image_fixtures",
                                               ROOT / "tools" / "make_torch_image_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

RGB = fx.micrograph(13, 22, 5, channels=3)


def _both(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return read_image(str(path)), cv2.imread(str(path), cv2.IMREAD_COLOR)


def _oriented(tmp_path, rgb, orientation):
    """``cv2.imread`` of ``rgb`` as a PNG whose ``eXIf`` holds ``orientation``."""
    return _both(tmp_path, "ref.png", fx.png_bytes(rgb, ctype=2, exif=fx.exif_block(orientation)))[1]


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("after_idat", [False, True])
@pytest.mark.parametrize("orientation", range(10))
def test_png_exif_orientation_matches_cv2(tmp_path, orientation, after_idat, big_endian):
    data = fx.png_bytes(RGB, ctype=2, exif=fx.exif_block(orientation, big_endian), exif_after_idat=after_idat)
    got, want = _both(tmp_path, "a.png", data)
    np.testing.assert_array_equal(got, want)
    stored = RGB[..., ::-1]
    turned = orientation in range(5, 9)
    assert got.shape == ((22, 13, 3) if turned else (13, 22, 3))
    assert np.array_equal(got, stored) == (orientation not in range(2, 9))


@pytest.mark.parametrize("depth, ctype, interlace", [(1, 0, 1), (4, 3, 0), (2, 3, 1), (16, 0, 0)])
def test_png_exif_orientation_of_other_encodings(tmp_path, depth, ctype, interlace):
    s = fx.micrograph(11, 19, 6).astype(np.int64)
    s = s * 257 if depth == 16 else s >> (8 - depth)
    pal = np.random.default_rng(depth).integers(0, 256, (2 ** min(depth, 8), 3)) if ctype == 3 else None
    for o in (6, 7):
        data = fx.png_bytes(s, depth, ctype=ctype, palette=pal, interlace=interlace, exif=fx.exif_block(o))
        got, want = _both(tmp_path, "b.png", data)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (19, 11, 3)


def test_png_exif_without_its_byte_order_first_is_ignored(tmp_path):
    """libpng drops an ``eXIf`` chunk that does not start with "II" or "MM"
    (here one with JPEG's "Exif\\0\\0" header), so OpenCV turns nothing."""
    got, want = _both(tmp_path, "c.png", fx.png_bytes(RGB, ctype=2, exif=b"Exif\x00\x00" + fx.exif_block(6)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, RGB[..., ::-1])


@pytest.mark.parametrize("layout", ["strips", "tiles", "big_endian"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_tag_turns_as_png_exif(tmp_path, orientation, layout):
    kw = {"strips": dict(rows_per_strip=4), "tiles": dict(tile=(16, 16)),
          "big_endian": dict(big_endian=True)}[layout]
    tagged = fx.tiff_image(RGB, photometric=2, extra={274: (fx.SHORT, [orientation])}, **kw)
    got, cv2_tagged = _both(tmp_path, "t.tif", tagged)
    plain = _both(tmp_path, "p.tif", fx.tiff_image(RGB, photometric=2, **kw))[1]
    np.testing.assert_array_equal(plain, RGB[..., ::-1])
    np.testing.assert_array_equal(got, _oriented(tmp_path, RGB, orientation))
    if orientation >= 5:
        # OpenCV 5.0 reads no TIFF whose Orientation transposes (its
        # "original_ptr == real_mat.data" check): a defect the port does not copy
        assert cv2_tagged is None
    elif layout == "tiles" and orientation in (2, 3):
        # OpenCV 5.0 mirrors each tile in place, not the image: a defect too
        assert not np.array_equal(cv2_tagged, got)
    else:
        np.testing.assert_array_equal(got, cv2_tagged)


def test_tiff_orientation_of_gray_and_palette(tmp_path):
    gray = fx.micrograph(13, 22, 7)
    for photometric, colormap in ((1, None), (3, np.tile(np.arange(256) * 257, (3, 1)))):
        for o in (5, 8):
            data = fx.tiff_image(gray, photometric=photometric, colormap=colormap, extra={274: (fx.SHORT, [o])})
            got, _ = _both(tmp_path, "g.tif", data)
            np.testing.assert_array_equal(got, _oriented(tmp_path, np.repeat(gray[..., None], 3, 2), o))

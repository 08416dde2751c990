"""Port parity of the measurement stage and the image decoder: the native
bindings, host measurements and window rows against the JAX package; the
INTER_AREA resize against ``cv2.resize``; ``read_image`` against
``cv2.imread(..., IMREAD_COLOR)`` on PNG and uncompressed TIFF written by
cv2. Tolerances: native results and decoded pixels equal; rows with a
contrast crop 1e-4 relative (the area resize sums in float64 here, in
float32 in OpenCV); the resize 1e-6 of the pixel range."""

import cv2
import numpy as np
import pytest

from deepemia_tpu import native as jax_native
from deepemia_tpu.inference import measure as jax_measure
from deepemia_tpu.inference import measure_host as jax_host
from deepemia_tpu_torch import native as pt_native
from deepemia_tpu_torch.inference import measure as pt_measure
from deepemia_tpu_torch.inference import measure_host as pt_host
from deepemia_tpu_torch.ops.image import read_image


def _shapes():
    m = np.zeros((5, 48, 48), bool)
    yy, xx = np.mgrid[0:48, 0:48]
    m[0] = (yy - 20) ** 2 / 150 + (xx - 22) ** 2 / 60 <= 1  # ellipse
    m[1, 5:30, 8:40] = True
    m[1, 12:20, 15:25] = False  # hole
    m[2, 3:6, 3:40] = True
    m[2, 30:45, 30:45] = True  # two components
    m[3, 10, 10] = True  # a single pixel
    m[4] = np.abs(xx - yy) < 3  # diagonal band
    return m


def test_native_bindings_match_jax():
    for mask in _shapes():
        pts = pt_native.trace_outer_contour(mask)
        np.testing.assert_array_equal(pts, jax_native.trace_outer_contour(mask))
        assert pt_native.polygon_area_perimeter(pts) == jax_native.polygon_area_perimeter(pts)
        assert pt_native.min_area_rect(pts) == jax_native.min_area_rect(pts)
        assert pt_native.fit_ellipse(pts) == jax_native.fit_ellipse(pts)


def test_measure_mask_host_matches_jax():
    gray = (np.random.default_rng(0).random((48, 48)) * 255).astype(np.float32)
    for mask in _shapes():
        for contrast in (False, True):
            assert pt_host.measure_mask_host(mask, gray, contrast) == jax_host.measure_mask_host(mask, gray, contrast)


def test_resize_area_matches_cv2():
    rng = np.random.default_rng(1)
    for src, dst in ((192, 192), (193, 192), (257, 192), (384, 192), (1000, 192), (37, 10)):
        a = (rng.random((src, src + 3)) * 255).astype(np.float32)
        ref = cv2.resize(a, (dst - 1, dst), interpolation=cv2.INTER_AREA)
        got = pt_host.resize_area(a, dst, dst - 1)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=255 * 1e-6)
    with pytest.raises(ValueError, match="downscales only"):
        pt_host.resize_area(a, src + 1, src)


def _close(got_rows, ref_rows, rtol):
    assert len(got_rows) == len(ref_rows) > 0
    for g, r in zip(got_rows, ref_rows):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            if isinstance(b, float):
                assert abs(a - b) <= rtol * max(abs(b), 1e-12), (a, b)
            else:
                assert a == b


@pytest.mark.parametrize("contrast", [False, True])
def test_window_rows_match_jax(contrast):
    """Native-scale windows and shrunk ones (scale < 1: rescaled
    quantities, and a contrast crop through the area resize)."""
    wins = _shapes()
    origins = np.array([[10, 4], [-3, 50], [100, 90], [0, 0], [33.5, 20]], np.float32)
    scales = np.array([1.0, 0.5, 0.73, 1.0, 0.3], np.float32)
    classes = np.array([0, 1, 1, 0, 2])
    valid = np.array([True, True, True, False, True])
    gray = (np.random.default_rng(2).random((160, 170)) * 255).astype(np.float32)
    args = (wins, origins, scales, classes, valid, "img.tif", ["a", "b"], 0.04, "2", 160.0 * 170)
    kw = dict(gray=gray, measure_contrast=contrast)
    ref = jax_host.measurement_rows_host_windows(*args, **kw)
    got = pt_host.measurement_rows_host_windows(*args, **kw)
    _close(got, ref, 1e-4 if contrast else 0.0)
    # the masks with two components (id 3) write one row each; the invalid
    # one consumes no id
    assert [r[0] for r in got] == ["img.tif_1", "img.tif_2", "img.tif_3", "img.tif_3", "img.tif_4"]


def test_full_mask_rows_and_device_row_format_match_jax():
    masks = _shapes()
    classes = np.array([0, 1, 1, 0, 1])
    valid = np.ones(5, bool)
    args = (masks, classes, valid, "m.png", ["p"], 0.5, "0", 48.0 * 48)
    assert pt_host.measurement_rows_host(*args) == jax_host.measurement_rows_host(*args)
    assert pt_measure.CSV_HEADER == jax_measure.CSV_HEADER
    rng = np.random.default_rng(3)
    keys = ("area", "perimeter", "rect_w", "rect_h", "major_axis", "minor_axis", "eccentricity",
            "contrast_d10", "contrast_d50", "contrast_d90")
    meas = {k: (rng.random(6) * 40).astype(np.float32) for k in keys}
    meas["area"][2] = 1.0  # under the area gate
    meas["perimeter"][3] = 0.0
    valid = np.array([1, 1, 1, 1, 0, 1], bool)
    classes = np.array([0, 1, 0, 3, 1, 0])
    rargs = (meas, None, "x.png", ["p", "q"], 0.1, "5", 1e6)
    ref = jax_measure.measurement_rows(*rargs, valid=valid, classes=classes)
    assert pt_measure.measurement_rows(*rargs, valid=valid, classes=classes) == ref


CASES = [
    ((45, 52), np.uint8), ((45, 52, 3), np.uint8), ((45, 52, 4), np.uint8),
    ((45, 52), np.uint16), ((45, 52, 3), np.uint16), ((45, 52, 4), np.uint16),
]


@pytest.mark.parametrize("shape, dtype", CASES)
@pytest.mark.parametrize("ext", [".png", ".tif"])
def test_read_image_matches_cv2(tmp_path, shape, dtype, ext):
    rng = np.random.default_rng(len(shape) * 7 + np.dtype(dtype).itemsize)
    # smooth ramps plus noise, so the PNG writer picks every scanline filter
    ramp = np.arange(shape[1])[None, :] * (np.iinfo(dtype).max // 64)
    a = rng.integers(0, np.iinfo(dtype).max // 4, shape, dtype=np.int64)
    a = (a + (ramp if len(shape) == 2 else ramp[..., None])) % (np.iinfo(dtype).max + 1)
    a = a.astype(dtype)
    path = str(tmp_path / f"img{ext}")
    params = [cv2.IMWRITE_TIFF_COMPRESSION, 1] if ext == ".tif" else []
    assert cv2.imwrite(path, a, params)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    got = read_image(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(got, ref)


def test_read_image_names_what_it_cannot_decode(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    # an LZMA TIFF (compression 34925): the header of an uncompressed one
    # with the compression tag changed
    cv2.imwrite(str(tmp_path / "raw.tif"), img, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    data = bytearray((tmp_path / "raw.tif").read_bytes())
    ifd = int.from_bytes(data[4:8], "little")
    for e in range(ifd + 2, ifd + 2 + 12 * int.from_bytes(data[ifd : ifd + 2], "little"), 12):
        if int.from_bytes(data[e : e + 2], "little") == 259:
            data[e + 8 : e + 10] = (34925).to_bytes(2, "little")
    (tmp_path / "lzma.tif").write_bytes(bytes(data))
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    with pytest.raises(ValueError, match="LZMA"):
        read_image(str(tmp_path / "lzma.tif"))
    # a JPEG decodes, to OpenCV's pixels
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.jpg")), cv2.imread(str(tmp_path / "a.jpg")))
    (tmp_path / "junk.png").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="unknown image encoding"):
        read_image(str(tmp_path / "junk.png"))


def test_host_rows_from_crops_equal_the_whole_masks():
    """``measurement_rows_host`` on each mask's bounding-box crop at its
    origin (the overlay path's export) gives the whole masks' rows exactly,
    contrast included."""
    masks = np.zeros((5, 60, 70), bool)
    masks[:, 6:54, 11:59] = _shapes()
    masks[3] = False
    masks[4, :, 0] = True  # a column on the left border
    gray = (np.random.default_rng(4).random((60, 70)) * 255).astype(np.float32)
    crops, origins = [], []
    for m in masks:
        ys, xs = np.nonzero(m)
        if ys.size == 0:
            crops.append(np.zeros((0, 0), bool))
            origins.append((0, 0))
            continue
        crops.append(m[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1])
        origins.append((xs.min(), ys.min()))
    args = (np.array([0, 1, 1, 0, 1]), np.ones(5, bool), "m.png", ["p", "q"], 0.5, "0", 60.0 * 70)
    ref = pt_host.measurement_rows_host(masks, *args, gray=gray, measure_contrast=True)
    assert ref == jax_host.measurement_rows_host(masks, *args, gray=gray, measure_contrast=True)
    got = pt_host.measurement_rows_host(crops, *args, gray=gray, measure_contrast=True, origins=np.array(origins))
    assert got == ref and len(got) > 4

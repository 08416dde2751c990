"""The PNG, TIFF and BMP encodings the port's ``read_image`` decodes beside
the plain 8-bit ones, each held to ``cv2.imread(path, cv2.IMREAD_COLOR)``
bit for bit: PNG gray and palettes at 1, 2 and 4 bits, plain and Adam7,
``tRNS`` on a palette; TIFF bilevel BlackIsZero and WhiteIsZero, 8- and
16-bit WhiteIsZero, palettes at 1, 4 and 8 bits (16-bit and 8-bit colour
maps), CMYK, YCbCr at every subsampling libtiff places (and its
coefficient and reference tags), and JPEG-compressed strips and tiles
(RGB, YCbCr and gray; Pillow's and hand-built files); BMP 1-, 4- and 8-bit
palettes, RLE8 and RLE4 with their escapes (random streams of runs,
absolute stretches, ends of line, deltas and ends of bitmap). Also: the
committed fixtures (``tests/data/torch_image_fixtures.npz``, which
``chip_smoke.py`` decodes on a host without OpenCV), truncated files as a
``ValueError``, what OpenCV refuses as ``RefusedImageError``, and a
palette TIFF through the port's ``InferencePipeline`` giving the CSVs of
the same raster as a plain TIFF."""

import csv
import importlib.util
import io
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from deepemia_tpu_torch.inference.pipeline import InferencePipeline
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image
from test_torch_pipeline import golden  # noqa: F401 - the fixture
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("make_torch_image_fixtures",
                                               ROOT / "tools" / "make_torch_image_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

H, W = 37, 53


def _check(tmp_path, ext, data):
    """``read_image`` equals ``cv2.imread`` on ``data`` -> the pixels."""
    path = tmp_path / f"f.{ext}"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None, "OpenCV reads nothing"
    got = read_image(str(path))
    np.testing.assert_array_equal(got, want)
    return got


def _levels(depth, seed, hw=(H, W)):
    return np.random.default_rng(seed).integers(0, 2**depth, hw)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_sub_byte_gray(tmp_path, depth, interlace):
    s = _levels(depth, depth)
    got = _check(tmp_path, "png", fx.png_bytes(s, depth, interlace=interlace, filters=(0, 1, 2, 3, 4)))
    np.testing.assert_array_equal(got[..., 1], s * (255 // (2**depth - 1)))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette(tmp_path, depth, interlace):
    s = _levels(depth, 10 + depth)
    pal = np.random.default_rng(depth).integers(0, 256, (2**depth, 3))
    trns = bytes(range(0, 256, 256 >> depth))[: 2**depth]
    got = _check(tmp_path, "png", fx.png_bytes(s, depth, ctype=3, palette=pal, trns=trns, interlace=interlace,
                                               filters=(4, 1, 2, 3), idat_chunks=3))
    np.testing.assert_array_equal(got, pal[s][..., ::-1])


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (2, 3), (8, 8), (17, 3), (5, 33)])
def test_png_adam7_small_sub_byte(tmp_path, hw):
    """Adam7 passes are counted in pixels; a pass may be empty or one pixel wide."""
    for depth in (1, 2, 4):
        _check(tmp_path, "png", fx.png_bytes(_levels(depth, depth, hw), depth, interlace=1, filters=(2, 4, 3)))


@pytest.mark.parametrize("layout", ["strips", "tiles", "big_endian"])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("depth", [1, 8])
def test_tiff_gray_black_and_white_is_zero(tmp_path, depth, photometric, layout):
    kw = {"strips": dict(rows_per_strip=5), "tiles": dict(tile=(16, 32)), "big_endian": dict(big_endian=True)}[layout]
    s = _levels(depth, depth)
    got = _check(tmp_path, "tif", fx.tiff_image(s, depth, photometric=photometric, **kw))
    v = s * 255 if depth == 1 else s
    np.testing.assert_array_equal(got[..., 0], 255 - v if photometric == 0 else v)


def test_tiff_16_bit_white_is_zero(tmp_path):
    s = _levels(16, 3)
    got = _check(tmp_path, "tif", fx.tiff_image(s, 16, photometric=0, rows_per_strip=7))
    np.testing.assert_array_equal(got[..., 0], 255 - (s >> 8))


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("map_bits", [16, 8])
@pytest.mark.parametrize("depth", [1, 4, 8])
def test_tiff_palette(tmp_path, depth, map_bits, layout):
    """libtiff reduces a 16-bit ColorMap by its high byte and takes one
    whose entries are all below 256 as it is."""
    s = _levels(depth, 20 + depth)
    cmap = np.random.default_rng(depth).integers(0, 2**map_bits, (3, 2**depth))
    kw = dict(rows_per_strip=7) if layout == "strips" else dict(tile=(16, 16))
    got = _check(tmp_path, "tif", fx.tiff_image(s, depth, photometric=3, colormap=cmap, **kw))
    cmap = cmap >> 8 if cmap.max() >= 256 else cmap
    np.testing.assert_array_equal(got, cmap.T[s][..., ::-1])


@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_tiff_cmyk(tmp_path, layout):
    c = np.random.default_rng(4).integers(0, 256, (H, W, 4))
    kw = dict(rows_per_strip=8) if layout == "strips" else dict(tile=(16, 16))
    got = _check(tmp_path, "tif", fx.tiff_image(c, photometric=5, **kw))
    np.testing.assert_array_equal(got, (255 - c[..., 3:]) * (255 - c[..., 2::-1]) // 255)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4)])
def test_tiff_ycbcr(tmp_path, sub):
    ycc = np.random.default_rng(sub[0] * 4 + sub[1]).integers(0, 256, (H, W, 3)).astype(np.uint8)
    _check(tmp_path, "tif", fx.ycbcr_tiff(ycc, sub, rows_per_strip=4 * sub[1]))


def test_tiff_ycbcr_every_triple(tmp_path):
    """Every (Cb, Cr) pair, each with 16 luma values that together cover all
    256, at 1x1 subsampling; and every triple of a coarse grid under
    non-default coefficients and reference levels."""
    i = np.arange(1 << 20)
    pair, k = i & 0xFFFF, i >> 16
    ycc = np.stack([(k * 17 + pair) & 255, pair & 255, pair >> 8], axis=-1).astype(np.uint8).reshape(1024, 1024, 3)
    _check(tmp_path, "tif", fx.ycbcr_tiff(ycc, (1, 1), rows_per_strip=256))
    g = np.arange(0, 256, 5)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3).astype(np.uint8)
    grid = grid[: len(grid) // 52 * 52].reshape(-1, 52, 3)
    for luma, rbw in ((((2126, 10000), (7152, 10000), (722, 10000)), ((16, 1), (235, 1), (128, 1), (240, 1),
                                                                     (128, 1), (240, 1))),
                      (((299, 1000), (587, 1000), (114, 1000)), ((21, 2), (1001, 4), (120, 1), (250, 1), (130, 1),
                                                                 (245, 1)))):
        _check(tmp_path, "tif", fx.ycbcr_tiff(grid, (1, 1), extra={529: (fx.RATIONAL, list(luma)),
                                                                    532: (fx.RATIONAL, list(rbw))}))


def _pillow_tiff(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("compression", ["jpeg", "tiff_jpeg"])
@pytest.mark.parametrize("gray", [False, True])
def test_tiff_jpeg_from_pillow(tmp_path, compression, gray):
    img = fx.micrograph(61, 45, 8, channels=3)
    _check(tmp_path, "tif", _pillow_tiff(img[..., 0] if gray else img, compression=compression))
    _check(tmp_path, "tif", _pillow_tiff(fx.micrograph(300, 200, 9, channels=3), compression=compression,
                                         quality=60))


JPEG_TIFFS = [
    ("ycbcr420_strips", dict(photometric=6, rows_per_strip=16, sub=(2, 2)), (90, "420")),
    ("ycbcr422_strips", dict(photometric=6, rows_per_strip=8, sub=(2, 1)), (80, "422")),
    ("ycbcr444_strips", dict(photometric=6, rows_per_strip=13, sub=(1, 1)), (95, "444")),
    ("ycbcr420_tiles", dict(photometric=6, tile=(16, 32), sub=(2, 2)), (75, "420")),
    ("rgb_strips", dict(photometric=2, rows_per_strip=24), (90, "444")),
    ("rgb_tiles", dict(photometric=2, tile=(32, 16)), (70, "444")),
    ("gray_strips", dict(photometric=1, rows_per_strip=16), (85, None)),
    ("gray_tiles", dict(photometric=1, tile=(16, 16)), (85, None)),
]


@pytest.mark.parametrize("name, kw, enc", JPEG_TIFFS, ids=[c[0] for c in JPEG_TIFFS])
def test_tiff_jpeg_strips_and_tiles(tmp_path, name, kw, enc):
    """Each strip or tile a JPEG stream whose tables live in JPEGTables:
    YCbCr converted by libjpeg, RGB and gray as stored (the RGB streams here
    hold YCbCr-coded samples, which libtiff takes as R, G and B)."""
    img = fx.micrograph(H, W + 8, 12, channels=3)
    encode = fx.cv2_jpeg(cv2)
    data = fx.jpeg_tiff(img[..., 0] if kw["photometric"] == 1 else img, lambda p: encode(p, *enc), **kw)
    _check(tmp_path, "tif", data)


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palette(tmp_path, bits, top_down):
    idx = _levels(bits, 30 + bits)
    pal = np.random.default_rng(bits).integers(0, 256, (2**bits, 3))
    got = _check(tmp_path, "bmp", fx.bmp_bytes(idx, bits, pal, top_down=top_down))
    np.testing.assert_array_equal(got, pal[idx][..., ::-1])


@pytest.mark.parametrize("bits", [4, 8])
def test_bmp_indices_past_the_palette_are_black(tmp_path, bits):
    idx = _levels(bits, 40 + bits)
    pal = np.random.default_rng(bits).integers(0, 256, (5, 3))
    got = _check(tmp_path, "bmp", fx.bmp_bytes(idx, bits, pal, colors_used=5))
    assert not got[idx >= 5].any()


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_bmp_rle(tmp_path, bits, top_down):
    idx = _levels(bits, 50 + bits)
    idx[5:20, 3:40] = 7
    idx[22] = np.tile([3, 9], W)[:W]
    pal = np.random.default_rng(bits).integers(0, 256, (2**bits, 3))
    data = fx.bmp_bytes(idx, bits, pal, compression=1 if bits == 8 else 2, data=fx.rle_encode(idx, bits),
                        top_down=top_down)
    got = _check(tmp_path, "bmp", data)
    np.testing.assert_array_equal(got, pal[idx[::-1] if top_down else idx][..., ::-1])


@pytest.mark.parametrize("bits", [4, 8])
def test_bmp_rle_escapes(tmp_path, bits):
    """Random streams of runs, absolute stretches, ends of line, deltas and
    ends of bitmap: skipped pixels take palette entry 0."""
    rng = np.random.default_rng(bits)
    pal = rng.integers(0, 256, (2**bits, 3))
    for k in range(150):
        h, w = int(rng.integers(1, 12)), int(rng.integers(1, 20))
        data = fx.bmp_bytes(np.zeros((h, w), np.int64), bits, pal, compression=1 if bits == 8 else 2,
                            data=fx.rle_with_escapes(rng, h, w, bits), top_down=k % 3 == 0)
        _check(tmp_path, "bmp", data)


# OpenCV's RLE4: an end of bitmap ends the line, a delta moves by dx alone;
# RLE8: a run that fills its row moves to the next, where an end of line
# does nothing; an end of line at a row's start skips the whole row
RLE_STREAMS = [
    (4, 2, 4, "041200000001"), (4, 2, 4, "0412000104340000"), (4, 3, 4, "00000412000104340000"),
    (4, 2, 6, "0002070004560000"), (4, 3, 6, "0002020101ff000000000000"), (4, 3, 3, "03120000000100000002"),
    (8, 3, 6, "0002020101ff00000000"), (8, 2, 3, "03120000000100000002"), (8, 1, 3, "0000"),
    (8, 2, 3, "00000312"), (8, 2, 4, "0412043400000000"), (8, 2, 4, "0001"),
]


@pytest.mark.parametrize("bits, h, w, stream", RLE_STREAMS)
def test_bmp_rle_escape_semantics(tmp_path, bits, h, w, stream):
    pal = np.repeat(np.arange(2**bits)[:, None] * (255 // (2**bits - 1)), 3, axis=1)
    _check(tmp_path, "bmp", fx.bmp_bytes(np.zeros((h, w), np.int64), bits, pal,
                                         compression=1 if bits == 8 else 2, data=bytes.fromhex(stream),
                                         top_down=True))


@pytest.mark.parametrize("bits, stream", [(4, "0001"), (4, "04120001"), (8, "0004010203040412"), (8, "03120212"),
                                          (4, "041204340000"), (8, "030000"), (4, "00050102")])
def test_bmp_rle_cut_or_past_the_row_is_corrupt(tmp_path, bits, stream):
    """Streams that end before the image does, or a run that crosses its
    row's end: OpenCV reads nothing, the port raises a ValueError."""
    path = tmp_path / "r.bmp"
    path.write_bytes(fx.bmp_bytes(np.zeros((2, 4), np.int64), bits, np.zeros((2**bits, 3), np.int64),
                                  compression=1 if bits == 8 else 2, data=bytes.fromhex(stream), top_down=True))
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError) as e:
        read_image(str(path))
    assert not isinstance(e.value, UnsupportedImageError)


FIXTURES = np.load(ROOT / "tests" / "data" / "torch_image_fixtures.npz")
CASES = sorted(k for k in FIXTURES.files if "." not in k)


def _fixture(name):
    (key,) = [k for k in FIXTURES.files if k.startswith(name + ".")]
    return key.rsplit(".", 1)[1], FIXTURES[key].tobytes()


@pytest.mark.parametrize("name", CASES)
def test_committed_fixture(tmp_path, name):
    """The fixture decodes to the pixels stored beside it, which are
    ``cv2.imread``'s (``tools/make_torch_image_fixtures.py:reference``)."""
    ext, data = _fixture(name)
    path = tmp_path / f"{name}.{ext}"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_image(str(path)), FIXTURES[name])
    np.testing.assert_array_equal(fx.reference(name, str(path), cv2), FIXTURES[name])


def test_fixtures_cover_every_encoding():
    assert len(CASES) >= 45
    for prefix in ("png_gray1", "png_palette4_adam7", "png_exif6", "tif_orientation6", "tif_bilevel", "tif_palette4",
                   "tif_cmyk", "tif_ycbcr42", "tif_jpeg_ycbcr420_tiles", "tif_jpeg_gray", "bmp_palette1",
                   "bmp_rle8_escapes", "bmp_rle4"):
        assert any(c.startswith(prefix) for c in CASES), prefix


@pytest.mark.parametrize("name", [c for c in CASES if not c.startswith("png_exif")])
def test_truncated_fixture_is_corrupt(tmp_path, name):
    """Cut inside its pixel data (or, for a TIFF, whose directory comes
    last, before it): a ValueError, not an unsupported encoding. A TIFF cut
    after its directory but inside the data of a tag libtiff then drops (a
    ColorMap: the palette reads as gray, C12) reads as ``cv2.imread``
    reads it."""
    ext, data = _fixture(name)
    path = tmp_path / f"{name}.{ext}"
    path.write_bytes(data[: len(data) * 2 // 3])
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if ref is not None:
        assert ext == "tif", name
        np.testing.assert_array_equal(read_image(str(path)), ref)
        return
    with pytest.raises(ValueError) as e:
        read_image(str(path))
    assert not isinstance(e.value, UnsupportedImageError)


@pytest.mark.parametrize("depth, photometric", [(2, 1), (4, 1), (4, 0), (2, 3)])
def test_what_opencv_refuses_is_unsupported(tmp_path, depth, photometric):
    """2- and 4-bit gray and 2-bit palette TIFFs: OpenCV 5.0 reads nothing
    ("Invalid bitsperpixel"), and the port names them."""
    cmap = np.zeros((3, 2**depth), np.int64) if photometric == 3 else None
    path = tmp_path / "u.tif"
    path.write_bytes(fx.tiff_image(_levels(depth, 1), depth, photometric=photometric, colormap=cmap))
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(RefusedImageError, match=f"samples of \\[{depth}\\] bits"):
        read_image(str(path))


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_palette_tiff_through_the_pipeline(golden, tmp_path):  # noqa: F811 - the fixture
    """The golden micrograph's raster as an 8-bit palette TIFF (a gray
    ColorMap) and as a plain gray TIFF: ``read_image`` gives OpenCV's pixels
    for both, and the port's pipeline the same two CSVs."""
    gray = golden["image"][..., 0]
    ramp = np.tile(np.arange(256) * 257, (3, 1))
    results = []
    for kind, data in (("plain", fx.tiff_image(gray, rows_per_strip=16)),
                       ("palette", fx.tiff_image(gray, photometric=3, colormap=ramp, tile=(32, 32)))):
        folder = tmp_path / kind
        folder.mkdir()
        (folder / "micro.tif").write_bytes(data)
        np.testing.assert_array_equal(read_image(str(folder / "micro.tif")), golden["image"])
        np.testing.assert_array_equal(cv2.imread(str(folder / "micro.tif")), golden["image"])
        pipe = InferencePipeline("zds", golden["split_dir"], output_dir=str(tmp_path / f"out_{kind}"),
                                 config=golden["cfg"], use_bf16=False, default_threshold=0.2, device="cpu")
        res = pipe.run(str(folder), visualize=False)
        assert res["processed"] == ["micro.tif"] and not res["failed"]
        results.append((_csv_rows(res["rle_csv"]), _csv_rows(res["measurements_csv"])))
    assert results[0] == results[1] and len(results[0][0]) > 1 and len(results[0][1]) > 1

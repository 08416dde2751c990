"""The TIFF codings the port reads beside the plain ones, against the JAX
package's reader (``deepemia_tpu.inference.pipeline._load_image``, which
is ``cv2.imread(path, cv2.IMREAD_COLOR)``), bit for bit: FillOrder 2
(tag 266) in every compression, BigTIFF in both byte orders, strips and
tiles, and CCITT fax (Modified Huffman, Group 3 1D and 2D, Group 4, RLEW),
on files written by Pillow through libtiff and by the numpy writers of
``tools/make_torch_codings_fixtures.py``, damaged ones included; and the
TIFF compressions OpenCV does not read either, which the port refuses by
name."""

import importlib.util
import io
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from deepemia_tpu.inference.pipeline import _load_image
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("make_torch_codings_fixtures",
                                               ROOT / "tools" / "make_torch_codings_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def reference(path):
    """What the JAX package reads: ``cv2.imread``'s BGR array, or None."""
    got = _load_image(str(path))
    return None if got is None else got[0]


def assert_reads_as_reference(path, want_gray=None):
    ref = reference(path)
    assert ref is not None, path
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if want_gray is not None:
        np.testing.assert_array_equal(got[..., 0], want_gray)


def _gray(h, w, seed):
    rng = np.random.default_rng(seed)
    return ((np.arange(w)[None] * 3 + np.arange(h)[:, None]) % 200 + rng.integers(0, 40, (h, w))).astype(np.uint8)


def _bits(h, w, seed):
    """Blocks, lines and speckle: long runs, short runs and every mode of
    the 2D codes."""
    rng = np.random.default_rng(seed)
    b = np.zeros((h, w), np.uint8)
    for _ in range(25):
        y, x = rng.integers(0, h), rng.integers(0, w)
        b[y : y + rng.integers(1, h + 1), x : x + rng.integers(1, w + 1)] ^= 1
    b[rng.random((h, w)) < 0.03] ^= 1
    return b


def _pillow(path, img, compression, info=None):
    TiffImagePlugin.WRITE_LIBTIFF = True
    try:
        img.save(str(path), compression=compression, tiffinfo=info or {})
    finally:
        TiffImagePlugin.WRITE_LIBTIFF = False
    return path


# ---------------------------------------------------------------------------
# FillOrder 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_fill_order_2_through_libtiff(tmp_path, compression, mode):
    """libtiff reverses each byte of a FillOrder 2 file as it writes and as
    it reads it: the image reads back as written."""
    g = _gray(32, 40, 1)
    img = Image.fromarray(g if mode == "L" else np.stack([g, 255 - g, g // 2], -1))
    path = _pillow(tmp_path / "a.tif", img, compression, {266: 2})
    want = np.asarray(img.convert("L")) if mode == "L" else None
    assert_reads_as_reference(path, want)


def test_fill_order_2_uncompressed_as_pillow_writes_it(tmp_path):
    """Pillow's own writer stores the bytes unreversed beside FillOrder 2:
    OpenCV (and the port) read the bit-reversed pixels."""
    g = _gray(32, 40, 2)
    Image.fromarray(g).save(str(tmp_path / "a.tif"), tiffinfo={266: 2})
    assert_reads_as_reference(tmp_path / "a.tif", fx.BIT_REVERSED[g])


@pytest.mark.parametrize("compression", [fx.RAW, fx.LZW, fx.DEFLATE, fx.PACKBITS])
@pytest.mark.parametrize("layout", [{}, {"rows_per_strip": 7}, {"tile": (16, 32)}])
def test_fill_order_2_numpy_writer(tmp_path, compression, layout):
    g = _gray(37, 45, 3)
    (tmp_path / "a.tif").write_bytes(fx.tiff_of(g, compression, fill_order=2, **layout))
    if compression == fx.RAW and "tile" in layout:
        # libtiff's tile reader fails on uncompressed FillOrder 2 tiles: OpenCV returns None
        assert reference(tmp_path / "a.tif") is None
        with pytest.raises(ValueError, match="FillOrder 2") as e:
            read_image(str(tmp_path / "a.tif"))
        assert not isinstance(e.value, UnsupportedImageError)
        return
    assert_reads_as_reference(tmp_path / "a.tif", g)


def test_fill_order_2_leaves_jpeg_strips_and_bilevel_alone(tmp_path):
    """tif_jpeg.c sets TIFF_NOBITREV: JPEG strips read as with FillOrder 1.
    A 1-bit uncompressed strip is reversed like any other."""
    g = _gray(32, 40, 4)
    a = _pillow(tmp_path / "a.tif", Image.fromarray(g), "jpeg")
    b = _pillow(tmp_path / "b.tif", Image.fromarray(g), "jpeg", {266: 2})
    assert_reads_as_reference(b)
    np.testing.assert_array_equal(read_image(str(a)), read_image(str(b)))
    bits = _bits(20, 24, 5)
    packed = np.packbits(bits, axis=1)
    tags = {256: (fx.LONG, [24]), 257: (fx.LONG, [20]), 258: (fx.SHORT, [1]), 259: (fx.SHORT, [1]),
            262: (fx.SHORT, [0]), 266: (fx.SHORT, [2]), 277: (fx.SHORT, [1]), 278: (fx.LONG, [20])}
    (tmp_path / "c.tif").write_bytes(fx.tiff_bytes(tags, [fx.BIT_REVERSED[packed].tobytes()]))
    assert_reads_as_reference(tmp_path / "c.tif", (255 - 255 * bits).astype(np.uint8))


@pytest.mark.parametrize("layout", [{}, {"rows_per_strip": 9}, {"tile": (16, 16)}])
@pytest.mark.parametrize("shape", [(32, 40), (130, 170)])
def test_old_style_lzw(tmp_path, layout, shape):
    """Old-style LZW (LSB-first codes that widen when the table fills,
    told by a Clear code's first bytes), which libtiff still reads
    (LZWDecodeCompat); the one 130x170 strip (~6000 codes) overflows the
    table and clears it."""
    g = _gray(*shape, 21) // 16 * 16
    (tmp_path / "a.tif").write_bytes(fx.tiff_of(g, fx.LZW_COMPAT, **layout))
    assert_reads_as_reference(tmp_path / "a.tif", g)


@pytest.mark.parametrize("spp", [2, 3, 4])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_gray_with_extra_samples(tmp_path, spp, photometric, dtype):
    """Gray with one to three extra samples (ExtraSamples or none): libtiff's
    RGBA reader takes the first sample. In strips and in tiles that cover
    the image, OpenCV reads the same; in partial right tiles it misreads
    the rows after a tile's first (as for 16-bit gray, pinned in
    ``test_torch_image_codecs.py``), where the port reads the first sample."""
    rng = np.random.default_rng(spp + photometric)
    top = np.iinfo(dtype).max
    a = rng.integers(0, top, (40, 45, spp)).astype(dtype)
    first = (a[..., 0] >> 8 if dtype == np.uint16 else a[..., 0]).astype(np.uint8)
    first = 255 - first if photometric == 0 else first
    extra = {338: (fx.SHORT, [2] + [0] * (spp - 2))} if spp > 2 else None
    for layout in ({"rows_per_strip": 7}, {"tile": (16, 16)}):
        data = fx.image_tool.tiff_image(a, 8 * a.itemsize, photometric=photometric, extra=extra, **layout)
        (tmp_path / "a.tif").write_bytes(data)
        got = read_image(str(tmp_path / "a.tif"))
        np.testing.assert_array_equal(got[..., 0], first)
        ref = reference(tmp_path / "a.tif")
        if "tile" not in layout:
            np.testing.assert_array_equal(got, ref)
            continue
        clean = np.ones(first.shape, bool)
        for y in range(0, 40, 16):
            clean[y + 1 : y + 16, 32:] = False  # the partial right tiles' later rows
        np.testing.assert_array_equal(got[clean], ref[clean])
        assert (got[~clean] != ref[~clean]).any()


def test_cielab(tmp_path):
    """CIELab (photometric 8) at 8 bits, every L with every fourth a and b
    (a million triples; the whole cube agrees too), under the default D50
    and another WhitePoint, and at 16 bits: libtiff's float32 conversion
    to the sRGB display, bit for bit."""
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(0, 256, 4), np.arange(0, 256, 4), indexing="ij"), -1)
    lab = grid.reshape(1024, 1024, 3).astype(np.uint8)
    (tmp_path / "a.tif").write_bytes(fx.image_tool.tiff_image(lab, 8, photometric=8, rows_per_strip=128))
    assert_reads_as_reference(tmp_path / "a.tif")
    d65 = {318: (fx.RATIONAL, [(3127, 10000), (3290, 10000)])}
    (tmp_path / "w.tif").write_bytes(fx.image_tool.tiff_image(lab[:64, :64], 8, photometric=8, extra=d65))
    assert_reads_as_reference(tmp_path / "w.tif")
    lab16 = np.random.default_rng(22).integers(0, 65536, (48, 40, 3)).astype(np.uint16)
    (tmp_path / "b.tif").write_bytes(fx.image_tool.tiff_image(lab16, 16, photometric=8, tile=(16, 16)))
    assert_reads_as_reference(tmp_path / "b.tif")


@pytest.mark.parametrize("quality", [95, 50])
@pytest.mark.parametrize("shape", [(32, 40), (37, 45)])
def test_cmyk_jpeg_strips(tmp_path, quality, shape):
    """JPEG strips of a CMYK TIFF (photometric 5): libtiff has libjpeg pass
    the four samples through as stored (JCS_UNKNOWN), then its RGBA reader
    converts CMYK as for uncompressed strips."""
    img = Image.fromarray(np.stack([_gray(*shape, 18), 255 - _gray(*shape, 19), _gray(*shape, 20) // 2], -1))
    TiffImagePlugin.WRITE_LIBTIFF = True
    try:
        img.convert("CMYK").save(str(tmp_path / "c.tif"), compression="jpeg", quality=quality)
    finally:
        TiffImagePlugin.WRITE_LIBTIFF = False
    assert_reads_as_reference(tmp_path / "c.tif")


# ---------------------------------------------------------------------------
# BigTIFF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [fx.RAW, fx.LZW, fx.DEFLATE, fx.PACKBITS])
@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("layout", [{"rows_per_strip": 5}, {"tile": (16, 16)}])
@pytest.mark.parametrize("channels", [1, 3])
def test_bigtiff(tmp_path, compression, big_endian, layout, channels):
    g = _gray(37, 45, 6)
    px = g if channels == 1 else np.stack([g, 255 - g, g // 3], -1)
    (tmp_path / "a.tif").write_bytes(fx.tiff_of(px, compression, big=True, big_endian=big_endian, **layout))
    assert (tmp_path / "a.tif").read_bytes()[:4] == (b"MM\x00+" if big_endian else b"II+\x00")
    assert_reads_as_reference(tmp_path / "a.tif")
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.tif"))[..., 2 if channels == 3 else 0], g)


@pytest.mark.parametrize("offsets_type", [fx.SHORT, fx.LONG, fx.LONG8])
def test_bigtiff_offset_types(tmp_path, offsets_type):
    g = _gray(20, 30, 7)
    (tmp_path / "a.tif").write_bytes(fx.tiff_of(g, fx.LZW, rows_per_strip=4, big=True, offsets_type=offsets_type))
    assert_reads_as_reference(tmp_path / "a.tif", g)


def test_bigtiff_from_pillow(tmp_path):
    """Pillow's own BigTIFF, and Pillow's JPEG, palette and fax TIFFs (with
    JPEGTables, ColorMap and T4Options) rewritten as BigTIFF in both byte
    orders."""
    g = _gray(33, 41, 8)
    Image.fromarray(g).save(str(tmp_path / "p.tif"), big_tiff=True)
    assert (tmp_path / "p.tif").read_bytes()[:4] == b"II+\x00"
    assert_reads_as_reference(tmp_path / "p.tif", g)
    rgb = Image.fromarray(np.stack([g, 255 - g, g // 2], -1))
    sources = {
        "jpeg": _pillow(tmp_path / "j.tif", rgb, "jpeg"),
        "palette": _pillow(tmp_path / "q.tif", rgb.quantize(16), "tiff_lzw"),
        "g3": _pillow(tmp_path / "f.tif", Image.fromarray(_bits(33, 41, 9) * 255).convert("1"), "group3",
                      {292: 1}),
    }
    for name, src in sources.items():
        for be in (False, True):
            out = tmp_path / f"{name}_{int(be)}.tif"
            out.write_bytes(fx.retiff(src.read_bytes(), big=True, big_endian=be))
            assert_reads_as_reference(out)
            np.testing.assert_array_equal(read_image(str(out)), read_image(str(src)))


# ---------------------------------------------------------------------------
# CCITT fax
# ---------------------------------------------------------------------------

FAX_PILLOW = [("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}), ("group3", {292: 5}), ("group3", {292: 4}),
              ("group4", {}), ("group4", {266: 2}), ("group3", {292: 1, 266: 2}), ("tiff_ccitt", {266: 2}),
              ("group4", {278: 7}), ("group3", {292: 1, 278: 5})]


@pytest.mark.parametrize("compression, info", FAX_PILLOW)
@pytest.mark.parametrize("shape", [(37, 45), (24, 3000)])
def test_fax_from_libtiff(tmp_path, compression, info, shape):
    """Pillow writes bilevel TIFF through libtiff as BlackIsZero; retagged
    to WhiteIsZero it reads inverted, as OpenCV reads it. The 3000-pixel
    rows use the makeup codes past 1728 and 2560."""
    bits = _bits(*shape, seed=shape[1] + len(info))
    path = _pillow(tmp_path / "a.tif", Image.fromarray(bits * 255).convert("1"), compression, info)
    assert_reads_as_reference(path, (255 * bits).astype(np.uint8))
    data = bytearray(path.read_bytes())
    (ifd,) = struct.unpack("<I", data[4:8])
    for i in range(struct.unpack("<H", data[ifd : ifd + 2])[0]):
        e = ifd + 2 + 12 * i
        if struct.unpack("<H", data[e : e + 2])[0] == 262:
            data[e + 8 : e + 10] = struct.pack("<H", 0)
    (tmp_path / "w.tif").write_bytes(bytes(data))
    assert_reads_as_reference(tmp_path / "w.tif", (255 - 255 * bits).astype(np.uint8))


@pytest.mark.parametrize("compression, options", [(fx.CCITT_RLE, 0), (fx.CCITT_RLEW, 0), (fx.CCITT_G3, 0),
                                                  (fx.CCITT_G3, 1), (fx.CCITT_G3, 5), (fx.CCITT_G4, 0)])
@pytest.mark.parametrize("layout", [{}, {"rows_per_strip": 6}, {"tile": (16, 32)}])
@pytest.mark.parametrize("fill_order", [1, 2])
def test_fax_numpy_encoders(tmp_path, compression, options, layout, fill_order):
    """The numpy encoders that ``chip_smoke.py`` writes its fax files with
    decode to their bits (RLEW: to what OpenCV reads, whose word alignment
    follows libtiff's bit buffer, not the rows)."""
    bits = _bits(37, 70, 11)
    (tmp_path / "a.tif").write_bytes(fx.fax_tiff(bits, compression, options, fill_order=fill_order, **layout))
    want = None if compression == fx.CCITT_RLEW else (255 - 255 * bits).astype(np.uint8)
    assert_reads_as_reference(tmp_path / "a.tif", want)


@pytest.mark.parametrize("compression, info", [("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}),
                                               ("group3", {292: 5}), ("group4", {})])
def test_fax_damaged_code_words(tmp_path, compression, info):
    """libtiff ends a row at a bad code word, repairs its length and goes
    on (Group 3 from the next EOL); a strip cut short keeps the rows it
    decoded, and a Group 3 one whose data ends before an EOL is decoded
    again from its first bit without EOLs (FAXMODE_NOEOL); OpenCV reads
    what it decoded. The port's decoder does the same: each damaged or cut
    file reads as OpenCV's."""
    bits = _bits(40, 64, 12)
    path = _pillow(tmp_path / "a.tif", Image.fromarray(bits * 255).convert("1"), compression, info)
    data = path.read_bytes()
    (ifd,) = struct.unpack("<I", data[4:8])
    ents = {struct.unpack("<H", data[ifd + 2 + 12 * i : ifd + 4 + 12 * i])[0]: ifd + 2 + 12 * i
            for i in range(struct.unpack("<H", data[ifd : ifd + 2])[0])}
    off = struct.unpack("<I", data[ents[273] + 8 : ents[273] + 12])[0]
    count = struct.unpack("<I", data[ents[279] + 8 : ents[279] + 12])[0]
    rng = np.random.default_rng(13)
    for k in range(6):
        bad = bytearray(data)
        bad[off + int(rng.integers(0, count))] ^= int(rng.integers(1, 256))
        (tmp_path / f"bad{k}.tif").write_bytes(bytes(bad))
        assert_reads_as_reference(tmp_path / f"bad{k}.tif")
    for frac in (3, 5, 7):  # cut: a Group 3 strip that ends before an EOL is read again without EOLs
        cut = bytearray(data)
        cut[ents[279] + 8 : ents[279] + 12] = struct.pack("<I", count * frac // 10)
        (tmp_path / f"cut{frac}.tif").write_bytes(bytes(cut))
        assert_reads_as_reference(tmp_path / f"cut{frac}.tif")


def _with_counts(data, scale):
    """A little-endian TIFF with its StripByteCounts or TileByteCounts
    (LONG) scaled by ``scale(k)`` for segment k (None: as it was)."""
    out = bytearray(data)
    (ifd,) = struct.unpack("<I", data[4:8])
    for i in range(struct.unpack("<H", data[ifd : ifd + 2])[0]):
        e = ifd + 2 + 12 * i
        tag, _, count = struct.unpack("<HHI", data[e : e + 8])
        if tag in (279, 325):
            at = e + 8 if count == 1 else struct.unpack("<I", data[e + 8 : e + 12])[0]
            for k in range(count):
                if scale(k) is not None:
                    (v,) = struct.unpack("<I", out[at + 4 * k : at + 4 * k + 4])
                    out[at + 4 * k : at + 4 * k + 4] = struct.pack("<I", int(v * scale(k)))
    return bytes(out)


def _planar(a, compression, rows):
    """An RGB TIFF of separate planes (PlanarConfiguration 2), strips of
    ``rows`` rows per plane."""
    h, w, _ = a.shape
    segs = [fx.ENCODERS[compression](a[y : y + rows, :, c].tobytes()) for c in range(3) for y in range(0, h, rows)]
    tags = {256: (fx.LONG, [w]), 257: (fx.LONG, [h]), 258: (fx.SHORT, [8] * 3), 259: (fx.SHORT, [compression]),
            262: (fx.SHORT, [2]), 277: (fx.SHORT, [3]), 278: (fx.LONG, [rows]), 284: (fx.SHORT, [2])}
    return fx.tiff_bytes(tags, segs)


@pytest.mark.parametrize("compression", [fx.RAW, fx.LZW, fx.DEFLATE, fx.PACKBITS])
@pytest.mark.parametrize("layout", ["strips", "predictor", "tiles", "planes"])
def test_cut_and_damaged_segments(tmp_path, compression, layout):
    """A strip or tile whose byte count is cut, or whose data is damaged,
    reads as libtiff leaves it (C8): what the codec decoded, zeros after,
    the predictor undone only where the codec succeeded; uncompressed byte
    counts that look wrong worked out from the image size; the first
    plane's unreadable segment (no bytes, or an uncompressed tile cut
    short) refused, as OpenCV refuses it."""
    rng = np.random.default_rng(16)
    g = _gray(29, 37, 17)
    rgb = np.stack([g, 255 - g, g // 2], -1)
    if layout == "predictor" and compression in (fx.LZW, fx.DEFLATE):
        params = [cv2.IMWRITE_TIFF_COMPRESSION, compression, cv2.IMWRITE_TIFF_ROWSPERSTRIP, 6,
                  cv2.IMWRITE_TIFF_PREDICTOR, 2]
        assert cv2.imwrite(str(tmp_path / "o.tif"), rgb, params)
        data = (tmp_path / "o.tif").read_bytes()
    elif layout == "tiles":
        data = fx.tiff_of(rgb, compression, tile=(16, 16))
    elif layout == "planes":
        data = _planar(rgb, compression, 8)
    else:
        data = fx.tiff_of(g, compression, rows_per_strip=6)
    for k, frac in [(0, 0.5), (1, 0.3), (2, 0.0), (3, 0.9), (4, 0.6)]:
        path = tmp_path / f"cut{k}.tif"
        path.write_bytes(_with_counts(data, lambda j: frac if j == k else None))
        reads_as_reference_or_both_refuse(path)
    for n in range(4):  # a byte of the first segments, which follow the header in every file here
        bad = bytearray(data)
        bad[8 + int(rng.integers(0, 64))] ^= int(rng.integers(1, 256))
        (tmp_path / f"bad{n}.tif").write_bytes(bytes(bad))
        reads_as_reference_or_both_refuse(tmp_path / f"bad{n}.tif")


def reads_as_reference_or_both_refuse(path):
    ref = reference(path)
    if ref is None:
        with pytest.raises(ValueError) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError)
    else:
        got = read_image(str(path))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_fax_of_more_than_one_bit_is_corrupt(tmp_path):
    """libtiff's fax codecs take 1-bit samples only: OpenCV returns None."""
    tags = {256: (fx.LONG, [8]), 257: (fx.LONG, [8]), 258: (fx.SHORT, [8]), 259: (fx.SHORT, [fx.CCITT_G4]),
            262: (fx.SHORT, [1]), 277: (fx.SHORT, [1]), 278: (fx.LONG, [8])}
    (tmp_path / "a.tif").write_bytes(fx.tiff_bytes(tags, [bytes(64)]))
    assert reference(tmp_path / "a.tif") is None
    with pytest.raises(ValueError, match="CCITT Group 4 compression of 1 samples at 8 bits") as e:
        read_image(str(tmp_path / "a.tif"))
    assert not isinstance(e.value, UnsupportedImageError)


# ---------------------------------------------------------------------------
# what OpenCV does not read either
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code, name", [(34925, "LZMA"), (50000, "ZSTD"), (50001, "WEBP"),
                                        (6, "old-style JPEG")])
def test_compressions_opencv_refuses_too(tmp_path, code, name):
    """OpenCV 5.0's libtiff is built without LZMA, ZSTD, WEBP and old-style
    JPEG ("... compression support is not configured"): it returns None,
    and the port names the compression. Old-style JPEG is a JPEG-in-TIFF
    file retagged to 6. If OpenCV starts reading one, this test says so."""
    g = _gray(16, 16, 14)
    if code == 6:
        src = _pillow(tmp_path / "j.tif", Image.fromarray(g), "jpeg").read_bytes()
        tags_at = struct.unpack("<I", src[4:8])[0]
    else:
        src = fx.tiff_of(g)
        tags_at = struct.unpack("<I", src[4:8])[0]
    data = bytearray(src)
    for i in range(struct.unpack("<H", data[tags_at : tags_at + 2])[0]):
        e = tags_at + 2 + 12 * i
        if struct.unpack("<H", data[e : e + 2])[0] == 259:
            data[e + 8 : e + 10] = struct.pack("<H", code)
    (tmp_path / "a.tif").write_bytes(bytes(data))
    assert reference(tmp_path / "a.tif") is None, f"OpenCV now reads {name} TIFF"
    with pytest.raises(RefusedImageError, match=f"{name} compression is not supported"):
        read_image(str(tmp_path / "a.tif"))


def test_png_of_a_bilevel_fax_page_round_trip(tmp_path):
    """A fax page read through the port and written as PNG by Pillow reads
    back the same: the 1-bit path expands to 0 and 255 only."""
    bits = _bits(30, 50, 15)
    (tmp_path / "a.tif").write_bytes(fx.fax_tiff(bits, fx.CCITT_G4))
    img = read_image(str(tmp_path / "a.tif"))
    assert set(np.unique(img)) <= {0, 255}
    buf = io.BytesIO()
    Image.fromarray(img[..., 0]).save(buf, "PNG")
    (tmp_path / "b.png").write_bytes(buf.getvalue())
    np.testing.assert_array_equal(read_image(str(tmp_path / "b.png")), img)

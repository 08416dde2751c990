"""``read_image`` against ``cv2.imread(path, cv2.IMREAD_COLOR)`` on every
encoding the port decodes: TIFF strips in LZW, Deflate (8 and 32946) and
PackBits at predictor 1 and 2, 8 and 16 bits, gray, RGB and RGBA, one strip
and several (written by OpenCV); tiled and planar TIFF (written by the small
writer below); Adam7 PNG; BMP (written by OpenCV and PIL). Every result must
equal OpenCV's bit for bit, and every other encoding must raise a
``ValueError`` that names it."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image

torch.set_num_threads(2)

LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS = 5, 32946, 8, 32773


def _image(shape, dtype, seed):
    """Smooth ramps plus noise plus flat runs: every compressor and every
    PNG filter sees structure."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    ramp = (np.arange(shape[1])[None, :] * (top // 64))
    a = rng.integers(0, top // 4, shape, dtype=np.int64)
    a = (a + (ramp if len(shape) == 2 else ramp[..., None])) % (top + 1)
    a[: shape[0] // 3, : shape[1] // 2] = top // 3  # a flat block: long runs
    return a.astype(dtype)


def _check(path):
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert ref is not None, path
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


SHAPES = [(37, 45), (37, 45, 3), (37, 45, 4)]


@pytest.mark.parametrize("compression", [LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", SHAPES)
def test_compressed_tiff_strips_match_cv2(tmp_path, compression, predictor, dtype, shape):
    a = _image(shape, dtype, seed=len(shape) + compression % 7)
    for rows in (37, 8):  # one strip, several (the last one short)
        path = tmp_path / f"c{compression}_p{predictor}_r{rows}.tif"
        params = [cv2.IMWRITE_TIFF_COMPRESSION, compression, cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
        if predictor == 2:
            params += [cv2.IMWRITE_TIFF_PREDICTOR, 2]
        assert cv2.imwrite(str(path), a, params)
        _check(path)


def test_cv2_default_tiff_is_lzw_and_reads(tmp_path):
    a = _image((64, 80, 3), np.uint8, seed=5)
    path = tmp_path / "default.tif"
    cv2.imwrite(str(path), a)
    assert _tags(path.read_bytes())[259] == LZW
    _check(path)


# ---------------------------------------------------------------------------
# a small TIFF writer for the layouts OpenCV does not write
# ---------------------------------------------------------------------------


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, early change), Clear first and on a full
    table, EOI last."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)

    table = {bytes([i]): i for i in range(256)}
    put(256)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = len(table) + 2  # codes 256, 257 are Clear and EOI
        nxt = len(table) + 2
        if nxt == 4095:  # a full table: Clear, as libtiff's encoder does
            put(256)
            table = {bytes([i]): i for i in range(256)}
            width = 9
        elif nxt >= (1 << width):
            width += 1
        w = bytes([byte])
    if w:
        put(table[w])
        if len(table) + 3 >= (1 << width) and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3+ equal bytes as repeats, the rest as literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 255, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(a):
    """Horizontal differencing along axis 1, modulo the sample width."""
    d = a.copy()
    d[:, 1:] = a[:, 1:] - a[:, :-1]
    return d


def write_tiff(path, a, compression=1, predictor=1, tile=None, planar=1, rows_per_strip=None, big_endian=False):
    """[H,W] or [H,W,S] uint8/uint16 -> a baseline TIFF with the given
    layout: strips of ``rows_per_strip`` rows or ``tile`` = (th, tw) tiles,
    contiguous (1) or separate (2) planes."""
    end = ">" if big_endian else "<"
    a = a if a.ndim == 3 else a[..., None]
    h, w, spp = a.shape
    planes = [a] if planar == 1 else [a[..., s : s + 1] for s in range(spp)]
    dt = np.dtype(end + ("u1" if a.dtype == np.uint8 else "u2"))
    segments = []
    for plane in planes:
        if tile:
            th, tw = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, plane.shape[2]), a.dtype)
                    part = plane[y : y + th, x : x + tw]
                    t[: part.shape[0], : part.shape[1]] = part
                    segments.append(t)
        else:
            rps = rows_per_strip or h
            segments += [plane[y : y + rps] for y in range(0, h, rps)]
    blobs = []
    for seg in segments:
        if predictor == 2:
            seg = _predict(seg)
        raw = np.ascontiguousarray(seg).astype(dt).tobytes()
        blobs.append({1: lambda r: r, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
                      32773: packbits_encode}[compression](raw))
    bits = 8 * dt.itemsize
    offsets, pos = [], 8
    for b in blobs:
        offsets.append(pos)
        pos += len(b) + (len(b) & 1)
    extra = bytearray()
    ifd_at = pos

    def entry(tag, typ, values):
        nonlocal extra
        fmt = {3: "H", 4: "I"}[typ]
        payload = struct.pack(f"{end}{len(values)}{fmt}", *values)
        if len(payload) <= 4:
            return struct.pack(end + "HHI", tag, typ, len(values)) + payload.ljust(4, b"\0")
        return ("deferred", tag, typ, len(values), payload)

    tags = [
        (256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
        (262, 3, [1 if spp <= 2 else 2]), (277, 3, [spp]), (284, 3, [planar]),
    ]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if spp in (2, 4):
        tags.append((338, 3, [2]))  # unassociated alpha
    if tile:
        tags += [(322, 4, [tile[1]]), (323, 4, [tile[0]]), (324, 4, offsets), (325, 4, [len(b) for b in blobs])]
    else:
        tags += [(273, 4, offsets), (278, 4, [rows_per_strip or h]), (279, 4, [len(b) for b in blobs])]
    tags.sort()
    n = len(tags)
    data_at = ifd_at + 2 + 12 * n + 4
    entries = []
    for tag, typ, values in tags:
        e = entry(tag, typ, values)
        if isinstance(e, tuple):
            _, tag, typ, count, payload = e
            e = struct.pack(end + "HHII", tag, typ, count, data_at + len(extra))
            extra += payload + b"\0" * (len(payload) & 1)
        entries.append(e)
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(end + "I", ifd_at)
    body = b"".join(b + b"\0" * (len(b) & 1) for b in blobs)
    ifd = struct.pack(end + "H", n) + b"".join(entries) + struct.pack(end + "I", 0)
    with open(path, "wb") as f:
        f.write(head + body + ifd + bytes(extra))


def _tags(data):
    end = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(end + "I", data[4:8])
    (n,) = struct.unpack(end + "H", data[ifd : ifd + 2])
    out = {}
    for i in range(n):
        tag, typ, count, val = struct.unpack(end + "HHII", data[ifd + 2 + 12 * i : ifd + 14 + 12 * i])
        out[tag] = (val & 0xFFFF) if (typ == 3 and end == "<") else (val >> 16 if typ == 3 else val)
    return out


def test_the_writer_matches_cv2_on_strips(tmp_path):
    """The test's own writer, LZW and PackBits encoders first read by OpenCV
    as they are meant (strips, both byte orders)."""
    a = _image((29, 33, 3), np.uint16, seed=2)
    for comp in (1, LZW, DEFLATE, PACKBITS):
        for big in (False, True):
            path = tmp_path / f"w{comp}{big}.tif"
            write_tiff(path, a, compression=comp, predictor=2, rows_per_strip=7, big_endian=big)
            _check(path)


@pytest.mark.parametrize("compression", [1, LZW, DEFLATE, PACKBITS])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_tiff_matches_cv2(tmp_path, compression, dtype, shape):
    a = _image(shape, dtype, seed=11)
    for predictor in (1, 2):
        path = tmp_path / f"t{compression}_{predictor}.tif"
        write_tiff(path, a, compression=compression, predictor=predictor, tile=(16, 32))
        if dtype == np.uint16 and len(shape) == 2:
            _check_gray16_partial_tiles(path, (16, 32))
        else:
            _check(path)
        # tiles that cover the image exactly
        full = a[:32, :32]
        write_tiff(path, full, compression=compression, predictor=predictor, tile=(16, 16))
        _check(path)


def _check_gray16_partial_tiles(path, tile):
    """OpenCV 5.0.0's IMREAD_COLOR misreads the rows after the first of a
    16-bit gray TIFF's partial right tiles (it leaves zeros and stray
    values there; IMREAD_UNCHANGED reads them right). The port reads them
    right: it equals the high byte of IMREAD_UNCHANGED everywhere, and
    IMREAD_COLOR outside those rows."""
    got = read_image(str(path))
    exact = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, np.repeat((exact >> 8).astype(np.uint8)[..., None], 3, axis=2))
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    h, w = exact.shape
    th, tw = tile
    clean = np.ones((h, w), bool)
    x0 = (w // tw) * tw
    for y in range(0, h, th):
        clean[y + 1 : y + th, x0:] = False
    np.testing.assert_array_equal(got[clean], ref[clean])
    assert (got[~clean] != ref[~clean]).any()


@pytest.mark.parametrize("compression", [1, LZW, DEFLATE, PACKBITS])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(37, 45, 3), (37, 45, 4)])
def test_planar_separate_tiff_matches_cv2(tmp_path, compression, dtype, shape):
    a = _image(shape, dtype, seed=13)
    for predictor, tile in ((1, None), (2, None), (2, (16, 16))):
        path = tmp_path / f"p{compression}_{predictor}_{tile is not None}.tif"
        write_tiff(path, a, compression=compression, predictor=predictor, planar=2, tile=tile, rows_per_strip=10)
        _check(path)


# ---------------------------------------------------------------------------
# PNG, Adam7
# ---------------------------------------------------------------------------


def _png_chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_adam7_png(path, a, palette=None):
    """[H,W] / [H,W,S] uint8 or uint16 (or palette indices) -> an
    Adam7-interlaced PNG, each pass's rows filtered with filters cycling
    0..4."""
    a = a if a.ndim == 3 else a[..., None]
    h, w, spp = a.shape
    depth = 8 * a.dtype.itemsize
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[spp]
    if spp >= 3:
        a = a[..., [2, 1, 0, 3][:spp]]  # BGR(A) -> RGB(A)
    raw = np.ascontiguousarray(a.astype(">u2" if depth == 16 else np.uint8)).view(np.uint8).reshape(h, w, -1)
    raw = raw.astype(np.int32)
    bpp = raw.shape[2]
    stream = bytearray()
    k = 0
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        p = raw[y0::dy, x0::dx]
        if p.size == 0:
            continue
        ph, pw = p.shape[:2]
        prev = np.zeros((pw, bpp), np.int32)
        for r in range(ph):
            cur = p[r]
            left = np.vstack([np.zeros((1, bpp), np.int32), cur[:-1]])
            ul = np.vstack([np.zeros((1, bpp), np.int32), prev[:-1]])
            f = k % 5
            k += 1
            if f == 4:
                pp = left + prev - ul
                pa, pb, pc = abs(pp - left), abs(pp - prev), abs(pp - ul)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
            else:
                pred = [0 * cur, left, prev, (left + prev) >> 1][f]
            stream += bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
            prev = cur
    chunks = _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if palette is not None:
        chunks += _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    chunks += _png_chunk(b"IDAT", zlib.compress(bytes(stream)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunks + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(37, 45), (37, 45, 2), (37, 45, 3), (37, 45, 4), (1, 1, 3), (3, 5), (9, 2, 3)])
def test_adam7_png_matches_cv2(tmp_path, dtype, shape):
    a = _image(shape, dtype, seed=17)
    path = tmp_path / "i.png"
    write_adam7_png(path, a)
    _check(path)


def test_adam7_palette_png_matches_cv2(tmp_path):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (21, 30)).astype(np.uint8)
    path = tmp_path / "pal.png"
    write_adam7_png(path, idx, palette=rng.integers(0, 256, (16, 3)))
    _check(path)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3), (13, 17, 4), (5, 1, 3), (6, 2)])
def test_bmp_matches_cv2(tmp_path, shape):
    """OpenCV's writer (8-bit palette, 24-bit, 32-bit bit fields; bottom-up)
    and PIL's (palette, RGB, RGBA)."""
    a = _image(shape, np.uint8, seed=19)
    cv2.imwrite(str(tmp_path / "cv.bmp"), a)
    _check(tmp_path / "cv.bmp")
    mode = {2: "L", 3: "RGB", 4: "RGBA"}[a.ndim if a.ndim == 2 else a.shape[2]]
    rgb = a if a.ndim == 2 else a[..., [2, 1, 0, 3][: a.shape[2]]]
    Image.fromarray(rgb, mode).save(tmp_path / "pil.bmp")
    _check(tmp_path / "pil.bmp")
    if a.ndim == 3 and a.shape[2] == 3:
        Image.fromarray(rgb, mode).convert("P", palette=Image.Palette.ADAPTIVE, colors=37).save(tmp_path / "p.bmp")
        _check(tmp_path / "p.bmp")


def test_top_down_bmp_matches_cv2(tmp_path):
    a = _image((11, 14, 3), np.uint8, seed=23)
    cv2.imwrite(str(tmp_path / "up.bmp"), a)
    data = bytearray((tmp_path / "up.bmp").read_bytes())
    (at,) = struct.unpack("<I", data[10:14])
    stride = (14 * 3 + 3) & ~3
    rows = [bytes(data[at + r * stride : at + (r + 1) * stride]) for r in range(11)]
    data[22:26] = struct.pack("<i", -11)
    data[at : at + 11 * stride] = b"".join(rows[::-1])
    (tmp_path / "down.bmp").write_bytes(bytes(data))
    _check(tmp_path / "down.bmp")
    np.testing.assert_array_equal(read_image(str(tmp_path / "down.bmp")), a)


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------


def _retag(src, dst, tag, value):
    """Copy a little-endian TIFF with one SHORT tag's value replaced."""
    data = bytearray(src.read_bytes())
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd : ifd + 2])
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack("<H", data[e : e + 2])[0] == tag:
            data[e + 8 : e + 10] = struct.pack("<H", value)
            break
    else:
        raise AssertionError(f"tag {tag} not found")
    dst.write_bytes(bytes(data))


@pytest.mark.parametrize("code, name", [
    (2, "CCITT RLE"), (3, "CCITT Group 3"), (4, "CCITT Group 4"), (6, "old-style JPEG"), (7, "JPEG"),
    (34925, "LZMA"), (50000, "ZSTD"), (50001, "WEBP"), (34676, "compression 34676"),
])
def test_unsupported_tiff_compressions_raise_by_name(tmp_path, code, name):
    a = _image((8, 8), np.uint8, seed=1)
    cv2.imwrite(str(tmp_path / "a.tif"), a, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    _retag(tmp_path / "a.tif", tmp_path / "b.tif", 259, code)
    if code == 7:
        # JPEG strips decode now (tests/test_torch_image_encodings.py): raw
        # pixels tagged as JPEG are a corrupt file, not an unsupported one
        with pytest.raises(ValueError, match="a JPEG strip or tile does not start with SOI") as e:
            read_image(str(tmp_path / "b.tif"))
        assert not isinstance(e.value, UnsupportedImageError)
        return
    if code in (2, 3, 4):
        # fax TIFF decodes now (tests/test_torch_tiff_codings.py): 8-bit
        # samples tagged as fax are a file libtiff refuses, and OpenCV reads None
        assert cv2.imread(str(tmp_path / "b.tif"), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=f"{name} compression of 1 samples at 8 bits") as e:
            read_image(str(tmp_path / "b.tif"))
        assert not isinstance(e.value, UnsupportedImageError)
        return
    with pytest.raises(ValueError, match=f"{name} compression is not supported"):
        read_image(str(tmp_path / "b.tif"))


def test_other_unsupported_kinds_raise_by_name(tmp_path):
    a = _image((8, 8, 3), np.uint8, seed=1)
    cv2.imwrite(str(tmp_path / "a.jpg"), a)
    # JPEG decodes now, to OpenCV's pixels (tests/test_torch_jpeg.py), and
    # so do its arithmetic and lossless codings (tests/test_torch_jpeg_codings.py);
    # its hierarchical processes do not: the frame header SOF0 patched to SOF5
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.jpg")), cv2.imread(str(tmp_path / "a.jpg")))
    jpg = bytearray((tmp_path / "a.jpg").read_bytes())
    jpg[jpg.index(b"\xff\xc0") + 1] = 0xC5
    (tmp_path / "hierarchical.jpg").write_bytes(bytes(jpg))
    with pytest.raises(ValueError, match=r"differential sequential \(SOF5\) is not supported"):
        read_image(str(tmp_path / "hierarchical.jpg"))
    # BigTIFF reads now (tests/test_torch_tiff_codings.py): one written by PIL reads as OpenCV reads it
    Image.fromarray(a).save(str(tmp_path / "big.tif"), big_tiff=True)
    assert (tmp_path / "big.tif").read_bytes()[:4] == b"II+\x00"
    np.testing.assert_array_equal(read_image(str(tmp_path / "big.tif")), cv2.imread(str(tmp_path / "big.tif")))
    write_tiff(tmp_path / "f.tif", a, compression=DEFLATE, predictor=2)
    _retag(tmp_path / "f.tif", tmp_path / "g.tif", 317, 3)
    with pytest.raises(ValueError, match="predictor 3 is not supported"):
        read_image(str(tmp_path / "g.tif"))
    cv2.imwrite(str(tmp_path / "r.bmp"), a)
    data = bytearray((tmp_path / "r.bmp").read_bytes())
    data[30:34] = struct.pack("<I", 1)  # BI_RLE8
    (tmp_path / "rle.bmp").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="BMP: compression 1"):
        read_image(str(tmp_path / "rle.bmp"))
    (tmp_path / "junk.png").write_bytes(b"not an image")
    with pytest.raises(ValueError, match="unknown image encoding"):
        read_image(str(tmp_path / "junk.png"))

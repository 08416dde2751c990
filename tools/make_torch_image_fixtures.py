"""Write the PNG, TIFF and BMP fixtures of the PyTorch port's decoder.

The port decodes images without OpenCV (``deepemia_tpu_torch/ops/image.py:
read_image``), to the pixels ``cv2.imread(path, cv2.IMREAD_COLOR)``
returns. A machine without OpenCV (the GPU host that runs
``chip_smoke.py``) checks that against this file: small files in the
encodings that PNG, TIFF and BMP writers use beside the plain 8-bit ones
(PNG gray and palettes at 1, 2 and 4 bits, plain and Adam7, ``tRNS`` on a
palette, ``eXIf`` orientations; TIFF bilevel, palette, CMYK, YCbCr and
JPEG-compressed strips and tiles; BMP 1- and 4-bit palettes, RLE8 and
RLE4 with their escapes), each beside the array ``cv2.imread`` returns
for it.

The writers below build each file byte by byte from its format (Pillow
cannot write 4-bit or RLE BMPs, or choose a TIFF's tags); they need only
numpy, and the tests import them. ``main`` needs OpenCV (the reference
pixels, and the JPEG streams inside the JPEG-compressed TIFFs).

    python tools/make_torch_image_fixtures.py   # writes tests/data/torch_image_fixtures.npz

The file holds, for each case, ``<case>.<ext>`` (the file's bytes, uint8)
and ``<case>`` ([H,W,3] uint8 BGR).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_image_fixtures.npz")

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def pack_rows(samples: np.ndarray, bits: int, order: str = ">") -> np.ndarray:
    """[H,W] or [H,W,S] samples -> [H, row bytes] uint8: each row's samples
    packed MSB first at ``bits`` each (16 bits in byte ``order``), the row
    padded to a whole byte."""
    s = samples.reshape(samples.shape[0], -1).astype(np.uint32)
    if bits == 16:
        return s.astype(order + "u2").view(np.uint8).reshape(s.shape[0], -1)
    if bits == 8:
        return s.astype(np.uint8)
    per = 8 // bits
    h, n = s.shape
    s = np.pad(s, ((0, 0), (0, -n % per)))
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint32)
    return (s.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def exif_block(orientation: int, big_endian: bool = False) -> bytes:
    """A bare TIFF structure (as a PNG ``eXIf`` chunk holds it) whose one
    IFD entry is Orientation (0x0112, SHORT) = ``orientation``."""
    e = ">" if big_endian else "<"
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "I", 8)
    return head + struct.pack(e + "HHHIHH", 1, 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)


def png_bytes(samples: np.ndarray, depth: int = 8, ctype: int = 0, palette=None, trns: bytes = None,
              interlace: int = 0, exif: bytes = None, exif_after_idat: bool = False, filters=(0,),
              idat_chunks: int = 1) -> bytes:
    """A PNG of ``samples`` ([H,W] or [H,W,S] at ``depth`` bits, colour
    type ``ctype``), with a PLTE of ``palette`` ([N,3] uint8), a ``tRNS``
    body, Adam7 when ``interlace`` is 1, an ``eXIf`` chunk before or after
    the image data, the scanline filter types cycled from ``filters``, and
    the zlib stream split over ``idat_chunks`` IDAT chunks."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, spp = s.shape
    unit = max(1, spp * depth // 8)

    def scanlines(part, k0):
        rows = pack_rows(part, depth).astype(np.int32)
        out = []
        for r in range(rows.shape[0]):
            f = filters[(k0 + r) % len(filters)]
            cur, prev = rows[r], rows[r - 1] if r else np.zeros_like(rows[r])
            a = np.concatenate([np.zeros(unit, np.int32), cur[:-unit]])
            c = np.concatenate([np.zeros(unit, np.int32), prev[:-unit]])
            if f == 4:
                p = a + prev - c
                pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
            else:
                pred = [0 * a, a, prev, (a + prev) >> 1][f]
            out.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
        return b"".join(out)

    if interlace:
        raw = b"".join(scanlines(s[y0::dy, x0::dx], k) for k, (x0, y0, dx, dy) in enumerate(ADAM7)
                       if s[y0::dy, x0::dx].size)
    else:
        raw = scanlines(s, 0)
    z = zlib.compress(raw, 9)
    cut = np.linspace(0, len(z), idat_chunks + 1).astype(int)
    idat = b"".join(_chunk(b"IDAT", z[cut[i]:cut[i + 1]]) for i in range(idat_chunks))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    if exif is not None and not exif_after_idat:
        out += _chunk(b"eXIf", exif)
    out += idat
    if exif is not None and exif_after_idat:
        out += _chunk(b"eXIf", exif)
    return out + _chunk(b"IEND", b"")


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

BYTE, ASCII, SHORT, LONG, RATIONAL, UNDEFINED, LONG8 = 1, 2, 3, 4, 5, 7, 16


def tiff_bytes(tags: dict, segments, tiled: bool = False, big_endian: bool = False, big: bool = False,
               offsets_type: int = None) -> bytes:
    """A one-page TIFF, or a BigTIFF when ``big``: header, the ``segments``
    (strips, or tiles when ``tiled``), then the IFD of ``tags`` ({tag:
    (type, values)}, values a list of ints, or bytes for UNDEFINED) with
    the offsets and byte counts of the segments, as ``offsets_type`` (LONG,
    or LONG8 in a BigTIFF by default)."""
    e = ">" if big_endian else "<"
    head = 16 if big else 8
    body, offsets = bytearray(), []
    for seg in segments:
        offsets.append(head + len(body))
        body += seg + b"\0" * (len(seg) & 1)
    otype = offsets_type or (LONG8 if big else LONG)
    tags = dict(tags)
    tags[324 if tiled else 273] = (otype, offsets)
    tags[325 if tiled else 279] = (otype, [len(s) for s in segments])
    word, entry, inline = ("Q", 20, 8) if big else ("I", 12, 4)
    ifd_at = head + len(body)
    tail_at = ifd_at + (8 if big else 2) + entry * len(tags) + (8 if big else 4)
    ifd, tail = bytearray(struct.pack(e + ("Q" if big else "H"), len(tags))), bytearray()
    codes = {BYTE: "B", SHORT: "H", LONG: "I", RATIONAL: "I", LONG8: "Q"}
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ in (ASCII, UNDEFINED):
            payload, count = bytes(vals), len(vals)
        else:
            flat = [int(x) for v in vals for x in (v if typ == RATIONAL else (v,))]
            payload, count = struct.pack(f"{e}{len(flat)}{codes[typ]}", *flat), len(vals)
        if len(payload) <= inline:
            ifd += struct.pack(e + "HH" + word, tag, typ, count) + payload.ljust(inline, b"\0")
        else:
            ifd += struct.pack(e + "HH" + word + word, tag, typ, count, tail_at + len(tail))
            tail += payload + b"\0" * (len(payload) & 1)
    ifd += struct.pack(e + word, 0)
    magic = (b"MM\x00" if big_endian else b"II") + (b"+" if big else b"*") + (b"" if big_endian else b"\x00")
    if big:
        magic += struct.pack(e + "HHQ", 8, 0, ifd_at)
    else:
        magic += struct.pack(e + "I", ifd_at)
    return magic + bytes(body) + bytes(ifd) + bytes(tail)


def tiff_image(samples: np.ndarray, bits: int = 8, photometric: int = 1, rows_per_strip: int = None,
               tile: tuple = None, colormap=None, extra: dict = None, big_endian: bool = False) -> bytes:
    """An uncompressed TIFF of ``samples`` ([H,W] or [H,W,S]) at ``bits``
    per sample, in strips of ``rows_per_strip`` rows or ``tile`` = (height,
    width) tiles (padded with zeros at the edges), with a ``colormap``
    ([3, 2**bits] 16-bit entries) and ``extra`` tags."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, spp = s.shape
    order = ">" if big_endian else "<"
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [bits] * spp), 259: (SHORT, [1]),
            262: (SHORT, [photometric]), 277: (SHORT, [spp])}
    if colormap is not None:
        tags[320] = (SHORT, list(np.asarray(colormap).ravel()))
    if tile:
        th, tw = tile
        tags[322], tags[323] = (LONG, [tw]), (LONG, [th])
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, spp), s.dtype)
        pad[:h, :w] = s
        segs = [pack_rows(pad[y : y + th, x : x + tw], bits, order).tobytes()
                for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        tags[278] = (LONG, [rps])
        segs = [pack_rows(s[y : y + rps], bits, order).tobytes() for y in range(0, h, rps)]
    tags.update(extra or {})
    return tiff_bytes(tags, segs, tiled=bool(tile), big_endian=big_endian)


def ycbcr_tiff(ycc: np.ndarray, sub=(2, 2), rows_per_strip: int = None, extra: dict = None) -> bytes:
    """An uncompressed YCbCr TIFF (photometric 6) of ``ycc`` [H,W,3] uint8
    (Y, Cb, Cr per pixel): chroma subsampled by ``sub`` = (horizontal,
    vertical), each block's chroma the value at its top-left pixel; data
    units of h*v luma samples, then Cb and Cr (TIFF 6.0, section 21), the
    image padded by edge replication to whole blocks."""
    sh, sv = sub
    h, w, _ = ycc.shape
    rps = rows_per_strip or -(-h // sv) * sv
    ph, pw = -(-h // sv) * sv, -(-w // sh) * sh
    p = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    by, bx = ph // sv, pw // sh
    blocks = p.reshape(by, sv, bx, sh, 3).transpose(0, 2, 1, 3, 4)  # [by, bx, v, h, 3]
    units = np.concatenate([blocks[..., 0].reshape(by, bx, -1), blocks[:, :, 0, 0, 1:]], axis=2)
    segs = [units[y // sv : (y + rps) // sv].tobytes() for y in range(0, h, rps)]
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [8, 8, 8]), 259: (SHORT, [1]), 262: (SHORT, [6]),
            277: (SHORT, [3]), 278: (LONG, [rps]), 530: (SHORT, [sh, sv])}
    tags.update(extra or {})
    return tiff_bytes(tags, segs)


def _jpeg_segments(data: bytes):
    """A JPEG stream -> (its DQT and DHT marker segments, the stream without
    them and without APPn segments)."""
    tables, rest, pos = bytearray(), bytearray(b"\xff\xd8"), 2
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            rest += data[pos:]
            return bytes(tables), bytes(rest)
        (length,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        seg = data[pos : pos + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:
            rest += seg
        pos += 2 + length


def jpeg_tiff(pixels: np.ndarray, encode, photometric: int, rows_per_strip: int = None, tile: tuple = None,
              sub=(1, 1)) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of ``pixels`` ([H,W] gray or
    [H,W,3] RGB), each strip or tile a JPEG stream from ``encode`` ([h,w]
    or [h,w,3] RGB -> JPEG bytes) with its tables moved into one
    ``JPEGTables`` (tag 347) shared by all; photometric 1, 2 (RGB, the
    stream's components stored as they are) or 6 (YCbCr, ``sub`` the
    subsampling the streams use)."""
    h, w = pixels.shape[:2]
    spp = 1 if pixels.ndim == 2 else 3
    if tile:
        th, tw = tile
        pad = np.pad(pixels, ((0, -h % th), (0, -w % tw)) + ((0, 0),) * (pixels.ndim - 2), mode="edge")
        parts = [pad[y : y + th, x : x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        parts = [pixels[y : y + rps] for y in range(0, h, rps)]
    tables, segs = b"", []
    for part in parts:
        t, s = _jpeg_segments(encode(np.ascontiguousarray(part)))
        tables = tables or t
        segs.append(s if t == tables else s[:2] + t + s[2:])
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [8] * spp), 259: (SHORT, [7]),
            262: (SHORT, [photometric]), 277: (SHORT, [spp]), 347: (UNDEFINED, b"\xff\xd8" + tables + b"\xff\xd9")}
    if tile:
        tags[322], tags[323] = (LONG, [tile[1]]), (LONG, [tile[0]])
    else:
        tags[278] = (LONG, [rows_per_strip or h])
    if photometric == 6:
        tags[530] = (SHORT, list(sub))
    return tiff_bytes(tags, segs, tiled=bool(tile))


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp_bytes(pixels: np.ndarray, bits: int, palette=None, compression: int = 0, data: bytes = None,
              top_down: bool = False, colors_used: int = 0) -> bytes:
    """A BMP with a 40-byte header: ``pixels`` ([H,W] palette indices at
    ``bits`` = 1, 4 or 8, or [H,W,3] BGR at 24) stored bottom-up (or
    ``top_down``) in rows padded to 4 bytes, or, with ``compression`` 1
    (RLE8) or 2 (RLE4), the encoded ``data`` (see ``rle_encode``)."""
    h, w = pixels.shape[:2]
    if data is None:
        rows = pack_rows(pixels, bits) if bits < 24 else pixels.reshape(h, -1).astype(np.uint8)
        rows = np.pad(rows, ((0, 0), (0, -rows.shape[1] % 4)))
        data = (rows if top_down else rows[::-1]).tobytes()
    pal = b"" if palette is None else np.concatenate(
        [np.asarray(palette, np.uint8)[:, ::-1], np.zeros((len(palette), 1), np.uint8)], axis=1).tobytes()
    at = 14 + 40 + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, compression, len(data), 2835, 2835,
                       colors_used, 0)
    return b"BM" + struct.pack("<IHHI", at + len(data), 0, 0, at) + info + pal + data


def rle_encode(idx: np.ndarray, bits: int) -> bytes:
    """[H,W] palette indices -> a BMP RLE8 (``bits`` 8) or RLE4 (4) stream,
    bottom row first: runs of one index (RLE4: of an alternating pair) as
    encoded pairs, other stretches of 3 or more pixels in absolute mode
    (padded to 16 bits), an end of line after each row and an end of
    bitmap at the last."""
    out = bytearray()
    for row in idx[::-1]:
        row = [int(v) for v in row]
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x + (n % 2 if bits == 4 else 0)]:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, row[x] if bits == 8 else row[x] << 4 | (row[x + 1] if n > 1 else 0)])
                x += n
                continue
            m = 3
            while x + m < w and m < 255 and not (x + m + 2 < w and row[x + m] == row[x + m + 1] == row[x + m + 2]):
                m += 1
            chunk = row[x : x + m]
            if bits == 8:
                body = bytes(chunk)
            else:
                body = bytes((chunk[i] << 4) | (chunk[i + 1] if i + 1 < m else 0) for i in range(0, m, 2))
            out += bytes([0, m]) + body + b"\0" * (len(body) & 1)
            x += m
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def rle_with_escapes(rng, h: int, w: int, bits: int) -> bytes:
    """A random BMP RLE8 (``bits`` 8) or RLE4 (4) stream of runs, absolute
    stretches, ends of line, deltas and (RLE8) an early end of bitmap, each
    kept inside its row as OpenCV's decoder requires, for an h x w image.
    The position model is OpenCV's: an RLE8 run that fills its row moves to
    the next, where an end of line does nothing; an RLE4 delta moves by dx
    alone and an RLE4 end of bitmap ends the line."""
    y = x = 0
    wrapped, out = False, bytearray()
    for _ in range(8 * h):
        if y >= h:
            return bytes(out)
        r = rng.random()
        if x < w and r < 0.35:
            n = int(rng.integers(1, w - x + 1))
            out += bytes([n, int(rng.integers(0, 256))])
            x, wrapped = x + n, False
            if bits == 8 and x == w:
                y, x, wrapped = y + 1, 0, True
        elif x + 3 <= w and r < 0.6:
            n = int(rng.integers(3, w - x + 1))
            size = n if bits == 8 else (n + 1) // 2
            out += bytes([0, n]) + rng.integers(0, 256, size).astype(np.uint8).tobytes() + b"\0" * (size & 1)
            x, wrapped = x + n, False
        elif r < 0.8:
            out += b"\0\0"
            if not wrapped:
                y, x = y + 1, 0
            wrapped = False
        elif r < 0.95 or bits == 4:
            dx, dy = int(rng.integers(0, 5)), int(rng.integers(0, 3))
            out += bytes([0, 2, dx, dy])
            y, x = divmod(y * w + x + dx + (dy * w if bits == 8 else 0), w)
            wrapped = False
        else:
            return bytes(out + b"\0\1")
    return bytes(out) + (b"\0\1" if bits == 8 else b"\0\0" * (h - y + 1))


def micrograph(h: int, w: int, seed: int, channels: int = 0) -> np.ndarray:
    """Smooth gray noise with bright and dark disks, uint8 [h,w] (or
    [h,w,channels] with the channels shifted apart)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(120, 40, (h + 4, w + 4))
    img = sum(img[i : i + h, j : j + w] for i in range(5) for j in range(5)) / 25 * 2.2 - 140
    yy, xx = np.mgrid[:h, :w]
    for _ in range(6):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(2, 6)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.choice([20, 235])
    img = img.clip(0, 255).astype(np.uint8)
    if channels:
        img = np.stack([np.roll(img, 7 * c, axis=1) for c in range(channels)], axis=-1)
    return img


def cases(cv2_encode=None) -> dict:
    """-> {case: (extension, file bytes)}. ``cv2_encode`` ([h,w] or
    [h,w,3] RGB, quality, sampling factor -> JPEG bytes) writes the JPEG
    streams of the JPEG-compressed TIFFs; without it they are left out."""
    rng = np.random.default_rng(11)
    h, w = 29, 41
    gray = micrograph(h, w, 0)
    out = {}
    for depth in (1, 2, 4):
        levels = gray.astype(np.int64) >> (8 - depth)
        pal = rng.integers(0, 256, (2**depth, 3))
        for il in (0, 1):
            tag = "_adam7" if il else ""
            out[f"png_gray{depth}{tag}"] = ("png", png_bytes(levels, depth, interlace=il, filters=(0, 1, 2, 3, 4)))
            out[f"png_palette{depth}{tag}"] = ("png", png_bytes(
                levels, depth, ctype=3, palette=pal, interlace=il, filters=(4, 1, 2),
                trns=bytes(range(0, 2**depth * 16, 16))[: 2**depth] if depth == 4 else None))
    rgb = micrograph(13, 22, 1, channels=3)
    for o in range(1, 9):
        out[f"png_exif{o}"] = ("png", png_bytes(rgb, ctype=2, exif=exif_block(o, big_endian=o % 2 == 0),
                                                exif_after_idat=o > 4))
    for o in (3, 6, 8):
        out[f"tif_orientation{o}"] = ("tif", tiff_image(rgb, photometric=2, rows_per_strip=5,
                                                        extra={274: (SHORT, [o])}))
    bilevel = (gray > 128).astype(np.int64)
    out["tif_bilevel_blackiszero"] = ("tif", tiff_image(bilevel, 1, photometric=1, rows_per_strip=8))
    out["tif_bilevel_whiteiszero_tiles"] = ("tif", tiff_image(bilevel, 1, photometric=0, tile=(16, 32)))
    out["tif_gray8_whiteiszero"] = ("tif", tiff_image(gray, 8, photometric=0, rows_per_strip=10))
    cmap16 = rng.integers(0, 65536, (3, 256))
    cmap16[:, 0] = 65535  # an entry >= 256: 16-bit entries, reduced by >> 8
    out["tif_palette8"] = ("tif", tiff_image(gray, 8, photometric=3, colormap=cmap16, rows_per_strip=7))
    out["tif_palette8_gray_map8"] = ("tif", tiff_image(gray, 8, photometric=3, colormap=np.tile(np.arange(256), (3, 1)),
                                                       tile=(16, 16)))
    out["tif_palette4"] = ("tif", tiff_image(gray >> 4, 4, photometric=3, colormap=rng.integers(0, 65536, (3, 16)),
                                             rows_per_strip=6, big_endian=True))
    out["tif_palette1"] = ("tif", tiff_image(bilevel, 1, photometric=3, colormap=[[0, 65535], [512, 4096], [65535, 0]]))
    cmyk = micrograph(h, w, 2, channels=4)
    out["tif_cmyk"] = ("tif", tiff_image(cmyk, 8, photometric=5, rows_per_strip=9))
    out["tif_cmyk_tiles"] = ("tif", tiff_image(cmyk, 8, photometric=5, tile=(16, 16)))
    ycc = micrograph(h, w, 3, channels=3)
    for sub in ((1, 1), (2, 1), (2, 2), (4, 2)):
        out[f"tif_ycbcr{sub[0]}{sub[1]}"] = ("tif", ycbcr_tiff(ycc, sub, rows_per_strip=4 * sub[1]))
    out["tif_ycbcr22_refbw"] = ("tif", ycbcr_tiff(ycc, (2, 2), extra={
        529: (RATIONAL, [(2126, 10000), (7152, 10000), (722, 10000)]),
        532: (RATIONAL, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])}))
    if cv2_encode is not None:
        big = micrograph(45, 61, 4, channels=3)

        def enc(q, sf=None):
            return lambda part: cv2_encode(part, q, sf)

        out["tif_jpeg_ycbcr420_strips"] = ("tif", jpeg_tiff(big, enc(90, "420"), 6, rows_per_strip=16, sub=(2, 2)))
        out["tif_jpeg_ycbcr422_strips"] = ("tif", jpeg_tiff(big, enc(80, "422"), 6, rows_per_strip=8, sub=(2, 1)))
        out["tif_jpeg_ycbcr420_tiles"] = ("tif", jpeg_tiff(big, enc(75, "420"), 6, tile=(16, 32), sub=(2, 2)))
        out["tif_jpeg_rgb_strips"] = ("tif", jpeg_tiff(big, enc(90, "444"), 2, rows_per_strip=24))
        out["tif_jpeg_gray_strips"] = ("tif", jpeg_tiff(big[..., 0], enc(85), 1, rows_per_strip=16))
        out["tif_jpeg_gray_tiles"] = ("tif", jpeg_tiff(big[..., 0], enc(85), 1, tile=(32, 16)))
    pal = rng.integers(0, 256, (256, 3))
    idx8 = gray.astype(np.int64)
    out["bmp_palette1"] = ("bmp", bmp_bytes(bilevel, 1, pal[:2]))
    out["bmp_palette4"] = ("bmp", bmp_bytes(idx8 >> 4, 4, pal[:16]))
    out["bmp_palette4_top_down_9_colours"] = ("bmp", bmp_bytes(idx8 >> 4, 4, pal[:9], top_down=True, colors_used=9))
    quant = (idx8 // 48) * 48  # long runs beside noise
    quant[5:9] = idx8[5:9]
    out["bmp_rle8"] = ("bmp", bmp_bytes(quant, 8, pal, compression=1, data=rle_encode(quant, 8)))
    out["bmp_rle4"] = ("bmp", bmp_bytes(quant >> 4, 4, pal[:16], compression=2, data=rle_encode(quant >> 4, 4)))
    for bits, comp in ((8, 1), (4, 2)):
        stream = rle_with_escapes(np.random.default_rng(bits), 12, 17, bits)
        out[f"bmp_rle{bits}_escapes"] = ("bmp", bmp_bytes(np.zeros((12, 17), np.int64), bits, pal[: 2**bits],
                                                          compression=comp, data=stream))
    return out


def reference(name: str, path: str, cv2):
    """``cv2.imread(path, cv2.IMREAD_COLOR)``; for a TIFF with an
    Orientation tag (OpenCV 5.0 returns None for it), the untagged raster
    turned by the mapping ``cv2.imread`` applies to a PNG's ``eXIf``."""
    if not name.startswith("tif_orientation"):
        return cv2.imread(path, cv2.IMREAD_COLOR)
    o = int(name[len("tif_orientation"):])
    rgb = micrograph(13, 22, 1, channels=3)
    with open(path, "wb") as f:
        f.write(png_bytes(rgb, ctype=2, exif=exif_block(o)))
    return cv2.imread(path, cv2.IMREAD_COLOR)


def cv2_jpeg(cv2):
    """A JPEG writer for ``cases``: [h,w] gray or [h,w,3] RGB, quality and
    sampling ("444", "422", "420") -> bytes."""
    factors = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
               "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}

    def encode(part, quality, sampling=None):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        if sampling:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factors[sampling]]
        ok, buf = cv2.imencode(".jpg", part if part.ndim == 2 else part[..., ::-1], params)
        assert ok
        return buf.tobytes()

    return encode


def main(path: str = DEFAULT_OUT) -> None:
    import tempfile

    import cv2

    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (ext, data) in cases(cv2_jpeg(cv2)).items():
            f = os.path.join(tmp, f"{name}.{ext}")
            with open(f, "wb") as fh:
                fh.write(data)
            ref = reference(name, f, cv2)
            assert ref is not None, name
            arrays[f"{name}.{ext}"] = np.frombuffer(data, np.uint8)
            arrays[name] = ref
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes, {len(arrays) // 2} cases)")


if __name__ == "__main__":
    main()

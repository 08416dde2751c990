"""Image ops: decoding micrograph files, pixel normalisation, the quality
score behind adaptive confidence, and the bilinear resize of the tile
upscale."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# Detectron2 R50/R101 zoo models take BGR input with these pixel stats.
PIXEL_MEAN_BGR = (103.53, 116.28, 123.675)
PIXEL_STD_BGR = (1.0, 1.0, 1.0)


class UnsupportedImageError(ValueError):
    """An image file in an encoding that OpenCV reads and ``read_image``
    does not decode: unlike a file OpenCV refuses too, it is not to be
    skipped as unreadable, since the JAX package would read it."""


class RefusedImageError(ValueError):
    """An image file in a form ``read_image`` refuses by name; OpenCV
    returns None for this too, so a reader that skips unreadable files
    skips it as the JAX package does."""


def to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """[H,W,3] BGR -> [H,W] float32 luma (cv2 BGR2GRAY weights)."""
    img = image.float()
    if img.ndim == 2:
        return img
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def image_quality_score(image: torch.Tensor) -> torch.Tensor:
    """Quality in [0,1] = 0.4·brightness + 0.6·contrast, with the
    population standard deviation."""
    gray = to_grayscale(image)
    brightness = gray.mean() / 255.0
    contrast = gray.std(correction=0) / 128.0
    return (0.4 * brightness + 0.6 * contrast).clamp(0.0, 1.0)


def adaptive_threshold_scale(quality: torch.Tensor) -> torch.Tensor:
    """Confidence multiplier from image quality: <0.3 → 0.7, <0.5 → 0.85,
    else 1.0."""
    one = torch.ones_like(quality)
    return torch.where(
        quality < 0.3, 0.7 * one, torch.where(quality < 0.5, 0.85 * one, one)
    )


def resize_image(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of [H,W,C] or [N,H,W,C] to (height, width), float32.

    Half-pixel centres with edge renormalisation, and an antialiasing
    (triangle) filter on downscale — the semantics of
    ``jax.image.resize(..., "linear")``."""
    x = image.float()
    single = x.ndim == 3
    if single:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    down = height < h or width < w
    y = F.interpolate(
        x.permute(0, 3, 1, 2),
        size=(height, width),
        mode="bilinear",
        align_corners=False,
        antialias=down,
    ).permute(0, 2, 3, 1)
    return y[0] if single else y


def normalize_bgr(image: torch.Tensor) -> torch.Tensor:
    """Subtract the Detectron2 BGR pixel means."""
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32, device=image.device)
    std = torch.tensor(PIXEL_STD_BGR, dtype=torch.float32, device=image.device)
    return (image.float() - mean) / std


# ---------------------------------------------------------------------------
# Decoding: the port's cv2.imread(path, cv2.IMREAD_COLOR)
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_TIFF_COMPRESSION = {
    1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
    7: "JPEG", 8: "Deflate", 32773: "PackBits", 32946: "Deflate", 34925: "LZMA", 50000: "ZSTD", 50001: "WEBP",
}
_TIFF_DECODED = (1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32946)
# the compressions of libtiff's codec table (tif_codec.c); under any other value every strip fails to decode
_TIFF_CODECS = (1, 2, 3, 4, 5, 6, 7, 8, 32766, 32771, 32773, 32809, 32909, 32946, 34661, 34676, 34677, 34887, 34925,
                50000, 50001)
_TIFF_FAX = (2, 3, 4, 32771)  # CCITT RLE, Group 3, Group 4, RLEW: 1-bit only
# field type -> (struct code, bytes per value); a RATIONAL is two LONGs; LONG8, SLONG8 and IFD8 are BigTIFF's
_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
               9: ("i", 4), 13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
# TIFFDataWidth: the bytes of a value of each type libtiff knows (EstimateStripByteCounts fails on the others)
_TIFF_WIDTHS = {1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4, 5: 8, 10: 8, 12: 8, 16: 8, 17: 8, 18: 8}
# how TIFFReadDirectory fetches each tag the port reads: one SHORT or LONG ("u16", "u32"), one value or one per
# sample ("sample"), an array ("u16s"), two SHORTs ("pair"), the ColorMap, bytes, RATIONALs of a fixed count
# (tag -> count), or the strip and tile arrays ("strile"), read once their number is known
_TIFF_FETCH = {256: "u32", 257: "u32", 258: "sample", 259: "sample", 262: "u16", 266: "u16", 273: "strile",
               274: "u16", 277: "u16", 278: "u32", 279: "strile", 280: "sample", 281: "sample", 284: "u16",
               292: "u32", 293: "u32", 317: "u16", 318: 2, 320: "colormap", 322: "u32", 323: "u32", 324: "strile",
               325: "strile", 332: "u16", 338: "u16s", 339: "sample", 347: "bytes", 529: 3, 530: "pair", 532: 6}
# the tags whose unreadable value fails the directory (the others are dropped with a warning)
_TIFF_FATAL = (256, 257, 258, 259, 277, 278, 280, 281, 284, 322, 323, 338, 339)
_SHORTS = (1, 3, 4, 6, 8, 9, 16, 17)  # the types TIFFReadDirEntryShort(Array) converts
_TIFF_INT_TYPES = {"u16": _SHORTS, "sample": _SHORTS, "u16s": _SHORTS, "pair": _SHORTS, "colormap": _SHORTS,
                   "u32": _SHORTS + (13, 18), "bytes": (1, 7)}
# byte -> its bits reversed: the strips of a FillOrder 2 (LSB first) TIFF
_BIT_REVERSED = np.packbits(np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)[:, ::-1], axis=1)[:, 0]
# (photometric, samples per pixel) -> the bit depths OpenCV reads: WhiteIsZero and BlackIsZero gray (with
# extra samples), RGB(A), palette (8-bit with extra samples: libtiff refuses contiguous extra samples below 8
# bits), CMYK, YCbCr and CIELab. OpenCV refuses 2- and 4-bit gray and 2-bit palettes.
_TIFF_KINDS = {
    (0, 1): (1, 8, 16), (1, 1): (1, 8, 16), (0, 2): (8, 16), (1, 2): (8, 16), (0, 3): (8, 16), (1, 3): (8, 16),
    (0, 4): (8, 16), (1, 4): (8, 16), (2, 3): (8, 16), (2, 4): (8, 16), (8, 3): (8, 16),
    (3, 1): (1, 4, 8), (3, 2): (8,), (3, 3): (8,), (3, 4): (8,), (5, 4): (8,), (6, 3): (8,),
}
# the YCbCr subsamplings libtiff's RGBA reader places (tif_getimage.c)
_YCBCR_SUBSAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def read_image(path: str) -> np.ndarray:
    """Decode an image file to [H,W,3] uint8 BGR, as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns it.

    Reads PNG (gray at 1, 2, 4, 8 and 16 bits, gray+alpha, RGB, RGBA and
    palettes at 1, 2, 4 and 8 bits, plain or Adam7-interlaced; ``tRNS`` is
    dropped with alpha), TIFF and BigTIFF, either byte order (the first
    page; BlackIsZero and WhiteIsZero gray at 1, 8 and 16 bits, gray+alpha,
    RGB and RGBA at 8 and 16 bits, gray with extra samples, palettes at 1,
    4 and 8 bits (8 bits with extra samples, the index the first), 8-bit
    CMYK and YCbCr with any subsampling libtiff places, CIELab at 8 and 16
    bits; strips or tiles, contiguous or separate planes (of gray, RGB,
    CMYK and 1x1 YCbCr); uncompressed, LZW (old-style too), Deflate,
    PackBits with predictor 1 or 2 (on YCbCr's data units too, in
    libtiff's rows), JPEG (gray, RGB, YCbCr or
    CMYK) with its ``JPEGTables``, and bilevel CCITT RLE, RLEW, Group 3 (1D
    and 2D) and Group 4; FillOrder 2 bits reversed where libtiff reverses
    them; a strip or tile cut short or damaged read as libtiff's RGBA reader
    leaves it: what its codec decoded, zeros after) and BMP (Windows and
    OS/2 core headers; 1-, 4- and 8-bit palettes, uncompressed, RLE4 or
    RLE8; 16-bit 5:5:5 and 5:6:5, 24-bit, 32-bit whatever its bit fields;
    bottom-up or top-down rows). Gray is replicated to
    three channels and alpha is dropped. Sub-byte gray expands to 0..255;
    palettes map through their colours (a TIFF ``ColorMap`` of 16-bit
    entries by its high byte, one whose entries are all below 256 as it
    is); CMYK, YCbCr and CIELab convert as libtiff's RGBA reader converts
    them.
    16-bit samples reduce to 8 bits as OpenCV reduces them: the high byte,
    except for 16-bit colour TIFF, which libtiff's RGBA reader rounds (v *
    255 + 32767) // 65535. JPEG decodes to libjpeg-turbo's pixels bit for
    bit (``native/codecs.cpp:jpeg_decode``): baseline, extended and
    progressive, Huffman- or arithmetic-coded, 8-bit gray, YCbCr, RGB, CMYK
    and YCCK (converted as OpenCV converts CMYK) in any sampling libjpeg
    takes, a progressive file with unrefined low coefficients block-
    smoothed as libjpeg smooths it, and lossless RGB and CMYK; so do a
    TIFF's JPEG strips and tiles. The EXIF orientation of a JPEG (APP1) or
    a PNG (``eXIf``, before or after the image data), and a TIFF's
    Orientation tag, turn the image as OpenCV's ``ApplyExifOrientation``
    does (OpenCV 5.0 returns None for a TIFF with that tag; the port turns
    it, so that the scale-bar region lies where the user sees it). The
    other containers OpenCV reads, the PNM family, PAM, PFM, Sun raster,
    Radiance HDR, GIF and WebP, are ``ops/containers.py``'s; JPEG 2000 (a
    JP2 file or a bare codestream) is ``ops/jpeg2000.py``'s, AVIF
    ``ops/avif.py``'s (its lossless form). A TIFF directory is read as
    libtiff's ``TIFFReadDirectory`` reads it (``_tiff_tags``), damaged ones
    included. What OpenCV refuses too raises a ``RefusedImageError`` that names it: old-style
    JPEG, LZMA, ZSTD and WEBP TIFF, 2- and 4-bit gray TIFF, 32-bit samples,
    a palette TIFF in separate planes or with extra samples below 8 bits,
    hierarchical and arithmetic-coded lossless JPEG, lossless gray or YCbCr
    JPEG, 12-bit and two-component JPEG, a file of no signature OpenCV
    knows; what OpenCV reads and the port does not decode (lossy AVIF
    and the other AVIF forms ``ops/avif.py`` names, and JPEG 2000's
    High-Throughput and Part 2 forms) an
    ``UnsupportedImageError``; a corrupt file, or one cut off before its
    pixel data, a ``ValueError`` (where OpenCV returns None), and a missing
    one an ``OSError``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(_PNG_SIGNATURE):
            return _decode_png(data)
        if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
            return _decode_tiff(data)
        if data[:2] == b"\xff\xd8":
            return _decode_jpeg(data)
        if data[:2] == b"BM":
            return _decode_bmp(data)
        decode = _container_decoder(data)
        if decode is not None:
            return decode(data)
    except (struct.error, KeyError, IndexError, zlib.error) as e:
        raise ValueError(f"{path}: corrupt or truncated file ({type(e).__name__}: {e})") from e
    except ValueError as e:
        raise type(e)(f"{path}: {e}") from None
    # every reader OpenCV 5.0 is built with here is one of the above
    raise RefusedImageError(f"{path}: unknown image encoding (no signature OpenCV reads)")


def _container_decoder(data: bytes):
    """The decoder of ``ops/containers.py`` whose signature ``data``
    starts with, as OpenCV's decoders check them, or None."""
    from deepemia_tpu_torch.ops import containers

    if len(data) >= 3 and data[0] == 0x50 and data[2] in b" \t\n\x0b\x0c\r":  # 'P', then whitespace
        if 0x31 <= data[1] <= 0x36:
            return containers.decode_pnm
        if data[1] == 0x37:
            return containers.decode_pam
        if data[1] in b"fF":
            return containers.decode_pfm
    if data[:4] == containers.SUN_MAGIC:
        return containers.decode_sun
    if data.startswith((b"#?RGBE", b"#?RADIANCE")):
        return containers.decode_hdr
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return containers.decode_gif
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return containers.decode_webp
    from deepemia_tpu_torch.ops import jpeg2000

    if data.startswith((jpeg2000.JP2_SIGNATURE, jpeg2000.J2K_SIGNATURE)):
        return jpeg2000.decode_jpeg2000
    if data[4:8] == b"ftyp":  # an ISO BMFF file: AVIF if its brands and first 500 bytes say so
        from deepemia_tpu_torch.ops import avif

        return avif.decode_avif
    return None


def _to_bgr(pix: np.ndarray) -> np.ndarray:
    """[H,W,S] uint8 samples (gray, gray+alpha, RGB or RGBA) -> [H,W,3] BGR."""
    if pix.shape[2] <= 2:
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., 2::-1])


def _unpack_bits(raw: np.ndarray, n: int, bits: int) -> np.ndarray:
    """[H, row bytes] uint8 -> [H, n] uint8: the first n samples of each row
    at ``bits`` (1, 2 or 4) each, packed MSB first."""
    b = np.unpackbits(raw, axis=1).reshape(raw.shape[0], -1, bits)[:, :n]
    return (b << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)


def _unfilter_png(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG scanline filters. raw [H,W,B] filtered bytes, ftype [H]
    -> [H,W,B] uint8. A pixel depends on its left, upper and upper-left
    neighbours, so every anti-diagonal decodes at once (H+W-1 steps)."""
    h, w, _ = raw.shape
    if int(ftype.max(initial=0)) > 4:
        raise ValueError(f"PNG: invalid filter type {int(ftype.max())}")
    out = np.zeros((h + 1, w + 1, raw.shape[2]), np.int32)  # zero row above, column left
    raw = raw.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a = out[r + 1, x]
        b = out[r, x + 1]
        c = out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (raw[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _png_pass(stream: np.ndarray, pos: int, h: int, w: int, spp: int, depth: int):
    """Unfilter one h x w image (or Adam7 pass) of ``spp`` samples at
    ``depth`` bits from ``stream`` at ``pos`` -> ([h,w,spp] uint8 samples,
    16-bit ones cut to their high byte; the next position). The filters
    work on bytes, a pixel's left neighbour one pixel back (one byte below 8
    bits a pixel); an Adam7 pass's rows are counted in pixels."""
    rowbytes = (w * spp * depth + 7) // 8
    unit = max(1, spp * depth // 8)
    end = pos + h * (1 + rowbytes)
    if end > stream.size:
        raise ValueError("PNG: image data has the wrong length")
    rows = stream[pos:end].reshape(h, 1 + rowbytes)
    raw = _unfilter_png(rows[:, 1:].reshape(h, rowbytes // unit, unit), rows[:, 0]).reshape(h, rowbytes)
    if depth < 8:  # one sample a pixel: gray or a palette index
        return _unpack_bits(raw, w, depth)[..., None], end
    return raw.reshape(h, w, spp, depth // 8)[..., 0], end  # big-endian samples: the high byte first


def _decode_png(data: bytes) -> np.ndarray:
    pos, idat, palette, hdr, exif = 8, [], None, None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and exif is None:
            exif = body
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in _PNG_DEPTHS.get(ctype, ()):
        raise RefusedImageError(f"PNG: colour type {ctype} at bit depth {depth} is not supported")
    if interlace not in (0, 1):
        raise RefusedImageError(f"PNG: interlace method {interlace} is not supported")
    spp = _PNG_CHANNELS[ctype]
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        pix, end = _png_pass(stream, 0, h, w, spp, depth)
    else:
        pix, end = np.zeros((h, w, spp), np.uint8), 0
        for x0, y0, dx, dy in _ADAM7:
            ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
            if ph > 0 and pw > 0:  # an empty pass has no scanlines at all
                pix[y0::dy, x0::dx], end = _png_pass(stream, end, ph, pw, spp, depth)
    if end != stream.size:
        raise ValueError("PNG: image data has the wrong length")
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        pix = palette[pix[..., 0]]
    elif depth < 8:  # libpng's expansion of 1-, 2- and 4-bit gray
        pix = pix * np.uint8(255 // (2**depth - 1))
    # libpng keeps an eXIf chunk that starts with its byte order, before or after the image data
    return _orient(_to_bgr(pix), _tiff_orientation(exif) if exif else 1)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def _tiff_tags(data: bytes):
    """The first IFD -> (byte order, {tag: values}, {tag: (type, count,
    value field, position in the directory)} of the strip and tile
    offsets and byte counts, whose values ``_tiff_striles`` reads once
    their number is known, [(type, count)] of every entry).

    The tags the port reads are fetched as libtiff's ``TIFFReadDirectory``
    and ``TIFFFetchNormalTag`` (tif_dirread.c) fetch them: the first entry
    of a tag counts; a value of a type, count or range its field does not
    take, or whose data lies past the end of the file, fails the directory
    for the tags of ``_TIFF_FATAL`` (a ``ValueError``, where OpenCV returns
    None) and drops the tag for the others; BitsPerSample, Compression
    and SampleFormat take one value, or one per sample that are all equal;
    a ColorMap counts only after BitsPerSample, with 3 << bits entries; an
    ExtraSamples of more values than samples, or of a value above 2 (999
    reads as 2), fails. A RATIONAL's values are its numerators and
    denominators in turn, an UNDEFINED's its bytes. A BigTIFF (version 43)
    has an 8-byte first-IFD offset after its ``8, 0`` header, an 8-byte
    entry count, and 20-byte entries with 8-byte counts and values inline up
    to 8 bytes."""
    end = "<" if data[:2] == b"II" else ">"
    big = struct.unpack(end + "H", data[2:4])[0] == 43
    if big and struct.unpack(end + "HH", data[4:8]) != (8, 0):
        raise ValueError("BigTIFF: offsets of other than 8 bytes")
    word = "Q" if big else "I"  # offsets and counts
    (ifd,) = struct.unpack(end + word, data[4 + 4 * big : 8 + 8 * big])
    (n,) = struct.unpack(end + ("Q" if big else "H"), data[ifd : ifd + 2 + 6 * big])
    entry, inline = (20, 8) if big else (12, 4)
    entries, all_entries = {}, []
    for i in range(n):
        e = ifd + 2 + 6 * big + entry * i
        if len(data[e : e + entry]) < entry:
            raise ValueError("TIFF: the directory runs past the end of the file")
        tag, typ, count = struct.unpack(end + "HH" + word, data[e : e + entry - inline])
        all_entries.append((typ, count))
        if tag not in entries:  # TIFFReadDirectory ignores the duplicates of a tag
            entries[tag] = (typ, count, data[e + entry - inline : e + entry], i)

    def values(typ, count, field):
        """The entry's values, or None where libtiff cannot read them."""
        if typ not in _TIFF_TYPES:
            return None
        fmt, size = _TIFF_TYPES[typ]
        if count * size <= inline:
            raw = field[: count * size]
        else:
            at = struct.unpack(end + word, field)[0]
            raw = data[at : at + count * size]
            if len(raw) < count * size:
                return None
        return struct.unpack(f"{end}{2 * count if typ == 5 else count}{fmt}", raw)

    tags, striles = {}, {}
    order = {tag: e[3] for tag, e in entries.items()}
    spp = 1
    for tag in sorted(entries, key=lambda t: ({277: 0, 259: 1}.get(t, 2), order[t])):  # SamplesPerPixel first
        typ, count, field, _ = entries[tag]
        kind = _TIFF_FETCH.get(tag)
        if kind is None:
            continue
        if kind == "strile":
            striles[tag] = (typ, count, field, order[tag])
            continue
        if isinstance(kind, int):  # RATIONALs of a fixed count
            v = values(typ, count, field) if typ == 5 and count == kind else None
        else:
            v = values(typ, count, field) if typ in _TIFF_INT_TYPES[kind] else None
        if v is not None and kind in ("u16", "sample", "u16s", "pair", "colormap", "u32"):
            top = 0xFFFFFFFF if kind == "u32" else 0xFFFF
            v = v if all(0 <= x <= top for x in v) else None
        if v is not None:
            if kind in ("u16", "u32"):
                v = v if count == 1 else None
            elif kind == "sample":  # TIFFReadDirEntryShort, else TIFFReadDirEntryPersampleShort
                v = v if count == 1 else v[:1] if count >= spp and len(set(v[:spp])) == 1 else None
            elif kind == "pair":
                v = v if count == 2 else None
            elif kind == "colormap":
                bits = tags.get(258, (1,))[0]
                v = v if 258 in tags and order[258] < order[tag] and bits <= 24 and count == 3 << bits else None
            elif kind == "u16s":  # setExtraSamples
                v = tuple(2 if x == 999 else x for x in v)
                v = v if count <= spp and all(x <= 2 for x in v) else None
        if v is None:
            if tag in _TIFF_FATAL:
                raise ValueError(f"TIFF: tag {tag} of type {typ}, count {count} cannot be read")
            continue
        tags[tag] = v
        if tag == 277:
            spp = v[0]
    return end, tags, striles, [(e[0], e[1]) for e in all_entries]


def _tiff_striles(data: bytes, end: str, big: bool, entry, n: int) -> tuple:
    """The first n values of a strip or tile offsets or byte counts entry
    as TIFFFetchStripThing reads them (TIFFReadDirEntryLong8ArrayWithLimit:
    no more than n values read, at the entry's offset unless all of them
    fit inline; missing ones 0); values past the end of the file fail."""
    typ, count, field, _ = entry
    if typ not in _TIFF_INT_TYPES["u32"]:
        raise ValueError(f"TIFF: strip or tile offsets or byte counts of type {typ}")
    fmt, size = _TIFF_TYPES[typ]
    k = min(count, n)
    if count * size <= (8 if big else 4):
        raw = field[: k * size]
    else:
        at = struct.unpack(end + ("Q" if big else "I"), field)[0]
        raw = data[at : at + k * size]
        if len(raw) < k * size:
            raise ValueError("TIFF: strip or tile offsets or byte counts past the end of the file")
    v = struct.unpack(f"{end}{k}{fmt}", raw)
    if min(v, default=0) < 0:
        raise ValueError("TIFF: a negative strip or tile offset or byte count")
    return v + (0,) * (n - k)


def _tiff_segment(raw: bytes, comp: int, size: int, lzw_compat: bool = False):
    """One strip or tile, decompressed to at most ``size`` bytes -> (the
    bytes, whether its codec filled ``size`` without an error). A codec that
    fails keeps what it wrote, as libtiff's does: an LZW or Deflate stream
    up to its first bad code, any stream cut short up to its end; an
    uncompressed one shorter than ``size`` copies nothing (DumpModeDecode).
    ``lzw_compat``: whether LZW is old-style."""
    if comp == 1:
        return (raw[:size], True) if len(raw) >= size else (b"", False)
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error:  # the bytes inflate wrote before the error: those of the longest sound prefix
            lo, hi = 0, len(raw)
            while hi - lo > 1:
                mid = (lo + hi) // 2
                try:
                    zlib.decompressobj().decompress(raw[:mid], size)
                    lo = mid
                except zlib.error:
                    hi = mid
            return zlib.decompressobj().decompress(raw[:lo], size), False
        return out, len(out) == size
    from deepemia_tpu_torch import native

    if comp == 5:
        out, sound = native.lzw_decode(raw, size, lzw_compat)
        return out, sound and len(out) == size
    out = native.packbits_decode(raw, size)
    return out, len(out) == size


def _ycbcr_predictor(seg: bytes, rowsize: int) -> bytes:
    """Undo predictor 2 on a YCbCr strip or tile's data units as libtiff's
    PredictorDecodeTile does: each ``rowsize`` bytes (TIFFScanlineSize,
    or TIFFTileRowSize, which ignores the subsampling) summed on their own
    with a stride of 3 (horAcc8), across the data units' bounds; where
    the size is no whole number of rows, or a row no whole number of
    strides, libtiff fails after its codec and the bytes stay as they
    were decoded."""
    if rowsize <= 0 or len(seg) % rowsize or rowsize % 3:
        return seg
    a = np.frombuffer(seg, np.uint8).reshape(-1, rowsize // 3, 3)
    return np.cumsum(a, axis=1, dtype=np.uint8).tobytes()


def _ycbcr_units(seg: bytes, sh: int, sw: int, sub, skew: int = 0) -> np.ndarray:
    """A YCbCr strip or tile's data units (TIFF 6.0 section 21: each block
    of sub[0] x sub[1] pixels holds its luma samples row by row, then one
    Cb and one Cr) -> [sh, sw, 3] Y, Cb, Cr, each block's chroma on all of
    its pixels, as libtiff's RGBA reader places them. ``skew``: the
    columns of a right-edge tile past the image, which the reader steps
    over after each row of blocks; putcontig8bitYCbCr44tile steps over
    each skipped 4x4 block as if it held 10 bytes, not 18."""
    hs, vs = sub
    block = hs * vs + 2
    by, bx = -(-sh // vs), -(-sw // hs)
    step = bx * block + (skew // hs) * (10 if sub == (4, 4) else block)
    buf = np.frombuffer(seg, np.uint8)
    u = buf[np.arange(by)[:, None] * step + np.arange(bx * block)].reshape(by, bx, block)
    y = u[..., : hs * vs].reshape(by, bx, vs, hs).transpose(0, 2, 1, 3).reshape(by * vs, bx * hs)
    c = np.repeat(np.repeat(u[..., hs * vs :], vs, axis=0), hs, axis=1)
    return np.concatenate([y[..., None], c], axis=2)[:sh, :sw]


def _tiff_jpeg(raw: bytes, tables: bytes, photometric: int, spp: int, sh: int, sw: int) -> np.ndarray:
    """One JPEG-compressed strip or tile -> [sh, sw, spp] uint8 gray, RGB
    or CMYK: its stream with the ``JPEGTables`` spliced in after SOI,
    decoded as libtiff has libjpeg decode it (tif_jpeg.c: YCbCr converted to
    RGB, gray, RGB and CMYK as stored). A last strip may hold more rows than
    the image."""
    from deepemia_tpu_torch import native

    if raw[:2] != b"\xff\xd8":
        raise ValueError("TIFF: a JPEG strip or tile does not start with SOI")
    status, meta, bgr = native.jpeg_decode(raw[:2] + tables + raw[2:], 0 if photometric == 6 else 1)
    if status:
        _jpeg_refusal(status, meta)
    if int(meta[2]) != spp or bgr.shape[1] != sw or bgr.shape[0] < sh:
        raise ValueError(f"TIFF: a JPEG strip or tile of {bgr.shape[0]}x{bgr.shape[1]}x{int(meta[2])} where "
                         f"{sh}x{sw}x{spp} was expected")
    return bgr[:sh] if spp == 4 else bgr[:sh, :, 2::-1][..., :spp]


def _rationals(values, default):
    """A RATIONAL tag's values as libtiff reads them (float32 numerator over
    float32 denominator, 0 for a zero denominator), or ``default``."""
    if values is None:
        return [np.float32(v) for v in default]
    num, den = np.float32(values[0::2]), np.float32(values[1::2])
    return list(np.where(den == 0, np.float32(0), num / np.where(den == 0, np.float32(1), den)))


def _ycbcr_to_bgr(ycc: np.ndarray, tags: dict) -> np.ndarray:
    """[H,W,3] Y, Cb, Cr -> BGR by libtiff's ``TIFFYCbCrToRGBInit`` and
    ``TIFFYCbCrtoRGB`` (tif_color.c): float32 coefficients from
    YCbCrCoefficients (tag 529) and ReferenceBlackWhite (532), or libtiff's
    defaults, then 16-bit fixed-point tables."""
    f32 = np.float32
    lr, lg, lb = _rationals(tags.get(529), (0.299, 0.587, 0.114))
    rbw = _rationals(tags.get(532), (0, 255, 128, 255, 128, 255))

    def fix(v):  # FIX(x): (int32)(x * 65536 + 0.5), the product in float32, the sum in double
        return int(np.float64(f32(min(max(v, f32(0)), f32(2))) * f32(65536)) + 0.5)

    f1, f3 = f32(2) - f32(2) * lr, f32(2) - f32(2) * lb
    d1, d2, d3, d4 = fix(f1), -fix(f32(lr * f1) / lg), fix(f3), -fix(f32(lb * f3) / lg)

    def code2v(c, rb, rw, cr):  # Code2V, then CLAMPw to +-4096 and the cast to int32
        den = f32(rw - rb) if rw != rb else f32(1)
        v = (c - int(rb)).astype(f32) * f32(cr) / den
        return np.clip(v, f32(-4096), f32(4096)).astype(np.int64)

    x = np.arange(-128, 128)
    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    y = code2v(x + 128, rbw[0], rbw[1], 255)[ycc[..., 0]]
    r = y + ((d1 * cr + 32768) >> 16)[ycc[..., 2]]
    g = y + (((d4 * cb + 32768)[ycc[..., 1]] + (d2 * cr)[ycc[..., 2]]) >> 16)
    b = y + ((d3 * cb + 32768) >> 16)[ycc[..., 1]]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def _cielab_to_bgr(lab: np.ndarray, depth: int, tags: dict) -> np.ndarray:
    """[H,W,3] CIELab samples -> BGR as libtiff's RGBA reader converts them
    (tif_getimage.c initCIELabConversion, tif_color.c): TIFFCIELab16ToXYZ
    against the WhitePoint (D50 by default), then TIFFXYZToRGB on the sRGB
    display (its matrix, 1500-step gamma 2.4 tables), in float32 as libtiff
    computes it."""
    f32 = np.float32
    if depth == 8:  # TIFFCIELabToXYZ: L * 257, a and b (signed) * 256
        l = lab[..., 0].astype(np.int64) * 257
        a, b = (lab[..., k].astype(np.int8).astype(np.int64) * 256 for k in (1, 2))
    else:
        l = lab[..., 0].astype(np.int64)
        a, b = (lab[..., k].astype(np.int16).astype(np.int64) for k in (1, 2))
    if 318 in tags:
        wp0, wp1 = _rationals(tags[318], ())[:2]
    else:
        s = f32(96.425) + f32(100) + f32(82.468)
        wp0, wp1 = f32(96.425) / s, f32(100) / s
    if wp1 == 0:
        raise ValueError("TIFF: a WhitePoint of y 0")
    x0, y0, z0 = wp0 / wp1 * f32(100), f32(100), (f32(1) - wp0 - wp1) / wp1 * f32(100)
    lum = l.astype(f32) * f32(100) / f32(65535)
    low = lum < f32(8.856)
    y = np.where(low, (lum * y0) / f32(903.292), f32(0)).astype(f32)
    cby = np.where(low, f32(7.787) * (y / y0) + f32(16) / f32(116), (lum + f32(16)) / f32(116)).astype(f32)
    y = np.where(low, y, y0 * cby * cby * cby).astype(f32)

    def xz(t, w0):
        return np.where(t < f32(0.2069), w0 * (t - f32(0.13793)) / f32(7.787), w0 * t * t * t).astype(f32)

    x = xz((a.astype(f32) / f32(256) / f32(500) + cby).astype(f32), x0)
    z = xz((cby - b.astype(f32) / f32(256) / f32(200)).astype(f32), z0)
    steps = 1500
    step = (f32(100) - f32(1)) / f32(steps)
    table = f32(255) * np.power(np.arange(steps + 1) / steps, 1.0 / np.float64(f32(2.4))).astype(f32)
    out = []
    for m in ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416), (0.0556, -0.2040, 1.0570)):
        v = (f32(m[0]) * x + f32(m[1]) * y + f32(m[2]) * z).astype(f32)
        v = np.minimum(np.maximum(v, f32(1)), f32(100))
        i = np.minimum(((v - f32(1)) / step).astype(f32).astype(np.int64), steps)
        out.append(np.minimum((table[i].astype(np.float64) + 0.5).astype(np.int64), 255))  # RINT, then the clip
    return np.stack(out[::-1], axis=-1).astype(np.uint8)


def _tiff_to_bgr(pix: np.ndarray, photometric: int, depth: int, tags: dict) -> np.ndarray:
    """The decoded samples -> [H,W,3] BGR as libtiff's RGBA reader
    (tif_getimage.c), which OpenCV reads 8-bit images through, maps them."""
    if photometric in (0, 1):  # 1 bit: 0 / 255; 16 bits: the high byte; WhiteIsZero inverted
        g = pix[..., :1]
        g = (g * 255 if depth == 1 else g >> 8 if depth == 16 else g).astype(np.uint8)
        return _to_bgr(255 - g if photometric == 0 else g)
    if photometric == 3:
        cmap = np.asarray(tags[320], np.int64)
        if cmap.size != 3 << depth:
            raise ValueError(f"TIFF: a ColorMap of {cmap.size} entries where {3 << depth} were expected")
        if cmap.max() >= 256:  # checkcmap: 16-bit entries, unless all are below 256
            cmap >>= 8
        return cmap.reshape(3, -1).T[:, ::-1].astype(np.uint8)[pix[..., 0]]
    if photometric == 5:  # putRGBcontig8bitCMYKtile
        v = pix.astype(np.int32)
        return ((255 - v[..., 3:]) * (255 - v[..., 2::-1]) // 255).astype(np.uint8)
    if photometric == 6:
        return _ycbcr_to_bgr(pix, tags)
    if photometric == 8:
        return _cielab_to_bgr(pix, depth, tags)
    if depth == 16:
        pix = ((pix.astype(np.int64) * 255 + 32767) // 65535).astype(np.uint8)
    if pix.shape[2] == 4 and tags.get(338, (0,))[0] == 2:
        # libtiff's RGBA reader premultiplies unassociated alpha
        v = pix.astype(np.int32)
        pix = ((v[..., :3] * v[..., 3:] + 127) // 255).astype(np.uint8)
    return _to_bgr(pix)


def _decode_tiff(data: bytes) -> np.ndarray:
    end, tags, striles, entries = _tiff_tags(data)
    get = lambda t, d: tags.get(t, (d,))  # noqa: E731
    w, h = tags[256][0], tags[257][0]
    if not 0 < w <= 1 << 20 or not 0 < h <= 1 << 20 or w * h > 1 << 30:  # OpenCV's validateInputImageSize
        raise ValueError(f"TIFF: an image of {w}x{h} pixels")
    spp = get(277, 1)[0]
    depth = get(258, 1)[0]
    comp = get(259, 1)[0]
    if 262 not in tags:  # OpenCV fails on TIFFGetField(TIFFTAG_PHOTOMETRIC)
        raise ValueError("TIFF: no readable PhotometricInterpretation")
    photometric = tags[262][0]
    # TIFFReadDirectory counts the samples past the photometric's colour channels as extra, then reads a
    # palette without a ColorMap as RGB (3 samples) or gray
    extra = len(tags.get(338, ()))
    channels = {0: 1, 1: 1, 3: 1, 4: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 5: 4}.get(photometric, 0)
    extra = max(extra, spp - channels) if channels else extra
    if photometric == 3 and 320 not in tags:
        if depth < 8:
            raise ValueError("TIFF: a palette image without a ColorMap")
        photometric = 2 if spp == 3 else 1
    # libtiff reverses the bits of every raw segment of a FillOrder 2 file, but those of the codecs
    # that set TIFF_NOBITREV: JPEG, and the fax codecs, which read either order through their tables
    fill = get(266, 1)[0]
    predictor, planar = get(317, 1)[0], get(284, 1)[0]
    # a compression libtiff has no codec for opens, and every strip then fails to decode
    undecodable = comp not in _TIFF_CODECS
    if comp not in _TIFF_DECODED and not undecodable:
        raise RefusedImageError(
            f"TIFF: {_TIFF_COMPRESSION.get(comp, f'compression {comp}')} compression is not supported"
        )
    # libtiff reads the predictor tag for LZW and Deflate only
    predictor = predictor if comp in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise RefusedImageError(f"TIFF: predictor {predictor} is not supported")
    if planar not in (1, 2):
        raise RefusedImageError(f"TIFF: planar configuration {planar} is not supported")
    planar = 1 if spp == 1 else planar  # libtiff reads one sample a pixel as contiguous whatever the tag says
    if photometric == 2 and spp - extra < 3:  # TIFFRGBAImageOK: fewer than 3 colour channels
        raise ValueError(f"TIFF: RGB of {spp} samples, {extra} of them extra")
    if (photometric, spp) not in _TIFF_KINDS:
        raise RefusedImageError(f"TIFF: photometric {photometric} with {spp} samples is not supported")
    if get(339, 1)[0] != 1 or depth not in _TIFF_KINDS[photometric, spp]:
        raise RefusedImageError(
            f"TIFF: samples of [{depth}] bits, format {get(339, 1)} are not supported with photometric "
            f"{photometric}"
        )
    sub = tags.get(530, (2, 2))  # libtiff's default
    # libtiff's RGBA reader reads separate planes of gray, RGB, CMYK and YCbCr without subsampling
    # (pickSeparateCase), a palette's index from the first of its samples in contiguous ones only
    if planar == 2 and (photometric not in (0, 1, 2, 5, 6) or (photometric == 6 and sub != (1, 1))):
        raise RefusedImageError(f"TIFF: separate planes of photometric {photometric} are not supported")
    if predictor == 2 and depth < 8:  # libtiff refuses the predictor below 8 bits
        raise RefusedImageError(f"TIFF: predictor 2 with photometric {photometric} at {depth} bits is not supported")
    if photometric == 5 and get(332, 1)[0] != 1:
        raise RefusedImageError(f"TIFF: ink set {get(332, 1)[0]} (not CMYK) is not supported")
    if comp in _TIFF_FAX and (depth != 1 or spp != 1):
        raise ValueError(f"TIFF: {_TIFF_COMPRESSION[comp]} compression of {spp} samples at {depth} bits")
    if comp == 7 and (photometric not in (1, 2, 5, 6) or planar == 2):
        raise RefusedImageError(f"TIFF: JPEG compression of photometric {photometric}, planar configuration "
                                f"{planar} is not supported")
    # JPEG strips convert YCbCr inside the JPEG decoder; separate planes hold one sample a pixel
    ycc = photometric == 6 and comp != 7 and planar == 1
    if ycc and sub not in _YCBCR_SUBSAMPLING:
        raise RefusedImageError(f"TIFF: YCbCr subsampling {sub} is not supported")
    tables = bytes(tags.get(347, b""))
    tables = tables[2:-2] if tables[:2] == b"\xff\xd8" else tables  # its SOI and EOI
    dtype = np.dtype(np.uint8) if depth <= 8 else np.dtype(end + "u2")
    sps = spp if planar == 1 else 1  # samples per pixel within one segment
    if (322 in tags or 323 in tags) and comp == 1 and fill == 2:
        raise ValueError("TIFF: uncompressed tiles in FillOrder 2, which libtiff's tile reader fails on")
    tiled = 322 in tags or 323 in tags
    row_bytes = (w * (spp if planar == 1 else 1) * depth + 7) // 8  # TIFFScanlineSize
    if ycc:  # of subsampled YCbCr: a row of data units over v
        row_bytes = -(-w // sub[0]) * (sub[0] * sub[1] + 2) // sub[1]
    if tiled:  # tiles, padded to the full tile size at the edges
        tw, th = get(322, 0)[0], get(323, 0)[0]
        if not tw or not th:
            raise ValueError(f"TIFF: tiles of {tw}x{th} pixels")
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
        shape_of = lambda y: (th, tw)  # noqa: E731
        seg_size = th * ((tw * sps * depth + 7) // 8)  # TIFFTileSize
        if ycc:
            seg_size = -(-th // sub[1]) * -(-tw // sub[0]) * (sub[0] * sub[1] + 2)
    else:
        rps = min(get(278, h)[0], h)
        if not rps:
            raise ValueError("TIFF: RowsPerStrip 0")
        grid = [(y, 0) for y in range(0, h, rps)]
        shape_of = lambda y: (min(rps, h - y), w)  # noqa: E731
        seg_size = row_bytes * rps
    planes = 1 if planar == 1 else spp
    nstrips = planes * len(grid)
    if not nstrips:
        raise ValueError("TIFF: an image of no strips or tiles")
    big = data[2:4] in (b"+\x00", b"\x00+")

    def strile(tags_):  # the last of the two tags in the directory's order is the one libtiff keeps
        found = [striles[t] for t in tags_ if t in striles]
        return max(found, key=lambda e: e[3]) if found else None

    if strile((273, 324)) is None:
        raise ValueError("TIFF: no StripOffsets or TileOffsets")
    offsets = _tiff_striles(data, end, big, strile((273, 324)), nstrips)
    count_entry = strile((279, 325))

    def estimated():  # EstimateStripByteCounts
        if comp != 1:
            space = (16 + 8 + 20 * len(entries) + 8) if big else (8 + 2 + 12 * len(entries) + 4)
            for typ, count in entries:
                if typ not in _TIFF_WIDTHS:
                    raise ValueError(f"TIFF: a tag of unknown type {typ}, which libtiff cannot size")
                size = _TIFF_WIDTHS[typ] * count
                space += size if size > (8 if big else 4) else 0
            space = len(data) if len(data) < space else len(data) - space
            est = [space // spp if planar == 2 else space] * nstrips
            if offsets[-1] + est[-1] > len(data):
                est[-1] = 0 if offsets[-1] >= len(data) else len(data) - offsets[-1]
            return tuple(est)
        if tiled:
            return (seg_size,) * nstrips
        return (row_bytes * (h // len(grid)),) * nstrips

    if count_entry is None:  # TIFFReadDirectory estimates one strip (or plane) of data, else fails
        if nstrips != planes:
            raise ValueError("TIFF: no StripByteCounts")
        counts = estimated()
    else:
        counts = _tiff_striles(data, end, big, count_entry, nstrips)
        # tif_dirread.c ignores the StripByteCounts where they look wrong (ByteCountLooksBad: one strip of no
        # bytes at a non-zero offset, or, uncompressed, of more bytes than the file holds past it or fewer than
        # the image; or, uncompressed and contiguous, the first two of three or more unequal) and estimates them
        bad = nstrips == 1 and not tiled and offsets[0] and (not counts[0] or comp == 1 and (
            offsets[0] <= len(data) and counts[0] > len(data) - offsets[0] or counts[0] < row_bytes * h))
        if bad or (comp == 1 and planar == 1 and nstrips > 2 and counts[0] != counts[1] and counts[0] and counts[1]):
            counts = estimated()
    pix = np.empty((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    lzw_compat = None
    for p in range(planes):
        for k, (y, x) in enumerate(grid):
            sh, sw = shape_of(y)
            j = p * len(grid) + k
            # libtiff's RGBA reader gives up where the first plane's segment cannot be read (or, in tiles, is
            # uncompressed and short), and reads what a failed codec left, zeros after it, everywhere else
            first_plane = planar == 1 or p == 0
            raw = data[offsets[j] : offsets[j] + counts[j]]
            if not counts[j] or offsets[j] + counts[j] > len(data):
                if first_plane:
                    raise ValueError("TIFF: a strip or tile of no bytes, or past the end of the file")
                raw = b""
            # _TIFFReadEncodedTileAndAllocBuffer refuses a first tile whose buffer would pass 1e8 bytes from
            # a compressed tile of less than a thousandth of TIFFTileSize
            alloc = seg_size * (1 if planar == 1 else 4 if spp > 3 else 3)
            if tiled and j == 0 and comp != 1 and alloc > 100_000_000 and counts[0] < seg_size // 1000:
                raise ValueError(f"TIFF: a tile of {counts[0]} bytes for {seg_size} decoded ones")
            if fill == 2 and comp != 7 and comp not in _TIFF_FAX:  # tif_read.c: TIFFReverseBits
                raw = _BIT_REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            if comp == 7:
                a = _tiff_jpeg(raw, tables, photometric, spp, sh, sw)
            elif comp in _TIFF_FAX:
                from deepemia_tpu_torch import native

                seg = native.fax_decode(raw, comp, sh, sw, get(293 if comp == 4 else 292, 0)[0], fill == 2)
                a = _unpack_bits(np.frombuffer(seg, np.uint8).reshape(sh, -1), sw, 1)[..., None]
            else:
                read = need = sh * ((sw * sps * depth + 7) // 8)
                if ycc:
                    read = need = -(-sh // sub[1]) * -(-sw // sub[0]) * (sub[0] * sub[1] + 2)
                    if not tiled:  # gtStripContig asks for whole rows of blocks of TIFFScanlineSize
                        read = min(need, -(-sh // sub[1]) * sub[1] * row_bytes)
                if comp == 5 and lzw_compat is None and raw:  # LZWPreDecode keeps the first segment's style
                    lzw_compat = len(raw) >= 2 and raw[0] == 0 and bool(raw[1] & 1)
                seg, sound = (b"", False) if undecodable else _tiff_segment(raw, comp, read, bool(lzw_compat))
                if comp == 1 and not sound and tiled and first_plane:
                    raise ValueError("TIFF: an uncompressed tile shorter than the tile, which libtiff's tile reader "
                                     "fails on")
                if ycc and predictor == 2 and sound:
                    seg = _ycbcr_predictor(seg, sw * 3 if tiled else row_bytes)
                seg = seg.ljust(need, b"\0")  # the rest of libtiff's buffer, zeroed when allocated
                if ycc:
                    vw = min(sw, w - x)  # the columns of the tile in the image
                    a = _ycbcr_units(seg, sh, vw, sub, sw - vw)
                elif depth < 8:
                    a = _unpack_bits(np.frombuffer(seg, np.uint8).reshape(sh, -1), sw, depth)[..., None]
                else:
                    a = np.frombuffer(seg, dtype).reshape(sh, sw, sps).astype(pix.dtype)
                if predictor == 2 and sound and not ycc:  # horizontal differencing, undone where the codec succeeded
                    a = np.cumsum(a, axis=1, dtype=pix.dtype)
            ch = slice(None) if planar == 1 else slice(p, p + 1)
            pix[y : y + sh, x : x + sw, ch] = a[: h - y, : w - x]
    photometric = 2 if comp == 7 and photometric == 6 else photometric
    return _orient(_tiff_to_bgr(pix, photometric, depth, tags), get(274, 1)[0])


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def _bmp_rle(src: bytes, width: int, rows: int, bits: int) -> np.ndarray:
    """A BMP's RLE8 (``bits`` 8) or RLE4 (4) stream -> [rows, width]
    palette indices in stream row order, as OpenCV's decoder
    (grfmt_bmp.cpp) lays them out: a run or an absolute stretch that would
    cross the end of its row is corrupt; the pixels an end of line, a delta
    or the end of the bitmap skips take index 0 (the skip runs on in raster
    order); an RLE8 run that fills its row moves to the next, where an end
    of line that follows does nothing, while an RLE4 run or an absolute
    stretch that fills its row waits for the end of line. In RLE4, OpenCV
    reads an end of bitmap as an end of line and moves a delta by its dx
    alone."""
    out = np.zeros(rows * width, np.uint8)
    n, pos, y, x, wrapped = len(src), 0, 0, 0, False
    while y < rows:
        if pos + 2 > n:
            raise ValueError("BMP: the RLE data ends before the image does")
        count, code = src[pos], src[pos + 1]
        pos += 2
        at = y * width + x  # x == width (a filled row) is the next row's start
        if count or code > 2:
            m = count or code
            if x + m > width:
                raise ValueError("BMP: an RLE run crosses the end of its row")
            if count:  # a run of one index (RLE4: of two in turn)
                vals = code if bits == 8 else np.array([code >> 4, code & 15], np.uint8)[np.arange(m) % 2]
            else:  # absolute: m indices, padded to 16 bits
                size = m if bits == 8 else (m + 1) // 2
                if pos + ((size + 1) & ~1) > n:
                    raise ValueError("BMP: the RLE data ends before the image does")
                vals = np.frombuffer(src, np.uint8, count=size, offset=pos)
                vals = vals if bits == 8 else _unpack_bits(vals[None], m, 4)[0]
                pos += (size + 1) & ~1
            out[at : at + m] = vals
            x += m
            wrapped = bool(count) and bits == 8 and x == width
            if wrapped:
                y, x = y + 1, 0
            continue
        if code == 0 and wrapped:
            wrapped = False
            continue
        if code == 2:  # delta: dx right, dy down (RLE4: dy is not read)
            if pos + 2 > n:
                raise ValueError("BMP: the RLE data ends before the image does")
            skip = src[pos] + (src[pos + 1] * width if bits == 8 else 0)
            pos += 2
        elif code == 0 or bits == 4:  # end of line (RLE4: the end of bitmap too)
            skip = width - x
        else:  # end of bitmap
            skip = width - x + (rows - y) * width
        y, x = divmod(at + skip, width)
        wrapped = False
    return out.reshape(rows, width)


def _decode_bmp(data: bytes) -> np.ndarray:
    """OpenCV's BMP reader (grfmt_bmp.cpp): a Windows header of 36 bytes or
    more, or an OS/2 core header (12 bytes, 3-byte palette entries);
    palettes at 1, 4 and 8 bits (RLE4, RLE8), 16-bit 5:5:5 (masks 0x7C00,
    0x3E0, 0x1F or none) and 5:6:5, 24- and 32-bit (bit fields or not: the
    first three bytes are B, G, R)."""
    (pixel_at,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    entry = 4  # palette entry bytes
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        comp, ncolors, entry = 0, 0, 3
    elif hsize >= 36:
        w, h, _, bits, comp, _, _, _, ncolors = struct.unpack("<iiHHIIiiI", data[18:50])
    else:
        raise RefusedImageError(f"BMP: a header of {hsize} bytes is not supported")
    if bits == 16 and comp == 3:  # OpenCV reads the masks after the header and takes 5:5:5 and 5:6:5
        masks = struct.unpack("<III", data[14 + hsize : 26 + hsize])
        if masks not in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
            raise RefusedImageError(f"BMP: bit fields {[hex(m) for m in masks]} are not supported")
    elif comp not in (0, {8: 1, 4: 2, 16: 3, 32: 3}.get(bits, 0)):
        raise RefusedImageError(f"BMP: compression {comp} at {bits} bits is not supported")
    if bits not in (1, 4, 8, 16, 24, 32) or (bits == 16 and hsize == 12):
        raise RefusedImageError(f"BMP: {bits}-bit pixels are not supported")
    if ncolors > 256:
        raise ValueError(f"BMP: {ncolors} palette colours")
    rows, width = abs(h), w
    if bits > 8:
        stride = (width * bits + 31) // 32 * 4
        raw = np.frombuffer(data, np.uint8, count=rows * stride, offset=pixel_at).reshape(rows, stride)
        raw = raw[::-1] if h > 0 else raw  # bottom-up rows
        if bits == 16:  # icvCvt_BGR5552BGR / BGR5652BGR: each field's bits at the top of its byte
            t = raw[:, : 2 * width].view("<u2").astype(np.int32)
            g565 = comp == 3 and masks[1] == 0x7E0
            bgr = [(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8] if g565 else \
                [(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8]
            return np.stack(bgr, axis=-1).astype(np.uint8)
        return np.ascontiguousarray(raw[:, : width * bits // 8].reshape(rows, width, bits // 8)[..., :3])
    # OpenCV's palette has 256 entries; those the file does not give are black
    given = ncolors or 1 << bits
    pal = np.zeros((256, 3), np.uint8)
    pal[:given] = np.frombuffer(data, np.uint8, count=entry * given, offset=14 + hsize).reshape(-1, entry)[:, :3]
    if comp:
        idx = _bmp_rle(data[pixel_at:], width, rows, bits)
    else:
        stride = (width * bits + 31) // 32 * 4
        raw = np.frombuffer(data, np.uint8, count=rows * stride, offset=pixel_at).reshape(rows, stride)
        idx = raw[:, :width] if bits == 8 else _unpack_bits(raw, width, bits)
    return np.ascontiguousarray(pal[idx[::-1] if h > 0 else idx])


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# the JPEG processes libjpeg-turbo (and so OpenCV) does not decode either: the
# hierarchical ones, and arithmetic-coded lossless
_JPEG_CODINGS = {
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "differential arithmetic-coded sequential (SOF13)", 0xCE: "differential arithmetic-coded progressive (SOF14)",
    0xCF: "differential arithmetic-coded lossless (SOF15)",
}


def _decode_jpeg(data: bytes) -> np.ndarray:
    from deepemia_tpu_torch import native

    status, meta, pix = native.jpeg_decode(data)
    if status:
        _jpeg_refusal(status, meta)
    return _orient(pix, _exif_orientation(data))


def _jpeg_refusal(status: int, meta: np.ndarray) -> None:
    """Raise for a negative status of ``native.jpeg_decode``."""
    if status == -2:
        coding = int(meta[3])
        raise RefusedImageError(f"JPEG: {_JPEG_CODINGS.get(coding, f'SOF marker 0x{coding:02X}')} is not supported")
    if status == -3:
        raise RefusedImageError("JPEG: two components (no colour space libjpeg converts) are not supported")
    if status == -4:
        raise RefusedImageError("JPEG: sample precision other than 8 bits (12-bit) is not supported")
    if status == -5:
        raise RefusedImageError("JPEG: lossless (SOF3) gray, YCbCr or YCCK, which libjpeg-turbo does not "
                                    "convert to BGR, is not supported")
    raise ValueError("JPEG: corrupt, or cut off before its pixel data")


def _exif_orientation(data: bytes) -> int:
    """The Orientation of the first APP1 Exif segment of a JPEG, or 1."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):
            break
        if marker == 0xFF:
            pos += 1
            continue
        (length,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        body = data[pos + 4 : pos + 2 + length]
        pos += 2 + length
        if marker == 0xE1 and body.startswith(b"Exif\x00\x00"):
            return _tiff_orientation(body[6:])
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112, SHORT) of the first IFD of an Exif
    block's TIFF structure, or 1; an unreadable block reads as 1, as OpenCV
    ignores it."""
    try:
        end = {b"II": "<", b"MM": ">"}[tiff[:2]]
        (ifd,) = struct.unpack(end + "I", tiff[4:8])
        (count,) = struct.unpack(end + "H", tiff[ifd : ifd + 2])
        for i in range(count):
            tag, typ, _, value = struct.unpack(end + "HHI4s", tiff[ifd + 2 + 12 * i : ifd + 14 + 12 * i])
            if tag == 0x0112 and typ == 3:
                return struct.unpack(end + "H", value[:2])[0]
    except (KeyError, struct.error):
        return 1
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation``: 2 flips left-right, 3 turns 180°,
    4 flips up-down, 5 transposes, 6 turns 90° clockwise, 7 transposes and
    turns 180°, 8 turns 90° counter-clockwise; any other value leaves the
    image as it is."""
    t = img.transpose(1, 0, 2)
    out = {2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1], 5: t, 6: t[:, ::-1], 7: t[::-1, ::-1],
           8: t[::-1]}.get(orientation, img)
    return np.ascontiguousarray(out)

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
    """An image file in an encoding ``read_image`` does not decode (where
    OpenCV may): unlike a missing or corrupt file, which OpenCV cannot read
    either, it is not to be skipped as unreadable."""


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
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_TIFF_COMPRESSION = {
    1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
    7: "JPEG", 8: "Deflate", 32773: "PackBits", 32946: "Deflate", 34925: "LZMA", 50000: "ZSTD", 50001: "WEBP",
}
_TIFF_DECODED = (1, 5, 8, 32773, 32946)


def read_image(path: str) -> np.ndarray:
    """Decode an image file to [H,W,3] uint8 BGR, as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns it.

    Reads PNG (8/16-bit gray, gray+alpha, RGB, RGBA and 8-bit palette,
    plain or Adam7-interlaced), TIFF (the first page; 8/16-bit gray, RGB,
    RGBA; strips or tiles, contiguous or separate planes; uncompressed,
    LZW, Deflate or PackBits, with predictor 1 or 2) and BMP (8-bit palette,
    24-bit, 32-bit; bottom-up or top-down rows). Gray is replicated to three
    channels and alpha is dropped. 16-bit samples reduce to 8 bits as
    OpenCV reduces them: the high byte, except for 16-bit colour TIFF,
    which libtiff's RGBA reader rounds (v * 255 + 32767) // 65535. JPEG
    (baseline, extended and progressive Huffman, 8-bit gray, YCbCr or RGB,
    any sampling libjpeg takes) decodes to libjpeg-turbo's pixels bit for
    bit (``native/codecs.cpp:jpeg_decode``), EXIF orientation applied as
    OpenCV applies it. Any other encoding (BigTIFF, the other TIFF
    compressions, JPEG's arithmetic, lossless and hierarchical codings,
    12-bit and CMYK JPEG) raises an ``UnsupportedImageError`` that names
    it; a corrupt file, or one cut off before its pixel data, a
    ``ValueError`` (where OpenCV returns None), and a missing one an
    ``OSError``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(_PNG_SIGNATURE):
            return _decode_png(data)
        if data[:4] in (b"II*\x00", b"MM\x00*"):
            return _decode_tiff(data)
        if data[:4] in (b"II+\x00", b"MM\x00+"):
            raise UnsupportedImageError("BigTIFF is not supported")
        if data[:2] == b"\xff\xd8":
            return _decode_jpeg(data)
        if data[:2] == b"BM":
            return _decode_bmp(data)
    except (struct.error, KeyError, IndexError, zlib.error) as e:
        raise ValueError(f"{path}: corrupt or truncated file ({type(e).__name__}: {e})") from e
    except ValueError as e:
        raise type(e)(f"{path}: {e}") from None
    raise UnsupportedImageError(f"{path}: unknown image encoding")


def _to_bgr(pix: np.ndarray) -> np.ndarray:
    """[H,W,S] uint8 samples (gray, gray+alpha, RGB or RGBA) -> [H,W,3] BGR."""
    if pix.shape[2] <= 2:
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., 2::-1])


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


def _png_pass(stream: np.ndarray, pos: int, h: int, w: int, bpp: int):
    """Unfilter one h x w image (or Adam7 pass) from ``stream`` at ``pos``
    -> ([h,w,bpp] uint8, next position)."""
    end = pos + h * (1 + w * bpp)
    if end > stream.size:
        raise ValueError("PNG: image data has the wrong length")
    rows = stream[pos:end].reshape(h, 1 + w * bpp)
    return _unfilter_png(rows[:, 1:].reshape(h, w, bpp), rows[:, 0]), end


def _decode_png(data: bytes) -> np.ndarray:
    pos, idat, palette, hdr = 8, [], None, None
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
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise UnsupportedImageError(f"PNG: colour type {ctype} at bit depth {depth} is not supported")
    if interlace not in (0, 1):
        raise UnsupportedImageError(f"PNG: interlace method {interlace} is not supported")
    spp = _PNG_CHANNELS[ctype]
    bpp = spp * depth // 8
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        pix, end = _png_pass(stream, 0, h, w, bpp)
    else:
        pix, end = np.zeros((h, w, bpp), np.uint8), 0
        for x0, y0, dx, dy in _ADAM7:
            ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
            if ph > 0 and pw > 0:  # an empty pass has no scanlines at all
                pix[y0::dy, x0::dx], end = _png_pass(stream, end, ph, pw, bpp)
    if end != stream.size:
        raise ValueError("PNG: image data has the wrong length")
    if depth == 16:
        pix = pix[..., 0::2]  # big-endian samples: keep the high byte
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        pix = palette[pix[..., 0]]
    return _to_bgr(pix)


def _tiff_segment(raw: bytes, comp: int, size: int) -> bytes:
    """One strip or tile, decompressed to at most ``size`` bytes."""
    if comp == 1:
        return raw[:size]
    if comp in (8, 32946):
        d = zlib.decompressobj()
        return d.decompress(raw, size)
    from deepemia_tpu_torch import native

    return native.lzw_decode(raw, size) if comp == 5 else native.packbits_decode(raw, size)


def _decode_tiff(data: bytes) -> np.ndarray:
    end = "<" if data[:2] == b"II" else ">"
    sizes = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4)}
    (ifd,) = struct.unpack(end + "I", data[4:8])
    (n,) = struct.unpack(end + "H", data[ifd : ifd + 2])
    tags = {}
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack(end + "HHI", data[e : e + 8])
        if typ not in sizes:
            continue
        fmt, size = sizes[typ]
        at = e + 8 if count * size <= 4 else struct.unpack(end + "I", data[e + 8 : e + 12])[0]
        tags[tag] = struct.unpack(f"{end}{count}{fmt}", data[at : at + count * size])
    get = lambda t, d: tags.get(t, (d,))  # noqa: E731
    w, h = tags[256][0], tags[257][0]
    spp = get(277, 1)[0]
    bits = set(get(258, 1))
    comp, photometric = get(259, 1)[0], get(262, 1)[0]
    predictor, planar = get(317, 1)[0], get(284, 1)[0]
    if comp not in _TIFF_DECODED:
        raise UnsupportedImageError(
            f"TIFF: {_TIFF_COMPRESSION.get(comp, f'compression {comp}')} compression is not supported"
        )
    # libtiff reads the predictor tag for LZW and Deflate only
    predictor = predictor if comp in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise UnsupportedImageError(f"TIFF: predictor {predictor} is not supported")
    if planar not in (1, 2):
        raise UnsupportedImageError(f"TIFF: planar configuration {planar} is not supported")
    if len(bits) != 1 or bits - {8, 16} or set(get(339, 1)) != {1}:
        raise UnsupportedImageError(f"TIFF: samples of {sorted(bits)} bits, format {get(339, 1)} are not supported")
    if photometric not in (1, 2) or spp not in ((1, 2) if photometric == 1 else (3, 4)):
        raise UnsupportedImageError(f"TIFF: photometric {photometric} with {spp} samples is not supported")
    depth = bits.pop()
    dtype = np.dtype(np.uint8) if depth == 8 else np.dtype(end + "u2")
    sps = spp if planar == 1 else 1  # samples per pixel within one segment
    if 322 in tags:  # tiles, padded to the full tile size at the edges
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        grid = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
        shape_of = lambda y: (th, tw)  # noqa: E731
    else:
        rps = min(get(278, h)[0], h)
        offsets, counts = tags[273], tags[279]
        grid = [(y, 0) for y in range(0, h, rps)]
        shape_of = lambda y: (min(rps, h - y), w)  # noqa: E731
    planes = 1 if planar == 1 else spp
    if len(offsets) < planes * len(grid) or len(counts) < len(offsets):
        raise ValueError("TIFF: fewer strips or tiles than the image needs")
    pix = np.empty((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    for p in range(planes):
        for k, (y, x) in enumerate(grid):
            sh, sw = shape_of(y)
            need = sh * sw * sps * dtype.itemsize
            j = p * len(grid) + k
            seg = _tiff_segment(data[offsets[j] : offsets[j] + counts[j]], comp, need)
            if len(seg) < need:
                raise ValueError("TIFF: a strip or tile holds fewer bytes than it must")
            a = np.frombuffer(seg, dtype).reshape(sh, sw, sps).astype(pix.dtype)
            if predictor == 2:  # horizontal differencing, per sample, modulo 2^bits
                a = np.cumsum(a, axis=1, dtype=pix.dtype)
            ch = slice(None) if planar == 1 else slice(p, p + 1)
            pix[y : y + sh, x : x + sw, ch] = a[: h - y, : w - x]
    if depth == 16:
        v = pix.astype(np.int64)
        pix = ((v * 255 + 32767) // 65535 if photometric == 2 else v >> 8).astype(np.uint8)
    if photometric == 2 and spp == 4 and get(338, 0)[0] == 2:
        # libtiff's RGBA reader premultiplies unassociated alpha
        v = pix.astype(np.int32)
        pix = ((v[..., :3] * v[..., 3:] + 127) // 255).astype(np.uint8)
    return _to_bgr(pix)


def _decode_bmp(data: bytes) -> np.ndarray:
    (pixel_at,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize < 40:
        raise UnsupportedImageError(f"BMP: OS/2 header of {hsize} bytes is not supported")
    w, h, _, bits, comp, _, _, _, ncolors = struct.unpack("<iiHHIIiiI", data[18:50])
    if comp == 3 and bits == 32:
        masks = struct.unpack("<III", data[54:66])
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise UnsupportedImageError(f"BMP: bit fields {[hex(m) for m in masks]} are not supported")
    elif comp != 0:
        raise UnsupportedImageError(f"BMP: compression {comp} (RLE or bit fields) is not supported")
    if bits not in (8, 24, 32):
        raise UnsupportedImageError(f"BMP: {bits}-bit pixels are not supported")
    rows, width = abs(h), w
    stride = (width * bits // 8 + 3) & ~3
    raw = np.frombuffer(data, np.uint8, count=rows * stride, offset=pixel_at).reshape(rows, stride)
    if h > 0:  # bottom-up rows
        raw = raw[::-1]
    if bits == 8:
        ncolors = ncolors or 256
        pal = np.frombuffer(data, np.uint8, count=4 * ncolors, offset=14 + hsize).reshape(-1, 4)[:, :3]
        idx = raw[:, :width]
        if int(idx.max(initial=0)) >= len(pal):
            raise ValueError("BMP: a pixel indexes past the palette")
        return np.ascontiguousarray(pal[idx])
    return np.ascontiguousarray(raw[:, : width * bits // 8].reshape(rows, width, bits // 8)[..., :3])


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

_JPEG_CODINGS = {
    0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCC: "arithmetic coding (DAC)", 0xCD: "differential arithmetic-coded sequential (SOF13)",
    0xCE: "differential arithmetic-coded progressive (SOF14)", 0xCF: "differential arithmetic-coded lossless (SOF15)",
}


def _decode_jpeg(data: bytes) -> np.ndarray:
    from deepemia_tpu_torch import native

    status, meta, pix = native.jpeg_decode(data)
    if status == 0:
        return _orient(pix, _exif_orientation(data))
    if status == -2:
        coding = int(meta[3])
        raise UnsupportedImageError(f"JPEG: {_JPEG_CODINGS.get(coding, f'SOF marker 0x{coding:02X}')} is not supported")
    if status == -3:
        raise UnsupportedImageError(f"JPEG: {int(meta[2]) or 'these'} components (CMYK, YCCK) are not supported")
    if status == -4:
        raise UnsupportedImageError("JPEG: sample precision other than 8 bits (12-bit) is not supported")
    if status == -5:
        raise UnsupportedImageError(
            "JPEG: a progressive image whose scans leave low coefficients unrefined (libjpeg's block "
            "smoothing) is not supported"
        )
    raise ValueError("JPEG: corrupt, or cut off before its pixel data")


def _exif_orientation(data: bytes) -> int:
    """The Orientation tag (0x0112) of the first APP1 Exif segment, or 1;
    an unreadable Exif block reads as 1, as OpenCV ignores it."""
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
        if marker != 0xE1 or not body.startswith(b"Exif\x00\x00"):
            continue
        tiff = body[6:]
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

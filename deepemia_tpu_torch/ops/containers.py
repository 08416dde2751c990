"""Decoders of the image containers ``read_image`` reads beside PNG, TIFF,
JPEG and BMP, each as OpenCV 5.0's ``cv2.imread(path, IMREAD_COLOR)``
reads it: the PNM family (``grfmt_pxm.cpp``), PAM (``grfmt_pam.cpp``),
PFM (``grfmt_pfm.cpp``), Sun raster (``grfmt_sunras.cpp``), Radiance HDR
(``grfmt_hdr.cpp`` with ``rgbe.cpp``), GIF (``grfmt_gif.cpp``) and WebP
(libwebp, ``native/webp.cpp``).

OpenCV's own misreads are copied where they are defined (a PAM RGB raster
keeps its R, G, B order; an ASCII PGM scales by ``v * 255 // maxval``
while a binary one does not; a float past the range of int32 becomes 0),
and named where they are not. What OpenCV refuses raises
``RefusedImageError``; a file cut off or damaged where OpenCV returns None,
a ``ValueError``."""

from __future__ import annotations

import re
import struct

import numpy as np

from deepemia_tpu_torch.ops.image import RefusedImageError

# C's isspace: space, \t, \n, \v, \f, \r
_SPACE = b" \t\n\x0b\x0c\r"
_IS_SPACE = np.zeros(256, bool)
_IS_SPACE[list(_SPACE)] = True
_IS_DIGIT = np.zeros(256, bool)
_IS_DIGIT[48:58] = True
# OpenCV's ReadNumber: whitespace and '#' comments (to \n or \r), then digits
_NUMBER = re.compile(rb"(?:[ \t\n\x0b\x0c\r]|#[^\n\r]*[\n\r])*(\d+)")
_DIGIT = re.compile(rb"(?:[ \t\n\x0b\x0c\r]|#[^\n\r]*[\n\r])*(\d)")
_INT_MAX = 2**31 - 1
_MAX_SIDE = 1 << 20  # imread's validateInputImageSize: CV_IO_MAX_IMAGE_WIDTH / HEIGHT
_MAX_PIXELS = 1 << 30


def _check_size(kind: str, w: int, h: int) -> None:
    """imread's ``validateInputImageSize``, which raises (not None) in cv2."""
    if not (0 < w <= _MAX_SIDE and 0 < h <= _MAX_SIDE and w * h <= _MAX_PIXELS):
        raise ValueError(f"{kind}: an image of {w}x{h} pixels")


# ---------------------------------------------------------------------------
# PNM: PBM, PGM and PPM, ASCII (P1-P3) and binary (P4-P6)
# ---------------------------------------------------------------------------


def _read_number(data: bytes, pos: int, one_digit: bool = False):
    """OpenCV's ``ReadNumber`` at ``pos`` -> (value, next position): the
    digits and, unless ``one_digit``, the one character after them, which
    it consumes whatever it is (the end of the file there is an error)."""
    m = (_DIGIT if one_digit else _NUMBER).match(data, pos)
    if m is None:
        raise ValueError("PNM: a number expected")
    value = int(m.group(1))
    if value > _INT_MAX:
        raise ValueError("PNM: a number past INT_MAX")
    if one_digit:
        return value, m.end()
    if m.end() >= len(data):
        raise ValueError("PNM: the file ends after a number")
    return value, m.end() + 1


def _ascii_raster(data: bytes, pos: int, n: int, one_digit: bool) -> np.ndarray:
    """The next ``n`` ReadNumber values from ``pos`` -> int64 [n]. Where the
    stretch they take holds nothing but digits and whitespace, numpy reads
    it; otherwise (comments, or other characters eaten after a number) it
    is read number by number."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    digit = _IS_DIGIT[arr]
    if one_digit:
        at = np.flatnonzero(digit)
        if at.size >= n and (n == 0 or (digit | _IS_SPACE[arr])[: at[n - 1] + 1].all()):
            return (arr[at[:n]] - 48).astype(np.int64)
    else:
        # a run of digits ends where the next byte is not a digit: that byte is its terminator
        ends = np.flatnonzero(digit & ~np.append(digit[1:], False))
        if ends.size >= n and (n == 0 or (ends[n - 1] + 1 < arr.size
                                          and (digit | _IS_SPACE[arr])[: ends[n - 1] + 2].all())):
            stop = 0 if n == 0 else ends[n - 1] + 1
            tokens = data[pos : pos + stop].split()
            try:
                values = np.array(tokens, dtype=np.bytes_).astype(np.int64) if tokens else np.zeros(0, np.int64)
            except OverflowError:
                values = np.array([_INT_MAX + 1])
            if values.size and values.max() > _INT_MAX:
                raise ValueError("PNM: a number past INT_MAX")
            return values
    out = np.empty(n, np.int64)
    for i in range(n):
        out[i], pos = _read_number(data, pos, one_digit)
    return out


def decode_pnm(data: bytes) -> np.ndarray:
    """P1-P6 (``PxMDecoder``). An ASCII sample above maxval is maxval, and
    one at 8 bits maps through ``v * 255 // maxval``; a binary 8-bit sample
    stays as stored (above maxval too); a maxval over 255 takes samples as
    16 bits, the high byte kept (binary ones big-endian, not clamped).
    PBM's 1 is black."""
    code = data[1] - 48
    bpp = {1: 1, 2: 8, 3: 24, 4: 1, 5: 8, 6: 24}[code]
    binary = code >= 4
    w, pos = _read_number(data, 2)
    h, pos = _read_number(data, pos)
    maxval = 1
    if bpp > 1:
        maxval, pos = _read_number(data, pos)
    if maxval > 65535 or maxval == 0 or w == 0 or h == 0:
        raise ValueError(f"PNM: a header of {w}x{h}, maxval {maxval}")
    _check_size("PNM", w, h)
    nch = 3 if bpp == 24 else 1
    wide = maxval > 255
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            raw = _take(data, pos, h * pitch, "PNM").reshape(h, pitch)
            bits = np.unpackbits(raw, axis=1)[:, :w]
        else:
            bits = (_ascii_raster(data, pos, w * h, True) != 0).reshape(h, w)
        return np.repeat((255 * (1 - bits)).astype(np.uint8)[..., None], 3, axis=2)
    if binary:
        raw = _take(data, pos, h * w * nch * (2 if wide else 1), "PNM")
        pix = (raw.view(">u2") >> 8).astype(np.uint8) if wide else raw
    else:
        v = np.minimum(_ascii_raster(data, pos, w * h * nch, False), maxval)
        pix = (v >> 8).astype(np.uint8) if wide else (v * 255 // maxval).astype(np.uint8)
    pix = pix.reshape(h, w, nch)
    return np.repeat(pix, 3, axis=2) if nch == 1 else np.ascontiguousarray(pix[..., ::-1])


def _take(data: bytes, pos: int, n: int, kind: str) -> np.ndarray:
    if pos + n > len(data):
        raise ValueError(f"{kind}: the file ends inside its raster")
    return np.frombuffer(data, np.uint8, count=n, offset=pos)


# ---------------------------------------------------------------------------
# PAM (P7)
# ---------------------------------------------------------------------------

_PAM_TYPES = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA")
_PAM_DEPTHS = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}
_PAM_FIELDS = ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE", "ENDHDR")


def _pam_line(data: bytes, pos: int):
    """OpenCV's ``ReadPAMHeaderLine`` -> (field or None for a comment, its
    value, next position): whitespace (line ends too) skipped, an
    identifier of at most 8 characters ended by whitespace, then, unless a
    line end follows it at once, whitespace skipped again and the value up
    to \\n or \\r (at most 16 characters), trailing whitespace trimmed."""
    n = len(data)
    while pos < n and data[pos] in _SPACE:
        pos += 1
    if pos >= n:
        raise ValueError("PAM: the header ends early")
    if data[pos] == 35:  # '#'
        end = min((i for i in (data.find(b"\n", pos), data.find(b"\r", pos)) if i >= 0), default=-1)
        if end < 0:
            raise ValueError("PAM: the header ends early")
        return None, b"", end + 1
    start = pos
    while pos < n and pos - start < 8 and data[pos] not in _SPACE:
        pos += 1
    if pos >= n or data[pos] not in _SPACE:
        raise ValueError("PAM: a header line OpenCV does not parse")
    ident = data[start:pos].decode("latin-1")
    if ident not in _PAM_FIELDS:
        raise ValueError(f"PAM: an unknown header field {ident!r}")
    if data[pos] in b"\n\r":
        return ident, b"", pos + 1
    pos += 1
    while pos < n and data[pos] in _SPACE:
        pos += 1
    start = pos
    while pos < n and pos - start < 16 and data[pos] not in b"\n\r":
        pos += 1
    if pos >= n or data[pos] not in b"\n\r":
        raise ValueError("PAM: a header value OpenCV does not parse")
    return ident, data[start:pos].rstrip(_SPACE), pos + 1


def _pam_int(value: bytes) -> int:
    """OpenCV's ``ParseInt``: an optional '-' and digits, nothing after."""
    if not re.fullmatch(rb"(?:-?\d+)?", value):
        raise ValueError(f"PAM: a header value {value!r}")
    v = int(value or b"0")
    if abs(v) >= _INT_MAX:
        raise ValueError("PAM: a header value past INT_MAX")
    return v


def decode_pam(data: bytes) -> np.ndarray:
    """P7 (``PAMDecoder``). Without a TUPLTYPE, DEPTH 1 at MAXVAL 1 is
    BLACKANDWHITE, DEPTH 1 or 3 at a MAXVAL below 256 GRAYSCALE or RGB.
    MAXVAL 1 (any tuple type) is OpenCV's bit mode: each row's bytes (one a
    sample) are read as packed bits, 1 white. Samples are not scaled; past
    255 the high byte of a big-endian 16-bit sample is kept. An RGB raster
    keeps its R, G, B order (OpenCV does not swap it). GRAYSCALE_ALPHA and
    RGB_ALPHA give gray and B, G, R; OpenCV sets only the first
    ceil(W / DEPTH) pixels of each row there and leaves the rest of the
    row unset (``basic_conversion`` stops at ``src + width``)."""
    if data[2] not in b"\n\r":
        raise ValueError("PAM: no line end after P7")
    pos, fields, tupltype = 3, {}, None
    while True:
        ident, value, pos = _pam_line(data, pos)
        if ident is None:
            continue
        if ident == "ENDHDR":
            break
        if ident == "TUPLTYPE":  # the last one holds; an empty one leaves the type to DEPTH and MAXVAL
            tupltype = value.decode("latin-1") or None
            if tupltype is not None and tupltype not in _PAM_TYPES:
                raise RefusedImageError(f"PAM: TUPLTYPE {tupltype!r} is not supported")
            continue
        if ident in fields:
            raise ValueError(f"PAM: {ident} given twice")
        fields[ident] = _pam_int(value)
        if ident == "MAXVAL" and fields[ident] > 65535:
            raise ValueError("PAM: MAXVAL past 65535")
    if len(fields) < 4:
        raise ValueError(f"PAM: a header without {sorted(set(_PAM_FIELDS[:4]) - set(fields))}")
    w, h, depth, maxval = fields["WIDTH"], fields["HEIGHT"], fields["DEPTH"], fields["MAXVAL"]
    if tupltype is None:
        if depth == 1 and maxval == 1:
            tupltype = "BLACKANDWHITE"
        elif depth in (1, 3) and maxval < 256:
            tupltype = "GRAYSCALE" if depth == 1 else "RGB"
        else:
            raise RefusedImageError(f"PAM: DEPTH {depth} at MAXVAL {maxval} without a TUPLTYPE is not supported")
    if depth != _PAM_DEPTHS[tupltype]:
        raise RefusedImageError(f"PAM: TUPLTYPE {tupltype} of DEPTH {depth} is not supported")
    _check_size("PAM", w, h)
    wide = maxval > 255
    raw = _take(data, pos, h * w * depth * (2 if wide else 1), "PAM").reshape(h, w * depth * (2 if wide else 1))
    if maxval == 1:  # bit mode: FillColorRow1 over the row's first bytes
        bits = np.unpackbits(raw, axis=1)[:, :w]
        return np.repeat((255 * bits).astype(np.uint8)[..., None], 3, axis=2)
    pix = ((raw.view(">u2") >> 8).astype(np.uint8) if wide else raw).reshape(h, w, depth)
    if depth == 3:
        return np.ascontiguousarray(pix)
    if depth == 4:
        return np.ascontiguousarray(pix[..., 2::-1])
    return np.repeat(pix[..., :1], 3, axis=2)


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

_STRTOD = re.compile(
    rb"[+-]?(?:(?P<hex>0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?)"
    rb"|(?P<dec>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)|(?P<inf>[iI][nN][fF](?:[iI][nN][iI][tT][yY])?)"
    rb"|(?P<nan>[nN][aA][nN]))")


def _pfm_token(data: bytes, pos: int):
    """OpenCV's ``read_number``: the bytes up to the first whitespace, which
    it consumes (a byte past 127 is an error) -> (token, next position)."""
    start = pos
    while True:
        if pos >= len(data):
            raise ValueError("PFM: the header ends early")
        c = data[pos]
        if c >= 128:
            raise ValueError("PFM: a header byte past 127")
        pos += 1
        if c in _SPACE:
            return data[start : pos - 1], pos


def _atoi(token: bytes) -> int:
    m = re.match(rb"[+-]?\d+", token)
    if m is None:
        return 0
    v = max(min(int(m.group()), 2**63 - 1), -(2**63))  # strtol, then the cast to int
    return (v + 2**31) % 2**32 - 2**31


def _atof(token: bytes) -> float:
    m = _STRTOD.match(token)
    if m is None:
        return 0.0
    sign = -1.0 if token[:1] == b"-" else 1.0
    if m.group("hex"):
        text = m.group("hex").decode()
        return sign * float.fromhex(text if re.search("[pP]", text) else text + "p0")
    if m.group("inf"):
        return sign * np.inf
    if m.group("nan"):
        return np.nan
    return sign * float(m.group("dec"))


def decode_pfm(data: bytes) -> np.ndarray:
    """PF (``PFMDecoder``): rows bottom to top, little-endian where the
    scale is negative, each sample times float32(1 / |scale|), then to 8
    bits by ``native.float_to_u8`` (no x255). A gray ``Pf`` file is
    refused: under IMREAD_COLOR OpenCV 5.0 converts it to one channel where
    imread holds three, and returns None."""
    if data[2] != 10:
        raise ValueError("PFM: no line end after the signature")
    w_tok, pos = _pfm_token(data, 3)
    h_tok, pos = _pfm_token(data, pos)
    s_tok, pos = _pfm_token(data, pos)
    w, h, scale = _atoi(w_tok), _atoi(h_tok), _atof(s_tok)
    _check_size("PFM", w, h)
    if data[1] == ord("f"):
        raise RefusedImageError("PFM: gray (Pf) under IMREAD_COLOR is not supported")
    if not abs(scale) > 0:
        raise ValueError(f"PFM: a scale of {scale}")
    from deepemia_tpu_torch import native

    raw = _take(data, pos, h * w * 12, "PFM")
    v = raw.view("<f4" if scale < 0 else ">f4").reshape(h, w, 3)[::-1].astype(np.float32)
    return np.ascontiguousarray(native.float_to_u8(v, float(np.float32(1.0 / abs(scale))))[..., ::-1])


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------

SUN_MAGIC = b"\x59\xa6\x6a\x95"
_SUN_TYPES = {2: "byte-encoded (RLE)", 3: "RGB-ordered"}


def decode_sun(data: bytes) -> np.ndarray:
    """Sun raster (``SunRasterDecoder``): depths 1, 8, 24 and 32, types
    RT_OLD and RT_STANDARD (OpenCV 5.0 returns None for RT_BYTE_ENCODED,
    RT_FORMAT_RGB and the rest), no colour map or an RMT_EQUAL_RGB one of at
    most 3 << depth bytes at 1 and 8 bits; rows padded to 16 bits. 1-bit
    without a map: 1 white; 24 bits as B, G, R; 32 as X, B, G, R."""
    if len(data) < 32:
        raise ValueError("Sun raster: the header is cut off")
    _, w, h, bpp, _, typ, maptype, maplength = struct.unpack(">8i", data[:32])
    if w <= 0 or h <= 0 or bpp not in (1, 8, 24, 32):
        raise RefusedImageError(f"Sun raster: {w}x{h} at depth {bpp} is not supported")
    palsize = 3 << bpp if bpp <= 8 else 0
    if not ((maptype == 0 and maplength == 0) or (maptype == 1 and 0 < maplength <= palsize)):
        raise RefusedImageError(f"Sun raster: a colour map of type {maptype}, {maplength} bytes at depth {bpp} "
                                "is not supported")
    if typ not in (0, 1):
        raise RefusedImageError(f"Sun raster: type {typ} ({_SUN_TYPES.get(typ, 'unknown')}) is not supported")
    _check_size("Sun raster", w, h)
    palette = np.zeros((256, 3), np.uint8)
    if maplength:
        n = maplength // 3
        cmap = _take(data, 32, maplength, "Sun raster")
        palette[:n] = cmap[: 3 * n].reshape(3, n).T[:, ::-1]
    elif bpp <= 8:
        palette[:] = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        if bpp == 1:
            palette[1] = 255
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    raw = _take(data, 32 + maplength, h * pitch, "Sun raster").reshape(h, pitch)
    if bpp == 1:
        return np.take(palette, np.unpackbits(raw, axis=1)[:, :w], axis=0)
    if bpp == 8:
        if not maplength:
            return np.repeat(raw[:, :w, None], 3, axis=2)
        return np.take(palette, raw[:, :w], axis=0)
    if bpp == 24:
        return np.ascontiguousarray(raw[:, : 3 * w].reshape(h, w, 3))
    return np.ascontiguousarray(raw[:, : 4 * w].reshape(h, w, 4)[..., 1:])


# ---------------------------------------------------------------------------
# Radiance HDR
# ---------------------------------------------------------------------------


def _fgets(data: bytes, pos: int):
    """C's ``fgets`` into a 128-byte buffer -> (line, next position)."""
    if pos >= len(data):
        raise ValueError("HDR: the header ends early")
    end = data.find(b"\n", pos, pos + 127)
    stop = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:stop], stop


def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE (``HdrDecoder``, ``RGBE_ReadHeader`` and
    ``RGBE_ReadPixels_RLE``): a ``FORMAT=32-bit_rle_rgbe`` line, a blank
    line, and only the ``-Y H +X W`` orientation; EXPOSURE and GAMMA are
    read and not applied. Scanlines 8 to 32767 wide may be new-style RLE
    (per channel); once a scanline does not start with 2, 2, the rest of
    the image is read flat (old-style RLE runs too, as plain pixels). Each
    pixel's mantissas times 2^(e - 136), in float32, then x255 to 8 bits by
    ``native.float_to_u8``."""
    from deepemia_tpu_torch import native

    line, pos = _fgets(data, 0)
    found = False
    while True:
        if line[:1] in (b"", b"\x00", b"\n"):
            if not found:
                raise RefusedImageError("HDR: no FORMAT=32-bit_rle_rgbe line (only RGBE is supported)")
            break
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            found = True
        line, pos = _fgets(data, pos)
    if line != b"\n":
        raise ValueError("HDR: no blank line after the FORMAT line")
    line, pos = _fgets(data, pos)
    m = re.match(rb"-Y[ \t\n\x0b\x0c\r]*([+-]?\d+)[ \t\n\x0b\x0c\r]*\+X[ \t\n\x0b\x0c\r]*([+-]?\d+)", line)
    if m is None:
        raise RefusedImageError(f"HDR: the size line {line[:40]!r} (only -Y H +X W) is not supported")
    h, w = int(m.group(1)), int(m.group(2))
    if w <= 0 or h <= 0:
        raise ValueError(f"HDR: an image of {w}x{h}")
    _check_size("HDR", w, h)
    return native.float_to_u8(native.hdr_decode(data[pos:], w, h), rgbe=True)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _skip_blocks(data: bytes, pos: int) -> int:
    """The position after the data sub-blocks that start at ``pos``."""
    while True:
        n = data[pos]
        if n == 0:
            return pos + 1
        pos += 1 + n
        if pos > len(data):
            raise ValueError("GIF: the file ends inside a data block")


def decode_gif(data: bytes) -> np.ndarray:
    """GIF 87a/89a (OpenCV 5.0's ``GifDecoder``): the first frame on a
    canvas of the logical screen, filled with the global table's background
    colour (black without a global table); the frame's transparent pixels
    (its Graphic Control Extension's) keep the canvas; its local table, the
    global one, or without either OpenCV's own (gray levels, 1 white);
    interlaced rows in their four passes. OpenCV checks the
    block structure of the whole file up to its trailer, refuses a frame
    past the screen, a disposal method past 3, an LZW code size outside 2
    to 11 and an index past the table, and returns None for LZW data that
    is short or corrupt, and for some that goes on past the frame
    (``native.gif_lzw_decode``)."""
    from deepemia_tpu_torch import native

    sw, sh, flags, background = struct.unpack("<HHBB", data[6:12])
    if sw == 0 or sh == 0:
        raise ValueError("GIF: a logical screen of no pixels")
    pos, gct = 13, None
    if flags & 0x80:
        n = 1 << ((flags & 7) + 1)
        gct = np.frombuffer(data, np.uint8, count=3 * n, offset=pos).reshape(n, 3)
        pos += 3 * n
        if background >= n:
            raise ValueError(f"GIF: background index {background} past a table of {n}")
    start, frames, at = pos, 0, pos
    while data[at] != 0x3B:  # getFrameCount_: every block up to the trailer
        kind = data[at]
        if kind == 0x21:
            if data[at + 1] == 0xFF and data[at + 2]:
                # OpenCV reads an application extension's second block of 3 bytes as NETSCAPE2.0's loop
                # count, and fails on one of any other name
                ident_end = at + 3 + data[at + 2]
                if data[ident_end] == 3 and data[at + 3 : ident_end] != b"NETSCAPE2.0":
                    raise ValueError("GIF: a 3-byte application block not of NETSCAPE2.0")
            at = _skip_blocks(data, at + 2)
        elif kind == 0x2C:
            frames += 1
            fl = data[at + 9]
            at += 10 + (3 << ((fl & 7) + 1) if fl & 0x80 else 0) + 1
            at = _skip_blocks(data, at)
        else:
            raise ValueError(f"GIF: a block of type 0x{kind:02X}")
    if not frames:
        raise ValueError("GIF: no image")
    pos, transparent, disposal = start, None, 0
    while data[pos] == 0x21:  # readExtensions: the Graphic Control Extension before the frame
        if data[pos + 1] == 0xF9:
            if data[pos + 2] != 4:
                raise ValueError("GIF: a Graphic Control Extension of other than 4 bytes")
            gflags = data[pos + 3]
            disposal = (gflags >> 2) & 7
            transparent = data[pos + 6] if gflags & 1 else None
            pos += 7
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
        else:
            pos = _skip_blocks(data, pos + 2)
    if data[pos] != 0x2C:
        raise ValueError("GIF: no image after the extensions")
    left, top, w, h, fl = struct.unpack("<HHHHB", data[pos + 1 : pos + 10])
    if not (w and h and left + w <= sw and top + h <= sh):
        raise ValueError(f"GIF: a frame of {w}x{h} at ({left}, {top}) on a screen of {sw}x{sh}")
    if disposal > 3:
        raise RefusedImageError(f"GIF: disposal method {disposal} is not supported")
    _check_size("GIF", sw, sh)
    canvas = np.zeros((sh, sw, 3), np.uint8)
    if gct is not None:
        canvas[:] = gct[background, ::-1]
    pos += 10
    if fl & 0x80:
        n = 1 << ((fl & 7) + 1)
        table = np.frombuffer(data, np.uint8, count=3 * n, offset=pos).reshape(n, 3)
        pos += 3 * n
    elif gct is not None:
        table = gct
    else:  # OpenCV's table where the file gives none: gray levels, but 1 white
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        table[1] = 255
    min_size = data[pos]
    codes = native.gif_lzw_decode(data[pos + 1 : _skip_blocks(data, pos + 1)], w * h, min_size).reshape(h, w)
    if fl & 0x40:  # interlaced: rows 0, 8, 16, ..., then 4, 12, ..., then 2, 6, ..., then 1, 3, ...
        order = np.concatenate([np.arange(s, h, k) for s, k in ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(codes)
        rows[order] = codes
        codes = rows
    hidden = codes == transparent if transparent is not None else None
    if int(codes.max()) >= len(table) and (hidden is None or (codes[~hidden] >= len(table)).any()):
        raise ValueError(f"GIF: an index past a colour table of {len(table)}")
    bgr = np.take(np.ascontiguousarray(table[:, ::-1]), codes, axis=0, mode="clip")
    region = canvas[top : top + h, left : left + w]
    region[...] = bgr if hidden is None or not hidden.any() else np.where(hidden[..., None], region, bgr)
    return canvas


# ---------------------------------------------------------------------------
# WebP
# ---------------------------------------------------------------------------


def _le(data: bytes, at: int, n: int) -> int:
    if at + n > len(data):
        raise ValueError("WebP: the file ends inside a header")
    return int.from_bytes(data[at : at + n], "little")


def decode_webp(data: bytes) -> np.ndarray:
    """WebP (libwebp's ``WebPDecodeBGR`` as OpenCV calls it): the RIFF
    header (its size within the file), an optional VP8X chunk (whose
    canvas must be the bitstream's size; ICCP, EXIF, XMP, ALPH and unknown
    chunks skipped, alpha dropped under IMREAD_COLOR), then a VP8L or VP8
    bitstream, decoded in ``native/webp.cpp`` from its first byte to the end
    of the file."""
    from deepemia_tpu_torch import native

    riff_size = _le(data, 4, 4)
    if riff_size < 12 or riff_size > 0xFFFFFFFF - 9:
        raise ValueError(f"WebP: a RIFF size of {riff_size}")
    if riff_size > len(data) - 8:
        raise ValueError("WebP: the file is shorter than its RIFF size")
    pos, canvas = 12, None
    if data[pos : pos + 4] == b"VP8X":
        if _le(data, pos + 4, 4) != 10:
            raise ValueError("WebP: a VP8X chunk of other than 10 bytes")
        flags = data[pos + 8]
        canvas = (1 + _le(data, pos + 12, 3), 1 + _le(data, pos + 15, 3))
        pos += 18
        if flags & 0x02:
            return _webp_animation(data, pos, canvas)
        total, alpha = 12 + 18, None
        while True:  # ParseOptionalChunks: up to the image's chunk; the last ALPH holds
            if pos + 8 > len(data):
                raise ValueError("WebP: no VP8 or VP8L chunk")
            if data[pos : pos + 4] in (b"VP8 ", b"VP8L"):
                break
            size = _le(data, pos + 4, 4)
            disk = 8 + ((size + 1) & ~1)
            total += disk
            if total > riff_size or pos + disk > len(data):
                raise ValueError("WebP: a chunk past the end of the file")
            if data[pos : pos + 4] == b"ALPH":
                alpha = data[pos + 8 : pos + 8 + size]
            pos += disk
        return _webp_bitstream(data, pos, riff_size, canvas, alpha)
    return _webp_bitstream(data, pos, riff_size, canvas)


def _webp_bitstream(data: bytes, pos: int, riff_size: int, canvas, alpha: bytes = None) -> np.ndarray:
    """ParseVP8Header, then VP8GetInfo or VP8LGetInfo, then the decode. A
    lossy image's ALPH payload is decoded and dropped: libwebp decodes it
    whatever the output, and fails the image where it cannot."""
    from deepemia_tpu_torch import native

    w, h, lossless = _webp_info(data, pos, riff_size)
    if canvas is not None and canvas != (w, h):
        raise ValueError(f"WebP: a canvas of {canvas} for an image of {(w, h)}")
    _check_size("WebP", w, h)
    if alpha is not None and not lossless and not native.webp_alpha_check(alpha, w, h):
        raise ValueError("WebP: an ALPH chunk libwebp does not decode")
    return native.webp_decode(data[pos + 8 :], lossless, w, h)


def _webp_info(data: bytes, pos: int, riff_size: int):
    """The VP8 or VP8L chunk at ``pos`` -> (width, height, lossless), with
    the checks of ParseVP8Header and VP8GetInfo / VP8LGetInfo."""
    tag = data[pos : pos + 4]
    if tag not in (b"VP8 ", b"VP8L"):
        raise ValueError(f"WebP: a {tag!r} chunk where the image was expected")
    size = _le(data, pos + 4, 4)
    if riff_size >= 12 and size > riff_size - 12:
        raise ValueError("WebP: an image chunk larger than the RIFF")
    if size > len(data) - pos - 8:
        raise ValueError("WebP: the image chunk is cut off")
    body = data[pos + 8 :]
    if tag == b"VP8L":
        if len(body) < 5 or body[0] != 0x2F or body[4] >> 5:
            raise ValueError("WebP: a VP8L header libwebp does not read")
        bits = _le(body, 1, 4)
        w, h = 1 + (bits & 0x3FFF), 1 + ((bits >> 14) & 0x3FFF)
    else:
        if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
            raise ValueError("WebP: a VP8 header libwebp does not read")
        bits = _le(body, 0, 3)
        if bits & 1:
            raise RefusedImageError("WebP: a VP8 inter frame (not a key frame) is not supported")
        if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= size:
            raise ValueError("WebP: a VP8 frame header libwebp does not read")
        w, h = _le(body, 6, 2) & 0x3FFF, _le(body, 8, 2) & 0x3FFF
        if not w or not h:
            raise ValueError("WebP: a VP8 frame of no pixels")
    return w, h, tag == b"VP8L"


def _webp_animation(data: bytes, pos: int, canvas) -> np.ndarray:
    """An animated WebP as OpenCV 5.0 reads it (WebPAnimDecoder over
    WebPDemux): every chunk of the file parsed, an ANIM chunk before the
    first ANMF and no image outside a frame. A frame's payload holds an
    optional ALPH, then a VP8 or VP8L chunk whose bitstream sets the frame's
    size, inside the canvas; parsing leaves a frame at its first other chunk
    and goes on there as at the top level, a frame without either chunk is
    dropped, and one with an ALPH and no image fails the file. The first
    frame is decoded onto a canvas of zeros at its offset."""
    from deepemia_tpu_torch import native

    end = 8 + _le(data, 4, 4)
    anim, first = False, None
    while pos < end:
        if pos + 8 > end:
            raise ValueError("WebP: a chunk header past the end of the file")
        tag, size = data[pos : pos + 4], _le(data, pos + 4, 4)
        padded = size + (size & 1)
        if tag in (b"VP8X", b"ALPH", b"VP8 ", b"VP8L"):
            raise ValueError(f"WebP: a {tag!r} chunk outside the frames of an animation")
        if pos + 8 + padded > end:
            raise ValueError("WebP: a chunk past the end of the file")
        if tag == b"ANIM":
            if padded < 6:
                raise ValueError("WebP: an ANIM chunk of fewer than 6 bytes")
            anim = True
        elif tag == b"ANMF":
            if not anim:
                raise ValueError("WebP: a frame before the ANIM chunk")
            if padded < 16:
                raise ValueError("WebP: an ANMF chunk of fewer than 16 bytes")
            frame, stop = _webp_frame(data, pos + 8, pos + 8 + padded, end, canvas)
            first = first or frame
            pos = stop
            continue
        pos += 8 + padded
    if first is None:
        raise ValueError("WebP: an animation without frames")
    x, y, w, h, lossless, alpha, bitstream = first
    if alpha is not None and not lossless and not native.webp_alpha_check(alpha, w, h):
        raise ValueError("WebP: an ALPH chunk libwebp does not decode")
    out = np.zeros((canvas[1], canvas[0], 3), np.uint8)
    out[y : y + h, x : x + w] = native.webp_decode(bitstream, lossless, w, h)
    return out


def _webp_frame(data: bytes, at: int, frame_end: int, end: int, canvas):
    """ParseAnimationFrame and StoreFrame on the ANMF payload at ``at`` ->
    ((x, y, width, height, lossless, ALPH payload or None, the image chunk's
    payload) or None for a dropped frame, where parsing goes on)."""
    x, y = 2 * _le(data, at, 3), 2 * _le(data, at + 3, 3)
    pos, alpha, image = at + 16, None, None
    while pos + 8 <= end:
        tag, size = data[pos : pos + 4], _le(data, pos + 4, 4)
        padded = size + (size & 1)
        if pos + 8 + padded > end:
            raise ValueError("WebP: a frame chunk past the end of the file")
        if tag == b"ALPH":
            if alpha is not None:
                break
            if image is not None:
                raise ValueError("WebP: a frame's ALPH chunk after its image")
            alpha = data[pos + 8 : pos + 8 + size]
        elif tag in (b"VP8 ", b"VP8L"):
            if image is not None:
                break
            if tag == b"VP8L" and alpha is not None:
                raise ValueError("WebP: an ALPH chunk before a VP8L image")
            image = pos
        else:
            break
        pos += 8 + padded
    if pos > frame_end:
        raise ValueError("WebP: a frame's chunks past its ANMF chunk")
    if image is None:
        if alpha is not None:
            raise ValueError("WebP: a frame with an ALPH chunk and no image")
        return None, pos
    w, h, lossless = _webp_info(data, image, 0)
    if x + w > canvas[0] or y + h > canvas[1]:
        raise ValueError(f"WebP: a frame of {w}x{h} at ({x}, {y}) past the canvas {canvas}")
    size = _le(data, image + 4, 4)
    return (x, y, w, h, lossless, alpha, data[image + 8 : image + 8 + size + (size & 1)]), pos

"""JPEG 2000 as OpenCV 5.0's ``cv2.imread(path, IMREAD_COLOR)`` reads it
through OpenJPEG 2.5 (``grfmt_jpeg2000_openjpeg.cpp``): the JP2 file
format (``jp2.c``: the boxes, the palette and the channel definitions)
around the codestream decoder of ``native/jpeg2000.cpp``, then OpenCV's
own last step, component count and colour space to 8-bit BGR, every
sample shifted right by the largest precision less 8.

What OpenCV refuses raises ``RefusedImageError``: a raw codestream of one
or two components (sRGB is assumed, and needs three), an image offset or
subsampled components ("tiles are not supported"), a signed component,
more than four components, a precision below 8, a CMYK or e-sYCC colour
space. A file OpenJPEG fails on (cut short, damaged) raises a
``ValueError``; a High-Throughput (Part 15) codestream (its code-blocks
in the HT style), or one with a Part 2 marker, which OpenCV may read and
the port does not decode, ``UnsupportedImageError``."""

from __future__ import annotations

import numpy as np

from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
_MAX_SIDE = 1 << 20  # imread's validateInputImageSize
_MAX_PIXELS = 1 << 30
# the colr box's enumerated colour spaces -> OpenJPEG's (jp2.c, opj_jp2_decode); any other is unknown
_ENUMCS = {16: "sRGB", 17: "gray", 18: "sYCC", 24: "e-sYCC", 12: "CMYK"}


def _be(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise ValueError("JPEG 2000: a box ends early")
    return int.from_bytes(data[pos : pos + n], "big")


class _Colour:
    """What the jp2h box holds of colour (``opj_jp2_color_t``)."""

    def __init__(self):
        self.enumcs = 0  # 0: none read, or an ICC profile
        self.has_colr = False
        self.pclr = None  # (channel sizes, channel signs, entries [n, channels])
        self.cmap = None  # [(cmp, mtyp, pcol)]
        self.cdef = None  # [(cn, typ, asoc)]
        self.size = None  # the ihdr box's (width, height)


def _boxes(data: bytes, pos: int, end: int):
    """The boxes from ``pos`` (``opj_jp2_read_boxhdr``) -> (type, start of
    the payload, its end), a length of 0 running to ``end``."""
    while pos + 8 <= end:
        length, kind = _be(data, pos, 4), data[pos + 4 : pos + 8]
        head = 8
        if length == 1:
            length, head = _be(data, pos + 8, 8), 16
        elif length == 0:
            length = end - pos
        if length < head:
            raise ValueError(f"JPEG 2000: a box of {length} bytes")
        yield kind, pos + head, pos + length
        pos += length


def _sub_boxes(data: bytes, pos: int, end: int):
    """The boxes inside a superbox (``opj_jp2_read_boxhdr_char``) ->
    (type, start of the payload, its end): each header whole, no length 0,
    none past the superbox."""
    while pos < end:
        if end - pos < 8:
            raise ValueError("JPEG 2000: a box of less than 8 bytes")
        length, kind, head = _be(data, pos, 4), data[pos + 4 : pos + 8], 8
        if length == 1:
            if end - pos < 16 or _be(data, pos + 8, 4):
                raise ValueError("JPEG 2000: an XL box OpenJPEG does not read")
            length, head = _be(data, pos + 12, 4), 16
        if length < head or length > end - pos:
            raise ValueError(f"JPEG 2000: a box of {length} bytes")
        yield kind, pos + head, pos + length
        pos += length


def _read_jp2h(data: bytes, start: int, end: int, colour: _Colour) -> None:
    """The JP2 header box (``opj_jp2_read_jp2h``): ihdr, colr, pclr, cmap
    and cdef as OpenJPEG reads and checks them; other boxes (bpcc, res)
    skipped; an ihdr required."""
    for kind, at, stop in _sub_boxes(data, start, end):
        size = stop - at
        if kind == b"ihdr":
            if colour.size is not None:  # "Ignoring ihdr box. First ihdr box already read"
                continue
            if size != 14:
                raise ValueError("JPEG 2000: an ihdr box of other than 14 bytes")
            h, w, nc = _be(data, at, 4), _be(data, at + 4, 4), _be(data, at + 8, 2)
            if h < 1 or w < 1 or not 1 <= nc <= 16384:
                raise ValueError(f"JPEG 2000: an ihdr of {w}x{h}x{nc}")
            colour.size = (w, h)
        elif kind == b"colr":
            if size < 3:
                raise ValueError("JPEG 2000: a colr box of fewer than 3 bytes")
            if colour.has_colr:  # a conforming reader ignores every colr box after the first
                continue
            meth = data[at]
            if meth == 1:
                if size < 7:
                    raise ValueError("JPEG 2000: an enumerated colr box of fewer than 7 bytes")
                colour.enumcs = _be(data, at + 3, 4)
                colour.has_colr = True
            elif meth == 2:  # an ICC profile: the colour space is unknown
                colour.has_colr = True
        elif kind == b"pclr":
            if colour.pclr is not None or size < 3:
                raise ValueError("JPEG 2000: a second or short pclr box")
            n, nch = _be(data, at, 2), data[at + 2]
            if not 0 < n <= 1024 or nch == 0 or size < 3 + nch:
                raise ValueError(f"JPEG 2000: a pclr box of {n} entries, {nch} columns")
            b = data[at + 3 : at + 3 + nch]
            sizes, signs = [(v & 0x7F) + 1 for v in b], [v >> 7 for v in b]
            widths = [min((s + 7) >> 3, 4) for s in sizes]
            entries = np.zeros((n, nch), np.int64)
            p = at + 3 + nch
            for j in range(n):
                for i in range(nch):
                    if p + widths[i] > stop:
                        raise ValueError("JPEG 2000: a pclr box ends early")
                    entries[j, i] = _be(data, p, widths[i])
                    p += widths[i]
            colour.pclr = (sizes, signs, entries)
        elif kind == b"cmap":
            if colour.pclr is None:
                raise ValueError("JPEG 2000: a cmap box before a pclr box")
            if colour.cmap is not None:
                raise ValueError("JPEG 2000: a second cmap box")
            nch = len(colour.pclr[0])
            if size < 4 * nch:
                raise ValueError("JPEG 2000: a short cmap box")
            colour.cmap = [(_be(data, at + 4 * i, 2), data[at + 4 * i + 2], data[at + 4 * i + 3]) for i in range(nch)]
        elif kind == b"cdef":
            if colour.cdef is not None or size < 2:
                raise ValueError("JPEG 2000: a second or short cdef box")
            n = _be(data, at, 2)
            if n == 0 or size < 2 + 6 * n:
                raise ValueError(f"JPEG 2000: a cdef box of {n} channels")
            colour.cdef = [tuple(_be(data, at + 2 + 6 * i + 2 * k, 2) for k in range(3)) for i in range(n)]
    if colour.size is None:
        raise ValueError("JPEG 2000: no ihdr box in the JP2 header")


def _read_jp2(data: bytes):
    """The boxes of a JP2 file up to its codestream box
    (``opj_jp2_read_header_procedure``) -> (offset of the codestream, the
    colour boxes). OpenJPEG reads the codestream from there to the end of
    the file."""
    colour, state, has_jp2h = _Colour(), 0, False
    for kind, at, stop in _boxes(data, 0, len(data)):
        if kind == b"jp2c":
            if not has_jp2h:
                raise ValueError("JPEG 2000: the codestream box comes before the JP2 header")
            return at, colour
        if stop > len(data):
            raise ValueError(f"JPEG 2000: a {kind!r} box past the end of the file")
        if kind == b"jP  ":
            if state != 0 or stop - at != 4 or data[at : at + 4] != b"\r\n\x87\n":
                raise ValueError("JPEG 2000: a bad signature box")
            state = 1
        elif kind == b"ftyp":
            if state != 1 or (stop - at) < 8 or (stop - at) % 4:
                raise ValueError("JPEG 2000: a bad file type box")
            state = 2  # the brands are not checked: a jph file of Part 1 code-blocks reads as JP2
        elif kind == b"jp2h":
            if state < 2:
                raise ValueError("JPEG 2000: the JP2 header box before the file type box")
            _read_jp2h(data, at, stop, colour)
            has_jp2h = True
        elif state < 2:
            raise ValueError("JPEG 2000: the first boxes are not the signature and file type")
    raise ValueError("JPEG 2000: no codestream box")


def _check_colour(colour: _Colour, ncomp: int) -> None:
    """``opj_jp2_check_color``: channel definitions that name channels
    there are, all of them; a palette mapping each channel once."""
    nch = ncomp
    if colour.pclr is not None and colour.cmap is not None:
        nch = len(colour.pclr[0])
    if colour.cdef is not None:
        for cn, _, asoc in colour.cdef:
            if cn >= nch or (asoc not in (0, 65535) and asoc - 1 >= nch):
                raise ValueError(f"JPEG 2000: a cdef box names channel {cn} of {nch}")
        named = {cn for cn, _, _ in colour.cdef}
        if not set(range(nch)) <= named:
            raise ValueError("JPEG 2000: incomplete channel definitions")
    if colour.pclr is not None and colour.cmap is not None:
        cmap = colour.cmap
        sane = all(cmp < ncomp for cmp, _, _ in cmap)
        used = [False] * nch
        for i, (_, mtyp, pcol) in enumerate(cmap):
            if mtyp not in (0, 1) or pcol >= nch or (used[pcol] and mtyp == 1) or (mtyp == 0 and pcol != 0) or (
                    mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        if any(not used[i] and cmap[i][1] != 0 for i in range(nch)):
            sane = False
        if sane and ncomp == 1 and not all(used):  # "Component mapping seems wrong. Trying to correct."
            colour.cmap = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(cmap)]
        if not sane:
            raise ValueError("JPEG 2000: an inconsistent component mapping")


def _apply_pclr(planes: list, colour: _Colour) -> list:
    """``opj_jp2_apply_pclr``: each cmap channel is a component as it is
    (mtyp 0) or its indices, clamped to the palette, looked up (mtyp 1)."""
    entries = colour.pclr[2]
    out = []
    for i, (cmp, mtyp, _) in enumerate(colour.cmap):
        if mtyp == 0:
            out.append(planes[cmp])
        else:
            out.append(entries[np.clip(planes[cmp], 0, len(entries) - 1), i].astype(np.uint32).astype(np.int32))
    return out


def _apply_cdef(planes: list, cdef: list) -> list:
    """``opj_jp2_apply_cdef``: each colour channel moves to the place its
    association names; later definitions follow the swap."""
    planes, info = list(planes), [list(d) for d in cdef]
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= len(planes) or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= len(planes):
            continue
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for d in info[i + 1 :]:
                if d[0] == cn:
                    d[0] = acn
                elif d[0] == acn:
                    d[0] = cn
    return planes


def _yuv_to_bgr(yuv: np.ndarray) -> np.ndarray:
    """OpenCV's ``cvtColor(COLOR_YUV2BGR)`` on 8 bits (``YCrCb2RGB_i``:
    14-bit fixed-point coefficients, rounded, saturated)."""
    y, u, v = (yuv[..., k].astype(np.int64) for k in range(3))
    u, v = u - 128, v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14

    b = y + descale(u * 33292)
    g = y + descale(u * -6472 + v * -9519)
    r = y + descale(v * 18678)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """A JP2 file or a raw codestream -> [H,W,3] BGR uint8 as
    ``cv2.imread`` reads it."""
    from deepemia_tpu_torch import native

    if data.startswith(J2K_SIGNATURE):
        start, colour, jp2 = 0, _Colour(), False
    else:
        start, colour = _read_jp2(data)
        jp2 = True
    codestream = data[start:]

    def refuse_status(status):
        if status == -2:
            raise UnsupportedImageError("High-Throughput JPEG 2000 (Part 15), which OpenCV may read, is not supported")
        if status == -3:
            raise UnsupportedImageError("a JPEG 2000 Part 2 marker (multiple component transform, arbitrary "
                                        "decomposition or wavelet), which OpenCV may read, is not supported")
        raise ValueError(f"JPEG 2000: a codestream OpenJPEG fails on, corrupt or cut short (status {status})")

    status, header, _ = native.jpeg2000_decode(codestream, header_only=True)
    if status != 1:
        refuse_status(status)
    x0, y0, x1, y1, comps = header
    # Jpeg2KOpjDecoderBase::readHeader
    if not 1 <= len(comps) <= 4:
        raise RefusedImageError(f"JPEG 2000: {len(comps)} components (OpenCV reads 1 to 4)")
    for i, (prec, sgnd, _, _) in enumerate(comps):
        if sgnd:
            raise RefusedImageError(f"JPEG 2000: component {i} is signed")
    max_prec = max(c[0] for c in comps)
    if max_prec < 8:
        raise RefusedImageError(f"JPEG 2000: a precision of {max_prec} bits (OpenCV reads 8 or more)")
    w, h = x1 - x0, y1 - y0
    if jp2 and colour.size != (w, h):  # opj_j2k_read_siz holds SIZ to the ihdr box
        raise ValueError(f"JPEG 2000: an ihdr box of {colour.size} and a SIZ of {(w, h)}")
    if not (0 < w <= _MAX_SIDE and 0 < h <= _MAX_SIDE and w * h <= _MAX_PIXELS):
        raise ValueError(f"JPEG 2000: an image of {w}x{h} pixels")
    # readData: opj_decode, then OpenJPEG's own steps
    status, header, planes = native.jpeg2000_decode(codestream)
    if status:
        refuse_status(status)
    geometry = [(-(-x0 // dx), -(-y0 // dy), dx, dy) for _, _, dx, dy in comps]
    if jp2:
        _check_colour(colour, len(planes))
        space = _ENUMCS.get(colour.enumcs, "unknown")
        if colour.pclr is not None and colour.cmap is not None:
            geometry = [geometry[cmp] for cmp, _, _ in colour.cmap]
            planes = _apply_pclr(planes, colour)
        if colour.cdef is not None:
            order = _apply_cdef(list(range(len(planes))), colour.cdef)
            planes = [planes[k] for k in order]
            geometry = [geometry[k] for k in order]
    else:
        space = "unknown"
    if space not in ("sRGB", "gray", "sYCC", "unknown"):
        raise RefusedImageError(f"JPEG 2000: the {space} colour space is not supported")
    for cx0, cy0, dx, dy in geometry:  # "tiles are not supported"
        if (dx, dy, cx0, cy0) != (1, 1, 0, 0):
            raise RefusedImageError("JPEG 2000: an image offset or subsampled components (OpenCV reads neither)")
    shift = max_prec - 8

    def out(channels):
        return np.stack([(p >> shift).astype(np.uint8) for p in channels], -1)

    n = len(planes)
    if space == "gray":
        return out([planes[0]] * 3)
    if space == "sYCC":
        if n < 3:
            raise RefusedImageError(f"JPEG 2000: sYCC of {n} components")
        return _yuv_to_bgr(out(planes[:3]))
    if n < 3:  # decodeSRGBData: "unsupported conversion from 1 components to 3"
        raise RefusedImageError(f"JPEG 2000: {n} components of an sRGB or unknown colour space")
    return out([planes[2], planes[1], planes[0]])

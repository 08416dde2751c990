"""AVIF as OpenCV 5.0's ``cv2.imread(path, IMREAD_COLOR)`` reads it
through libavif 1.4 and libaom 3.14 (``grfmt_avif.cpp``): the HEIF still
image container (ISO/IEC 23008-12 boxes, read as libavif reads them)
around the AV1 decoder of ``native/av1.cpp``, then OpenCV's last step to
8-bit BGR.

OpenCV recognises a file as AVIF when libavif parses its first 500 bytes
(``checkSignature``): a top-level box whose header does not lie within
them before the ``meta`` box is read makes it no AVIF OpenCV knows
(``RefusedImageError``). The primary item's AV1 payload is decoded; an
alpha item (``auxl``) is decoded too and dropped. The identity matrix
(``colr`` nclx, else the AV1 sequence header) maps Y, U, V to G, B, R as
libavif does: 8-bit full range as stored, other depths and limited range
through libavif's float tables (``(uint8)(0.5f + clamp((v - bias) /
range) * 255)``). The other matrices libavif converts (``_MATRICES``)
take the path libavif 1.4 takes in OpenCV's build: libyuv's fixed point
with its bilinear chroma upsampling for BT.601, BT.709 and BT.2020
(``_LIBYUV``; 10 and 12 bits cut to their top 8 bits first), libavif's
float path for the rest (``_libavif_float``; YCgCo-Re, matrix 16, only at
10 bits and full range, two bits above OpenCV's 8, as libavif has it);
each was read off ``cv2.imread``. A monochrome image is OpenCV's own: Y, divided by
2^(depth - 8) and rounded (``convertTo``), replicated to BGR. ``irot``,
``imir`` and ``clap`` are not applied (OpenCV does not apply them).

What OpenCV refuses raises ``RefusedImageError``; a corrupt or cut file,
or an ``ispe`` or AV1 frame past libavif's size limits, a ``ValueError``;
what OpenCV reads and the port does not decode an
``UnsupportedImageError`` naming it: an image sequence, a grid, the AV1
tools ``av1.cpp`` lacks (superres, film grain, frames other than a shown
key frame; segmentation is decoded, every in-loop filter is applied,
deblocking with delta loop filter levels and segmentation's, CDEF and loop
restoration, as are both screen content tools, palette mode and intra
block copy), a
chroma-derived matrix under primaries libyuv has no constants for,
premultiplied alpha, and an ``ispe`` that differs from the AV1 frame
(libavif scales the frame)."""

from __future__ import annotations

import struct

import numpy as np

from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError

SIGNATURE_BYTES = 500  # grfmt_avif.cpp: kAvifSignatureSize
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
# av1.cpp's refusals (its enum Tool)
AV1_TOOLS = {5: "AV1 superres", 6: "AV1 film grain", 7: "an AV1 frame that is not a key frame",
             8: "an AV1 frame that is not shown", 9: "AV1 large-scale tile lists", 10: "an AV1 shown existing frame"}
_UNIQUE_META = (b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref")
_TRANSFORMS = (b"irot", b"imir", b"clap")
# the matrix coefficients other than the identity that libavif converts YUV to RGB with
_MATRICES = (1, 2, 4, 5, 6, 7, 8, 9, 12, 15, 16)


class _Reader:
    """Big-endian fields of a box's body, failing past its end."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def u(self, n: int) -> int:
        if self.pos + n > self.end:
            raise ValueError("AVIF: a box ends early")
        v = int.from_bytes(self.data[self.pos : self.pos + n], "big")
        self.pos += n
        return v

    def bytes(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise ValueError("AVIF: a box ends early")
        self.pos += n
        return self.data[self.pos - n : self.pos]

    def string(self) -> bytes:
        """A null-terminated string (libavif's avifROStreamReadString)."""
        k = self.data.find(b"\0", self.pos, self.end)
        if k < 0:
            raise ValueError("AVIF: a string without its terminator")
        s, self.pos = self.data[self.pos : k], k + 1
        return s

    def full(self, max_version: int = 0) -> tuple:
        version, flags = self.u(1), self.u(3)
        if version > max_version:
            raise ValueError(f"AVIF: a box of version {version}")
        return version, flags


def _boxes(data: bytes, pos: int, end: int):
    """The boxes of data[pos:end], nested in another box -> [(type, body
    start, body end)]; a box that runs past ``end`` fails, and so does one
    of size 0 (to the end of the file: libavif takes it at the top level
    only)."""
    out = []
    while pos < end:
        r = _Reader(data, pos, end)
        size, kind = r.u(4), r.bytes(4)
        if size == 1:
            size = r.u(8)
        elif size == 0:
            raise ValueError(f"AVIF: a {kind!r} box of size 0 inside another box")
        if size < r.pos - pos or pos + size > end:
            raise ValueError(f"AVIF: a {kind!r} box of {size} bytes")
        out.append((kind, r.pos, pos + size))
        pos += size
    return out


def _brands(data: bytes, s: int, e: int):
    r = _Reader(data, s, e)
    major = r.bytes(4)
    r.u(4)
    if (e - r.pos) % 4:
        raise ValueError("AVIF: an ftyp box of a partial brand")
    return [major] + [data[k : k + 4] for k in range(r.pos, e, 4)]


def _top_level(data: bytes, size: int):
    """libavif's avifParse over the first ``size`` bytes of the file ->
    ("ok" or "truncated", brands, meta box, whether a moov box was read);
    a parse error raises ``ValueError``. Boxes are read until the ftyp
    box and what its brands need (meta for avif, moov for avis) are;
    ftyp, meta and moov are read whole (one that runs past ``size`` is
    truncated data), the others skipped; a box header past ``size`` is an
    I/O error."""
    pos, ftyp, meta, moov = 0, None, None, False
    while True:
        if pos > size:
            raise ValueError("AVIF: a box past the end of the file")
        if pos == size:
            break
        if pos + 8 > size:
            raise ValueError("AVIF: a box header cut off")
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        head = 8
        if length == 1:
            if pos + 16 > size:
                raise ValueError("AVIF: a box header cut off")
            length, head = struct.unpack(">Q", data[pos + 8 : pos + 16])[0], 16
        elif length == 0:
            length = len(data) - pos
        if length < head:
            raise ValueError(f"AVIF: a {kind!r} box of {length} bytes")
        if kind in (b"ftyp", b"meta", b"moov"):
            if pos + length > size:
                return "truncated", ftyp, meta, moov
            if kind == b"ftyp":
                if ftyp is not None:
                    raise ValueError("AVIF: a second ftyp box")
                ftyp = _brands(data, pos + head, pos + length)
                if not {b"avif", b"avis"} & set(ftyp):
                    raise ValueError("AVIF: no avif or avis brand")
            elif kind == b"meta":
                if meta is not None:
                    raise ValueError("AVIF: a second meta box")
                meta = _parse_meta(data, pos + head, pos + length)
            else:
                moov = True
        pos += length
        if ftyp is not None and (b"avif" not in ftyp or meta is not None) and (b"avis" not in ftyp or moov):
            return "ok", ftyp, meta, moov
    if ftyp is None:
        raise ValueError("AVIF: no ftyp box")
    return "truncated", ftyp, meta, moov


def recognized(data: bytes) -> bool:
    """Whether OpenCV takes the file for an AVIF (``checkSignature``):
    avifParse of its first SIGNATURE_BYTES bytes gives OK or truncated
    data."""
    try:
        _top_level(data, min(len(data), SIGNATURE_BYTES))
    except ValueError:
        return False
    return True


class _Meta:
    def __init__(self):
        self.primary = None
        self.locations = {}  # item -> (construction method, base offset, [(offset, length)])
        self.types = {}  # item -> type
        self.props = []  # ipco: [(type, body start, body end)]
        self.assoc = {}  # item -> [(property index, essential)]
        self.refs = []  # (type, from, [to])
        self.idat = None  # (start, end)


def _parse_meta(data: bytes, s: int, e: int) -> _Meta:
    """libavif's avifParseMetaBox: the hdlr box first (handler 'pict'),
    iloc, pitm, idat, iprp, iinf and iref at most once each."""
    r = _Reader(data, s, e)
    r.full(0)
    m = _Meta()
    kids = _boxes(data, r.pos, e)
    if not kids or kids[0][0] != b"hdlr":
        raise ValueError("AVIF: the meta box does not start with hdlr")
    seen = set()
    for kind, ks, ke in kids:
        if kind in _UNIQUE_META:
            if kind in seen:
                raise ValueError(f"AVIF: a second {kind!r} box")
            seen.add(kind)
        k = _Reader(data, ks, ke)
        if kind == b"hdlr":
            k.full(0)
            if k.u(4):
                raise ValueError("AVIF: a handler's pre_defined field other than 0")
            if k.bytes(4) != b"pict":
                raise ValueError("AVIF: a handler other than pict")
            k.bytes(12)
            k.string()
        elif kind == b"pitm":
            version, _ = k.full(1)
            m.primary = k.u(4 if version else 2)
        elif kind == b"iloc":
            _parse_iloc(k, m)
        elif kind == b"idat":
            m.idat = (ks, ke)
        elif kind == b"iinf":
            version, _ = k.full(1)
            count = k.u(4 if version else 2)
            infes = _boxes(data, k.pos, ke)
            if len(infes) < count:
                raise ValueError("AVIF: fewer infe boxes than iinf counts")
            for ik, s2, e2 in infes[:count]:
                if ik != b"infe":
                    raise ValueError(f"AVIF: a {ik!r} box in iinf")
                f = _Reader(data, s2, e2)
                v, _ = f.full(3)
                if v < 2:
                    raise ValueError(f"AVIF: an infe box of version {v}")
                item = f.u(4 if v == 3 else 2)
                f.u(2)
                m.types[item] = f.bytes(4)
                f.string()  # item_name
                if m.types[item] in (b"mime", b"uri "):
                    f.string()  # content_type, or item_uri_type
        elif kind == b"iprp":
            iprp = _boxes(data, ks, ke)
            if not iprp or iprp[0][0] != b"ipco":
                raise ValueError("AVIF: the iprp box does not start with ipco")
            m.props = _boxes(data, iprp[0][1], iprp[0][2])
            for pk, s2, e2 in m.props:
                _check_property(data, pk, s2, e2)
            for pk, s2, e2 in iprp[1:]:
                if pk == b"ipma":
                    _parse_ipma(_Reader(data, s2, e2), m)
        elif kind == b"iref":
            version, _ = k.u(1), k.u(3)
            if version > 1:  # a version libavif does not read: no references
                continue
            for rk, s2, e2 in _boxes(data, k.pos, ke):
                f = _Reader(data, s2, e2)
                w = 4 if version else 2
                src, n = f.u(w), f.u(2)
                m.refs.append((rk, src, [f.u(w) for _ in range(n)]))
    for item, kind in m.types.items():
        kinds = {m.props[i - 1][0]: m.props[i - 1] for i, _ in m.assoc.get(item, []) if 0 < i <= len(m.props)}
        if kind == b"av01" and item in m.locations and b"ispe" not in kinds:  # libavif skips items of no data
            raise ValueError(f"AVIF: item {item} of type av01 without ispe")
        if b"pixi" in kinds and b"av1C" in kinds:  # pixi is held to av1C's depth
            _, s2, e2 = kinds[b"av1C"]
            flags = data[s2 + 2]
            config_depth = 12 if flags & 0x20 else 10 if flags & 0x40 else 8  # twelve_bit, high_bitdepth
            _, s2, e2 = kinds[b"pixi"]
            if any(c != config_depth for c in data[s2 + 5 : s2 + 5 + data[s2 + 4]]):
                raise ValueError(f"AVIF: item {item}'s pixi does not hold av1C's depth {config_depth}")
    return m


def _check_property(data: bytes, kind: bytes, s: int, e: int) -> None:
    """A property of ipco as libavif parses it when it reads the file."""
    r = _Reader(data, s, e)
    if kind == b"ispe":
        r.full(0)
        r.u(8)
    elif kind == b"pixi":
        r.full(0)
        r.bytes(r.u(1))
    elif kind == b"av1C":
        if r.u(1) != 0x81:  # marker and version 1
            raise ValueError("AVIF: an av1C box of another marker or version than 1")
        r.u(3)
    elif kind == b"colr":
        if r.bytes(4) == b"nclx":
            r.u(6)
            if r.u(1) & 0x7F:
                raise ValueError("AVIF: an nclx box with reserved bits set")
    elif kind == b"auxC":
        r.full(0)
        r.string()
    elif kind in (b"irot", b"imir"):
        r.u(1)
    elif kind == b"clap":
        r.u(32)


def _parse_iloc(k: _Reader, m: _Meta) -> None:
    version, _ = k.full(2)
    sizes = k.u(1)
    more = k.u(1)
    off_size, len_size, base_size = sizes >> 4, sizes & 15, more >> 4
    index_size = more & 15 if version else 0
    if not {off_size, len_size, base_size, index_size} <= {0, 4, 8}:
        raise ValueError("AVIF: iloc field sizes other than 0, 4 and 8")
    for _ in range(k.u(4 if version == 2 else 2)):
        item = k.u(4 if version == 2 else 2)
        if item in m.locations:
            raise ValueError(f"AVIF: item {item} located twice")
        method = k.u(2) if version else 0  # 12 reserved bits, then construction_method
        if method > 1:
            raise ValueError(f"AVIF: construction method {method}")
        k.u(2)  # data_reference_index, which libavif does not read
        base = k.u(base_size) if base_size else 0
        extents = []
        for _ in range(k.u(2)):
            if index_size:
                k.u(index_size)
            off = k.u(off_size) if off_size else 0
            extents.append((base + off, k.u(len_size) if len_size else 0))
        m.locations[item] = (method, extents)


def _parse_ipma(k: _Reader, m: _Meta) -> None:
    version, flags = k.full(1)
    for _ in range(k.u(4)):
        item = k.u(4 if version else 2)
        if item in m.assoc:
            raise ValueError(f"AVIF: item {item} in ipma twice")
        a = []
        for _ in range(k.u(1)):
            v = k.u(2) if flags & 1 else k.u(1)
            bits = 15 if flags & 1 else 7
            a.append((v & ((1 << bits) - 1), v >> bits))
        m.assoc[item] = a


def _item_data(data: bytes, m: _Meta, item: int) -> bytes:
    if item not in m.locations:
        raise ValueError(f"AVIF: item {item} has no location")
    method, extents = m.locations[item]
    if method == 1 and m.idat is None:
        raise ValueError("AVIF: an item in idat with no idat box")
    start, end = (m.idat if method == 1 else (0, len(data)))
    out = b""
    for off, n in extents:
        if n == 0:  # to the end of the file (or of idat)
            n = end - start - off
        if off + n > end - start or n < 0:
            raise ValueError("AVIF: an item's data past the end of the file")
        out += data[start + off : start + off + n]
    return out


def _properties(data: bytes, m: _Meta, item: int) -> dict:
    """{type: (body start, body end)} of an item's properties, as libavif
    checks them: an unknown property marked essential (an item libavif
    cannot decode: ``RefusedImageError``), or a transform (irot, imir,
    clap) not marked essential, fails."""
    known = (b"ispe", b"pixi", b"av1C", b"colr", b"auxC", b"pasp", b"clli", b"a1op", b"lsel", b"a1lx") + _TRANSFORMS
    props = {}
    for idx, essential in m.assoc.get(item, []):
        if idx == 0:
            if essential:
                raise ValueError("AVIF: an essential association of no property")
            continue
        if idx > len(m.props):
            raise ValueError(f"AVIF: property {idx} of {len(m.props)}")
        kind, s, e = m.props[idx - 1]
        if kind not in known and essential:
            raise RefusedImageError(f"AVIF: an unknown essential property {kind!r}")
        if kind in _TRANSFORMS and not essential:
            raise ValueError(f"AVIF: a {kind!r} property not marked essential")
        if kind == b"colr":  # read by _nclx, which takes each colour type at most once
            continue
        props.setdefault(kind, (s, e))
    return props


def _nclx(data: bytes, m: _Meta, item: int):
    """The (body start, body end) of an item's nclx ``colr`` property, or
    None, as libavif's avifReadColorProperties takes them: at most one
    nclx and one ICC (``rICC`` or ``prof``) among the associations, a
    second of either failing the file, other colour types ignored."""
    seen, nclx = set(), None
    for idx, _ in m.assoc.get(item, []):
        if not 0 < idx <= len(m.props) or m.props[idx - 1][0] != b"colr":
            continue
        _, s, e = m.props[idx - 1]
        kind = {b"nclx": b"nclx", b"rICC": b"icc", b"prof": b"icc"}.get(data[s : s + 4])
        if kind in seen:
            raise ValueError(f"AVIF: an item with two {kind.decode()} colr properties")
        if kind:
            seen.add(kind)
        if kind == b"nclx":
            nclx = (s, e)
    return nclx


def decode_avif(data: bytes) -> np.ndarray:
    if not recognized(data):
        raise RefusedImageError("unknown image encoding (no signature OpenCV reads)")
    status, ftyp, meta, moov = _top_level(data, len(data))
    if status != "ok":
        raise ValueError("AVIF: the file is cut off before its meta (or moov) box ends")
    if moov and (ftyp[0] == b"avis" or meta is None or meta.primary is None):
        raise _unsupported("an image sequence (a track)")
    if meta is None or meta.primary is None:
        raise ValueError("AVIF: no meta box, or no primary item")
    m = meta
    kind = m.types.get(m.primary)
    if kind == b"grid":
        raise _unsupported("a grid image (a derived item of tiles)")
    if kind != b"av01":
        raise ValueError(f"AVIF: a primary item of type {kind!r}")
    props = _properties(data, m, m.primary)
    if b"av1C" not in props or b"ispe" not in props:
        raise ValueError("AVIF: a primary item without av1C or ispe")
    s, e = props[b"ispe"]
    r = _Reader(data, s, e)
    r.full(0)
    width, height = r.u(4), r.u(4)
    if not width or not height or max(width, height) > 32768 or width * height > 16384 * 16384:
        raise ValueError(f"AVIF: an image of {width}x{height} (libavif's limits)")
    alpha = None
    for rk, src, to in m.refs:
        if rk == b"auxl" and m.primary in to and m.types.get(src) == b"av01" and src in m.locations:
            try:
                aux = _properties(data, m, src)
            except RefusedImageError:  # an alpha item libavif cannot decode is no alpha item
                continue
            if b"auxC" in aux:
                a = _Reader(data, *aux[b"auxC"])
                a.full(0)
                if a.string() in _ALPHA_URNS:
                    if b"av1C" not in aux:
                        raise ValueError("AVIF: an alpha item without av1C")
                    alpha = src
                    break
    if alpha is not None and any(rk == b"prem" and src == m.primary and alpha in to for rk, src, to in m.refs):
        raise _unsupported("premultiplied alpha")
    if alpha is not None and b"ispe" in _properties(data, m, alpha):
        a = _Reader(data, *_properties(data, m, alpha)[b"ispe"])
        a.full(0)
        if (a.u(4), a.u(4)) != (width, height):
            raise ValueError("AVIF: an alpha item of another size than the image")
    planes, meta_av1 = _av1(_item_data(data, m, m.primary))
    if alpha is not None:
        _av1(_item_data(data, m, alpha))
    depth = int(meta_av1[2])
    flags = data[props[b"av1C"][0] + 2]  # av1C's monochrome bit: OpenCV's channel count
    fh, fw = planes[0].shape
    if (fw, fh) != (width, height):
        raise _unsupported(f"an ispe of {width}x{height} for an AV1 frame of {fw}x{fh}, "
                           f"which libavif scales")
    mc, full_range, cp, nclx = int(meta_av1[6]), int(meta_av1[5]), int(meta_av1[7]), False
    colour = _nclx(data, m, m.primary)
    if colour is not None:
        c = _Reader(data, *colour)
        c.bytes(4)
        cp, _ = c.u(2), c.u(2)
        mc, full_range, nclx = c.u(2), c.u(1) >> 7, True
    if alpha is not None and not nclx:  # OpenCV fails on these (libavif's alpha path takes no CICP of the stream)
        raise ValueError("AVIF: an image with alpha and no nclx colour box")
    return _to_bgr(planes, depth, mc, full_range, bool(flags & 0x10), cp)


def _unsupported(what: str) -> UnsupportedImageError:
    return UnsupportedImageError(f"AVIF, which OpenCV reads, is not supported: {what}")


def _av1(payload: bytes):
    from deepemia_tpu_torch import native

    status, meta, planes = native.av1_decode(payload)
    if status == -2:
        raise _unsupported(AV1_TOOLS.get(int(meta[4]), "an AV1 tool"))
    if status == -3:
        raise ValueError(f"AVIF: an AV1 frame of {meta[0]}x{meta[1]} (libavif's limits)")
    if status:
        raise ValueError("AVIF: an AV1 stream libaom fails on (corrupt or cut)")
    return planes, meta


def _to_bgr(planes: list, depth: int, mc: int, full_range: int, config_mono: bool, cp: int = 2) -> np.ndarray:
    """The decoded planes -> [H,W,3] BGR uint8, as OpenCV and libavif make
    it: OpenCV takes one channel where av1C says monochrome (CopyToMat: Y,
    convertTo, GRAY2BGR), else has libavif convert to BGR (a monochrome
    stream as gray)."""
    if config_mono:
        y = planes[0]
        if depth > 8:
            y = np.clip(np.rint(y.astype(np.float32) * np.float32(1.0 / (1 << (depth - 8)))), 0, 255)
        return np.repeat(y.astype(np.uint8)[..., None], 3, axis=2)
    if len(planes) == 1:
        bgr = np.repeat(planes[0][..., None], 3, axis=2)
    elif mc == 0:
        bgr = np.stack([planes[1], planes[0], planes[2]], axis=-1)
    elif mc in _MATRICES:
        return _yuv_to_bgr(planes, depth, mc, full_range, cp)
    else:
        raise RefusedImageError(f"AVIF: matrix coefficients {mc}, which libavif does not convert")
    if depth == 8 and full_range:  # avifImageIdentity8ToRGB8ColorFullRange
        return bgr.astype(np.uint8)
    # avifImageYUVAnyToRGBAnySlow: the unorm float table of Y, used for U and V too under the identity matrix
    bias = np.float32(0 if full_range else 16 << (depth - 8))
    scale = np.float32((1 << depth) - 1 if full_range else 219 << (depth - 8))
    f = np.clip((bgr.astype(np.float32) - bias) / scale, np.float32(0), np.float32(1))
    return (np.float32(0.5) + f * np.float32(255)).astype(np.uint8)


# libyuv's YuvConstants (YG, YB, UB, UG, VG, VR) that libavif picks by matrix and range: BT.601 (JPEG, I601),
# BT.709 (F709, H709) and BT.2020 (V2020, 2020), the limited ones with UB held to 128
_LIBYUV = {("601", 1): (16320, 32, 113, 22, 46, 90), ("601", 0): (18997, -1160, 128, 25, 52, 102),
           ("709", 1): (16320, 32, 119, 12, 30, 101), ("709", 0): (18997, -1160, 128, 14, 34, 115),
           ("2020", 1): (16320, 32, 120, 11, 37, 94), ("2020", 0): (19003, -1160, 128, 12, 42, 107)}
_LIBYUV_MATRIX = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
# chroma-derived NCL (12): libyuv's constants by colour primaries, where cv2 was seen to use them (under other
# primaries libavif derives its coefficients from the primaries in float, which the port does not)
_LIBYUV_PRIMARIES = {1: "709", 5: "601", 6: "601", 9: "2020"}
# libavif's own (kr, kb) where libyuv has no constants; 15 takes libavif's BT.601 defaults
_KR_KB = {4: (0.30, 0.11), 7: (0.212, 0.087), 15: (0.299, 0.114)}


def _yuv_to_bgr(planes: list, depth: int, mc: int, full_range: int, cp: int) -> np.ndarray:
    """YUV under a matrix -> BGR as libavif 1.4 converts it in OpenCV's
    build: libyuv's fixed point (its bilinear chroma upsampling, high bit
    depths first cut to 8 bits) where libyuv has the matrix's constants,
    else libavif's float path (bilinear upsampling with weights 9, 3, 3, 1
    sixteenths; YCgCo-Re in integers from it)."""
    y, u, v = planes
    key = _LIBYUV_MATRIX.get(mc) or (_LIBYUV_PRIMARIES.get(cp) if mc == 12 else None)
    if key is not None:
        from deepemia_tpu_torch import native

        return native.yuv_to_bgr_libyuv(y, u, v, depth, _LIBYUV[key, int(bool(full_range))])
    if mc == 12:
        raise _unsupported(f"chroma-derived matrix coefficients under colour primaries {cp}")
    if mc == 8 and not full_range:
        raise RefusedImageError("AVIF: YCgCo at limited range, which libavif does not convert")
    if mc == 16 and (depth != 10 or not full_range):
        raise RefusedImageError("AVIF: YCgCo-Re other than at 10 bits and full range, which libavif does not "
                                "convert to 8 bits")
    return _libavif_float(y, u, v, depth, mc, full_range)


def _libavif_float(y, u, v, depth: int, mc: int, full_range: int) -> np.ndarray:
    """libavif's avifImageYUVAnyToRGBAnySlow in float32: unorm tables,
    bilinear chroma (9/16, 3/16, 3/16, 1/16 of the sample, its horizontal
    and vertical neighbours away from the luma sample, and the diagonal),
    then (uint8)(0.5 + clamp(c) * 255). YCgCo-Re (16) takes Y as it is and
    Cg, Co as floorf(0.5 + chroma * max) and lifts them to 8-bit R, G, B
    (G = t + Cg, B = t - (Co >> 1), R = B + Co with t = Y - (Cg >> 1), each
    clamped to 0-255, R from the clamped B)."""
    f32 = np.float32
    mx = (1 << depth) - 1
    bias_y = 0 if full_range else 16 << (depth - 8)
    range_y, range_uv = (mx, mx) if full_range else (219 << (depth - 8), 224 << (depth - 8))
    table_y = ((np.arange(mx + 1) - bias_y).astype(f32) / f32(range_y)).astype(f32)
    table_uv = ((np.arange(mx + 1) - (1 << (depth - 1))).astype(f32) / f32(range_uv)).astype(f32)
    h, w = y.shape
    sx, sy = int(u.shape[1] != w), int(u.shape[0] != h)

    def neighbours(n, sub):
        i = np.arange(n)
        base = i >> sub
        if not sub:
            return base, base
        adj = np.where((i == 0) | ((i == n - 1) & (i % 2 == 1)), 0, np.where(i % 2 == 1, 1, -1))
        return base, base + adj

    cols, cols_adj = neighbours(w, sx)
    rows, rows_adj = neighbours(h, sy)

    def chroma(p):
        t = table_uv[np.minimum(p, mx)]
        if not (sx or sy):
            return t
        t00 = t[np.ix_(rows, cols)]
        t10 = t[np.ix_(rows, cols_adj)]
        t01 = t[np.ix_(rows_adj, cols)]
        t11 = t[np.ix_(rows_adj, cols_adj)]
        return t00 * f32(9 / 16) + t10 * f32(3 / 16) + t01 * f32(3 / 16) + t11 * f32(1 / 16)

    cb, cr = chroma(u), chroma(v)
    if mc == 16:  # YCgCo-Re: integers, R from the clamped B
        cg, co = (np.floor(c * f32(mx) + f32(0.5)).astype(np.int64) for c in (cb, cr))
        t = y.astype(np.int64) - (cg >> 1)
        b = np.clip(t - (co >> 1), 0, 255)
        return np.stack([b, np.clip(t + cg, 0, 255), np.clip(b + co, 0, 255)], -1).astype(np.uint8)
    yy = table_y[y]
    if mc == 8:  # YCgCo
        t = yy - cb
        g, b, r = yy + cb, t - cr, t + cr
    else:
        kr, kb = (f32(x) for x in _KR_KB[mc])
        kg = f32(1) - kr - kb
        r = yy + (f32(2) * (f32(1) - kr)) * cr
        b = yy + (f32(2) * (f32(1) - kb)) * cb
        g = yy - ((f32(2) * ((kr * (f32(1) - kr) * cr) + (kb * (f32(1) - kb) * cb))) / kg)
    return np.stack([(f32(0.5) + np.clip(c, f32(0), f32(1)) * f32(255)).astype(np.uint8) for c in (b, g, r)], -1)

"""Write the fixtures of the image codings the PyTorch port's decoder reads
beside the plain ones: FillOrder 2, BigTIFF, old-style LZW, CIELab, gray
with extra samples and cut TIFFs, CCITT fax TIFFs, arithmetic-coded, four-component, block-smoothed and
lossless JPEGs, and 16-bit, bit-field and OS/2 BMPs.

The port decodes images without OpenCV (``deepemia_tpu_torch/ops/image.py:
read_image``), to the pixels ``cv2.imread(path, cv2.IMREAD_COLOR)``
returns. A machine without OpenCV (the GPU host that runs
``chip_smoke.py``) checks that against this file: small files in each
coding, each beside the array ``cv2.imread`` returns for it.

The writers below need only numpy; the tests and ``chip_smoke.py`` import
them: TIFF and BigTIFF files (``tiff_variants``, over the TIFF writer of
``tools/make_torch_image_fixtures.py``), the CCITT
Modified Huffman, Group 3 (1D and 2D) and Group 4 encoders
(``fax_encode``), and the JPEG arithmetic coder of ITU T.81 Annex D
(``arith_jpeg``), which codes the quantised coefficients of a JPEG as a
sequential (SOF9) or progressive (SOF10) file. ``main`` needs OpenCV (the
reference pixels) and PIL (the CMYK JPEGs).

    python tools/make_torch_codings_fixtures.py   # writes tests/data/torch_codings_fixtures.npz

The file holds, for each case, ``<case>.<ext>`` (the file's bytes, uint8)
and ``<case>`` ([H,W,3] uint8 BGR).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_codings_fixtures.npz")


def _image_tool():
    """``tools/make_torch_image_fixtures.py`` beside this file, by its path:
    its TIFF writer (``tiff_bytes``) writes these files too."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_image_fixtures", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "make_torch_image_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


image_tool = _image_tool()
tiff_bytes = image_tool.tiff_bytes
BYTE, ASCII, SHORT, LONG, RATIONAL, UNDEFINED, LONG8 = (
    image_tool.BYTE, image_tool.ASCII, image_tool.SHORT, image_tool.LONG, image_tool.RATIONAL, image_tool.UNDEFINED,
    image_tool.LONG8)
RAW, CCITT_RLE, CCITT_G3, CCITT_G4, LZW, DEFLATE, CCITT_RLEW, PACKBITS = 1, 2, 3, 4, 5, 8, 32771, 32773
LZW_COMPAT = -5  # tiff_variants' name for old-style LZW, written as compression 5

# byte -> its bits reversed (FillOrder 2)
BIT_REVERSED = np.packbits(np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)[:, ::-1], axis=1)[:, 0]


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def retiff(data: bytes, big: bool = True, big_endian: bool = False, offsets_type: int = None) -> bytes:
    """A classic TIFF's first page rewritten (as a BigTIFF when ``big``, in
    the byte order ``big_endian``, which leaves samples of more than 8 bits
    as they were): the same tags and the same strip or tile bytes."""
    e = "<" if data[:2] == b"II" else ">"
    sizes = {BYTE: ("B", 1), ASCII: ("B", 1), SHORT: ("H", 2), LONG: ("I", 4), RATIONAL: ("I", 8), UNDEFINED: ("B", 1)}
    (ifd,) = struct.unpack(e + "I", data[4:8])
    (n,) = struct.unpack(e + "H", data[ifd : ifd + 2])
    tags = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack(e + "HHI4s", data[ifd + 2 + 12 * i : ifd + 14 + 12 * i])
        fmt, size = sizes[typ]
        at = ifd + 10 + 12 * i if count * size <= 4 else struct.unpack(e + "I", value)[0]
        k = 2 * count if typ == RATIONAL else count
        vals = list(struct.unpack(f"{e}{k}{fmt}", data[at : at + count * size]))
        if typ == RATIONAL:
            vals = list(zip(vals[0::2], vals[1::2]))
        tags[tag] = (typ, bytes(vals) if typ in (ASCII, UNDEFINED) else vals)
    tiled = 324 in tags
    offsets, counts = tags.pop(324 if tiled else 273)[1], tags.pop(325 if tiled else 279)[1]
    segs = [data[o : o + c] for o, c in zip(offsets, counts)]
    return tiff_bytes(tags, segs, tiled=tiled, big_endian=big_endian, big=big, offsets_type=offsets_type)


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9..12 bits that widen one code early, a
    Clear code first and when the table fills, EOI last."""
    out = bytearray()
    acc = nacc = 0
    width, nxt = 9, 258
    table = {bytes((i,)): i for i in range(256)}

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    put(256)
    w = b""
    for byte in data:
        wc = w + bytes((byte,))
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == 4095:
            put(256)
            table = {bytes((i,)): i for i in range(256)}
            width, nxt = 9, 258
        elif nxt >= (1 << width):
            width += 1
        w = bytes((byte,))
    if w:
        put(table[w])
        if nxt + 1 >= (1 << width) and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def lzw_compat_encode(data: bytes) -> bytes:
    """Old-style TIFF LZW (libtiff's LZWDecodeCompat): LSB-first codes of
    9..12 bits that widen when the decoder's table fills, a Clear code first
    and before the table overflows, EOI last."""
    out = bytearray()
    acc = nacc = count = 0  # count: codes since the last Clear
    table = {bytes((i,)): i for i in range(256)}

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += max(9, (258 + max(count - 1, 0)).bit_length())  # the decoder's width for this code
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    put(256)
    w = b""
    for byte in data:
        wc = w + bytes((byte,))
        if wc in table:
            w = wc
            continue
        put(table[w])
        count += 1
        table[wc] = 258 + len(table) - 256
        if 258 + count >= 4094:
            put(256)
            table, count = {bytes((i,)): i for i in range(256)}, 0
        w = bytes((byte,))
    if w:
        put(table[w])
        count += 1
    put(257)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeat packets, the rest
    as literal packets of at most 128 bytes."""
    a = np.frombuffer(data, np.uint8)
    n = a.size
    change = np.flatnonzero(np.diff(a) != 0) + 1
    starts = np.concatenate([[0], change])
    lengths = np.diff(np.concatenate([starts, [n]]))
    out = bytearray()
    lit = 0  # start of the pending literal span

    def literals(lo, hi):
        for k in range(lo, hi, 128):
            chunk = data[k : min(k + 128, hi)]
            out.append(len(chunk) - 1)
            out.extend(chunk)

    for st, ln in zip(starts[lengths >= 3].tolist(), lengths[lengths >= 3].tolist()):
        literals(lit, st)
        for k in range(st, st + ln, 128):
            m = min(128, st + ln - k)
            if m >= 2:
                out.extend((257 - m, a[k]))
            else:
                literals(k, k + 1)
        lit = st + ln
    literals(lit, n)
    return bytes(out)


ENCODERS = {RAW: bytes, LZW: lzw_encode, DEFLATE: zlib.compress, PACKBITS: packbits_encode,
            LZW_COMPAT: lzw_compat_encode}


def tiff_variants(pixels: np.ndarray, compression: int, variants: dict, rows_per_strip: int = None,
                  tile: tuple = None, photometric: int = None, extra: dict = None) -> dict:
    """An 8-bit gray ([H,W]) or RGB ([H,W,3]) image in ``compression``
    (none, LZW, Deflate, PackBits), strips of ``rows_per_strip`` rows or
    ``tile`` = (height, width) tiles, encoded once and written as each of
    ``variants`` ({name: (fill order, BigTIFF, big-endian)}): a FillOrder 2
    file has each segment's bytes bit-reversed after compression, as
    libtiff writes it. -> {name: file bytes}."""
    s = pixels if pixels.ndim == 3 else pixels[..., None]
    h, w, spp = s.shape
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [8] * spp), 259: (SHORT, [abs(compression)]),
            262: (SHORT, [photometric if photometric is not None else (2 if spp == 3 else 1)]),
            277: (SHORT, [spp])}
    if tile:
        th, tw = tile
        tags[322], tags[323] = (LONG, [tw]), (LONG, [th])
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, spp), np.uint8)
        pad[:h, :w] = s
        raws = [pad[y : y + th, x : x + tw].tobytes() for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        tags[278] = (LONG, [rps])
        raws = [s[y : y + rps].tobytes() for y in range(0, h, rps)]
    tags.update(extra or {})
    segs = [ENCODERS[compression](r) for r in raws]
    out = {}
    for name, (fill_order, big, big_endian) in variants.items():
        vtags = dict(tags)
        vsegs = segs
        if fill_order == 2:
            vtags[266] = (SHORT, [2])
            vsegs = [BIT_REVERSED[np.frombuffer(g, np.uint8)].tobytes() for g in segs]
        out[name] = tiff_bytes(vtags, vsegs, tiled=bool(tile), big_endian=big_endian, big=big)
    return out


def tiff_of(pixels: np.ndarray, compression: int = RAW, rows_per_strip: int = None, tile: tuple = None,
            fill_order: int = 1, big: bool = False, big_endian: bool = False, offsets_type: int = None,
            photometric: int = None, extra: dict = None) -> bytes:
    """One variant of ``tiff_variants``; ``offsets_type`` the type of its
    offsets and byte counts (LONG, or LONG8 in a BigTIFF, by default)."""
    if offsets_type is None:
        return tiff_variants(pixels, compression, {"": (fill_order, big, big_endian)}, rows_per_strip, tile,
                             photometric, extra)[""]
    data = tiff_variants(pixels, compression, {"": (fill_order, False, big_endian)}, rows_per_strip, tile,
                         photometric, extra)[""]
    return retiff(data, big=big, big_endian=big_endian, offsets_type=offsets_type)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp_raw(w: int, h: int, bits: int, rows: bytes, hsize: int = 40, comp: int = 0, masks=None, palette=b"",
            top_down: bool = False, colors_used: int = 0) -> bytes:
    """A BMP of the stored ``rows`` (padded to 4 bytes, bottom-up unless
    ``top_down``) behind a Windows header of ``hsize`` bytes, or the OS/2
    core header (``hsize`` 12, 3-byte palette entries), with bit-field
    ``masks`` after the header and the raw ``palette`` bytes."""
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits, comp, len(rows), 2835, 2835,
                           colors_used, 0).ljust(hsize, b"\0")
    extra = b"".join(struct.pack("<I", m) for m in masks) if masks else b""
    at = 14 + len(head) + len(extra) + len(palette)
    return b"BM" + struct.pack("<IHHI", at + len(rows), 0, 0, at) + head + extra + palette + rows


# ---------------------------------------------------------------------------
# CCITT fax (ITU T.4 and T.6)
# ---------------------------------------------------------------------------

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
    "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
    "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 "
    "01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
    "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
    "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
    "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 000000101011 "
    "000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 0000001101100 "
    "0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 000000010110 "
    "000000010111 000000011100 000000011101 000000011110 000000011111").split()
_EOL = "000000000001"
_MODES = {"P": "0001", "H": "001", 0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
          -3: "0000010"}


def _run_code(run: int, black: bool) -> str:
    """The makeup and terminating codes of one run."""
    term, makeup = (_BLACK_TERM, _BLACK_MAKEUP) if black else (_WHITE_TERM, _WHITE_MAKEUP)
    out = []
    while run >= 2560:
        out.append(_EXT_MAKEUP[-1])
        run -= 2560
    if run >= 64:
        m = run // 64
        out.append(makeup[m - 1] if m <= 27 else _EXT_MAKEUP[m - 28])
        run -= 64 * m
    out.append(term[run])
    return "".join(out)


def _changes(row: np.ndarray) -> list:
    """The changing elements of a row of bits (1 black): the positions
    where a pixel differs from the one before it (white before the row)."""
    return np.flatnonzero(np.diff(np.concatenate([[0], row.astype(np.int8)]))).tolist()


def _mh_row(row: np.ndarray) -> str:
    edges = [0] + _changes(row) + [row.size]
    return "".join(_run_code(b - a, bool(i % 2)) for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])))


def _2d_row(row: np.ndarray, ref: np.ndarray) -> str:
    """A row coded against its reference row (T.4 4.2.1.3 / T.6)."""
    import bisect

    w = row.size
    cur, rch = _changes(row) + [w, w], _changes(ref) + [w, w]
    out, a0, colour = [], -1, 0
    while a0 < w:
        a1 = cur[bisect.bisect_right(cur, a0) if a0 >= 0 else 0]
        # b1: the first change on the reference row right of a0 into the colour opposite to a0's
        k = bisect.bisect_right(rch, a0) if a0 >= 0 else 0
        while k < len(rch) - 2 and k % 2 != colour:
            k += 1
        b1 = rch[min(k, len(rch) - 1)]
        b2 = rch[min(k + 1, len(rch) - 1)]
        if b2 < a1:
            out.append(_MODES["P"])
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(_MODES[a1 - b1])
            a0, colour = a1, 1 - colour
        else:
            a2 = cur[min(bisect.bisect_right(cur, a1), len(cur) - 1)]
            start = max(a0, 0)
            out.append(_MODES["H"] + _run_code(a1 - start, bool(colour)) + _run_code(a2 - a1, not colour))
            a0 = a2
    return "".join(out)


def _pack(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return np.packbits(np.frombuffer(bits.encode(), np.uint8) - 48).tobytes()


def fax_encode(bits: np.ndarray, compression: int, options: int = 0, k: int = 4, lsb_first: bool = False,
               rtc: bool = True) -> bytes:
    """One strip of [H,W] bits (1 black) in CCITT ``compression``: 2
    (Modified Huffman, rows byte-aligned), 32771 (the same, rows aligned to
    16 bits), 3 (Group 3: an EOL before every row; with ``options`` bit 0,
    2D rows, every ``k``-th one 1D, each tagged by the bit after its EOL;
    bit 2, fill bits that end each EOL on a byte boundary; ``rtc`` six EOLs
    at the end) or 4 (Group 4: 2D rows, EOFB at the end); each byte's bits
    reversed when ``lsb_first`` (FillOrder 2)."""
    rows, parts, ref = bits.astype(np.uint8), [], np.zeros(bits.shape[1], np.uint8)
    length = 0
    for y, row in enumerate(rows):
        if compression in (CCITT_RLE, CCITT_RLEW):
            code = _mh_row(row)
            align = 8 if compression == CCITT_RLE else 16
            code += "0" * (-(length + len(code)) % align)
        elif compression == CCITT_G3:
            eol = _EOL
            if options & 4:
                eol = "0" * (-(length + len(_EOL)) % 8) + _EOL
            two_d = options & 1
            if two_d:
                code = eol + ("1" + _mh_row(row) if y % k == 0 else "0" + _2d_row(row, ref))
            else:
                code = eol + _mh_row(row)
        else:
            code = _2d_row(row, ref)
        parts.append(code)
        length += len(code)
        ref = row
    if compression == CCITT_G3 and rtc:
        parts.append((_EOL + ("1" if options & 1 else "")) * 6)
    if compression == CCITT_G4:
        parts.append(_EOL * 2)
    data = _pack("".join(parts))
    return BIT_REVERSED[np.frombuffer(data, np.uint8)].tobytes() if lsb_first else data


def fax_tiff(bits: np.ndarray, compression: int, options: int = 0, rows_per_strip: int = None,
             fill_order: int = 1, photometric: int = 0, big: bool = False, tile: tuple = None,
             keep: float = 1.0) -> bytes:
    """A bilevel TIFF of [H,W] bits (1 black, as WhiteIsZero stores them
    when ``photometric`` is 0; BlackIsZero inverts them) in CCITT
    ``compression``, strips of ``rows_per_strip`` rows or ``tile`` tiles,
    T4Options or T6Options ``options``; each segment cut to ``keep`` of
    its bytes (a file cut short)."""
    h, w = bits.shape
    stored = bits if photometric == 0 else 1 - bits
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [1]), 259: (SHORT, [compression]),
            262: (SHORT, [photometric]), 277: (SHORT, [1])}
    if fill_order != 1:
        tags[266] = (SHORT, [fill_order])
    if options:
        tags[293 if compression == CCITT_G4 else 292] = (LONG, [options])
    if tile:
        th, tw = tile
        tags[322], tags[323] = (LONG, [tw]), (LONG, [th])
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw), np.uint8)
        pad[:h, :w] = stored
        blocks = [pad[y : y + th, x : x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        tags[278] = (LONG, [rps])
        blocks = [stored[y : y + rps] for y in range(0, h, rps)]
    segs = [fax_encode(b, compression, options, lsb_first=fill_order == 2) for b in blocks]
    segs = [g[: int(len(g) * keep)] for g in segs]
    return tiff_bytes(tags, segs, tiled=bool(tile), big=big)


# ---------------------------------------------------------------------------
# JPEG: one set of quantised coefficients, Huffman- or arithmetic-coded
# ---------------------------------------------------------------------------

# ITU T.81 Annex K: the luminance quantization table (natural order) and the
# luminance DC and AC Huffman tables, used here for every component
JPEG_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
JPEG_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
JPEG_AC = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
    "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
    "e7e8e9eaf1f2f3f4f5f6f7f8f9fa")))
ZIGZAG = np.array([  # zigzag position -> natural index
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
    14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39,
    46, 53, 60, 61, 54, 47, 55, 62, 63])


def jpeg_coefficients(image: np.ndarray, quality: int = 95, sampling=(1, 1)):
    """A gray [H,W] or BGR [H,W,3] uint8 image -> its quantised DCT
    coefficients as a baseline encoder makes them: colour as YCbCr with
    luma sampling ``sampling`` (h, v), an orthonormal float DCT and
    libjpeg's quality scaling of the Annex K table. -> (per component
    [rows, cols, 64] int64 blocks in zigzag order over the MCU-padded
    plane, the quantization table in natural order, the sampling factors,
    (H, W))."""
    if image.ndim == 2:
        return plane_coefficients([image.astype(np.float64)], [(1, 1)], quality)
    return plane_coefficients(ycc_planes(image), [sampling, (1, 1), (1, 1)], quality)


def ycc_planes(bgr: np.ndarray) -> list:
    """[H,W,3] BGR -> the float Y, Cb and Cr planes of JFIF."""
    b, g, r = (bgr[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b]


def plane_coefficients(planes: list, factors: list, quality: int = 95):
    """Float [H,W] sample planes (one per component, full size) with their
    sampling factors -> ``jpeg_coefficients``' tuple."""
    h, w = planes[0].shape
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qt = np.clip((JPEG_QT * scale + 50) // 100, 1, 255)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    u = np.arange(8)
    dct = np.sqrt(np.where(u == 0, 1 / 8, 2 / 8))[:, None] * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    comps = []
    for plane, (ch, cv) in zip(planes, factors):
        full = np.pad(plane, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)), mode="edge")
        sy, sx = vmax // cv, hmax // ch
        sub = full.reshape(full.shape[0] // sy, sy, full.shape[1] // sx, sx).mean(axis=(1, 3))
        blocks = sub.reshape(sub.shape[0] // 8, 8, sub.shape[1] // 8, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.einsum("ur,pqrc,vc->pquv", dct, blocks, dct, optimize=True)
        comps.append(np.round(coef.reshape(*coef.shape[:2], 64) / qt).astype(np.int64)[..., ZIGZAG])
    return comps, qt, factors, (h, w)


def _huff_codes(bits, vals):
    """Canonical Huffman codes of a DHT table -> (code, length) per symbol."""
    code_of, len_of, code, k = np.zeros(256, np.int64), np.zeros(256, np.int64), 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + bytes(body)


def _frame(sof, qt, factors, shape, adobe=None) -> bytes:
    """SOI, JFIF (or an Adobe APP14 segment of transform ``adobe``: 0 RGB
    or CMYK, 1 YCbCr, 2 YCCK), the one quantization table and the frame
    header."""
    h, w = shape
    body = [8, *h.to_bytes(2, "big"), *w.to_bytes(2, "big"), len(factors)]
    for c, (ch, cv) in enumerate(factors):
        body += [c + 1, ch * 16 + cv, 0]
    app = (_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") if adobe is None
           else _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe])))
    return b"\xff\xd8" + app + _segment(0xDB, [0, *qt[ZIGZAG].tolist()]) + _segment(sof, body)


def _mcu_order(comps, factors):
    """Every block in MCU order (per MCU, each component's v x h blocks) ->
    ([N,64] coefficients, [N] component)."""
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcuy, mcux = comps[0].shape[0] // vmax, comps[0].shape[1] // hmax
    order, owner = [], []
    for c, (ch, cv) in enumerate(factors):
        by = np.arange(mcuy)[:, None, None, None] * cv + np.arange(cv)[None, None, :, None]
        bx = np.arange(mcux)[None, :, None, None] * ch + np.arange(ch)[None, None, None, :]
        by, bx = np.broadcast_arrays(by, bx)
        order.append(comps[c][by, bx].reshape(mcuy, mcux, cv * ch, 64))
        owner.append(np.full((mcuy, mcux, cv * ch), c))
    return np.concatenate(order, axis=2).reshape(-1, 64), np.concatenate(owner, axis=2).reshape(-1)


def huffman_jpeg(comps, qt, factors, shape, adobe=None) -> bytes:
    """A baseline (SOF0) JFIF file of the coefficients, one interleaved
    scan, the Annex K Huffman tables, the entropy coding vectorised over all
    blocks."""
    coef, owner = _mcu_order(comps, factors)
    dc = coef[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(len(factors)):
        sel = owner == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    dc_code, dc_len = _huff_codes(*JPEG_DC)
    ac_code, ac_len = _huff_codes(*JPEG_AC)

    def magnitude(v):
        size = np.where(v == 0, 0, np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)
        return size, np.where(v < 0, v + (1 << size) - 1, v)

    nblk = coef.shape[0]
    events = []  # (block, position, sub-order, code << value bits | value, total length)
    s, val = magnitude(diff)
    events.append((np.arange(nblk), np.zeros(nblk, np.int64), np.zeros(nblk, np.int64),
                   (dc_code[s] << s) | val, dc_len[s] + s))
    b, k = np.nonzero(coef[:, 1:])
    k = k + 1
    prev = np.where(np.r_[True, b[1:] != b[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    s, val = magnitude(coef[b, k])
    sym = (run % 16) * 16 + s
    events.append((b, k, np.full(b.size, 16), (ac_code[sym] << s) | val, ac_len[sym] + s))
    nzrl = run // 16
    zb = np.repeat(np.arange(b.size), nzrl)
    zsub = np.arange(zb.size) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    events.append((b[zb], k[zb], zsub, np.full(zb.size, ac_code[0xF0]), np.full(zb.size, ac_len[0xF0])))
    last = np.zeros(nblk, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    events.append((eob, np.full(eob.size, 64), np.zeros(eob.size, np.int64), np.full(eob.size, ac_code[0]),
                   np.full(eob.size, ac_len[0])))
    blk, pos, sub, word, length = (np.concatenate(x) for x in zip(*events))
    idx = np.lexsort((sub, pos, blk))
    word, length = word[idx], length[idx]
    nbits = int(length.sum())
    owner_ev = np.repeat(np.arange(length.size), length)
    shift = length[owner_ev] - 1 - (np.arange(nbits) - np.repeat(np.cumsum(length) - length, length))
    bits = ((word[owner_ev] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-nbits % 8, np.uint8)])  # pad with 1-bits
    data = np.packbits(bits)
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).astype(np.uint8)  # byte stuffing
    nc = len(factors)
    sos = [nc] + [x for c in range(nc) for x in (c + 1, 0x00)] + [0, 63, 0]
    return (_frame(0xC0, qt, factors, shape, adobe) + _segment(0xC4, [0x00, *JPEG_DC[0], *JPEG_DC[1]])
            + _segment(0xC4, [0x10, *JPEG_AC[0], *JPEG_AC[1]]) + _segment(0xDA, sos) + data.tobytes()
            + b"\xff\xd9")


# ITU T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS; entry 113 is libjpeg's fixed 0.5
_QE = (
    "5a1d 2586 1114 080b 03d8 01da 00e5 006f 0036 001a 000d 0006 0003 0001 5a7f 3f25 2cf2 207c 17b9 1182 0cef "
    "09a1 072f 055c 0406 0303 0240 01b1 0144 00f5 00b7 008a 0068 004e 003b 002c 5ae1 484c 3a0d 2ef1 261f 1f33 "
    "19a8 1518 1177 0e74 0bfb 09f8 0861 0706 05cd 04de 040f 0363 02d4 025c 01f8 01a4 0160 0125 00f6 00cb 00ab "
    "008f 5b12 4d04 412c 37d8 2fe8 293c 2379 1edf 1aa9 174e 1424 119c 0f6b 0d51 0bb6 0a40 5832 4d1c 438e 3bdd "
    "34ee 2eae 299a 2516 5570 4ca9 44d9 3e22 3824 32b4 2e17 56a8 4f46 47e5 41cf 3c3d 375e 5231 4c0f 4639 415e "
    "5627 50e7 4b85 5597 504f 5a10 5522 59eb 5a1d")
_NLPS = (1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38, 39, 40, 42, 43, 45, 46, 48, 49, 51, 52,
         54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74, 75, 77, 78, 79, 48, 50, 50,
         51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83, 84, 86, 87, 87, 72, 72, 74, 74, 75, 77,
         77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97, 99, 99, 93, 95, 101, 102, 103, 104, 99, 105, 106,
         107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113)
_NMPS = tuple(list(range(1, 14)) + [13] + list(range(15, 35)) + [35, 9] + list(range(37, 64)) + [32]
              + list(range(65, 80)) + [48] + list(range(81, 88)) + [71] + list(range(89, 95)) + [86]
              + list(range(96, 101)) + [93] + list(range(102, 105)) + [99] + [106, 107, 103, 109, 107, 111, 109,
                                                                              111, 113])
_SWITCH = frozenset((0, 14, 36, 64, 80, 88, 95, 105, 110, 112))
# per state: (Qe, next state after an LPS with the MPS flag flipped if Switch_MPS, next state after an MPS)
ARITH_STATES = [(int(q, 16), _NLPS[i] | (0x80 if i in _SWITCH else 0), _NMPS[i]) for i, q in enumerate(_QE.split())]


# the statistics bins of a scan, flat: DC conditioning table t at 64 t, AC table t at AC_BINS + 256 t, and the
# fixed probability 0.5 at FIXED_BIN
AC_BINS, FIXED_BIN = 1024, 1024 + 16 * 256
_QE_OF = [q for q, _, _ in ARITH_STATES]
_LPS_OF = [n for _, n, _ in ARITH_STATES]
_MPS_OF = [n for _, _, n in ARITH_STATES]


def qm_encode(bins: list, bits: list) -> bytes:
    """The QM coder of ITU T.81 Annex D as libjpeg's jcarith.c runs it, over
    one entropy-coded segment's decisions (``bits[i]`` in statistics bin
    ``bins[i]``; every bin starts at state 0, the fixed bin at 113): its
    bytes, terminated (D.1.8) and 0xFF-stuffed."""
    st = bytearray(FIXED_BIN + 1)
    st[FIXED_BIN] = 113
    qe_of, lps_of, mps_of = _QE_OF, _LPS_OF, _MPS_OF
    out = bytearray()
    c, a, sc, zc, ct, buffer = 0, 0x10000, 0, 0, 11, -1
    for i, bit in zip(bins, bits):
        sv = st[i]
        s = sv & 0x7F
        qe = qe_of[s]
        a -= qe
        if bit != sv >> 7:  # the less probable symbol
            if a >= qe:
                c += a
                a = qe
            st[i] = (sv & 0x80) ^ lps_of[s]
        else:
            if a >= 0x8000:
                continue
            if a < qe:
                c += a
                a = qe
            st[i] = (sv & 0x80) ^ mps_of[s]
        while True:  # renormalization and output, D.1.6
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:  # a carry over the stacked 0xFF bytes
                    if buffer >= 0:
                        out += bytes(zc)
                        zc = 0
                        out.append(buffer + 1)
                        if buffer + 1 == 0xFF:
                            out.append(0)
                    zc += sc
                    sc = 0
                    buffer = temp & 0xFF
                elif temp == 0xFF:
                    sc += 1
                else:
                    if buffer == 0:
                        zc += 1
                    elif buffer >= 0:
                        out += bytes(zc)
                        zc = 0
                        out.append(buffer)
                    if sc:
                        out += bytes(zc) + b"\xff\x00" * sc
                        zc = sc = 0
                    buffer = temp
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
    temp = (a - 1 + c) & 0xFFFF0000
    c = temp + 0x8000 if temp < c else temp
    c <<= ct
    if c & 0xF8000000:
        if buffer >= 0:
            out += bytes(zc)
            zc = 0
            out.append(buffer + 1)
            if buffer + 1 == 0xFF:
                out.append(0)
        zc += sc
        sc = 0
    else:
        if buffer == 0:
            zc += 1
        elif buffer >= 0:
            out += bytes(zc)
            zc = 0
            out.append(buffer)
        if sc:
            out += bytes(zc) + b"\xff\x00" * sc
            zc = sc = 0
    if c & 0x7FFF800:  # the final bytes, unless they are zeros
        out += bytes(zc)
        for byte in ((c >> 19) & 0xFF, (c >> 11) & 0xFF)[: 2 if c & 0x7F800 else 1]:
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
    return bytes(out)


# libjpeg's progressive script (jcparam.c jpeg_simple_progression): (components, Ss, Se, Ah, Al)
PROGRESSION_GRAY = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))
PROGRESSION_YCC = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                   ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                   ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))


def arith_jpeg(comps, qt, factors, shape, progressive: bool = False, restart: int = 0, dac=None,
               scans=None, adobe=None) -> bytes:
    """An arithmetic-coded JFIF file of the coefficients: sequential (SOF9,
    one interleaved scan) or progressive (SOF10, ``scans`` or libjpeg's
    progressive script), following jcarith.c, with a restart marker every
    ``restart`` MCUs and a DAC segment of ``dac`` ({Tc << 4 | Tb: value},
    DC tables 0-15 and AC tables 16-31) when given: its DC L and U and AC
    Kx condition the statistics as the decoder must."""
    nc = len(factors)
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    for index, val in (dac or {}).items():
        if index >= 16:
            ac_k[index - 16] = val
        else:
            dc_l[index], dc_u[index] = val & 15, val >> 4
    tables = [0] * nc  # every component codes with conditioning table 0
    if not progressive:
        scans = (((tuple(range(nc))), 0, 63, 0, 0),)
    elif scans is None:
        scans = PROGRESSION_GRAY if nc == 1 else PROGRESSION_YCC
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    out = bytearray(_frame(0xCA if progressive else 0xC9, qt, factors, shape, adobe))
    if dac:
        out += _segment(0xCC, [x for kv in sorted(dac.items()) for x in kv])
    if restart:
        out += _segment(0xDD, list(restart.to_bytes(2, "big")))
    h, w = shape
    for members, ss, se, ah, al in scans:
        selectors = [x for c in members for x in (c + 1, tables[c] * 16 + tables[c])]
        body = [len(members)] + selectors + [ss, se, ah * 16 + al]
        out += _segment(0xDA, body)
        if len(members) > 1:  # interleaved: MCUs of each member's v x h blocks
            mcuy, mcux = comps[0].shape[0] // vmax, comps[0].shape[1] // hmax
            units = [[(c, my * factors[c][1] + y, mx * factors[c][0] + x) for c in members
                      for y in range(factors[c][1]) for x in range(factors[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        else:  # one component: its blocks that hold samples, in raster order
            (c,) = members
            bw = -(-(-(-w * factors[c][0] // hmax)) // 8)
            bh = -(-(-(-h * factors[c][1] // vmax)) // 8)
            units = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
        out += _arith_scan(comps, units, members, tables, ss, se, ah, al, restart, dc_l, dc_u, ac_k, progressive)
    return bytes(out + b"\xff\xd9")


def _arith_scan(comps, units, members, tables, ss, se, ah, al, restart, dc_l, dc_u, ac_k, progressive):
    """The entropy-coded segments of one scan (jcarith.c), restart markers
    between: each block's decisions, then the QM coder over them."""
    out = bytearray()
    segments = [units[i : i + restart] for i in range(0, len(units), restart)] if restart else [units]
    for n, segment in enumerate(segments):
        bins, bits = [], []
        b_app, v_app = bins.append, bits.append
        last = {c: 0 for c in members}
        context = {c: 0 for c in members}
        for mcu in segment:
            for c, by, bx in mcu:
                blk = comps[c][by, bx].tolist()
                t = tables[c]
                if ss == 0 and ah == 0:  # a DC value (sequential, or progressive first)
                    dc = blk[0] >> al
                    context[c] = _dc_decisions(b_app, v_app, 64 * t, context[c], dc - last[c], dc_l[t], dc_u[t])
                    last[c] = dc
                elif ss == 0:  # DC refinement: bit al
                    b_app(FIXED_BIN)
                    v_app((blk[0] >> al) & 1)
                if not progressive:
                    _ac_decisions(b_app, v_app, AC_BINS + 256 * t, blk, 1, 63, 0, ac_k[t])
                elif ss > 0 and ah == 0:
                    _ac_decisions(b_app, v_app, AC_BINS + 256 * t, blk, ss, se, al, ac_k[t])
                elif ss > 0:
                    _ac_refine_decisions(b_app, v_app, AC_BINS + 256 * t, blk, ss, se, ah, al)
        if n:
            out += bytes([0xFF, 0xD0 + (n - 1) % 8])
        out += qm_encode(bins, bits)
    return bytes(out)


def _magnitude_decisions(b_app, v_app, st, x1, v):
    """v >= 1: the magnitude category of v - 1 from bin ``st`` (F.8: the X
    bins from ``x1``, which for AC follow a second decision at ``st``),
    then its bits in the M bins 14 above the last X bin (F.9)."""
    m = 0
    v -= 1
    if v:
        b_app(st)
        v_app(1)
        m, v2 = 1, v
        if x1 < 0:  # DC: the X bins follow at once
            st = -x1
        elif v2 >> 1:  # AC: a second decision, then the X bins
            v2 >>= 1
            b_app(st)
            v_app(1)
            m <<= 1
            st = x1
        while v2 >> 1:
            v2 >>= 1
            b_app(st)
            v_app(1)
            m <<= 1
            st += 1
    b_app(st)
    v_app(0)
    st += 14
    while m > 1:
        m >>= 1
        b_app(st)
        v_app(1 if m & v else 0)
    return m


def _dc_decisions(b_app, v_app, base, context, diff, lo, hi) -> int:
    """One DC difference (F.1.4.1) -> the next conditioning context."""
    st = base + context
    b_app(st)
    if diff == 0:
        v_app(0)
        return 0
    v_app(1)
    sign = diff < 0
    b_app(st + 1)
    v_app(1 if sign else 0)
    v = -diff if sign else diff
    cat = (v - 1).bit_length()  # the magnitude category's leading bit is 1 << (cat - 1)
    _magnitude_decisions(b_app, v_app, st + (3 if sign else 2), -(base + 20), v)
    m = 1 << (cat - 1) if cat else 0
    if m < (1 << lo) >> 1:
        return 0
    return (8 if sign else 4) + (8 if m > (1 << hi) >> 1 else 0)


def _point(v, al):
    """The AC point transform: |v| >> al with v's sign."""
    return -((-v) >> al) if v < 0 else v >> al


def _ac_decisions(b_app, v_app, base, blk, ss, se, al, kx):
    """AC coefficients ss..se of one block (F.1.4.2, G.1.3.2), point-
    transformed by al."""
    vals = [_point(x, al) for x in blk] if al else blk
    ke = se
    while ke > 0 and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        st = base + 3 * (k - 1)
        b_app(st)
        v_app(0)  # not the end of the block
        while vals[k] == 0:
            b_app(st + 1)
            v_app(0)
            st += 3
            k += 1
        b_app(st + 1)
        v_app(1)
        v = vals[k]
        b_app(FIXED_BIN)
        v_app(1 if v < 0 else 0)
        _magnitude_decisions(b_app, v_app, st + 2, base + (189 if k <= kx else 217), -v if v < 0 else v)
        k += 1
    if k <= se:
        b_app(base + 3 * (k - 1))
        v_app(1)


def _ac_refine_decisions(b_app, v_app, base, blk, ss, se, ah, al):
    """An AC refinement scan's block (G.1.3.3): bit al of each coefficient."""
    vals = [abs(_point(x, al)) for x in blk]
    ke = se
    while ke > 0 and vals[ke] == 0:
        ke -= 1
    kex = ke
    while kex > 0 and _point(blk[kex], ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        st = base + 3 * (k - 1)
        if k > kex:
            b_app(st)
            v_app(0)
        while True:
            v = vals[k]
            if v:
                if v >> 1:  # nonzero before: its correction bit
                    b_app(st + 2)
                    v_app(v & 1)
                else:  # newly nonzero: its sign
                    b_app(st + 1)
                    v_app(1)
                    b_app(FIXED_BIN)
                    v_app(1 if blk[k] < 0 else 0)
                break
            b_app(st + 1)
            v_app(0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        b_app(base + 3 * (k - 1))
        v_app(1)


def _predict(x: np.ndarray, predictor: int, first_rows, initial: int) -> np.ndarray:
    """The lossless prediction of every sample of a plane (ITU T.81 H.1.2):
    the first row of the scan or a restart interval from ``initial`` and
    its left neighbours, the first column from above, the rest by
    ``predictor``."""
    x = x.astype(np.int64)
    p = np.zeros_like(x)
    ra, rb, rc = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    p[1:, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                 7: (ra + rb) >> 1}[predictor]
    p[1:, 0] = x[:-1, 0]
    for r in first_rows:
        p[r, 0] = initial
        p[r, 1:] = x[r, :-1]
    return p


def lossless_jpeg(planes: list, factors: list, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  adobe=None, jfif: bool = False, ids=None) -> bytes:
    """A lossless (SOF3) file of 8-bit sample planes (each at its
    component's size for ``factors``), one interleaved scan with predictor
    ``predictor`` and point transform ``pt``, a restart marker every
    ``restart_rows`` MCU rows, the differences coded with the Annex K
    luminance DC table, and a JFIF or Adobe marker when asked for."""
    nc = len(planes)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    h = max(-(-pl.shape[0] * vmax // f[1]) for pl, f in zip(planes, factors))
    w = max(-(-pl.shape[1] * hmax // f[0]) for pl, f in zip(planes, factors))
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    diffs = []
    for pl, (ch, cv) in zip(planes, factors):
        x = pl.astype(np.int64) >> pt
        first = [r for r in range(0, x.shape[0], cv * restart_rows or x.shape[0])]
        d = (x - _predict(x, predictor, first, 1 << (7 - pt))) & 0xFFFF
        d = np.where(d >= 32768, d - 65536, d)
        full = np.zeros((mcuy * cv, mcux * ch), np.int64)
        full[: d.shape[0], : d.shape[1]] = d
        diffs.append(full.reshape(mcuy, cv, mcux, ch).transpose(0, 2, 1, 3).reshape(mcuy, mcux, -1))
    mcus = np.concatenate(diffs, axis=2)  # [mcuy, mcux, samples of an MCU]
    code, length = _huff_codes(*JPEG_DC)
    out = bytearray()
    rows_per_segment = restart_rows or mcuy
    for n, y0 in enumerate(range(0, mcuy, rows_per_segment)):
        bits = []
        for v in mcus[y0 : y0 + rows_per_segment].reshape(-1).tolist():
            s = 0 if v == 0 else (16 if v == 32768 or v == -32768 else abs(v).bit_length())
            bits.append(format(int(code[s]), f"0{int(length[s])}b"))
            if 0 < s < 16:
                bits.append(format(v if v >= 0 else v + (1 << s) - 1, f"0{s}b"))
        seg = "".join(bits)
        seg += "1" * (-len(seg) % 8)
        if n:
            out += bytes([0xFF, 0xD0 + (n - 1) % 8])
        out += _pack(seg).replace(b"\xff", b"\xff\x00")
    ids = ids or list(range(1, nc + 1))
    sof = [8, *h.to_bytes(2, "big"), *w.to_bytes(2, "big"), nc]
    for i, (ch, cv) in zip(ids, factors):
        sof += [i, ch * 16 + cv, 0]
    head = b"\xff\xd8"
    if jfif:
        head += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        head += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    if restart_rows:
        head += _segment(0xDD, list((restart_rows * mcux).to_bytes(2, "big")))
    sos = [nc] + [x for i in ids for x in (i, 0)] + [predictor, 0, pt]
    return (head + _segment(0xC3, sof) + _segment(0xC4, [0, *JPEG_DC[0], *JPEG_DC[1]]) + _segment(0xDA, sos)
            + bytes(out) + b"\xff\xd9")


def twelve_bit_jpeg(gray: np.ndarray, quality: int = 95, sof: int = 0xC1) -> bytes:
    """A 12-bit extended sequential (SOF1) JPEG of a [H,W] 0..4095 image:
    one scan, Huffman tables that hold every DC category to 15 and every
    AC run/size to size 14 (codes of 5 and 8 bits)."""
    h, w = gray.shape
    comps, qt, _, _ = plane_coefficients([gray.astype(np.float64) - 2048 + 128], [(1, 1)], quality)
    coef = comps[0].reshape(-1, 64)
    dc_syms, ac_syms = list(range(16)), [0, 0xF0] + [r * 16 + s for r in range(16) for s in range(1, 15)]
    dc_bits, ac_bits = [0] * 16, [0] * 16
    dc_bits[4], ac_bits[7] = len(dc_syms), len(ac_syms)
    dcc, dcl = _huff_codes(dc_bits, dc_syms)
    acc, acl = _huff_codes(ac_bits, ac_syms)
    out, last = [], 0

    def put(sym_code, sym_len, v, s):
        out.append(format(int(sym_code), f"0{int(sym_len)}b"))
        if s:
            out.append(format(v if v >= 0 else v + (1 << s) - 1, f"0{s}b"))

    for blk in coef.tolist():
        diff, last = blk[0] - last, blk[0]
        s = abs(diff).bit_length()
        put(dcc[s], dcl[s], diff, s)
        nz = [k for k in range(1, 64) if blk[k]]
        run = 0
        for k in range(1, (nz[-1] if nz else 0) + 1):
            if blk[k] == 0:
                run += 1
                continue
            while run > 15:
                put(acc[0xF0], acl[0xF0], 0, 0)
                run -= 16
            s = abs(blk[k]).bit_length()
            put(acc[run * 16 + s], acl[run * 16 + s], blk[k], s)
            run = 0
        if not nz or nz[-1] < 63:
            put(acc[0], acl[0], 0, 0)
    data = _pack("".join(out).ljust(-(-len("".join(out)) // 8) * 8, "1")).replace(b"\xff", b"\xff\x00")
    sof_body = [12, *h.to_bytes(2, "big"), *w.to_bytes(2, "big"), 1, 1, 0x11, 0]
    return (b"\xff\xd8" + _segment(0xDB, [0, *qt[ZIGZAG].tolist()]) + _segment(sof, sof_body)
            + _segment(0xC4, [0x00, *dc_bits, *dc_syms]) + _segment(0xC4, [0x10, *ac_bits, *ac_syms])
            + _segment(0xDA, [1, 1, 0x00, 0, 63, 0]) + data + b"\xff\xd9")


def jpeg_encode(image: np.ndarray, quality: int = 95, sampling=(1, 1), coding: str = "huffman", **kw) -> bytes:
    """A JFIF file of a gray [H,W] or BGR [H,W,3] uint8 image: ``coding``
    "huffman" (baseline), "arith" (SOF9) or "arith-progressive" (SOF10),
    the same quantised coefficients (``jpeg_coefficients``) in each, so
    that all decode to the same pixels."""
    parts = jpeg_coefficients(image, quality, sampling)
    if coding == "huffman":
        return huffman_jpeg(*parts)
    return arith_jpeg(*parts, progressive=coding == "arith-progressive", **kw)


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------


def bits_of(h: int, w: int, seed: int) -> np.ndarray:
    """[H,W] bilevel bits (1 black): blocks, lines and speckle."""
    rng = np.random.default_rng(seed)
    b = np.zeros((h, w), np.uint8)
    for _ in range(25):
        y, x = rng.integers(0, h), rng.integers(0, w)
        b[y : y + rng.integers(1, h + 1), x : x + rng.integers(1, w + 1)] ^= 1
    b[rng.random((h, w)) < 0.03] ^= 1
    return b


def cases(pil=None) -> dict:
    """{name: (extension, file bytes)}: every coding this slice reads, small.
    ``pil`` (the PIL package, optional) adds its CMYK JPEG and libtiff's
    Group 3 and 4 files."""
    g, c = image_tool.micrograph(32, 40, 1), image_tool.micrograph(32, 40, 2, channels=3)
    rgb = [c[..., 2], c[..., 1], c[..., 0]]
    bits = bits_of(30, 50, 3)
    out = {}
    for comp, name in ((RAW, "raw"), (LZW, "lzw"), (DEFLATE, "deflate"), (PACKBITS, "packbits")):
        out[f"fill2_{name}"] = ("tif", tiff_of(g, comp, rows_per_strip=7, fill_order=2))
    out["fill2_lzw_tiles_rgb"] = ("tif", tiff_of(c, LZW, tile=(16, 16), fill_order=2))
    out["lzw_old_style"] = ("tif", tiff_of(c, LZW_COMPAT, rows_per_strip=10))
    out["cielab"] = ("tif", image_tool.tiff_image(c, 8, photometric=8, rows_per_strip=9))
    out["gray_extra_samples"] = ("tif", image_tool.tiff_image(c, 8, photometric=1, rows_per_strip=9))
    out["bigtiff_ii_strips"] = ("tif", tiff_of(c, DEFLATE, rows_per_strip=5, big=True))
    out["bigtiff_mm_strips"] = ("tif", tiff_of(g, PACKBITS, rows_per_strip=5, big=True, big_endian=True))
    out["bigtiff_ii_lzw_tiles"] = ("tif", tiff_of(g, LZW, tile=(16, 16), big=True))
    out["bigtiff_mm_raw_tiles"] = ("tif", tiff_of(c, RAW, tile=(16, 16), big=True, big_endian=True))
    out["bigtiff_short_offsets"] = ("tif", tiff_of(g, LZW, rows_per_strip=4, big=True, offsets_type=SHORT))
    for comp, opts, name in ((CCITT_RLE, 0, "rle"), (CCITT_RLEW, 0, "rlew"), (CCITT_G3, 0, "g3_1d"),
                             (CCITT_G3, 1, "g3_2d"), (CCITT_G3, 5, "g3_2d_fill"), (CCITT_G4, 0, "g4")):
        out[f"fax_{name}"] = ("tif", fax_tiff(bits, comp, opts, rows_per_strip=12))
    out["fax_g4_fill2_blackiszero"] = ("tif", fax_tiff(bits, CCITT_G4, fill_order=2, photometric=1))
    out["fax_g3_2d_tiles"] = ("tif", fax_tiff(bits, CCITT_G3, 1, tile=(16, 32)))
    out["fax_g4_bigtiff"] = ("tif", fax_tiff(bits, CCITT_G4, big=True))
    out["fax_g3_2d_cut"] = ("tif", fax_tiff(bits, CCITT_G3, 1, keep=0.6))
    damaged = bytearray(fax_tiff(bits, CCITT_G4))
    damaged[8 + 20] ^= 0x5A  # a bad code word inside the strip
    out["fax_g4_damaged"] = ("tif", bytes(damaged))
    gray_parts, colour_parts = jpeg_coefficients(g, 90), jpeg_coefficients(c, 90, (2, 2))
    out["arith_gray"] = ("jpg", arith_jpeg(*gray_parts))
    out["arith_420"] = ("jpg", arith_jpeg(*colour_parts))
    out["arith_progressive_420"] = ("jpg", arith_jpeg(*colour_parts, progressive=True))
    out["arith_restart_dac"] = ("jpg", arith_jpeg(*colour_parts, restart=2, dac={0: 0x52, 16: 2}))
    full = arith_jpeg(*colour_parts)
    out["arith_cut"] = ("jpg", full[: len(full) * 2 // 3])
    k = image_tool.micrograph(32, 40, 4).astype(np.float64)
    out["ycck"] = ("jpg", huffman_jpeg(*plane_coefficients(ycc_planes(c) + [k], [(2, 2), (1, 1), (1, 1), (2, 2)], 90),
                                      adobe=2))
    out["cmyk_arith"] = ("jpg", arith_jpeg(*plane_coefficients([p.astype(np.float64) for p in rgb] + [k],
                                                              [(1, 1)] * 4, 90), adobe=0))
    progressive = arith_jpeg(*jpeg_coefficients(c, 85, (2, 2)), progressive=True)
    sos = [i for i in range(len(progressive) - 1) if progressive[i : i + 2] == b"\xff\xda"]
    out["smoothing_dc_only"] = ("jpg", progressive[: sos[1]])
    out["smoothing_mid_scan"] = ("jpg", progressive[: (sos[2] + sos[3]) // 2])
    out["smoothing_late_scan"] = ("jpg", progressive[: sos[6] + 40])
    for pred in (1, 4, 7):
        out[f"lossless_pred{pred}"] = ("jpg", lossless_jpeg(rgb, [(1, 1)] * 3, pred))
    out["lossless_pt2_restart"] = ("jpg", lossless_jpeg(rgb, [(1, 1)] * 3, 5, pt=2, restart_rows=3))
    out["lossless_420"] = ("jpg", lossless_jpeg([rgb[0], rgb[1][::2, ::2], rgb[2][::2, ::2]],
                                                [(2, 2), (1, 1), (1, 1)], 6))
    rng = np.random.default_rng(5)
    for depth, hsize, masks, name in ((16, 40, (0xF800, 0x7E0, 0x1F), "bmp_rgb565"), (16, 40, None, "bmp_rgb555"),
                                      (32, 124, (0xFF, 0xFF00, 0xFF0000), "bmp_xbgr32_v5"),
                                      (8, 12, None, "bmp_os2_palette8"), (4, 12, None, "bmp_os2_palette4")):
        rows = rng.integers(0, 256, (23, (31 * depth + 31) // 32 * 4)).astype(np.uint8).tobytes()
        palette = rng.integers(0, 256, 3 << depth).astype(np.uint8).tobytes() if depth <= 8 else b""
        out[name] = ("bmp", bmp_raw(31, 23, depth, rows, hsize, 3 if masks else 0, masks, palette))
    if pil is not None:
        import io

        buf = io.BytesIO()
        pil.Image.fromarray(c[..., ::-1]).convert("CMYK").save(buf, "JPEG", quality=90)
        out["cmyk_pil"] = ("jpg", buf.getvalue())
        from PIL import TiffImagePlugin

        TiffImagePlugin.WRITE_LIBTIFF = True
        try:
            for comp, info, name in (("group3", {292: 1}, "libtiff_g3_2d"), ("group4", {266: 2}, "libtiff_g4_fill2")):
                buf = io.BytesIO()
                pil.Image.fromarray(bits * 255).convert("1").save(buf, "TIFF", compression=comp, tiffinfo=info)
                out[name] = ("tif", buf.getvalue())
        finally:
            TiffImagePlugin.WRITE_LIBTIFF = False
    return out


def main(path: str = DEFAULT_OUT) -> None:
    import tempfile

    import cv2
    import PIL.Image

    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (ext, data) in cases(PIL).items():
            f = os.path.join(tmp, f"{name}.{ext}")
            with open(f, "wb") as fh:
                fh.write(data)
            ref = cv2.imread(f, cv2.IMREAD_COLOR)
            if ref is None:
                raise RuntimeError(f"OpenCV does not read {name}")
            arrays[f"{name}.{ext}"] = np.frombuffer(data, np.uint8)
            arrays[name] = ref
    np.savez_compressed(path, **arrays)
    print(f"{path}: {len(arrays) // 2} cases, {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()

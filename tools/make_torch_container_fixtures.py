"""Write ``tests/data/torch_container_fixtures.npz``: small files in the
image containers ``read_image`` reads beside PNG, TIFF, JPEG and BMP (the
PNM family, PAM, PFM, Sun raster, Radiance HDR, GIF and WebP), each beside
the array ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns for it here
(OpenCV 5.0, libwebp 1.6).

``chip_smoke.py`` decodes them on a host that has no OpenCV and holds the
port's decoders to these arrays; ``tests/test_torch_containers.py`` checks
that the file still matches cv2. The writers below (numpy, no image
library) also make the test files of the forms cv2 and PIL do not write.

Usage: ``python tools/make_torch_container_fixtures.py [out.npz]``
(deterministic; needs cv2 and PIL).
"""

from __future__ import annotations

import hashlib
import io
import struct
import sys
import tempfile
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path(__file__).resolve().parents[1] / "tests" / "data" / "torch_container_fixtures.npz"


def micrograph(h: int, w: int, seed: int, gray: bool = False) -> np.ndarray:
    """A smooth BGR (or gray) uint8 test image: gradients, blobs and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        img[..., c] = 128 + 60 * np.sin(x / (5 + 3 * c) + c) * np.cos(y / (7 + 2 * c))
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 9)
        img -= 70 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))[..., None]
    img += rng.normal(0, 6, img.shape)
    out = np.clip(img, 0, 255).astype(np.uint8)
    return out[..., 1] if gray else out


# ---------------------------------------------------------------------------
# numpy writers
# ---------------------------------------------------------------------------


def pnm(code: int, samples: np.ndarray, maxval: int = 255, header: bytes = None, sep: bytes = b" ") -> bytes:
    """P1-P6 of ``samples`` ([H,W] or [H,W,3] R, G, B; bits for P1/P4):
    ASCII values joined by ``sep``; 16-bit big-endian past maxval 255.
    ``header`` replaces the text between the magic and the raster."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w = s.shape[:2]
    head = header if header is not None else (
        f"\n{w} {h}\n".encode() + (b"" if code in (1, 4) else f"{maxval}\n".encode()))
    if code == 1:
        body = b"\n".join(b" ".join(str(int(v)).encode() for v in row) for row in s[..., 0]) + b"\n"
    elif code == 4:
        body = np.packbits(s[..., 0].astype(np.uint8), axis=1).tobytes()
    elif code in (2, 3):
        body = b"\n".join(sep.join(str(int(v)).encode() for v in row.ravel()) for row in s) + b"\n"
    else:
        body = s.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return f"P{code}".encode() + head + body


def pam(samples: np.ndarray, maxval: int = 255, tupltype: str = None, header: bytes = None) -> bytes:
    """P7 of ``samples`` [H,W,D] (16-bit big-endian past maxval 255)."""
    h, w, d = samples.shape
    head = header if header is not None else (
        f"WIDTH {w}\nHEIGHT {h}\nDEPTH {d}\nMAXVAL {maxval}\n".encode()
        + (f"TUPLTYPE {tupltype}\n".encode() if tupltype else b"") + b"ENDHDR\n")
    return b"P7\n" + head + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm(rgb: np.ndarray, scale: float = -1.0, gray: bool = False, scale_text: bytes = None) -> bytes:
    """PF (or Pf) of float ``rgb`` [H,W,3] (or [H,W]) R, G, B, rows bottom to
    top, little-endian for a negative scale."""
    h, w = rgb.shape[:2]
    text = scale_text if scale_text is not None else repr(float(scale)).encode()
    body = np.ascontiguousarray(rgb[::-1]).astype("<f4" if scale < 0 else ">f4").tobytes()
    return (b"Pf\n" if gray else b"PF\n") + f"{w} {h}\n".encode() + text + b"\n" + body


def sun(w: int, h: int, bpp: int, rows: np.ndarray, typ: int = 1, maptype: int = 0, cmap: bytes = b"") -> bytes:
    """A Sun raster of ``rows`` [H, bytes] (padded to 16 bits here)."""
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    raw = np.zeros((h, pitch), np.uint8)
    raw[:, : rows.shape[1]] = rows
    return struct.pack(">8I", 0x59A66A95, w, h, bpp, raw.size, typ, maptype, len(cmap)) + cmap + raw.tobytes()


def rgbe_of(rgb: np.ndarray) -> np.ndarray:
    """float [H,W,3] R, G, B -> [H,W,4] RGBE bytes (Ward's float2rgbe)."""
    v = rgb.max(axis=2)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0, m * 256.0 / np.where(v < 1e-32, 1, v))
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128)
    return out


def hdr(rgbe: np.ndarray, rle: bool = True, head: bytes = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
        size: bytes = None, old_runs: bool = False) -> bytes:
    """A Radiance file of ``rgbe`` [H,W,4]: new-style RLE scanlines (runs of
    3 or more, literal stretches of up to 128), or flat pixels, or, with
    ``old_runs``, flat pixels where a repeat of the previous pixel is an
    old-style run (1, 1, 1, count)."""
    h, w = rgbe.shape[:2]
    out = bytearray(head + (size if size is not None else f"-Y {h} +X {w}\n".encode()))
    if old_runs:
        flat = rgbe.reshape(-1, 4)
        i = 0
        while i < len(flat):
            j = i + 1
            while j < len(flat) and j - i < 256 and (flat[j] == flat[i]).all():
                j += 1
            out += flat[i].tobytes()
            if j - i > 1:
                out += bytes([1, 1, 1, j - i - 1])
            i = j
        return bytes(out)
    if not rle:
        return bytes(out) + rgbe.tobytes()
    for row in rgbe:
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            ch = row[:, c]
            # runs of 3 or more equal bytes (split at 127), literal stretches of up to 128 between them
            starts = np.flatnonzero(np.r_[True, ch[1:] != ch[:-1]])
            lengths = np.diff(np.r_[starts, w])
            i = 0
            for st, n in zip(starts.tolist(), lengths.tolist()):
                if n < 3:
                    continue
                while i < st:
                    k = min(128, st - i)
                    out += bytes([k]) + ch[i : i + k].tobytes()
                    i += k
                while n >= 3:
                    k = min(127, n)
                    if n - k in (1, 2):  # leave a run of 3 or more, or nothing
                        k -= 3 - (n - k)
                    out += bytes([128 + k, ch[st]])
                    st, n, i = st + k, n - k, st + k
            while i < w:
                k = min(128, w - i)
                out += bytes([k]) + ch[i : i + k].tobytes()
                i += k
    return bytes(out)


def gif_lzw(indices: np.ndarray, min_size: int, clear_every: int = 0, deferred: bool = False) -> bytes:
    """GIF LZW of palette ``indices`` (flat) at code size ``min_size``:
    LSB-first variable-width codes, a Clear first, a Clear where the table
    fills (or after every ``clear_every`` codes; with ``deferred``, none:
    12-bit codes go on with the full table), and an End."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    width, table, next_code = min_size + 1, {}, end + 1  # table: (prefix code << 8 | byte) -> code

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    put(clear)
    seq, emitted = -1, 0
    for v in indices.ravel().tolist():
        if seq < 0:
            seq = v
            continue
        key = seq << 8 | v
        code = table.get(key)
        if code is not None:
            seq = code
            continue
        put(seq)
        emitted += 1
        if next_code < 4096 and not (clear_every and emitted % clear_every == 0):
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        elif not deferred or clear_every:
            put(clear)
            table, next_code, width = {}, end + 1, min_size + 1
        seq = v
    if seq >= 0:
        put(seq)
        if next_code < 4096:
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
    put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def gif_blocks(data: bytes) -> bytes:
    """Data sub-blocks of at most 255 bytes, then the terminator."""
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255] for i in range(0, len(data), 255)) + b"\0"


def gif(frames: list, screen: tuple, palette: np.ndarray = None, background: int = 0, version: bytes = b"89a",
        extensions: bytes = b"") -> bytes:
    """A GIF of ``frames``: dicts of ``indices`` [h,w], and optionally
    ``left``, ``top``, ``palette`` (a local table), ``interlace``,
    ``transparent`` (index), ``disposal``, ``delay``, ``min_size`` (LZW code
    size) and ``lzw`` (the raw image data in place of the encoded indices);
    ``palette`` [2**k, 3] R, G, B is the global table, ``screen`` (w, h)."""
    sw, sh = screen
    flags = 0
    if palette is not None:
        flags = 0x80 | 0x70 | (int(np.log2(len(palette))) - 1)
    out = bytearray(b"GIF" + version + struct.pack("<HHBBB", sw, sh, flags, background, 0))
    if palette is not None:
        out += palette.astype(np.uint8).tobytes()
    out += extensions
    for f in frames:
        idx = f["indices"]
        h, w = idx.shape
        if "transparent" in f or "disposal" in f or "delay" in f:
            t = f.get("transparent")
            packed = (f.get("disposal", 0) << 2) | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, f.get("delay", 0), t or 0) + b"\0"
        lp = f.get("palette")
        fl = (0x80 | (int(np.log2(len(lp))) - 1) if lp is not None else 0) | (0x40 if f.get("interlace") else 0)
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h, fl)
        if lp is not None:
            out += lp.astype(np.uint8).tobytes()
        rows = idx
        if f.get("interlace"):
            rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        size = f.get("min_size", max(2, int(np.ceil(np.log2(max(int(idx.max()) + 1, 2))))))
        out += bytes([size]) + gif_blocks(f.get("lzw", gif_lzw(rows, size)))
    return bytes(out + b"\x3b")


_REVERSED = np.packbits(np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)[:, ::-1], axis=1)[:, 0]
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _bits(fields) -> np.ndarray:
    """(value, bit count) pairs -> their bits, each value LSB first."""
    return np.array([(v >> i) & 1 for v, n in fields for i in range(n)], np.uint8)


def _eight_bit_code(alphabet: int) -> list:
    """A VP8L normal prefix code that gives the first 256 symbols of
    ``alphabet`` 8 bits (symbol s's code is s) and the rest none: its code
    length code has the lengths 0 and 8 at one bit each."""
    fields = [(0, 1), (12 - 4, 4)]
    fields += [(1 if sym in (0, 8) else 0, 3) for sym in _CODE_LENGTH_ORDER[:12]]
    fields += [(0, 1)]  # every symbol's length is written
    return fields + [(1, 1)] * 256 + [(0, 1)] * (alphabet - 256)


def vp8l(rgb: np.ndarray) -> bytes:
    """A lossless WebP of [H,W,3] R, G, B that any VP8L decoder reads: the
    subtract-green transform, no colour cache, one prefix-code group whose
    green, red and blue codes give every byte 8 bits, a constant alpha of
    255 and a one-symbol distance code; every pixel a literal."""
    h, w, _ = rgb.shape
    fields = [(0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (0, 3), (1, 1), (2, 2), (0, 1), (0, 1), (0, 1)]
    fields += _eight_bit_code(256 + 24) + _eight_bit_code(256) + _eight_bit_code(256)
    fields += [(1, 1), (0, 1), (1, 1), (255, 8)]  # alpha: one 8-bit symbol, 255
    fields += [(1, 1), (0, 1), (0, 1), (0, 1)]  # distance: one 1-bit symbol, 0
    head = _bits(fields)
    g = rgb[..., 1]
    px = np.stack([g, rgb[..., 0] - g, rgb[..., 2] - g], axis=-1)  # green, red - green, blue - green (mod 256)
    body = np.unpackbits(_REVERSED[px].reshape(-1), bitorder="little")
    payload = np.packbits(np.concatenate([head, body]), bitorder="little").tobytes()
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _vp8_tables():
    """RFC 6386's default token probabilities and their update
    probabilities, [4][8][3][11] each, read from ``native/webp.cpp``."""
    import re

    src = (Path(__file__).resolve().parents[1] / "deepemia_tpu_torch" / "native" / "webp.cpp").read_text()

    def table(name):
        body = re.search(name + r"\[4\]\[8\]\[3\]\[11\] = \{(.*?)\};", src, re.S).group(1)
        return np.array([int(v) for v in re.findall(r"\d+", body)], np.int64).reshape(4, 8, 3, 11)

    return table("kCoeffsProba0"), table("kCoeffsUpdateProba")


class BoolEncoder:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, bit: int, prob: int = 128) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def value(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def signed(self, v: int, n: int) -> None:
        self.value(abs(v), n)
        self.put(int(v < 0))

    def optional(self, v, n: int, signed: bool = True) -> None:
        """A flag, then the value if it is not 0 (or None)."""
        self.put(int(bool(v)))
        if v:
            (self.signed if signed else self.value)(v, n)

    def bytes(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        out = bytearray(self.out)
        for _ in range(4):
            out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(out)


def vp8_frame(width: int, height: int, seed: int = 0, partitions: int = 0, segments: int = 0,
              absolute: bool = False, simple: bool = False, level: int = 20, sharpness: int = 0,
              lf_deltas: bool = False, skip_prob: int = None, base_q: int = 40) -> bytes:
    """A lossy WebP of one VP8 key frame that no encoder here writes:
    ``1 << partitions`` token partitions, ``segments`` segments (with a
    map, random ids, absolute or relative quantizers and filter levels),
    the simple or normal loop filter at ``level`` and ``sharpness``,
    reference and mode filter deltas, a skip probability; every macroblock
    16x16-predicted (random DC/V/H/TM luma and chroma modes) with a random
    Y2 DC and chroma DCs of 1 to 4 (all AC tokens end at once), the
    default token probabilities."""
    rng = np.random.default_rng(seed)
    proba, update = _vp8_tables()
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    hdr = BoolEncoder()
    hdr.value(0, 1)  # colour space
    hdr.value(0, 1)  # clamping type
    seg_probs = [int(v) for v in rng.integers(1, 256, 3)]
    hdr.put(int(segments > 0))
    if segments:
        hdr.put(1)  # update the map
        hdr.put(1)  # update the data
        hdr.put(int(absolute))
        for _ in range(4):
            hdr.optional(int(rng.integers(1, 100)) if absolute else int(rng.integers(-20, 21)), 7)
        for _ in range(4):
            hdr.optional(int(rng.integers(0, 60)) if absolute else int(rng.integers(-15, 16)), 6)
        for p in seg_probs:
            hdr.optional(p, 8, signed=False)
    hdr.put(int(simple))
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.put(int(lf_deltas))
    if lf_deltas:
        hdr.put(1)
        for _ in range(8):
            hdr.optional(int(rng.integers(-20, 21)), 6)
    hdr.value(partitions, 2)
    hdr.value(base_q, 7)
    for _ in range(5):
        hdr.optional(int(rng.integers(-8, 9)), 4)
    hdr.put(0)  # refresh entropy probabilities
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for k in range(11):
                    hdr.put(0, int(update[t, b, c, k]))
    hdr.put(int(skip_prob is not None))
    if skip_prob is not None:
        hdr.value(skip_prob, 8)
    parts = [BoolEncoder() for _ in range(1 << partitions)]
    top_dc = np.zeros(mbw, np.int64)  # Y2 non-zero above each column
    top_uv = np.zeros((mbw, 2, 2), np.int64)  # chroma DC non-zero flags of the bottom row above, per plane
    for y in range(mbh):
        tok = parts[y % len(parts)]
        left_dc, left_uv = 0, np.zeros((2, 2), np.int64)
        for x in range(mbw):
            if segments:
                sid = int(rng.integers(0, 4))
                hdr.put(sid >> 1, seg_probs[0])
                hdr.put(sid & 1, seg_probs[2 if sid >> 1 else 1])
            skip = skip_prob is not None and rng.random() < 0.3
            if skip_prob is not None:
                hdr.put(int(skip), skip_prob)
            hdr.put(1, 145)  # 16x16 prediction
            ymode = int(rng.integers(0, 4))  # DC, TM, V, H: bits 156 then 163 or 128
            hdr.put(int(ymode in (1, 3)), 156)
            hdr.put(int(ymode == 1) if ymode in (1, 3) else int(ymode == 2), 128 if ymode in (1, 3) else 163)
            uv = int(rng.integers(0, 4))
            hdr.put(int(uv != 0), 142)
            if uv:
                hdr.put(int(uv != 2), 114)
                if uv != 2:
                    hdr.put(int(uv == 1), 183)
            if skip:  # no tokens: the Y2 context falls to 0 with the rest
                top_dc[x] = left_dc = 0
                top_uv[x] = 0
                left_uv[:] = 0
                continue

            def dc_token(t, ctx, v):
                p = proba[t, 0, ctx]
                tok.put(1, int(p[0]))
                tok.put(1, int(p[1]))
                if v == 1:
                    tok.put(0, int(p[2]))
                else:
                    tok.put(1, int(p[2]))
                    tok.put(0, int(p[3]))
                    tok.put(int(v > 2), int(p[4]))
                    if v > 2:
                        tok.put(v - 3, int(p[5]))
                tok.put(int(rng.random() < 0.5))  # the sign
                tok.put(0, int(proba[t, 1, 1 if v == 1 else 2][0]))  # end of block after the DC

            v = int(rng.integers(1, 5))
            dc_token(1, int(top_dc[x] + left_dc), v)
            top_dc[x] = left_dc = 1
            for _ in range(16):  # Y after Y2: ends at once (context 0: no neighbour past its DC)
                tok.put(0, int(proba[0, 1, 0][0]))
            new_top = np.zeros((2, 2), np.int64)
            for plane in range(2):
                for by in range(2):
                    for bx in range(2):
                        above = top_uv[x, plane, bx] if by == 0 else new_top[plane, bx]
                        ctx = int(left_uv[plane, by] + above)
                        if rng.random() < 0.5:
                            dc_token(2, ctx, int(rng.integers(1, 5)))
                            nz = 1
                        else:
                            tok.put(0, int(proba[2, 0, ctx][0]))
                            nz = 0
                        left_uv[plane, by] = nz
                        new_top[plane, bx] = nz
            top_uv[x] = new_top
    first = hdr.bytes()
    tokens = [p.bytes() for p in parts]
    sizes = b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
    tag = (len(first) << 5) | (1 << 4)  # key frame, profile 0, shown
    frame = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", width, height) + first + sizes \
        + b"".join(tokens)
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame + b"\0" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


# ---------------------------------------------------------------------------
# libwebp's own encoder, for the VP8 forms cv2 and PIL do not ask it for
# ---------------------------------------------------------------------------


def _libwebp():
    """Pillow's bundled libwebp, loaded with ctypes: its WebPEncode takes a
    WebPConfig (filter type, sharpness, segments...), which Pillow's and
    OpenCV's WebP writers do not expose."""
    import ctypes
    import glob
    import os

    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])


def libwebp_encode(rgb: np.ndarray, **options) -> bytes:
    """[H,W,3] R, G, B (or [H,W,4] with alpha) -> a WebP file from
    libwebp's advanced encoder, ``options`` set on its WebPConfig
    (``quality``, ``filter_type`` 0 simple / 1 normal, ``filter_strength``,
    ``filter_sharpness``, ``segments``, ``sns_strength``, ``method``,
    ``lossless``, ...)."""
    import ctypes

    P = ctypes.c_void_p

    class Config(ctypes.Structure):
        _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int) for n in (
            "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments", "sns_strength",
            "filter_strength", "filter_sharpness", "filter_type", "autofilter", "alpha_compression",
            "alpha_filtering", "alpha_quality", "pass_", "show_compressed", "preprocessing", "partitions",
            "partition_limit", "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
            "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")] + [("pad", ctypes.c_uint32 * 32)]

    class Picture(ctypes.Structure):
        _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int), ("width", ctypes.c_int),
                    ("height", ctypes.c_int), ("y", P), ("u", P), ("v", P), ("y_stride", ctypes.c_int),
                    ("uv_stride", ctypes.c_int), ("a", P), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                    ("argb", P), ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3), ("writer", P),
                    ("custom_ptr", P), ("extra_info_type", ctypes.c_int), ("extra_info", P), ("stats", P),
                    ("error_code", ctypes.c_int), ("progress_hook", P), ("user_data", P),
                    ("pad3", ctypes.c_uint32 * 3), ("pad4", P), ("pad5", P), ("pad6", ctypes.c_uint32 * 8),
                    ("memory_", P), ("memory_argb_", P), ("pad7", P * 2), ("spare", ctypes.c_uint8 * 256)]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", P), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]

    lib = _libwebp()
    for fn, args in (("WebPConfigInitInternal", [P, ctypes.c_int, ctypes.c_float, ctypes.c_int]),
                     ("WebPPictureInitInternal", [P, ctypes.c_int]), ("WebPPictureImportRGB", [P, P, ctypes.c_int]),
                     ("WebPPictureImportRGBA", [P, P, ctypes.c_int]), ("WebPMemoryWriterInit", [P]),
                     ("WebPEncode", [P, P]), ("WebPPictureFree", [P]), ("WebPValidateConfig", [P]),
                     ("WebPMemoryWriterClear", [P])):
        getattr(lib, fn).argtypes = args
    cfg = Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(options.pop("quality", 75)), 0x0210)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), 0x0210)
    h, w, c = rgb.shape
    pic.width, pic.height, pic.use_argb = w, h, cfg.lossless
    arr = np.ascontiguousarray(rgb, np.uint8)
    import_rgb = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert import_rgb(ctypes.byref(pic), arr.ctypes.data, w * c)
    writer = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, P).value
    pic.custom_ptr = ctypes.cast(ctypes.byref(writer), P).value
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    out = ctypes.string_at(writer.mem, writer.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(writer))
    assert ok, pic.error_code
    return out


# the WebPConfig forms the fixtures hold: the simple filter, every sharpness, no filter, one segment, no
# noise shaping, the fastest and slowest methods
VP8_FORMS = {
    "simple": dict(filter_type=0, filter_strength=60), "simple-sharp7": dict(filter_type=0, filter_strength=100,
                                                                            filter_sharpness=7),
    **{f"sharp{k}": dict(filter_sharpness=k, filter_strength=80) for k in range(1, 8)},
    "nofilter": dict(filter_strength=0), "one-segment": dict(segments=1), "two-segments": dict(segments=2),
    "no-sns": dict(sns_strength=0), "method0": dict(method=0), "method6": dict(method=6, pass_=4),
    "q5-simple": dict(quality=5, filter_type=0), "q100": dict(quality=100), "sharp-yuv": dict(use_sharp_yuv=1),
}


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------


def _cv2_write(ext: str, img: np.ndarray, params=()) -> bytes:
    import cv2

    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


def cases() -> dict:
    """{name: (extension, file bytes)} of every form the fixtures cover."""
    import cv2
    from PIL import Image

    img = micrograph(23, 31, 1)
    gray = micrograph(23, 31, 2, gray=True)
    rng = np.random.default_rng(5)
    rgb = img[..., ::-1]
    out = {
        "pbm-binary": (".pbm", pnm(4, gray > 128)),
        "pbm-ascii": (".pbm", pnm(1, gray > 128)),
        "pgm-binary": (".pgm", _cv2_write(".pgm", gray)),
        "pgm-ascii-100": (".pgm", pnm(2, gray // 3, 100)),
        "pgm-16": (".pgm", pnm(5, gray.astype(np.uint16) * 257 + 3, 65535)),
        "ppm-binary": (".ppm", _cv2_write(".ppm", img)),
        "ppm-ascii-1000": (".ppm", pnm(3, rgb.astype(np.int64) * 4, 1000)),
        "pam-rgb": (".pam", _cv2_write(".pam", img)),
        "pam-gray-16": (".pam", pam(gray[..., None].astype(np.uint16) * 250, 65535, "GRAYSCALE")),
        "pam-bits": (".pam", pam((gray > 128)[..., None], 1, "BLACKANDWHITE")),
        "pfm": (".pfm", pfm(rgb.astype(np.float32) / 255 * 3, -1 / 85.0)),
        "sun-8": (".ras", _cv2_write(".sr", gray)),
        "sun-24": (".ras", _cv2_write(".sr", img)),
        "sun-1": (".ras", sun(31, 23, 1, np.packbits(gray > 128, axis=1))),
        "sun-32": (".ras", sun(31, 23, 32, np.concatenate([np.zeros((23, 31, 1), np.uint8), img], 2).reshape(23, -1))),
        "sun-8-map": (".ras", sun(31, 23, 8, gray, maptype=1, cmap=rng.integers(0, 256, 768, np.uint8).tobytes())),
        "hdr-rle": (".hdr", _cv2_write(".hdr", rgb.astype(np.float32)[..., ::-1] / 200)),
        "hdr-flat": (".hdr", hdr(rgbe_of(rgb.astype(np.float32) / 300), rle=False)),
    }
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    idx = (gray // 16).astype(np.uint8)
    out.update({
        "gif-cv2": (".gif", _cv2_write(".gif", img)),
        "gif-small-frame": (".gif", gif([dict(indices=idx[:9, :14], left=5, top=3, transparent=2)], (31, 23), pal,
                                        background=7)),
        "gif-interlaced": (".gif", gif([dict(indices=idx, interlace=True, palette=pal[::-1].copy())], (31, 23))),
        "gif-frames": (".gif", gif([dict(indices=idx), dict(indices=idx[::-1].copy())], (31, 23), pal)),
    })
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb)).save(buf, "GIF", interlace=True)
    out["gif-pil"] = (".gif", buf.getvalue())
    out["webp-lossless"] = (".webp", _cv2_write(".webp", img, (cv2.IMWRITE_WEBP_QUALITY, 101)))
    out["webp-lossy"] = (".webp", _cv2_write(".webp", img, (cv2.IMWRITE_WEBP_QUALITY, 80)))
    alpha = np.dstack([rgb, gray])
    for name, kw in (("webp-alpha", dict(quality=70)), ("webp-lossless-alpha", dict(lossless=True))):
        buf = io.BytesIO()
        Image.fromarray(alpha).save(buf, "WEBP", **kw)
        out[name] = (".webp", buf.getvalue())
    buf = io.BytesIO()
    frames = [Image.fromarray(np.ascontiguousarray(rgb)), Image.fromarray(np.ascontiguousarray(rgb[::-1]))]
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], quality=70)
    out["webp-animated"] = (".webp", buf.getvalue())
    for name, opts in VP8_FORMS.items():
        out[f"vp8-{name}"] = (".webp", libwebp_encode(np.ascontiguousarray(rgb), **opts))
    # the numpy writer's forms: eight and four token partitions, segments, filter deltas, skips
    out["vp8w-8-partitions"] = (".webp", vp8_frame(47, 33, seed=1, partitions=3, segments=1, lf_deltas=True,
                                                   skip_prob=60, sharpness=3, level=50))
    out["vp8w-4-partitions-simple"] = (".webp", vp8_frame(47, 33, seed=2, partitions=2, segments=1, absolute=True,
                                                          simple=True, level=30))
    # two larger lossy files for chip_smoke.py's phase 19, held by the SHA-256 of cv2's array: the first
    # micrograph of its dataset (``draw_labelled`` at CONTAINER_SEED) and a 2048² one for its decode timing
    smoke = _chip_smoke()
    gray, _ = smoke.draw_labelled(np.random.default_rng(smoke.CONTAINER_SEED), smoke.DATASET_HW)
    out["dataset-webp-lossy"] = (".webp", _cv2_write(".webp", np.repeat(gray[..., None], 3, 2),
                                                     (cv2.IMWRITE_WEBP_QUALITY, 80)))
    out["webp-lossy-2048"] = (".webp", _cv2_write(".webp", particles(2048, 0), (cv2.IMWRITE_WEBP_QUALITY, 75)))
    return out


# the entries held by the SHA-256 of cv2's array rather than the array
HASHED = ("dataset-webp-lossy", "webp-lossy-2048")


def particles(size: int, seed: int) -> np.ndarray:
    """A size x size gray micrograph as [H,W,3] BGR: 300 dark round
    particles on a background of 170 with noise of 4 levels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.full((size, size), 170.0)
    for _ in range(300):
        cy, cx = rng.random(2) * size
        r = 6 + 40 * rng.random()
        y0, y1 = max(int(cy - 3 * r), 0), min(int(cy + 3 * r) + 1, size)
        x0, x1 = max(int(cx - 3 * r), 0), min(int(cx + 3 * r) + 1, size)
        d2 = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2
        img[y0:y1, x0:x1] -= 90 * np.exp(-d2 / (2 * (0.6 * r) ** 2))
    gray = np.clip(img + 4 * rng.standard_normal((size, size)), 0, 255).round().astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=2)


def _chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(out: str = str(DEFAULT_OUT)) -> str:
    import cv2

    arrays = {}
    with tempfile.TemporaryDirectory() as d:
        for name, (ext, data) in cases().items():
            path = Path(d) / f"f{ext}"
            path.write_bytes(data)
            ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
            assert ref is not None, name
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/ext"] = np.frombuffer(ext.encode(), np.uint8)
            if name in HASHED:
                arrays[f"{name}/sha256"] = np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)
            else:
                arrays[f"{name}/bgr"] = ref
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main(*sys.argv[1:]))

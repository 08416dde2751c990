"""Write ``tests/data/torch_jpeg2000_fixtures.npz``: small JPEG 2000 files
(JP2 and raw codestreams) and the TIFF forms of C11 (a palette with extra
samples, CMYK and YCbCr in separate planes, YCbCr with predictor 2), each
beside the array ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns for it here
(OpenCV 5.0 with OpenJPEG 2.5), or beside nothing where cv2 returns None.

``chip_smoke.py`` decodes them on a host that has no OpenCV and holds
``read_image`` to these arrays; ``tests/test_torch_jpeg2000.py`` checks
that each still matches cv2. Files come from Pillow's encoder and from
``cv2.imwrite``; the numpy writer below (``encode``: the forward 5/3 or
9/7, an MQ coder and the three coding passes, tag trees and packet
headers; ``jp2``: the boxes) writes what those encoders cannot set: every
code-block style switch, SOP and EPH, POC, PPM and PPT, RGN, derived and
expounded quantisation, subsampled components, precisions 1 to 16, the
palette, component mapping and channel definition boxes, several
tile-parts, and the cut and damaged copies.

Usage: ``python tools/make_torch_jpeg2000_fixtures.py [out.npz]``
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

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_jpeg2000_fixtures.npz"

# ---------------------------------------------------------------------------
# MQ coder (ISO 15444-1 Annex C, as OpenJPEG's mqc.c encodes)
# ---------------------------------------------------------------------------

QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401, 0x1C01,
      0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801,
      0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111,
      0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
        30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25,
        26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
SWITCH = (0, 6, 14)


class MQEncoder:
    """The MQ coder of one code-block: contexts (state, MPS) that live
    across terminated segments, and one codeword per segment."""

    def __init__(self):
        self.reset_contexts()
        self.start()

    def reset_contexts(self):
        self.ctx = [[0, 0] for _ in range(19)]
        self.ctx[18] = [46, 0]
        self.ctx[17] = [3, 0]
        self.ctx[0] = [4, 0]

    def start(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.buf = bytearray([0])  # a dummy byte before the codeword
        self.bp = 0

    def _put(self, v):
        self.bp += 1
        if self.bp == len(self.buf):
            self.buf.append(v & 0xFF)
        else:
            self.buf[self.bp] = v & 0xFF

    def _byteout(self):
        if self.buf[self.bp] == 0xFF:
            self._put(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self._put(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.buf[self.bp] += 1
            if self.buf[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self._put(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self._put(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, cx: int, d: int):
        st = self.ctx[cx]
        qe = QE[st[0]]
        self.a -= qe
        if d == st[1]:  # MPS
            if not self.a & 0x8000:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                st[0] = NMPS[st[0]]
                self._renorm()
            else:
                self.c += qe
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if st[0] in SWITCH:
                st[1] ^= 1
            st[0] = NLPS[st[0]]
            self._renorm()

    def flush(self) -> bytes:
        """Terminate the codeword (SETBITS, two byte-outs, no trailing 0xff)."""
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        end = self.bp + (self.buf[self.bp] != 0xFF)
        out = bytes(self.buf[1:end])
        self.start()
        return out


class RawEncoder:
    """A bypass (raw) segment: bits MSB first, seven after a 0xff byte."""

    def __init__(self):
        self.out, self.byte, self.n, self.width = bytearray(), 0, 0, 8

    def encode(self, bit: int):
        self.byte = (self.byte << 1) | bit
        self.n += 1
        if self.n == self.width:
            self.out.append(self.byte)
            self.width = 7 if self.byte == 0xFF else 8
            self.byte, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.out.append(self.byte << (self.width - self.n))
        out = bytes(self.out)
        self.__init__()
        return out


# ---------------------------------------------------------------------------
# Tier-1: the three coding passes (the decoder's contexts, Annex D)
# ---------------------------------------------------------------------------


class BlockCoder:
    """One code-block's magnitudes and signs, coded pass by pass."""

    def __init__(self, q: np.ndarray, orient: int, style: int):
        self.h, self.w = q.shape
        self.mag, self.neg = np.abs(q).astype(np.int64), q < 0
        self.sig = np.zeros((self.h + 2, self.w + 2), bool)
        self.sgn = np.zeros((self.h + 2, self.w + 2), bool)
        self.visit = np.zeros((self.h, self.w), bool)
        self.refined = np.zeros((self.h, self.w), bool)
        self.orient, self.vsc = orient, bool(style & 8)

    def _s(self, y, x):
        return int(self.sig[y + 1, x + 1])

    def _below(self, y):
        return not (self.vsc and y % 4 == 3)

    def zc(self, y, x):
        s = self._s
        hs = s(y, x - 1) + s(y, x + 1)
        vs = s(y - 1, x)
        ds = s(y - 1, x - 1) + s(y - 1, x + 1)
        if self._below(y):
            vs += s(y + 1, x)
            ds += s(y + 1, x - 1) + s(y + 1, x + 1)
        if self.orient == 1:
            hs, vs = vs, hs
        if self.orient == 3:
            hv = hs + vs
            if ds >= 3:
                return 8
            if ds == 2:
                return 7 if hv >= 1 else 6
            if ds == 1:
                return 5 if hv >= 2 else 4 if hv == 1 else 3
            return 2 if hv >= 2 else 1 if hv == 1 else 0
        if hs == 2:
            return 8
        if hs == 1:
            return 7 if vs >= 1 else 6 if ds >= 1 else 5
        if vs == 2:
            return 4
        if vs == 1:
            return 3
        return 2 if ds >= 2 else 1 if ds == 1 else 0

    def neighbour(self, y, x):
        s = self._s
        n = s(y, x - 1) | s(y, x + 1) | s(y - 1, x - 1) | s(y - 1, x) | s(y - 1, x + 1)
        if self._below(y):
            n |= s(y + 1, x - 1) | s(y + 1, x) | s(y + 1, x + 1)
        return n

    def _contrib(self, y, x):
        if not self.sig[y + 1, x + 1]:
            return 0
        return -1 if self.sgn[y + 1, x + 1] else 1

    def sign_ctx(self, y, x):
        hc = max(-1, min(1, self._contrib(y, x - 1) + self._contrib(y, x + 1)))
        vc = self._contrib(y - 1, x) + (self._contrib(y + 1, x) if self._below(y) else 0)
        vc = max(-1, min(1, vc))
        if hc == 0:
            return (9 if vc == 0 else 10), int(vc < 0)
        return (12 if vc == 0 else 13 if vc == hc else 11), int(hc < 0)

    def _bit(self, y, x, p):
        return int((self.mag[y, x] >> p) & 1)

    def _significant(self, y, x, coder, raw):
        neg = bool(self.neg[y, x])
        if raw:
            coder.encode(int(neg))
        else:
            cx, xorbit = self.sign_ctx(y, x)
            coder.encode(cx, int(neg) ^ xorbit)
        self.sig[y + 1, x + 1] = True
        self.sgn[y + 1, x + 1] = neg

    def _stripes(self):
        for k in range(0, self.h, 4):
            for x in range(self.w):
                yield k, x

    def sigpass(self, p, coder, raw):
        for k, x in self._stripes():
            for y in range(k, min(k + 4, self.h)):
                if self.sig[y + 1, x + 1] or self.visit[y, x] or not self.neighbour(y, x):
                    continue
                b = self._bit(y, x, p)
                if raw:
                    coder.encode(b)
                else:
                    coder.encode(self.zc(y, x), b)
                if b:
                    self._significant(y, x, coder, raw)
                self.visit[y, x] = True

    def refpass(self, p, coder, raw):
        for k, x in self._stripes():
            for y in range(k, min(k + 4, self.h)):
                if not self.sig[y + 1, x + 1] or self.visit[y, x]:
                    continue
                b = self._bit(y, x, p)
                if raw:
                    coder.encode(b)
                else:
                    coder.encode(16 if self.refined[y, x] else 15 if self.neighbour(y, x) else 14, b)
                self.refined[y, x] = True

    def clnpass(self, p, coder, segsym):
        for k, x in self._stripes():
            y = k
            if k + 3 < self.h and all(not self.sig[j + 1, x + 1] and not self.visit[j, x] and not self.neighbour(j, x)
                                      for j in range(k, k + 4)):
                bits = [self._bit(j, x, p) for j in range(k, k + 4)]
                if not any(bits):
                    coder.encode(17, 0)
                    continue
                coder.encode(17, 1)
                run = bits.index(1)
                coder.encode(18, run >> 1)
                coder.encode(18, run & 1)
                y = k + run
                self._significant(y, x, coder, False)
                y += 1
                for y in range(y, k + 4):
                    b = self._bit(y, x, p)
                    coder.encode(self.zc(y, x), b)
                    if b:
                        self._significant(y, x, coder, False)
                continue
            for y in range(k, min(k + 4, self.h)):
                if self.sig[y + 1, x + 1] or self.visit[y, x]:
                    continue
                b = self._bit(y, x, p)
                coder.encode(self.zc(y, x), b)
                if b:
                    self._significant(y, x, coder, False)
        self.visit[:] = False
        if segsym:
            for b in (1, 0, 1, 0):
                coder.encode(18, b)


def code_block(q: np.ndarray, orient: int, style: int, planes: int, npasses: int):
    """A code-block's coefficients (``planes`` bit-planes coded) -> the
    segments of its first ``npasses`` passes: [(passes, bytes)], one
    terminated codeword each (every pass under TERMALL; under LAZY, 10
    passes, then raw sig+ref and MQ cleanup in turn)."""
    bc = BlockCoder(q, orient, style)
    mq, raw = MQEncoder(), RawEncoder()
    segs, count, passtype, p = [], 0, 2, planes - 1
    for i in range(npasses):
        lazy_raw = bool(style & 1) and passtype < 2 and p + 1 <= planes - 4
        coder = raw if lazy_raw else mq
        if passtype == 0:
            bc.sigpass(p, coder, lazy_raw)
        elif passtype == 1:
            bc.refpass(p, coder, lazy_raw)
        else:
            bc.clnpass(p, coder, bool(style & 32))
        if (style & 2) and not lazy_raw:
            mq.reset_contexts()
        count += 1
        passtype = (passtype + 1) % 3
        if passtype == 0:
            p -= 1
        # where this pass ends a segment (init_seg's maxpasses)
        if style & 4:
            end = True
        elif style & 1:
            end = i + 1 == 10 or (i + 1 > 10 and ((i + 1 - 10) % 3 in (0, 2)))
        else:
            end = False
        if end or i + 1 == npasses:
            segs.append((count, coder.flush()))
            count = 0
    return segs


# ---------------------------------------------------------------------------
# Wavelets, quantisation and the tile structure
# ---------------------------------------------------------------------------


def _mirror(k, n):
    while k < 0 or k >= n:
        k = -k if k < 0 else 2 * (n - 1) - k
    return k


def fdwt53_1d(x: np.ndarray, cas: int) -> np.ndarray:
    """Forward reversible 5/3 of one line (first sample of parity cas) ->
    low coefficients then high ones."""
    n = len(x)
    y = x.astype(np.int64).copy()
    if n == 1:
        return y * 2 if cas else y
    for i in range(n):
        if (i + cas) & 1:
            y[i] -= (y[_mirror(i - 1, n)] + y[_mirror(i + 1, n)]) >> 1
    for i in range(n):
        if not (i + cas) & 1:
            y[i] += (y[_mirror(i - 1, n)] + y[_mirror(i + 1, n)] + 2) >> 2
    low = [y[i] for i in range(n) if not (i + cas) & 1]
    return np.array(low + [y[i] for i in range(n) if (i + cas) & 1], np.int64)


def fdwt97_1d(x: np.ndarray, cas: int) -> np.ndarray:
    """Forward irreversible 9/7 (float64) of one line."""
    n = len(x)
    y = x.astype(np.float64).copy()
    if n == 1:
        return y
    for c, par in ((-1.586134342, 1), (-0.052980118, 0), (0.882911075, 1), (0.443506852, 0)):
        for i in range(n):
            if ((i + cas) & 1) == par:
                y[i] += c * (y[_mirror(i - 1, n)] + y[_mirror(i + 1, n)])
    k = 1.230174105
    low = [y[i] / k for i in range(n) if not (i + cas) & 1]
    return np.array(low + [y[i] * k / 2 for i in range(n) if (i + cas) & 1], np.float64)


def _ceil_pow2(a, b):
    return -(-a // (1 << b))


def fdwt(a: np.ndarray, x0: int, y0: int, levels: int, reversible: bool) -> np.ndarray:
    """The 2-D forward transform of a tile-component at (x0, y0), in the
    decoder's layout (each level's low band at the top left): columns,
    then rows, the inverse of the decoder's rows-then-columns."""
    a = a.astype(np.int64 if reversible else np.float64).copy()
    one = fdwt53_1d if reversible else fdwt97_1d
    h, w = a.shape
    for lev in range(levels):
        rx0, ry0 = _ceil_pow2(x0, lev), _ceil_pow2(y0, lev)
        rw, rh = _ceil_pow2(x0 + w, lev) - rx0, _ceil_pow2(y0 + h, lev) - ry0
        if rw == 0 or rh == 0:
            break
        for j in range(rw):
            a[:rh, j] = one(a[:rh, j], ry0 % 2)
        for i in range(rh):
            a[i, :rw] = one(a[i, :rw], rx0 % 2)
    return a


class Band:
    def __init__(self, x0, y0, x1, y1, bandno):
        self.x0, self.y0, self.x1, self.y1, self.bandno = x0, y0, x1, y1, bandno

    @property
    def empty(self):
        return self.x1 == self.x0 or self.y1 == self.y0


def tile_layout(tcx0, tcy0, tcx1, tcy1, levels, prc, cb):
    """Resolutions -> [(res box, pdx, pdy, pw, ph, bands, cblk exps)] as the
    decoder (tcd.c) lays them out; prc[r] = (PPx, PPy), cb = (xcb, ycb)."""
    out = []
    for r in range(levels + 1):
        lev = levels - r
        rx0, ry0, rx1, ry1 = (_ceil_pow2(v, lev) for v in (tcx0, tcy0, tcx1, tcy1))
        pdx, pdy = prc[r]
        px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        px1, py1 = _ceil_pow2(rx1, pdx) << pdx, _ceil_pow2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
        ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
        if r == 0:
            bands = [Band(rx0, ry0, rx1, ry1, 0)]
            cbg = (px0, py0, pdx, pdy)
        else:
            bands = []
            for b in (1, 2, 3):
                xo, yo, nb = b & 1, b >> 1, lev + 1
                bands.append(Band(*(-(-(v - (o << (nb - 1))) // (1 << nb)) for v, o in
                                    ((tcx0, xo), (tcy0, yo), (tcx1, xo), (tcy1, yo))), b))
            cbg = (-(-px0 // 2), -(-py0 // 2), pdx - 1, pdy - 1)
        cbw, cbh = min(cb[0], cbg[2]), min(cb[1], cbg[3])
        out.append(((rx0, ry0, rx1, ry1), pdx, pdy, pw, ph, bands, cbg, (cbw, cbh)))
    return out


def precinct_blocks(band, cbg, cbexp, pw, pn):
    """The code-blocks of precinct pn of a band -> (cw, ch, [(x0, y0, x1, y1)])."""
    sx = cbg[0] + (pn % pw) * (1 << cbg[2])
    sy = cbg[1] + (pn // pw) * (1 << cbg[3])
    x0, y0 = max(sx, band.x0), max(sy, band.y0)
    x1, y1 = min(sx + (1 << cbg[2]), band.x1), min(sy + (1 << cbg[3]), band.y1)
    if x0 >= x1 or y0 >= y1:
        return 0, 0, []
    cw_, ch_ = cbexp
    bx0, by0 = (x0 >> cw_) << cw_, (y0 >> ch_) << ch_
    cw = ((_ceil_pow2(x1, cw_) << cw_) - bx0) >> cw_
    ch = ((_ceil_pow2(y1, ch_) << ch_) - by0) >> ch_
    blocks = []
    for k in range(cw * ch):
        cx, cy = bx0 + (k % cw) * (1 << cw_), by0 + (k // cw) * (1 << ch_)
        blocks.append((max(cx, x0), max(cy, y0), min(cx + (1 << cw_), x1), min(cy + (1 << ch_), y1)))
    return cw, ch, blocks


# ---------------------------------------------------------------------------
# Tier-2: tag trees, packet headers, packet order
# ---------------------------------------------------------------------------


class BitWriter:
    """Packet-header bits (bio.c): MSB first, seven bits after a 0xff."""

    def __init__(self):
        self.out, self.byte, self.n, self.width = bytearray(), 0, 0, 8

    def put(self, bit, count=1):
        for i in range(count - 1, -1, -1):
            self.byte = (self.byte << 1) | ((bit >> i) & 1)
            self.n += 1
            if self.n == self.width:
                self.out.append(self.byte)
                self.width = 7 if self.byte == 0xFF else 8
                self.byte, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.out.append(self.byte << (self.width - self.n))
        elif self.width == 7:  # the decoder reads the stuffed byte after a final 0xff
            self.out.append(0)
        return bytes(self.out)


class TagTree:
    def __init__(self, w, h, values):
        self.levels = []
        vals = np.asarray(values, np.int64).reshape(h, w) if w * h else np.zeros((0, 0), np.int64)
        while True:
            self.levels.append(vals)
            if vals.size <= 1:
                break
            hh, ww = -(-vals.shape[0] // 2), -(-vals.shape[1] // 2)
            nxt = np.full((hh, ww), 1 << 30, np.int64)
            for j in range(vals.shape[0]):
                for i in range(vals.shape[1]):
                    nxt[j // 2, i // 2] = min(nxt[j // 2, i // 2], vals[j, i])
            vals = nxt
        self.low = [np.zeros(v.shape, np.int64) for v in self.levels]
        self.known = [np.zeros(v.shape, bool) for v in self.levels]
        self.w = w

    def encode(self, bw: BitWriter, leaf: int, threshold: int):
        j, i = divmod(leaf, self.w)
        path = []
        for lev in range(len(self.levels)):
            path.append((lev, j, i))
            j, i = j // 2, i // 2
        low = 0
        for lev, j, i in reversed(path):
            if low > self.low[lev][j, i]:
                self.low[lev][j, i] = low
            else:
                low = int(self.low[lev][j, i])
            while low < threshold:
                if low >= self.levels[lev][j, i]:
                    if not self.known[lev][j, i]:
                        bw.put(1)
                        self.known[lev][j, i] = True
                    break
                bw.put(0)
                low += 1
            self.low[lev][j, i] = low


def packet_order(tiles_res, ncomp, numlayers, prg, pocs, tile_box, comp_d):
    """The decoder's packet iterator (pi.c) -> [(layer, res, comp, precinct)].
    tiles_res[c] = tile_layout of component c; comp_d[c] = (dx, dy)."""
    maxres = max(len(r) for r in tiles_res)
    maxprec = max(pw * ph for r in tiles_res for (_, _, _, pw, ph, *_) in r)
    step_c, step_r = maxprec, ncomp * maxprec
    step_l = maxres * step_r
    seen, out = set(), []
    tx0, ty0, tx1, ty1 = tile_box

    def emit(l, r, c, p):
        idx = l * step_l + r * step_r + c * step_c + p
        if idx not in seen:
            seen.add(idx)
            out.append((l, r, c, p))

    def dmin(cs):
        dx = dy = None
        for c in cs:
            nres = len(tiles_res[c])
            for r, (_, pdx, pdy, *_) in enumerate(tiles_res[c]):
                lev = nres - 1 - r
                vx, vy = comp_d[c][0] << (pdx + lev), comp_d[c][1] << (pdy + lev)
                dx, dy = vx if dx is None else min(dx, vx), vy if dy is None else min(dy, vy)
        return dx, dy

    def prec_at(c, r, x, y):
        res = tiles_res[c]
        if r >= len(res):
            return -1
        (_, _, _, _), pdx, pdy, pw, ph = res[r][0], res[r][1], res[r][2], res[r][3], res[r][4]
        dx, dy = comp_d[c]
        lev = len(res) - 1 - r
        trx0, try0 = -(-tx0 // (dx << lev)), -(-ty0 // (dy << lev))
        trx1, try1 = -(-tx1 // (dx << lev)), -(-ty1 // (dy << lev))
        rpx, rpy = pdx + lev, pdy + lev
        if not (y % (dy << rpy) == 0 or (y == ty0 and (try0 << lev) % (1 << rpy))):
            return -1
        if not (x % (dx << rpx) == 0 or (x == tx0 and (trx0 << lev) % (1 << rpx))):
            return -1
        if pw == 0 or ph == 0 or trx0 == trx1 or try0 == try1:
            return -1
        prci = (-(-x // (dx << lev)) >> pdx) - (trx0 >> pdx)
        prcj = (-(-y // (dy << lev)) >> pdy) - (try0 >> pdy)
        return prci + prcj * pw

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    for (r0, c0, l1, r1, c1, order) in (pocs or [(0, 0, numlayers, maxres, ncomp, prg)]):
        l1, c1 = min(l1, numlayers), min(c1, ncomp)
        if order in (0, 1):
            outer = ((l, r) for l in range(l1) for r in range(r0, r1)) if order == 0 else \
                ((l, r) for r in range(r0, r1) for l in range(l1))
            for l, r in outer:
                for c in range(c0, c1):
                    if r < len(tiles_res[c]):
                        for p in range(tiles_res[c][r][3] * tiles_res[c][r][4]):
                            emit(l, r, c, p)
        elif order == 2:
            dx, dy = dmin(range(ncomp))
            for r in range(r0, r1):
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        p = prec_at(c, r, x, y)
                        if p >= 0:
                            for l in range(l1):
                                emit(l, r, c, p)
        elif order == 3:
            dx, dy = dmin(range(ncomp))
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, r1):
                        p = prec_at(c, r, x, y)
                        if p >= 0:
                            for l in range(l1):
                                emit(l, r, c, p)
        elif order == 4:
            for c in range(c0, c1):
                dx, dy = dmin([c])
                for x, y in positions(dx, dy):
                    for r in range(r0, min(r1, len(tiles_res[c]))):
                        p = prec_at(c, r, x, y)
                        if p >= 0:
                            for l in range(l1):
                                emit(l, r, c, p)
    return out


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------


def _marker(code, body=b""):
    return struct.pack(">HH", code, len(body) + 2) + body


def _step(delta, rb):
    """A quantisation step -> (exponent, mantissa): delta = 2^(rb - e) (1 + m / 2048)."""
    e = int(np.floor(rb - np.log2(delta)))
    m = int(round((delta / 2.0 ** (rb - e) - 1) * 2048))
    if m >= 2048:
        e, m = e - 1, 0
    return max(0, min(31, e)), max(0, min(2047, m))


def encode(img: np.ndarray, prec=8, signed=False, reversible=True, levels=3, cblk=(4, 4), style=0, layers=1,
           prg=0, precincts=None, sop=False, eph=False, pocs=None, tile=None, tileparts=1, tnsot=True, ppm=False,
           ppt=False, rgn=None, qstyle=None, guard=2, mct=None, sub=None, offset=(0, 0), step=4.0,
           max_passes=None, com=True, extra_main=b"") -> bytes:
    """A JPEG 2000 codestream of ``img`` ([H,W] or [H,W,C] ints, each below
    2^prec): ``levels`` decompositions, code-blocks of 2^cblk, code-block
    ``style`` (1 bypass, 2 reset, 4 terminate every pass, 8 vertically
    causal, 16 predictable termination, 32 segmentation symbols),
    ``layers`` quality layers, progression ``prg`` (0 LRCP .. 4 CPRL) or
    ``pocs`` [(res0, comp0, layer end, res end, comp end, order)],
    ``precincts`` [(PPx, PPy)] per resolution, SOP and EPH markers,
    ``tile`` (width, height) tiles of ``tileparts`` parts each (TNsot
    written unless not ``tnsot``), packet headers in PPM or PPT, ``rgn``
    (component, shift), quantisation ``qstyle`` (0 none, 1 derived, 2
    expounded; 9/7 steps of ``step``), ``mct``, ``sub`` [(dx, dy)] per
    component, an image ``offset``, and at most ``max_passes`` coding
    passes per code-block."""
    a = np.asarray(img, np.int64)
    a = a if a.ndim == 3 else a[..., None]
    h, w, nc = a.shape
    sub = sub or [(1, 1)] * nc
    prc = precincts or []
    prc = [prc[r] if r < len(prc) else (15, 15) for r in range(levels + 1)]
    qstyle = (0 if reversible else 2) if qstyle is None else qstyle
    mct = (nc >= 3) if mct is None else mct
    ox, oy = offset
    X, Y = ox + w * sub[0][0], oy + h * sub[0][1]
    tw, th = tile or (X, Y)
    ntx, nty = -(-X // tw), -(-Y // th)
    cod_style = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    siz = struct.pack(">HIIIIIIIIH", 0, X, Y, ox, oy, tw, th, 0, 0, nc)
    for c in range(nc):
        siz += struct.pack(">BBB", (prec - 1) | (0x80 if signed else 0), *sub[c])
    spcod = struct.pack(">BBBBB", levels, cblk[0] - 2, cblk[1] - 2, style, 1 if reversible else 0)
    if precincts:
        spcod += bytes((py << 4) | px for px, py in prc)
    main = _marker(0xFF51, siz) + _marker(0xFF52, struct.pack(">BBHB", cod_style, prg, layers, int(mct)) + spcod)
    gains = [0] + [g for _ in range(levels) for g in (1, 1, 2)]
    if qstyle == 0:
        eps = [prec + g for g in gains]
        qcd = bytes([guard << 5]) + bytes(e << 3 for e in eps)
        steps = [(e, 0) for e in eps]
    elif qstyle == 1:
        e0, m0 = _step(step, prec)
        qcd = bytes([(guard << 5) | 1]) + struct.pack(">H", (e0 << 11) | m0)
        steps = [(e0, m0)] + [(max(0, e0 - (b - 1) // 3), m0) for b in range(1, 3 * levels + 1)]
    else:
        steps = [_step(step, prec)] * len(gains)
        qcd = bytes([(guard << 5) | 2]) + b"".join(struct.pack(">H", (e << 11) | m) for e, m in steps)
    main += _marker(0xFF5C, qcd)
    if rgn:
        main += _marker(0xFF5E, struct.pack(">BBB", rgn[0], 0, rgn[1]))
    if pocs:
        main += _marker(0xFF5F, b"".join(struct.pack(">BBHBBB", *p) for p in pocs))
    if com:
        main += _marker(0xFF64, b"\x00\x01numpy writer")
    main += extra_main
    parts, ppm_chunks = [], []
    samples = a - (0 if signed else (1 << (prec - 1)))
    for t in range(ntx * nty):
        tx, ty = t % ntx, t // ntx
        tbox = (max(tx * tw, ox), max(ty * th, oy), min((tx + 1) * tw, X), min((ty + 1) * th, Y))
        comps, layouts, coded = [], [], []
        for c in range(nc):
            dx, dy = sub[c]
            cx0, cy0, cx1, cy1 = (-(-tbox[0] // dx), -(-tbox[1] // dy), -(-tbox[2] // dx), -(-tbox[3] // dy))
            ix0, iy0 = -(-ox // dx), -(-oy // dy)
            comps.append((samples[cy0 - iy0 : cy1 - iy0, cx0 - ix0 : cx1 - ix0, c], (cx0, cy0, cx1, cy1)))
        if mct and nc >= 3:
            r, g, b = (comps[k][0] for k in range(3))
            if reversible:
                yv, u, v = (r + 2 * g + b) >> 2, b - g, r - g
            else:
                r, g, b = (x.astype(np.float64) for x in (r, g, b))
                yv = 0.299 * r + 0.587 * g + 0.114 * b
                u = -0.16875 * r - 0.331260 * g + 0.5 * b
                v = 0.5 * r - 0.41869 * g - 0.08131 * b
            comps[:3] = [(yv, comps[0][1]), (u, comps[1][1]), (v, comps[2][1])]
        for c, (s, (cx0, cy0, cx1, cy1)) in enumerate(comps):
            coef = fdwt(s, cx0, cy0, levels, reversible)
            lay = tile_layout(cx0, cy0, cx1, cy1, levels, prc, cblk)
            layouts.append(lay)
            blocks = {}
            for r, (rbox, pdx, pdy, pw, ph, bands, cbg, cbexp) in enumerate(lay):
                for bi, band in enumerate(bands):
                    if band.empty:
                        continue
                    ox_ = (lay[r - 1][0][2] - lay[r - 1][0][0]) if band.bandno & 1 else 0
                    oy_ = (lay[r - 1][0][3] - lay[r - 1][0][1]) if band.bandno & 2 else 0
                    stepno = 0 if r == 0 else 3 * (r - 1) + bi + 1
                    e, m = steps[stepno]
                    mb = guard + e - 1
                    for pn in range(pw * ph):
                        cw, ch, bl = precinct_blocks(band, cbg, cbexp, pw, pn)
                        entries = []
                        for (bx0, by0, bx1, by1) in bl:
                            q = coef[by0 - band.y0 + oy_ : by1 - band.y0 + oy_, bx0 - band.x0 + ox_ : bx1 - band.x0 + ox_]
                            if not reversible:
                                delta = 2.0 ** (prec - e) * (1 + m / 2048)  # no band gain on OpenJPEG's 9/7 path
                                q = (np.sign(q) * np.floor(np.abs(q) / delta)).astype(np.int64)
                            q = np.clip(q, -(2 ** mb - 1), 2 ** mb - 1)
                            shift = 0
                            if rgn and rgn[0] == c:
                                shift = rgn[1]
                                roi = np.zeros(q.shape, bool)
                                roi[: (q.shape[0] + 1) // 2] = True
                                q = np.where(roi, q * (1 << shift), q)
                            planes = int(np.abs(q).max()).bit_length() if q.size else 0
                            zero = mb + shift - planes
                            total = max(0, 3 * planes - 2)
                            npass = total if max_passes is None else min(total, max_passes)
                            segs = code_block(q, band.bandno, style, planes, npass) if npass else []
                            entries.append((zero, npass, segs))
                        blocks[(r, bi, pn)] = (cw, ch, entries)
            coded.append(blocks)
        order = packet_order(layouts, nc, layers, prg, pocs, tbox, sub)
        # layer l of a code-block takes its segments' passes up to ceil(total * (l + 1) / layers)
        state = {}
        headers, bodies = [], []
        for idx, (l, r, c, p) in enumerate(order):
            lay = layouts[c][r]
            bw, body, present = BitWriter(), bytearray(), False
            plan = []
            for bi, band in enumerate(lay[5]):
                if band.empty:
                    continue
                cw, ch, entries = coded[c][(r, bi, p)]
                key = (c, r, bi, p)
                if key not in state:
                    first = [next((k for k in range(layers) if e[1] * (k + 1) // layers > 0), 1 << 20)
                             for e in entries]
                    state[key] = dict(incl=TagTree(cw, ch, first), imsb=TagTree(cw, ch, [e[0] for e in entries]),
                                      first=first, done=[0] * len(entries), lblock=[3] * len(entries))
                plan.append((key, entries))
                st = state[key]
                for k, e in enumerate(entries):
                    if e[1] * (l + 1) // layers > st["done"][k]:
                        present = True
            bw.put(int(present))
            if present:
                for key, entries in plan:
                    st = state[key]
                    for k, (zero, npass, segs) in enumerate(entries):
                        upto = npass * (l + 1) // layers
                        new = upto - st["done"][k]
                        if new <= 0:
                            if st["done"][k] == 0:
                                st["incl"].encode(bw, k, l + 1)
                            else:
                                bw.put(0)
                            continue
                        if st["done"][k] == 0:
                            st["incl"].encode(bw, k, l + 1)
                            st["imsb"].encode(bw, k, zero + 1)
                        else:
                            bw.put(1)
                        if new == 1:
                            bw.put(0)
                        elif new == 2:
                            bw.put(2, 2)
                        elif new <= 5:
                            bw.put(0b1100 | (new - 3), 4)
                        elif new <= 36:
                            bw.put((0b1111 << 5) | (new - 6), 9)
                        else:
                            bw.put((0b111111111 << 7) | (new - 37), 16)
                        # the new passes, split at segment ends, with the bytes of each piece
                        pieces, at = [], 0
                        for n_seg, data in segs:
                            lo, hi = max(at, st["done"][k]), min(at + n_seg, upto)
                            if lo < hi:
                                a0 = len(data) * (lo - at) // n_seg
                                a1 = len(data) * (hi - at) // n_seg if hi < at + n_seg else len(data)
                                pieces.append((hi - lo, data[a0:a1]))
                            at += n_seg
                        need = max(len(d).bit_length() - (n.bit_length() - 1) for n, d in pieces)
                        inc = max(0, need - st["lblock"][k])
                        bw.put((1 << (inc + 1)) - 2, inc + 1)
                        st["lblock"][k] += inc
                        for n, d in pieces:
                            bw.put(len(d), st["lblock"][k] + n.bit_length() - 1)
                            body += d
                        st["done"][k] = upto
            head = bw.flush()
            if eph:
                head += b"\xff\x92"
            sop_bytes = struct.pack(">HHH", 0xFF91, 4, idx & 0xFFFF) if sop else b""
            headers.append(head)
            bodies.append((sop_bytes, bytes(body)))
        # tile-parts: the packets split into tileparts runs
        n = len(order)
        cuts = [round(n * k / tileparts) for k in range(tileparts + 1)]
        for k in range(tileparts):
            hs, bs = headers[cuts[k] : cuts[k + 1]], bodies[cuts[k] : cuts[k + 1]]
            theader = b""
            if ppm or ppt:
                data = b"".join(s + b for s, b in bs)
                hdata = b"".join(hs)
                if ppm:
                    ppm_chunks.append(hdata)
                else:
                    theader += _marker(0xFF61, bytes([k]) + hdata)
            else:
                data = b"".join(s + hh + b for hh, (s, b) in zip(hs, bs))
            psot = 12 + len(theader) + 2 + len(data)
            parts.append(_marker(0xFF90, struct.pack(">HIBB", t, psot, k, tileparts if tnsot else 0)) + theader
                         + b"\xff\x93" + data)
    if ppm:
        stream = b"".join(struct.pack(">I", len(ch)) + ch for ch in ppm_chunks)
        z, pos = 0, 0
        while pos < len(stream):
            main += _marker(0xFF60, bytes([z]) + stream[pos : pos + 60000])
            pos += 60000
            z += 1
    return b"\xff\x4f" + main + b"".join(parts) + b"\xff\xd9"


def retile_parts(codestream: bytes, numbering) -> bytes:
    """A codestream whose tile-parts are renumbered: ``numbering(tile,
    [part data]) -> [(TPsot, TNsot, data)]`` per tile (Psot rewritten),
    for the tile-part counts OpenJPEG corrects or refuses."""
    first = codestream.index(b"\xff\x90\x00\x0a")
    pos, tiles = first, {}
    while codestream[pos : pos + 2] == b"\xff\x90":
        tile, psot = struct.unpack(">HI", codestream[pos + 4 : pos + 10])
        tiles.setdefault(tile, []).append(codestream[pos + 14 : pos + psot])
        pos += psot
    out = codestream[:first]
    for tile in sorted(tiles):
        for tp, tn, data in numbering(tile, tiles[tile]):
            out += struct.pack(">HHHIBB", 0xFF90, 10, tile, 14 + len(data), tp, tn) + b"\xff\x93" + data
    return out + codestream[pos:]


def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2(codestream: bytes, enumcs=None, icc: bytes = None, pclr=None, cmap=None, cdef=None, ihdr=None,
        extra_header: bytes = b"", brand=b"jp2 ") -> bytes:
    """A JP2 file around ``codestream``: signature, ftyp, jp2h (ihdr from
    the SIZ unless given, colr enumerated ``enumcs`` or an ``icc``
    profile, ``pclr`` (sizes, entries [n, channels]), ``cmap`` [(cmp,
    mtyp, pcol)], ``cdef`` [(cn, typ, asoc)]), jp2c."""
    x1, y1, x0, y0 = struct.unpack(">IIII", codestream[8:24])
    nc, s0 = struct.unpack(">H", codestream[40:42])[0], codestream[42]
    ih = ihdr or struct.pack(">IIHBBBB", y1 - y0, x1 - x0, nc, s0, 7, 0, 0)
    head = box(b"ihdr", ih)
    if icc is not None:
        head += box(b"colr", bytes([2, 0, 0]) + icc)
    elif enumcs is not None:
        head += box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs))
    if pclr is not None:
        sizes, entries = pclr
        body = struct.pack(">HB", len(entries), len(sizes)) + bytes(s - 1 for s in sizes)
        for row in entries:
            for s, v in zip(sizes, row):
                body += int(v).to_bytes((s + 7) // 8, "big")
        head += box(b"pclr", body)
    if cmap is not None:
        head += box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in cmap))
    if cdef is not None:
        head += box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(struct.pack(">HHH", *d) for d in cdef))
    head += extra_header
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + box(b"ftyp", brand + b"\x00\x00\x00\x00" + brand)
            + box(b"jp2h", head) + box(b"jp2c", codestream))


# ---------------------------------------------------------------------------
# C11: the TIFF forms
# ---------------------------------------------------------------------------


def _tool(name):
    """``tools/<name>.py`` beside this file, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def c11_tiff(kind: str, h: int, w: int, seed: int, compression: int = 1, bits: int = 8, spp: int = 2,
             sub=(2, 2), tile=None, rows: int = 4) -> bytes:
    """A TIFF of one of C11's forms, random samples: ``palette`` (an
    8- or 4-bit index and spp - 1 extra samples, contiguous),
    ``palette-planes``, ``cmyk-planes`` (8 or 16 bits), ``ycbcr-planes``
    (subsampling ``sub``), ``lab-planes``, or ``ycbcr-predictor`` (data
    units of ``sub`` with Predictor 2, strips of ``rows`` rows or
    ``tile`` (width, height) tiles)."""
    fx = _tool("make_torch_codings_fixtures")  # its TIFF writer and codecs
    rng = np.random.default_rng(seed)
    S, L = fx.SHORT, fx.LONG
    enc = fx.ENCODERS[compression]
    tags = {256: (L, [w]), 257: (L, [h]), 259: (S, [compression])}
    if kind.startswith("palette"):
        planar = 2 if kind == "palette-planes" else 1
        idx = rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint8)
        if bits == 8:
            segs = [idx.tobytes()] if planar == 1 else [idx[..., k].tobytes() for k in range(spp)]
        else:
            v = idx.reshape(h, -1)
            v = np.concatenate([v, np.zeros((h, v.shape[1] % 2), np.uint8)], 1)
            segs = [(v[:, 0::2] << 4 | v[:, 1::2]).astype(np.uint8).tobytes()]
        tags.update({258: (S, [bits] * spp), 262: (S, [3]), 277: (S, [spp]), 278: (L, [h]), 284: (S, [planar]),
                     320: (S, rng.integers(0, 65536, 3 << bits).tolist()), 338: (S, [0] * (spp - 1))})
        return fx.tiff_bytes(tags, [enc(s) for s in segs])
    if kind.endswith("-planes"):
        photometric, n = {"cmyk-planes": (5, 4), "ycbcr-planes": (6, 3), "lab-planes": (8, 3)}[kind]
        dt = np.uint8 if bits == 8 else np.dtype("<u2")
        c = rng.integers(0, 1 << bits, (n, h, w)).astype(dt)
        tags.update({258: (S, [bits] * n), 262: (S, [photometric]), 277: (S, [n]), 278: (L, [rows]),
                     284: (S, [2]), 530: (S, list(sub))})
        return fx.tiff_bytes(tags, [enc(c[k, y : y + rows].tobytes()) for k in range(n) for y in range(0, h, rows)])
    assert kind == "ycbcr-predictor", kind
    hs, vs = sub
    block = hs * vs + 2
    if tile:
        tw, th = tile
        n = -(-th // vs) * -(-tw // hs) * block
        segs = [rng.integers(0, 256, n).astype(np.uint8).tobytes() for _ in range(-(-h // th) * -(-w // tw))]
        tags.update({322: (L, [tw]), 323: (L, [th])})
    else:
        segs = [rng.integers(0, 256, -(-min(rows, h - y) // vs) * -(-w // hs) * block).astype(np.uint8).tobytes()
                for y in range(0, h, rows)]
        tags[278] = (L, [rows])
    tags.update({258: (S, [8] * 3), 262: (S, [6]), 277: (S, [3]), 317: (S, [2]), 530: (S, [hs, vs])})
    return fx.tiff_bytes(tags, [enc(s) for s in segs], tiled=bool(tile))


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------


def micrograph(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """A smooth uint8 test image: gradients, dark blobs and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        img[..., c] = 128 + 60 * np.sin(x / (5 + 3 * c) + c) * np.cos(y / (7 + 2 * c))
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 6)
        img -= 70 * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))[..., None]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)[..., :channels]


def _pillow(img: np.ndarray, mode: str = None, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img), mode).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _cv2(img: np.ndarray, *params) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jp2", img, list(params))
    assert ok
    return buf.tobytes()


def _pillow_i16(gray16: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.frombytes("I;16", gray16.shape[::-1], gray16.astype("<u2").tobytes()).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def damaged(data: bytes, seed: int, n: int) -> list:
    """n copies of ``data``, each with one byte past the first 16 XORed
    with a random non-zero value."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = bytearray(data)
        k = int(rng.integers(16, len(data)))
        b[k] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    return out


def cases() -> dict:
    """{name: (extension, file bytes)} of every form the fixtures cover."""
    import cv2

    rgb = micrograph(23, 31, 1)[..., ::-1]  # Pillow's channel order
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    gray = micrograph(23, 31, 2, 1)[..., 0]
    g16 = gray.astype(np.int64) * 257 + np.arange(31)[None] % 7
    small = micrograph(13, 17, 3)
    sg = micrograph(13, 17, 4, 1)[..., 0].astype(np.int64)
    prc = [(3, 3), (3, 3), (4, 4), (4, 4), (5, 5), (5, 5)]
    out = {
        "pil-rev-rgb": _pillow(rgb), "pil-rev-gray": _pillow(gray),
        "pil-irr-rgb": _pillow(rgb, irreversible=True), "pil-irr-gray": _pillow(gray, irreversible=True),
        "pil-tiles": _pillow(rgb, tile_size=(16, 12)),
        "pil-irr-tiles": _pillow(rgb, tile_size=(16, 12), irreversible=True),
        "pil-precincts": _pillow(rgb, precinct_size=[(16, 16), (8, 8)]),
        "pil-codeblocks": _pillow(rgb, codeblock_size=(4, 16)),
        "pil-rev-layers": _pillow(rgb, quality_mode="rates", quality_layers=[30, 10, 3]),
        "pil-irr-layers": _pillow(rgb, irreversible=True, quality_mode="rates", quality_layers=[30, 10, 3]),
        "pil-irr-mct0": _pillow(rgb, irreversible=True, mct=0), "pil-rev-mct0": _pillow(rgb, mct=0),
        "pil-res1": _pillow(rgb, num_resolutions=1), "pil-res2": _pillow(gray, num_resolutions=2),
        "pil-la": _pillow(np.stack([gray, 255 - gray], -1), "LA"),
        "pil-rgba": _pillow(np.concatenate([rgb, gray[..., None]], -1), "RGBA"),
        "pil-i16": _pillow_i16(g16), "pil-i16-irr": _pillow_i16(g16, irreversible=True),
        "pil-raw-rgb": _pillow(rgb, no_jp2=True), "pil-raw-gray": _pillow(gray, no_jp2=True),
        "pil-signed": _pillow(gray, signed=True), "pil-plt": _pillow(rgb, plt=True),
    }
    cv = micrograph(35, 41, 5)  # cv2's encoder takes six resolutions: 32 pixels a side at least
    out.update({"cv2-rgb": _cv2(cv), "cv2-gray": _cv2(cv[..., 0]), "cv2-bgra": _cv2(np.dstack([cv, cv[..., :1]])),
                "cv2-lossy": _cv2(cv, cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 120),
                "cv2-16": _cv2(cv.astype(np.uint16) * 199)})
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        for irr in (False, True):
            out[f"pil-{order.lower()}{'-irr' if irr else ''}"] = _pillow(
                rgb, progression=order, precinct_size=[(16, 16), (8, 8)], quality_mode="rates",
                quality_layers=[20, 5], irreversible=irr, tile_size=(16, 16) if irr else None)
    # the numpy writer: code-block styles, markers and boxes
    for style in (1, 2, 4, 8, 16, 32, 5, 61):
        out[f"np-style-{style}"] = jp2(encode(small, style=style, levels=2, layers=2), 16)
    out["np-style-9-gray"] = jp2(encode(sg, style=9, levels=2, cblk=(3, 2)), 17)
    out["np-sop-eph"] = jp2(encode(small, sop=True, eph=True, layers=3), 16)
    out["np-poc"] = jp2(encode(small, layers=2, pocs=[(0, 0, 1, 2, 3, 1), (0, 0, 2, 4, 3, 0)]), 16)
    # resolutions no packet was read for: OpenJPEG reconstructs up to the last read and places it
    out["np-poc-low-resolutions"] = jp2(encode(small, levels=3, pocs=[(0, 0, 1, 2, 3, 0)]), 16)
    out["np-poc-low-resolutions-tiles"] = jp2(encode(sg, levels=2, tile=(9, 7), pocs=[(0, 0, 1, 2, 1, 0)]), 17)
    out["np-poc-component-resolutions"] = jp2(encode(small, levels=2, mct=False,
                                                     pocs=[(0, 0, 1, 3, 2, 0), (0, 2, 1, 2, 3, 0)]), 16)
    out["np-poc-unknown-order"] = jp2(encode(sg, levels=2, pocs=[(0, 0, 1, 3, 1, 7)]), 17)
    out["np-poc-positions"] = jp2(encode(small, layers=2, precincts=prc, cblk=(2, 2),
                                         pocs=[(0, 0, 2, 2, 3, 2), (2, 0, 2, 4, 2, 4), (2, 2, 2, 4, 3, 3)]), 16)
    for prg in range(5):
        out[f"np-prg-{prg}"] = jp2(encode(small, prg=prg, precincts=prc, cblk=(2, 2), layers=2, tile=(9, 7)), 16)
    out["np-tileparts"] = jp2(encode(small, tile=(9, 7), tileparts=3), 16)
    out["np-tileparts-tnsot0"] = jp2(encode(small, tile=(9, 7), tileparts=2, tnsot=False), 16)
    # tile-part counts (opj_j2k_need_nb_tile_parts_correction): TNsot one short with three parts is corrected,
    # with two (a single part declared: no look-ahead) refused; a tile of one part, the next one short, refused
    three = encode(small, tile=(9, 7), tileparts=3)
    out["np-tileparts-one-short"] = retile_parts(three, lambda t, ds: [(k, 2, d) for k, d in enumerate(ds)])
    out["np-tileparts-single-declared"] = retile_parts(encode(small, tile=(9, 7), tileparts=2),
                                                       lambda t, ds: [(k, 1, d) for k, d in enumerate(ds)])
    out["np-tileparts-mixed"] = retile_parts(three, lambda t, ds: [(0, 1, b"".join(ds))] if t == 0 else
                                             [(k, 2, d) for k, d in enumerate(ds)])
    # no EOC after tiles of TNsot 0 (OpenJPEG's "non conformant SPOT6 files"): read as if it were there
    out["np-tnsot0-no-eoc"] = encode(small, tile=(9, 7), tnsot=False)[:-2]
    # cut just after the next SOT's marker code: with single-part tiles OpenJPEG keeps the tile it decoded
    for parts in (1, 2):
        cs = encode(small, tile=(9, 7), tileparts=parts)
        sots = [i for i in range(len(cs)) if cs.startswith(b"\xff\x90\x00\x0a", i)]
        out[f"np-cut-at-sot-{parts}-parts"] = cs[: sots[parts] + 2]  # tile 0 whole, then FF90
    out["np-ppm"] = jp2(encode(small, tile=(9, 7), tileparts=2, ppm=True, layers=2, sop=True), 16)
    out["np-ppt"] = jp2(encode(small, tile=(9, 7), tileparts=2, ppt=True, layers=2, sop=True, eph=True), 16)
    out["np-rgn"] = jp2(encode(sg, rgn=(0, 12)), 17)
    out["np-irr-expounded"] = jp2(encode(small, reversible=False, step=1.5, layers=2), 16)
    out["np-irr-derived"] = jp2(encode(small, reversible=False, qstyle=1, step=1.5), 16)
    out["np-rev-derived-style"] = jp2(encode(sg, reversible=False, qstyle=1, step=0.75, style=4 | 8), 17)
    out["np-truncated"] = jp2(encode(sg, max_passes=6, layers=2), 17)
    out["np-guard-1"] = jp2(encode(sg, guard=1), 17)
    for prec in (1, 4, 7, 8, 9, 10, 12, 15, 16):
        v = sg * ((1 << prec) - 1) // 255
        out[f"np-gray-{prec}bit"] = jp2(encode(v, prec=prec, levels=2), 17)
        out[f"np-rgb-{prec}bit"] = jp2(encode(small.astype(np.int64) * ((1 << prec) - 1) // 255, prec=prec,
                                              levels=2), 16)
    out["np-offset"] = jp2(encode(small, offset=(3, 2)), 16)
    out["np-subsampled"] = jp2(encode(small, sub=[(1, 1), (2, 2), (2, 2)], mct=False), 16)
    out["np-raw-2"] = encode(small[..., :2])
    out["np-raw-4"] = encode(np.dstack([small, small[..., :1]]))
    out["np-five-components"] = jp2(encode(np.dstack([small, small[..., :2]])), 16)
    out["np-gray-srgb-2"] = jp2(encode(small[..., :2]), 16)
    out["np-gray-2"] = jp2(encode(small[..., :2]), 17)
    out["np-gray-3"] = jp2(encode(small), 17)
    out["np-sycc"] = jp2(encode(small, mct=False), 18)
    out["np-sycc-1"] = jp2(encode(sg), 18)
    out["np-cmyk"] = jp2(encode(np.dstack([small, small[..., :1]]), mct=False), 12)
    out["np-esycc"] = jp2(encode(small, mct=False), 24)
    out["np-enum-20"] = jp2(encode(small), 20)
    out["np-icc-rgb"] = jp2(encode(small), icc=bytes(64))
    out["np-icc-gray"] = jp2(encode(sg), icc=bytes(64))
    out["np-no-colr"] = jp2(encode(small))
    out["np-two-colr"] = jp2(encode(small), 16, extra_header=box(b"colr", bytes([1, 0, 0, 0, 0, 0, 17])))
    out["np-res-box"] = jp2(encode(small), 16, extra_header=box(b"res ", box(b"resc", bytes(10))))
    out["np-cap-part15"] = encode(small, extra_main=_marker(0xFF50, (0x00020000).to_bytes(4, "big") + bytes(2)))
    out["np-jph-brand"] = jp2(encode(small), 16, brand=b"jph ")
    idx = sg // 16
    ents = np.random.default_rng(3).integers(0, 256, (16, 3))
    e16 = np.random.default_rng(4).integers(0, 65536, (16, 3))
    pal = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
    out["np-pclr"] = jp2(encode(idx, levels=2), 16, pclr=([8, 8, 8], ents), cmap=pal)
    out["np-pclr-16"] = jp2(encode(idx, levels=2), 16, pclr=([16, 16, 16], e16), cmap=pal)
    out["np-pclr-gray"] = jp2(encode(idx, levels=2), 17, pclr=([8], ents[:, :1]), cmap=[(0, 1, 0)])
    out["np-pclr-clamped"] = jp2(encode(sg, levels=2), 16, pclr=([8, 8, 8], ents), cmap=pal)
    out["np-pclr-index-4bit"] = jp2(encode(idx, prec=4, levels=2), 16, pclr=([8, 8, 8], ents), cmap=pal)
    out["np-pclr-no-cmap"] = jp2(encode(idx, levels=2), 16, pclr=([8, 8, 8], ents))
    out["np-cmap-direct"] = jp2(encode(small[..., :2], levels=2, mct=False), 16, pclr=([8, 8], ents[:, :2]),
                                cmap=[(0, 1, 0), (1, 0, 0)])
    out["np-cmap-bad"] = jp2(encode(idx, levels=2), 16, pclr=([8, 8, 8], ents), cmap=[(0, 1, 0), (0, 1, 2), (0, 1, 1)])
    rgba = np.dstack([small, small[..., :1]])
    out["np-cdef-swap"] = jp2(encode(small), 16, cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)])
    out["np-cdef-alpha"] = jp2(encode(rgba), 16, cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])
    out["np-cdef-alpha-first"] = jp2(encode(np.dstack([small[..., :1], small]), mct=False), 16,
                                     cdef=[(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])
    out["np-cdef-incomplete"] = jp2(encode(small), 16, cdef=[(0, 0, 1), (1, 0, 2)])
    out["np-cdef-bad-association"] = jp2(encode(small), 16, cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 7)])
    cs = encode(small)
    out["np-ihdr-mismatch"] = jp2(cs, 16, ihdr=struct.pack(">IIHBBBB", 14, 17, 3, 7, 7, 0, 0))
    # cut and damaged copies
    base = out["pil-irr-layers"]
    for frac in (50, 90, 99):
        out[f"cut-{frac}"] = base[: len(base) * frac // 100]
    out["cut-after-tile"] = out["np-tileparts"][: out["np-tileparts"].rindex(b"\xff\x90")]
    for i, d in enumerate(damaged(out["pil-lrcp-irr"], 17, 12)):
        out[f"damaged-{i:02d}"] = d
    for i, d in enumerate(damaged(out["np-style-61"], 18, 6)):
        out[f"damaged-styles-{i}"] = d
    out = {k: (".j2k" if v.startswith(b"\xff\x4f") else ".jp2", v) for k, v in out.items()}
    # C11: the TIFF forms
    for spp in (2, 3, 4):
        out[f"c11-palette-extra-{spp}"] = (".tif", c11_tiff("palette", 13, 19, spp, spp=spp))
    out["c11-palette-extra-lzw"] = (".tif", c11_tiff("palette", 13, 19, 5, compression=5))
    out["c11-palette-extra-4bit"] = (".tif", c11_tiff("palette", 13, 19, 6, bits=4))
    out["c11-palette-planes"] = (".tif", c11_tiff("palette-planes", 13, 19, 7))
    for comp in (1, 5, 8):
        out[f"c11-cmyk-planes-{comp}"] = (".tif", c11_tiff("cmyk-planes", 13, 19, 8 + comp, compression=comp))
    out["c11-cmyk-planes-16"] = (".tif", c11_tiff("cmyk-planes", 13, 19, 20, bits=16))
    out["c11-ycbcr-planes-11"] = (".tif", c11_tiff("ycbcr-planes", 13, 19, 21, sub=(1, 1)))
    out["c11-ycbcr-planes-22"] = (".tif", c11_tiff("ycbcr-planes", 13, 19, 22, sub=(2, 2)))
    out["c11-lab-planes"] = (".tif", c11_tiff("lab-planes", 13, 19, 23, sub=(1, 1)))
    for i, (comp, sub, shape, tile) in enumerate([
            (5, (1, 1), (13, 19), None), (8, (1, 2), (13, 19), None), (5, (2, 1), (13, 19), None),
            (8, (2, 2), (13, 19), None), (5, (4, 1), (9, 7), None), (8, (4, 2), (21, 34), None),
            (5, (4, 4), (16, 24), None), (8, (4, 4), (13, 19), None), (5, (2, 2), (13, 19), (16, 16)),
            (8, (4, 4), (13, 19), (16, 16)), (5, (4, 2), (21, 34), (32, 16)), (8, (1, 1), (9, 7), (16, 16))]):
        name = f"c11-ycbcr-predictor-{'lzw' if comp == 5 else 'deflate'}-{sub[0]}{sub[1]}-{shape[1]}x{shape[0]}"
        out[name + ("-tiles" if tile else "")] = (".tif", c11_tiff("ycbcr-predictor", *shape, 30 + i, compression=comp,
                                                                  sub=sub, tile=tile))
    # chip_smoke.py phase 20's files, held by the SHA-256 of cv2's array: a 2048² micrograph reversible (5/3,
    # its layers cut by rate) and irreversible, and its dataset's labelled frames
    containers = _tool("make_torch_container_fixtures")
    big = containers.particles(2048, 0)[..., 0]
    out["smoke-rev-2048"] = (".jp2", _pillow(big, quality_mode="rates", quality_layers=[20]))
    out["smoke-irr-2048"] = (".jp2", _pillow(big, irreversible=True, quality_mode="rates", quality_layers=[20]))
    smoke = containers._chip_smoke()
    rng = np.random.default_rng(smoke.JPEG2000_SEED)
    for i, form in enumerate(smoke.JPEG2000_FORMS):
        frame, _ = smoke.draw_labelled(rng, smoke.DATASET_HW)
        out[f"dataset-{form}"] = (".jp2", dataset_frame(form, frame))
    return out


def dataset_frame(form: str, gray: np.ndarray) -> bytes:
    """One of phase 20's labelled frames in a JPEG 2000 form: ``rev`` and
    ``irr`` (layers cut by rate), ``tiled`` (256² tiles), ``gray16`` (the
    gray levels times 257 at 16 bits), ``la`` (gray and an alpha plane)
    or ``signed`` (a signed component, which cv2 refuses)."""
    rates = dict(quality_mode="rates", quality_layers=[40])
    if form == "rev":
        return _pillow(gray, **rates)
    if form == "irr":
        return _pillow(gray, irreversible=True, **rates)
    if form == "tiled":
        return _pillow(gray, tile_size=(256, 256), irreversible=True, **rates)
    if form == "gray16":
        return _pillow_i16(gray.astype(np.int64) * 257, **rates)
    if form == "la":
        return _pillow(np.stack([gray, np.full_like(gray, 255)], -1), "LA", **rates)
    assert form == "signed", form
    return _pillow(gray, signed=True, **rates)


# the entries held by the SHA-256 of cv2's array rather than the array
HASHED_PREFIXES = ("smoke-", "dataset-")


def main(out: str = str(DEFAULT_OUT)) -> str:
    import cv2

    arrays = {}
    with tempfile.TemporaryDirectory() as d:
        for name, (ext, data) in cases().items():
            path = Path(d) / f"f{ext}"
            path.write_bytes(data)
            ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/ext"] = np.frombuffer(ext.encode(), np.uint8)
            if ref is None:
                arrays[f"{name}/none"] = np.zeros(0, np.uint8)
            elif name.startswith(HASHED_PREFIXES):
                arrays[f"{name}/sha256"] = np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)
            else:
                arrays[f"{name}/bgr"] = ref
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main(*sys.argv[1:]))

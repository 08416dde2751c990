"""A lossless AV1 still-picture writer in numpy, for the test fixtures of
``tests/test_torch_avif.py``: it writes the forms of the bitstream that
``cv2.imencode('.avif')`` does not (a full sequence header with timing and
decoder model information, frame header and tile group OBUs apart,
several tiles, uniform or not, 128x128 superblocks, partitions of every
type, skipped blocks, CDF updates off, padding and metadata OBUs), so that
cv2 (libaom) and the port's decoder can be held to each other on them.
With ``palette``, the frame allows screen content tools, and blocks of 8x8
to 64x64 take palettes of Y and UV, their colours partly from the colour
cache of their neighbours. With ``lossy``'s ``delta_lf``, superblocks
code delta loop filter levels, one or one per plane and direction, under
any multiplier, drawn at random. With ``intrabc``, it allows intra block copy
too, and some blocks copy: each skipped, far enough from any other that
its DV stack is empty, its DV the default one or a pixel off it where that
is valid (half-pixel chroma where subsampled), so that the paths cv2's
frames do not take (4:2:2, 128x128 superblocks, tile rows) are written.
With ``segmentation``, the frame codes segments with any features (a
quantizer per segment, lossless ones among lossy ones, loop filter levels
per plane and direction, SKIP, REF_FRAME or GLOBALMV, which move the id
before skip) and each block's segment id, drawn at random and coded
against its spatial prediction.

Every block takes intra modes drawn at random (every Y and UV mode, angle
deltas, CFL, filter intra), its residual coded exactly with TX_4X4
Walsh-Hadamard coefficients. With ``lossy``, the frame is a lossy one
(at q-context 0) under the loop filter, CDEF and loop restoration
parameters given, its transforms the largest
(TX_MODE_LARGEST): every block larger than 4x4 skips, and each 4x4 block
codes a few random coefficients in each plane (the luma transform type
drawn from the intra set's 2D types), so that the planes are the intra
prediction of that texture, deblocked; the writer mirrors the
decoding process of the AV1 specification (the symbol coder of libaom's
``entenc.c`` on Python integers, the CDFs read from
``deepemia_tpu_torch/native/av1.cpp``). Slow (pure Python): small images.

    data = encode(planes, bit_depth=8, sb128=True, tiles=("uniform", 1, 1))
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

AV1_CPP = Path(__file__).resolve().parents[1] / "deepemia_tpu_torch" / "native" / "av1.cpp"
AV1_TABLES = AV1_CPP.with_name("av1_tables.h")
_SCAN = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BASE_OFFSET = ((0, 1, 6, 6), (1, 6, 6, 21), (6, 6, 21, 21), (6, 21, 21, 21))
_MODE_CTX = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)  # Intra_Mode_Context
_WIDE = (1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16)
_HIGH = (1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4)
B4X4, B8X8, B64X64, B128X128 = 0, 3, 12, 15
NONE, HORZ, VERT, SPLIT, HORZ_A, HORZ_B, VERT_A, VERT_B, HORZ_4, VERT_4 = range(10)


def _values(src: str, name: str) -> list:
    body = re.search(rf"\b{name}\b\s*(?:\[[^\]]*\]\s*)*=\s*\{{(.*?)\}};", src, re.S).group(1)
    return [int(x) for x in re.findall(r"-?\d+", body)]


def _tables() -> dict:
    """The CDF tables of av1.cpp, and the TX_4X4 q-context-0 coefficient
    CDFs of av1_tables.h (what a lossless frame reads) -> {name: [cdfs]}
    (each N values and a counter)."""
    src = AV1_CPP.read_text()
    out = {}
    for name, per in (("kPartition8", 5), ("kPartition16", 11), ("kPartition128", 9), ("kKfYMode", 14),
                      ("kUvModeNoCfl", 14), ("kUvModeCfl", 15), ("kSkip", 3), ("kAngleDelta", 8),
                      ("kFilterIntra", 3), ("kFilterIntraMode", 6), ("kCflSign", 9), ("kCflAlpha", 17),
                      ("kDrIntraDerivative", 90), ("kFilterIntraTaps", 56), ("kModeToAngle", 13)):
        v = _values(src, name)
        out[name] = [list(v[k : k + per]) for k in range(0, len(v), per)]
    tables = AV1_TABLES.read_text()
    # (name in av1_tables.h, values per CDF, CDFs of TX_4X4 at q-context 0 and its index stride per tx size)
    for name, header, per, count in (("kTxbSkip", "kTxbSkipCdf", 3, 13), ("kEobPt16", "kEobPt16Cdf", 6, 4),
                                     ("kEobExtra", "kEobExtraCdf", 3, 18), ("kCoeffBaseEob", "kCoeffBaseEobCdf", 4, 8),
                                     ("kCoeffBase", "kCoeffBaseCdf", 5, 84), ("kCoeffBr", "kCoeffBrCdf", 5, 42),
                                     ("kDcSign", "kDcSignCdf", 3, 6)):
        v = _values(tables, header)[: per * count]
        out[name] = [list(v[k : k + per]) for k in range(0, len(v), per)]
    out["kSmWeights4"] = [_values(tables, "kSmWeights")[:4]]
    out["kDeltaQ"] = out["kDeltaLf"] = [_values(tables, "kDeltaQCdf")]  # Default_Delta_Lf_Cdf is the same
    out["kDeltaLfMulti"] = out["kDeltaLf"] * 4  # FRAME_LF_COUNT CDFs, each adapting on its own
    for name in ("kSwitchableRestore", "kWienerRestore", "kSgrprojRestore"):
        out[name] = [_values(tables, f"{name}Cdf")]
    v = _values(tables, "kIntraTxTypeSet1Cdf")[: 8 * 13]  # TX_4X4's, by intra direction
    out["kIntraTx1"] = [list(v[k : k + 8]) for k in range(0, len(v), 8)]
    v = _values(tables, "kIntraTxTypeSet2Cdf")[: 6 * 13]  # TX_4X4's under reduced_tx_set
    out["kIntraTx2"] = [list(v[k : k + 6]) for k in range(0, len(v), 6)]
    for name, per in (("kPaletteYMode", 3), ("kPaletteUvMode", 3), ("kPaletteYSize", 8), ("kPaletteUvSize", 8),
                      ("kPaletteYColor", 9), ("kPaletteUvColor", 9), ("kIntrabc", 3), ("kMvJoint", 5),
                      ("kMvClass", 12), ("kMvSign", 3), ("kMvClass0Bit", 3), ("kMvBits", 3)):
        v = _values(tables, f"{name}Cdf")
        out[name] = [list(v[k : k + per]) for k in range(0, len(v), per)]
    v = _values(tables, "kSpatialPredSegCdf")
    out["kSpatialPredSeg"] = [list(v[k : k + 9]) for k in range(0, len(v), 9)]
    return out


# segmentation: Segmentation_Feature_Bits, _Signed and _Max of each SEG_LVL_* (ALT_Q, ALT_LF_Y_V, ALT_LF_Y_H,
# ALT_LF_U, ALT_LF_V, REF_FRAME, SKIP, GLOBALMV)
SEG_BITS, SEG_SIGNED, SEG_MAX = (8, 6, 6, 6, 6, 3, 0, 0), (1, 1, 1, 1, 1, 0, 0, 0), (255, 63, 63, 63, 63, 7, 0, 0)
SEG_LVL_ALT_Q, SEG_LVL_REF_FRAME, SEG_LVL_SKIP = 0, 5, 6


def segment_features(seg) -> list:
    """``encode``'s ``segmentation`` -> per segment {SEG_LVL_* index: value as coded}."""
    return [{int(j): int(v) for j, v in seg.get("features", {}).get(s, {}).items()} for s in range(8)]


def segment_qindex(seg, q: int) -> list:
    """Per segment, its quantizer without delta q (base_q_idx ``q`` plus ALT_Q clamped, as get_qindex(1, ·))."""
    if seg is None:
        return [q] * 8
    return [min(255, max(0, q + max(-255, min(255, f[SEG_LVL_ALT_Q])))) if SEG_LVL_ALT_Q in f else q
            for f in segment_features(seg)]


def neg_interleave(x: int, ref: int, n: int) -> int:
    """libaom's av1_neg_interleave: the symbol that codes segment id ``x``
    against the prediction ``ref`` of ``n`` ids (neg_deinterleave's inverse)."""
    diff = x - ref
    if not ref:
        return x
    if ref >= n - 1:
        return n - x - 1
    if abs(diff) <= (ref if 2 * ref < n else n - ref - 1):
        return 2 * diff - 1 if diff > 0 else -2 * diff
    return x if 2 * ref < n else n - x - 1


def color_context(m: np.ndarray, r: int, c: int, n: int):
    """get_palette_color_context: the colours ranked by the weights (2, 1,
    2) of the left, above-left and above indices of the map ``m``, and
    the context their ranked scores hash to -> (order, context)."""
    scores, order = [0] * 8, list(range(8))
    if c > 0:
        scores[m[r, c - 1]] += 2
    if r > 0 and c > 0:
        scores[m[r - 1, c - 1]] += 1
    if r > 0:
        scores[m[r - 1, c]] += 2
    for i in range(3):
        best = i
        for j in range(i + 1, n):
            if scores[j] > scores[best]:
                best = j
        score, color = scores[best], order[best]
        for k in range(best, i, -1):
            scores[k], order[k] = scores[k - 1], order[k - 1]
        scores[i], order[i] = score, color
    return order, (-1, -1, 0, -1, -1, 4, 3, 2, 1)[scores[0] + 2 * scores[1] + 2 * scores[2]]


def _ceil_log2(x: int) -> int:
    return 0 if x < 2 else (x - 1).bit_length()


class Bits:
    """A big-endian bit writer."""

    def __init__(self):
        self.bits = []

    def f(self, n: int, v: int) -> None:
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def ns(self, n: int, v: int) -> None:
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            self.f(w - 1, v)
        else:
            self.f(w - 1, (v + m) >> 1)
            self.f(1, (v + m) & 1)

    def trailing(self) -> None:
        self.bits.append(1)
        while len(self.bits) % 8:
            self.bits.append(0)

    def align(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        return bytes(int("".join(map(str, self.bits[k : k + 8])), 2) for k in range(0, len(self.bits), 8))


class SymbolWriter:
    """libaom's od_ec encoder (entenc.c) with the low end of the interval a
    Python integer (no carry buffer), and the specification's CDF
    adaptation."""

    def __init__(self, adapt: bool):
        self.low, self.rng, self.shift, self.adapt = 0, 0x8000, 0, adapt

    def symbol(self, s: int, cdf: list, n: int) -> None:
        r, big_n = self.rng, n - 1
        fl = 32768 - cdf[s - 1] if s > 0 else 32768
        fh = 32768 - cdf[s]
        if fl < 32768:
            u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (big_n - (s - 1))
            v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (big_n - s)
            self.low += r - u
            r = u - v
        else:
            r -= ((r >> 8) * (fh >> 6) >> 1) + 4 * (big_n - s)
        d = 16 - r.bit_length()
        self.low <<= d
        self.rng = r << d
        self.shift += d
        if self.adapt:
            rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + min(n.bit_length() - 1, 2)
            tmp = 0
            for i in range(n - 1):
                if i == s:
                    tmp = 1 << 15
                if tmp < cdf[i]:
                    cdf[i] -= (cdf[i] - tmp) >> rate
                else:
                    cdf[i] += (tmp - cdf[i]) >> rate
            cdf[n] += cdf[n] < 32

    def bool(self, b: int) -> None:
        a = self.adapt
        self.adapt = False
        self.symbol(b, [1 << 14, 1 << 15, 0], 2)
        self.adapt = a

    def finish(self) -> bytes:
        """od_ec_enc_done: the interval's value with a one where the decoder
        stops telling (its reserved bit), then zeros to a whole byte."""
        m = 0x3FFF
        e = ((self.low + m) & ~m) | (m + 1)
        n = (self.shift + 1 + 7) // 8
        top = self.shift + 14
        out = bytearray(n)
        for k in range(8 * n):
            if top - k >= 0 and (e >> (top - k)) & 1:
                out[k >> 3] |= 0x80 >> (k & 7)
        return bytes(out)


# loop restoration: the Wiener taps' and the self-guided weights' ranges, subexp parameters and references
WIENER_MIN, WIENER_MAX, WIENER_K, WIENER_MID = (-5, -23, -17), (10, 8, 46), (1, 2, 3), (3, -7, 15)
XQD_MIN, XQD_MAX, XQD_MID = (-96, -32), (31, 95), (-32, 31)
# the radii (r0, r1) of each self-guided set (av1_tables.h: kSgrParams)
SGR_RADII = [tuple(v) for v in np.array(_values(AV1_TABLES.read_text(), "kSgrParams")).reshape(16, 4)[:, :2]]
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)  # Remap_Lr_Type: lr_type as coded


def _subexp_with_ref(sym, low: int, high: int, k: int, ref: int, v: int) -> None:
    """encode_signed_subexp_with_ref_bool: ``v`` of [low, high) against
    ``ref`` in bools (libaom's aom_write_primitive_refsubexpfin)."""
    n, r, x = high - low, ref - low, v - low

    def recenter(r_, v_):
        return v_ if v_ > 2 * r_ else 2 * (v_ - r_) if v_ >= r_ else 2 * (r_ - v_) - 1

    x = recenter(r, x) if 2 * r <= n else recenter(n - 1 - r, n - 1 - x)

    def literal(value, bits):
        for i in range(bits - 1, -1, -1):
            sym.bool((value >> i) & 1)

    i = mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:  # quniform(n - mk)
            m_n, val = n - mk, x - mk
            if m_n > 1:
                ln = m_n.bit_length()
                m = (1 << ln) - m_n
                if val < m:
                    literal(val, ln - 1)
                else:
                    literal(m + ((val - m) >> 1), ln - 1)
                    sym.bool((val - m) & 1)
            return
        more = int(x >= mk + a)
        sym.bool(more)
        if not more:
            literal(x - mk, b)
            return
        i, mk = i + 1, mk + a


def _wht_levels(res: np.ndarray) -> np.ndarray:
    """The TX_4X4 levels whose inverse Walsh-Hadamard transform (av1.cpp's
    reconstruct: rows, then columns) gives ``res`` [4,4] exactly."""

    def inverse_step(out):
        a_f, b_f, c_f, d_f = (int(x) for x in out)
        a2, d2 = a_f + b_f, d_f - c_f
        e = (a2 - d2) >> 1
        b0, c0 = e - b_f, e - c_f
        return [a2 - c0, c0, d2 + b0, b0]  # T[0], T[1], T[2], T[3] = a, c, d, b

    t = np.zeros((4, 4), np.int64)
    for j in range(4):
        t[:, j] = inverse_step(res[:, j])
    lv = np.zeros((4, 4), np.int64)
    for i in range(4):
        lv[i] = inverse_step(t[i])
    return lv


class _Frame:
    def __init__(self, planes, bit_depth, sb128, tiles, disable_cdf_update, rng, weights, modes, sub=(0, 0),
                 lossy=False, deltas=False, cdef=None, empty=0.0, skip64=(), restoration=None, seed=0, palette=None,
                 intrabc=None, reduced_tx_set=False, segmentation=None, q=0, dq=(0, 0, 0), delta_q=None):
        self.lossy, self.deltas = lossy, deltas
        # delta q: {"odds", "range", "res"} where each superblock's delta is drawn (else each 0), from its own rng
        self.delta_q = delta_q
        self.dq_rng = np.random.default_rng([seed, 27])
        # delta LF: {"multi", "res", "odds", "range", "sign"} where deltas are drawn (else each 0), drawn from its own
        # rng, so that odds 0 gives the blocks of the same seed with every delta 0
        self.delta_lf = deltas if isinstance(deltas, dict) else None
        self.dlf_rng = np.random.default_rng([seed, 26])
        self.reduced_tx_set = reduced_tx_set
        self.palette, self.palette_count = palette, 0
        self.intrabc = intrabc
        self.lr = restoration
        self.lr_rng = np.random.default_rng([seed, 7])  # the units' draws, apart from the blocks'
        self.lr_count = 0
        # CDEF: (index bits, the 64x64s whose blocks all skip); the index of each 64x64 (mode info units) written
        self.cdef, self.skip64, self.empty = cdef, set(skip64), empty
        self.cdef_idx = {}
        self.coded_empty = False
        self.src = [np.asarray(p, np.int64) for p in planes]
        self.mono = len(planes) == 1
        self.bd = bit_depth
        self.sb128 = sb128
        self.ssx, self.ssy = (1, 1) if self.mono else sub
        self.h, self.w = self.src[0].shape
        self.mi_cols, self.mi_rows = 2 * ((self.w + 7) >> 3), 2 * ((self.h + 7) >> 3)
        # the decoded area (whole 4x4 blocks up to the 8-aligned size, subsampled for chroma): the source,
        # edges replicated
        self.pix = []
        for k, p in enumerate(self.src):
            sx, sy = (self.ssx, self.ssy) if k else (0, 0)
            assert p.shape == ((self.h + sy) >> sy, (self.w + sx) >> sx), p.shape
            self.pix.append(np.pad(p, ((0, ((self.mi_rows * 4) >> sy) - p.shape[0]),
                                       (0, ((self.mi_cols * 4) >> sx) - p.shape[1])), mode="edge"))
        self.disable_cdf_update = disable_cdf_update
        self.rng = rng
        self.tiles = tiles
        self.weights = weights
        self.base = _tables()
        self.mode_odds = np.full(13, 1 / 13) if modes else np.eye(13)[0]
        self.mode_odds_uv = np.full(14, 1.0) if modes else np.eye(14)[0]
        self.ibc = np.zeros((self.mi_rows, self.mi_cols), bool)  # the 4x4 units of blocks that copy
        self.ibc_blocks = 0
        self.seg_setup(segmentation, q, dq, seed)

    # ---- segmentation (5.9.14, 5.11.9) ----
    def seg_setup(self, seg, q, dq, seed):
        """The segments' features as coded, LastActiveSegId, SegIdPreSkip,
        each segment's quantizer without delta q (ALT_Q clamped as the
        decoder clamps it) and lossless flag."""
        self.seg = seg
        self.seg_map = np.zeros((self.mi_rows, self.mi_cols), np.int64)  # each 4x4 unit's segment id
        self.seg_rng = np.random.default_rng([seed, 28])  # the ids' draws, apart from the blocks'
        self.seg_corrupted = False
        self.segment_id, self.forced_skip = 0, False
        self.seg_qindex = segment_qindex(seg, q)
        self.seg_lossless = [v == 0 and not any(dq) for v in self.seg_qindex]  # LosslessArray
        self.lossless_blk = self.seg_lossless[0]
        if seg is None:
            return
        self.seg_features = segment_features(seg)
        self.seg_last = max([s for s in range(8) if self.seg_features[s]], default=0)
        self.seg_preskip = any(j >= SEG_LVL_REF_FRAME for f in self.seg_features for j in f)

    def seg_begin(self, r, c, bsize, skip_known):
        """A block's segment id before its skip is known: the spatial
        prediction and its context (av1_get_spatial_seg_pred), and the id,
        the prediction where the block reads none (``skip_known`` and the
        id read after skip), else the prediction at the odds ``repeat``
        (0.4), else drawn at the odds ``odds`` (a weight per id up to
        LastActiveSegId, else even)."""
        if self.seg is None:
            return
        m = self.seg_map
        ul = int(m[r - 1, c - 1]) if self.avail_u and self.avail_l else -1
        u, lt = (int(m[r - 1, c]) if self.avail_u else -1), (int(m[r, c - 1]) if self.avail_l else -1)
        self.seg_ctx = 0 if ul < 0 else 2 if ul == u == lt else 1 if ul in (u, lt) or u == lt else 0
        self.seg_pred = (0 if lt == -1 else lt) if u == -1 else u if lt == -1 else u if ul == u else lt
        rng, n = self.seg_rng, self.seg_last + 1
        if skip_known and not self.seg_preskip:
            seg_id = self.seg_pred
        elif rng.random() < self.seg.get("repeat", 0.4):
            seg_id = self.seg_pred
        else:
            odds = np.asarray(self.seg.get("odds", [1.0] * n), np.float64)[:n]
            seg_id = int(rng.choice(n, p=odds / odds.sum()))
        self.set_segment(seg_id)

    def set_segment(self, seg_id):
        self.segment_id = seg_id
        self.forced_skip = SEG_LVL_SKIP in self.seg_features[seg_id]
        self.lossless_blk = self.seg_lossless[seg_id]

    def write_segment_id(self):
        """The block's id against its prediction, in the CDF of its context;
        with ``corrupt``, the first id coded is one past LastActiveSegId
        (libaom fails on it)."""
        n = self.seg_last + 1
        coded = neg_interleave(self.segment_id, self.seg_pred, n)
        if self.seg.get("corrupt") and not self.seg_corrupted and n < 8:
            coded, self.seg_corrupted = n, True  # neg_deinterleave gives an id outside 0..n-1 for every symbol >= n
        self.sym.symbol(coded, self.cdf["kSpatialPredSeg"][self.seg_ctx], 8)

    def write_skip_and_segment(self, r, c, bsize, skip):
        """skip and the segment id in the order intra_frame_mode_info reads
        them (the id first under SegIdPreSkip; no skip symbol under
        SEG_LVL_SKIP; after skip, a skipped block takes the prediction), and
        the id kept for the 4x4 units the block covers."""
        ctx = (self.skips[r - 1, c] if self.avail_u else 0) + (self.skips[r, c - 1] if self.avail_l else 0)
        if self.seg is None:
            self.sym.symbol(skip, self.cdf["kSkip"][ctx], 2)
            return
        if self.seg_preskip:
            self.write_segment_id()
        if self.forced_skip:
            assert skip, "SEG_LVL_SKIP: the block codes no residual"
        else:
            self.sym.symbol(skip, self.cdf["kSkip"][ctx], 2)
        if not self.seg_preskip:
            if skip:
                self.set_segment(self.seg_pred)
            else:
                self.write_segment_id()
        self.seg_map[r : r + _HIGH[bsize], c : c + _WIDE[bsize]] = self.segment_id

    def sub(self, p):
        return (self.ssx, self.ssy) if p else (0, 0)

    def chroma_invalid(self, bsize):
        """Whether the subsampling leaves no chroma block for ``bsize``
        (Subsampled_Size is BLOCK_INVALID: a tall block in 4:2:2)."""
        return not self.mono and self.ssx and not self.ssy and _HIGH[bsize] > _WIDE[bsize]
    # ---- tile layout ----
    def tile_layout(self):
        sb = 32 if self.sb128 else 16
        sb_cols, sb_rows = -(-self.mi_cols // sb), -(-self.mi_rows // sb)
        kind, a, b = self.tiles
        if kind == "uniform":
            cols_log2, rows_log2 = a, b
            w = -(-sb_cols // (1 << cols_log2))
            h = -(-sb_rows // (1 << rows_log2))
            cols = list(range(0, sb_cols, w))
            rows = list(range(0, sb_rows, h))
        else:  # explicit widths and heights in superblocks
            cols = list(np.cumsum([0] + list(a))[:-1])
            rows = list(np.cumsum([0] + list(b))[:-1])
            assert sum(a) == sb_cols and sum(b) == sb_rows
        return ([c * sb for c in cols] + [self.mi_cols], [r * sb for r in rows] + [self.mi_rows], sb_cols, sb_rows)

    # ---- a tile ----
    def encode_tile(self, r0, r1, c0, c1) -> bytes:
        self.cdf = {k: [list(c) for c in v] for k, v in self.base.items()}
        self.sym = SymbolWriter(not self.disable_cdf_update)
        self.tile = (r0, r1, c0, c1)
        n = 1 if self.mono else 3
        self.ref_wiener = [[list(WIENER_MID), list(WIENER_MID)] for _ in range(n)]
        self.ref_sgr = [list(XQD_MID) for _ in range(n)]
        self.above_level = [np.zeros(self.mi_cols + 32, np.int64) for _ in range(n)]
        self.above_dc = [np.zeros(self.mi_cols + 32, np.int64) for _ in range(n)]
        self.mi_size = np.full((self.mi_rows, self.mi_cols), -1)
        self.skips = np.zeros((self.mi_rows, self.mi_cols), np.int64)
        self.y_modes = np.zeros((self.mi_rows, self.mi_cols), np.int64)
        self.uv_modes = np.zeros((self.mi_rows, self.mi_cols), np.int64)
        # each 4x4 unit's palette sizes (Y, UV) and colours (Y, U)
        self.pal_n = np.zeros((2, self.mi_rows, self.mi_cols), np.int64)
        self.pal_c = np.zeros((2, self.mi_rows, self.mi_cols, 8), np.int64)
        self.block_decoded = [None] * n
        self.delta_lf_running = [0] * 4  # av1_reset_loop_filter_delta
        sb4 = 32 if self.sb128 else 16
        for r in range(r0, r1, sb4):
            self.left_level = [np.zeros(self.mi_rows + 32, np.int64) for _ in range(n)]
            self.left_dc = [np.zeros(self.mi_rows + 32, np.int64) for _ in range(n)]
            for c in range(c0, c1, sb4):
                self.clear_block_decoded(r, c)
                self.read_deltas = bool(self.deltas or self.delta_q)
                if self.lr:
                    self.lr_units(r, c)
                self.partition(r, c, B128X128 if self.sb128 else B64X64)
        return self.sym.finish()

    # ---- loop restoration units (5.11.57-58) ----
    def lr_geometry(self, p):
        """(frame restoration type, unit size, unit rows, unit columns) of plane ``p``."""
        lr = self.lr
        ftype = LR_TYPE[lr["types"][p]]
        size = 256 >> (2 - lr["unit_shift"])
        if p:
            size >>= lr.get("uv_shift", 0)
        sx, sy = self.sub(p)

        def count(n):
            return max((n + (size >> 1)) // size, 1)

        return ftype, size, count((self.h + sy) >> sy), count((self.w + sx) >> sx)

    def lr_units(self, r, c):
        """The coefficients of the units whose top-left corner lies in the superblock at (r, c)."""
        sb4 = 32 if self.sb128 else 16
        for p in range(1 if self.mono else 3):
            ftype, size, rows, cols = self.lr_geometry(p)
            if ftype == RESTORE_NONE:
                continue
            sx, sy = self.sub(p)
            mx, my = 4 >> sx, 4 >> sy
            for _ in range((r * my + size - 1) // size, min(rows, ((r + sb4) * my + size - 1) // size)):
                for _ in range((c * mx + size - 1) // size, min(cols, ((c + sb4) * mx + size - 1) // size)):
                    self.lr_unit(p, ftype)

    def lr_unit(self, p, ftype):
        lr, rng, sym, cdf = self.lr, self.lr_rng, self.sym, self.cdf
        none = lr.get("none", False)
        if ftype == RESTORE_SWITCHABLE:
            kind = RESTORE_NONE if none else int(rng.choice(3, p=[0.2, 0.4, 0.4]))
            sym.symbol(kind, cdf["kSwitchableRestore"][0], 3)
        else:
            on = int(not none and rng.random() < 0.85)
            sym.symbol(on, cdf["kWienerRestore" if ftype == RESTORE_WIENER else "kSgrprojRestore"][0], 2)
            kind = ftype if on else RESTORE_NONE
        sgr_set = -1
        if kind == RESTORE_WIENER:
            for pass_ in range(2):
                for j in range(1 if p else 0, 3):
                    lo, hi = WIENER_MIN[j], WIENER_MAX[j]
                    v = int(rng.choice([lo, hi])) if lr.get("extreme") else int(rng.integers(lo, hi + 1))
                    _subexp_with_ref(sym, lo, hi + 1, WIENER_K[j], self.ref_wiener[p][pass_][j], v)
                    self.ref_wiener[p][pass_][j] = v
        elif kind == RESTORE_SGRPROJ:
            sets = lr.get("sets")
            sgr_set = int(sets[self.lr_count % len(sets)]) if sets else int(rng.integers(0, 16))
            self.lr_count += 1
            for i in range(3, -1, -1):
                sym.bool((sgr_set >> i) & 1)
            for i in range(2):
                lo, hi = XQD_MIN[i], XQD_MAX[i]
                if SGR_RADII[sgr_set][i]:
                    v = int(rng.integers(lo, hi + 1))
                    _subexp_with_ref(sym, lo, hi + 1, 4, self.ref_sgr[p][i], v)
                else:
                    v = 0 if i == 0 else min(hi, max(lo, (1 << 7) - self.ref_sgr[p][0]))
                self.ref_sgr[p][i] = v
        if "log" in lr:  # (plane, type, the self-guided set or -1, whether the Wiener taps lie at their ends)
            lr["log"].append((p, kind, sgr_set, int(kind == RESTORE_WIENER and bool(lr.get("extreme")))))

    def inside(self, r, c):
        r0, r1, c0, c1 = self.tile
        return r0 <= r < r1 and c0 <= c < c1

    @staticmethod
    def sub_size(p, bsize):
        w, h = _WIDE[bsize], _HIGH[bsize]
        if p in (HORZ, HORZ_A, HORZ_B):
            h //= 2
        elif p in (VERT, VERT_A, VERT_B):
            w //= 2
        elif p == SPLIT:
            w, h = w // 2, h // 2
        elif p == HORZ_4:
            h //= 4
        elif p == VERT_4:
            w //= 4
        for b in range(22):
            if _WIDE[b] == w and _HIGH[b] == h:
                return b
        return -1

    def partition(self, r, c, bsize):
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        num4 = _WIDE[bsize]
        half, quarter = num4 >> 1, num4 >> 2
        has_rows, has_cols = r + half < self.mi_rows, c + half < self.mi_cols
        bsl = num4.bit_length() - 1
        if bsize == B4X4:
            p = NONE
        else:
            above = self.inside(r - 1, c) and (_WIDE[self.mi_size[r - 1, c]].bit_length() - 1) < bsl
            left = self.inside(r, c - 1) and (_HIGH[self.mi_size[r, c - 1]].bit_length() - 1) < bsl
            ctx = left * 2 + above
            if bsl == 1:
                cdf, n = self.cdf["kPartition8"][ctx], 4
            elif bsl == 5:
                cdf, n = self.cdf["kPartition128"][ctx], 8
            else:
                cdf, n = self.cdf["kPartition16"][(bsl - 2) * 4 + ctx], 10
            if has_rows and has_cols:
                w = self._weights(n, bsize)
                for k in range(n):
                    if self.chroma_invalid(self.sub_size(k, bsize)):
                        w[k] = 0
                p = int(self.rng.choice(n, p=w / w.sum()))
                self.sym.symbol(p, cdf, n)
            elif has_cols or has_rows:
                split = int(self.rng.random() < 0.7 or self.chroma_invalid(self.sub_size(HORZ if has_cols else VERT, bsize)))

                def prob(e):
                    return cdf[e] - (cdf[e - 1] if e > 0 else 0)

                if has_cols:
                    psum = prob(VERT) + prob(SPLIT) + prob(HORZ_A) + prob(VERT_A) + prob(VERT_B)
                    psum += prob(VERT_4) if bsize != B128X128 else 0
                else:
                    psum = prob(HORZ) + prob(SPLIT) + prob(HORZ_A) + prob(HORZ_B) + prob(VERT_A)
                    psum += prob(HORZ_4) if bsize != B128X128 else 0
                a = self.sym.adapt
                self.sym.adapt = False
                self.sym.symbol(split, [32768 - psum, 32768, 0], 2)
                self.sym.adapt = a
                p = SPLIT if split else HORZ if has_cols else VERT
            else:
                p = SPLIT
        sub, split = self.sub_size(p, bsize), self.sub_size(SPLIT, bsize)
        blk = self.block
        if p == NONE:
            blk(r, c, sub)
        elif p == HORZ:
            blk(r, c, sub)
            if has_rows:
                blk(r + half, c, sub)
        elif p == VERT:
            blk(r, c, sub)
            if has_cols:
                blk(r, c + half, sub)
        elif p == SPLIT:
            for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
                self.partition(r + dr, c + dc, sub)
        elif p == HORZ_A:
            blk(r, c, split), blk(r, c + half, split), blk(r + half, c, sub)
        elif p == HORZ_B:
            blk(r, c, sub), blk(r + half, c, split), blk(r + half, c + half, split)
        elif p == VERT_A:
            blk(r, c, split), blk(r + half, c, split), blk(r, c + half, sub)
        elif p == VERT_B:
            blk(r, c, sub), blk(r, c + half, split), blk(r + half, c + half, split)
        elif p == HORZ_4:
            for i in range(4):
                if i < 3 or r + quarter * 3 < self.mi_rows:
                    blk(r + quarter * i, c, sub)
        else:
            for i in range(4):
                if i < 3 or c + quarter * 3 < self.mi_cols:
                    blk(r, c + quarter * i, sub)

    def _weights(self, n, bsize):
        """Partition choices: ``weights`` ({block size: [weight per
        partition]}) where given, else mostly SPLIT down to 8x8 and every
        type now and then."""
        if bsize in self.weights:
            w = np.asarray(self.weights[bsize][:n], np.float64)
        else:
            w = np.full(n, 0.3)
            w[SPLIT] = 3.0 if bsize > B8X8 else 0.0
            w[NONE] = 1.0
        if self.delta_lf is not None and bsize == (B128X128 if self.sb128 else B64X64):
            w[NONE] = 0.0  # a whole lossy superblock skips, and reads no delta
        return w / w.sum()

    # ---- intra block copy (5.11.24-26, libaom's read_intrabc_info) ----
    def dv_valid(self, r, c, bsize, row, col):
        """av1_is_dv_valid, as ``av1.cpp:dv_valid``: the source in the tile (a sub-8x8 block's chroma too) and in a
        superblock coded at least 256 pixels earlier, the rows above behind a wavefront."""
        r0, r1, c0, c1 = self.tile
        bw, bh = _WIDE[bsize] * 4, _HIGH[bsize] * 4
        top, left, bottom, right = r * 32 + row, c * 32 + col, (r * 4 + bh) * 8 + row, (c * 4 + bw) * 8 + col
        if top < r0 * 32 or left < c0 * 32 or bottom > r1 * 32 or right > c1 * 32:
            return False
        if self.has_chroma and ((bw < 8 and self.ssx and left < c0 * 32 + 32) or
                                (bh < 8 and self.ssy and top < r0 * 32 + 32)):
            return False
        sb_log2 = 5 if self.sb128 else 4
        sb_size = 4 << sb_log2
        active_row, active_col = r >> sb_log2, (c * 4) >> 6
        src_row, src_col = ((bottom >> 3) - 1) // sb_size, ((right >> 3) - 1) >> 6
        per_row = ((c1 - c0 - 1) >> 4) + 1
        if src_row * per_row + src_col >= active_row * per_row + active_col - 4:
            return False
        wavefront = (1 + 4 + (sb_size > 64)) * (active_row - src_row)
        return not (src_row > active_row or src_col >= active_col - 4 + wavefront)

    def choose_dv(self, r, c, bsize):
        """A DV for a block that may copy: None where a block that copies lies near enough to reach its DV stack,
        else the default DV (av1_find_ref_dv), or one pixel off it at the odds ``intrabc["shift"]``, the first of
        those that is valid; with ``intrabc["invalid"]``, the first block's DV is (0, 0)."""
        bw4, bh4 = _WIDE[bsize], _HIGH[bsize]
        if self.ibc[max(r - 6, 0) : r + bh4 + 1, max(c - 6, 0) : c + bw4 + 1].any():
            return None
        sb4 = 32 if self.sb128 else 16
        ref = (0, -(4 * sb4 + 256) * 8) if r - sb4 < self.tile[0] else (-4 * sb4 * 8, 0)
        if self.intrabc.get("invalid") and not self.ibc_blocks:
            return ref, (0, 0)  # the block itself: not decoded yet, which libaom marks corrupt
        offsets = [(0, 0)]
        if self.rng.random() < self.intrabc.get("shift", 0.5):
            offsets = [(0, -8), (-8, 0), (-8, -8), (0, 8), (8, 0)] + offsets
        for dr, dc in offsets:
            if self.dv_valid(r, c, bsize, ref[0] + dr, ref[1] + dc):
                return ref, (ref[0] + dr, ref[1] + dc)
        return None

    def write_mv_component(self, comp, diff):
        """read_mv_component at whole pixels: sign, class, class 0's bit or the class's bits."""
        sym, cdf = self.sym, self.cdf
        mag = abs(diff)
        cls = 0 if mag <= 16 else (mag - 1).bit_length() - 4
        d = (mag - (0 if cls == 0 else 2 << (cls + 2))) // 8 - 1
        sym.symbol(int(diff < 0), cdf["kMvSign"][comp], 2)
        sym.symbol(cls, cdf["kMvClass"][comp], 11)
        if cls == 0:
            sym.symbol(d, cdf["kMvClass0Bit"][comp], 2)
        else:
            for i in range(cls):
                sym.symbol((d >> i) & 1, cdf["kMvBits"][comp * 10 + i], 2)

    def copy_block(self, r, c, bsize, dv):
        """The block's prediction in each plane (av1.cpp:predict_intrabc) into the decoded area, and its 4x4
        units marked decoded as the decoder's transform blocks mark them."""
        bw, bh = _WIDE[bsize] * 4, _HIGH[bsize] * 4
        sb_mask = 31 if self.sb128 else 15
        for p in range(3 if self.has_chroma else 1):
            ssx, ssy = self.sub(p)
            w, h = max(4, bw >> ssx), max(4, bh >> ssy)
            bx, by = (c * 4 - (4 if bw == 4 and ssx else 0)) >> ssx, (r * 4 - (4 if bh == 4 and ssy else 0)) >> ssy
            mx, my = bx * 16 + dv[1] * (2 >> ssx), by * 16 + dv[0] * (2 >> ssy)
            x0, y0, fx, fy = mx >> 4, my >> 4, int(mx & 15 != 0), int(my & 15 != 0)
            pix = self.pix[p]
            a = pix[y0 : y0 + h + fy, x0 : x0 + w + fx]
            pred = (a[:h, :w] + a[fy : h + fy, :w] + a[:h, fx : w + fx] + a[fy : h + fy, fx : w + fx] + 2) >> 2
            rows, cols = min(h, pix.shape[0] - by), min(w, pix.shape[1] - bx)
            pix[by : by + rows, bx : bx + cols] = pred[:rows, :cols]
            bd = self.block_decoded[p]
            for y in range(by, by + rows, 4):
                for x in range(bx, bx + cols, 4):
                    row, col = (((y << ssy) >> 2) & sb_mask) >> ssy, (((x << ssx) >> 2) & sb_mask) >> ssx
                    bd[row + 1, col + 1] = 1

    def clear_contexts(self, r, c, bsize):
        """A skipped block's coefficient contexts, zero in each plane it codes."""
        bw4, bh4 = _WIDE[bsize], _HIGH[bsize]
        for p in range(3 if self.has_chroma else 1):
            sx, sy = self.sub(p)
            self.above_level[p][c >> sx : (c + bw4) >> sx] = 0
            self.above_dc[p][c >> sx : (c + bw4) >> sx] = 0
            self.left_level[p][r >> sy : (r + bh4) >> sy] = 0
            self.left_dc[p][r >> sy : (r + bh4) >> sy] = 0

    def copy(self, r, c, bsize, ref, dv):
        """A skipped block that copies: its skip, delta q, use_intrabc and DV (against ``ref``, its stack empty)."""
        bw4, bh4 = _WIDE[bsize], _HIGH[bsize]
        cdf, sym = self.cdf, self.sym
        self.write_skip_and_segment(r, c, bsize, 1)
        if self.read_deltas and bsize != (B128X128 if self.sb128 else B64X64):
            sym.symbol(0, cdf["kDeltaQ"][0], 4)
        self.read_deltas = False
        sym.symbol(1, cdf["kIntrabc"][0], 2)
        diff = (dv[0] - ref[0], dv[1] - ref[1])
        sym.symbol(2 * (diff[0] != 0) + (diff[1] != 0), cdf["kMvJoint"][0], 4)
        for comp in range(2):
            if diff[comp]:
                self.write_mv_component(comp, diff[comp])
        self.clear_contexts(r, c, bsize)
        rr, cc = min(r + bh4, self.mi_rows), min(c + bw4, self.mi_cols)
        self.mi_size[r:rr, c:cc] = bsize
        self.skips[r:rr, c:cc] = 1
        self.y_modes[r:rr, c:cc] = 0
        if self.has_chroma:
            self.uv_modes[r:rr, c:cc] = 0
        self.pal_n[:, r:rr, c:cc] = 0
        self.ibc[r:rr, c:cc] = True
        self.ibc_blocks += 1
        if not self.lossy:
            self.copy_block(r, c, bsize, dv)

    # ---- a block ----
    def block(self, r, c, bsize):
        bw4, bh4 = _WIDE[bsize], _HIGH[bsize]
        self.avail_u, self.avail_l = self.inside(r - 1, c), self.inside(r, c - 1)
        self.mi_row, self.mi_col, self.bsize = r, c, bsize
        rng, cdf, sym = self.rng, self.cdf, self.sym
        self.has_chroma = not self.mono and not (self.ssx and bw4 == 1 and c % 2 == 0) and not (
            self.ssy and bh4 == 1 and r % 2 == 0)
        # a lossy frame's block skips unless it is 4x4 (whose CFL rule is the same lossless or not)
        self.seg_begin(r, c, bsize, self.lossy and (bsize != B4X4 or (r >> 4, c >> 4) in self.skip64))
        if self.intrabc is not None and rng.random() < self.intrabc.get("odds", 0.2):
            chosen = self.choose_dv(r, c, bsize)
            if chosen:
                self.coded_empty = False
                self.copy(r, c, bsize, *chosen)
                return
        # the modes, drawn
        self.y_mode = int(rng.choice(13, p=self.mode_odds))
        self.angle_y = int(rng.integers(-3, 4)) if bsize >= B8X8 and 1 <= self.y_mode <= 8 else 0
        self.uv_mode, self.angle_uv, self.cfl = 0, 0, (0, 0)
        self.avail_uc = self.has_chroma and (self.inside(r - 2, c) if self.ssy and bh4 == 1 else self.avail_u)
        self.avail_lc = self.has_chroma and (self.inside(r, c - 2) if self.ssx and bw4 == 1 else self.avail_l)
        if self.lossy and not self.lossless_blk:  # a lossy block of 32x32 or less
            self.cfl_allowed = max(bw4, bh4) <= 8
        else:
            self.cfl_allowed = _WIDE[self.chroma_size(bsize)] == 1 and _HIGH[self.chroma_size(bsize)] == 1
        if self.has_chroma:
            n_uv = 14 if self.cfl_allowed else 13
            self.uv_mode = int(rng.choice(n_uv, p=self.mode_odds_uv[:n_uv] / self.mode_odds_uv[:n_uv].sum()))
            if self.uv_mode == 13:
                self.signs = int(rng.integers(0, 8))
                sign_u, sign_v = (self.signs + 1) // 3, (self.signs + 1) % 3
                au, av = int(rng.integers(0, 16)), int(rng.integers(0, 16))
                self.cfl_codes = (au, av)
                self.cfl = ((au + 1) * (-1 if sign_u == 1 else 1) if sign_u else 0,
                            (av + 1) * (-1 if sign_v == 1 else 1) if sign_v else 0)
            self.angle_uv = int(rng.integers(-3, 4)) if bsize >= B8X8 and 1 <= self.uv_mode <= 8 else 0
        self.use_filter_intra = 0
        if self.y_mode == 0 and max(bw4, bh4) <= 8:
            self.use_filter_intra = int(rng.random() < 0.5)
            self.filter_mode = int(rng.integers(0, 5))
        self.pal, self.pal_colors, self.pal_cached, self.color_maps = [0, 0], [[], [], []], [[], []], [None, None]
        self.palette_allowed = bool(self.palette) and bsize >= B8X8 and bw4 <= 16 and bh4 <= 16
        if self.palette_allowed:
            self.draw_palettes(r, c, bsize)
        # the residual (a block whose prediction is exact in every plane skips)
        levels = self.lossy_levels(r, c, bsize) if self.lossy else self.predict_block(r, c, bsize)
        skip = int(not any(lv.any() for _, _, _, lv in levels) and not self.coded_empty)
        self.write_skip_and_segment(r, c, bsize, skip)
        if self.cdef is not None and not skip and (r & ~15, c & ~15) not in self.cdef_idx:
            # the CDEF index of the 64x64 at this block's first non-skip block, and of the others the block covers
            bits = self.cdef
            v = int(rng.integers(0, 1 << bits))
            for i in range(bits - 1, -1, -1):
                sym.bool((v >> i) & 1)
            for y in range(r & ~15, r + bh4, 16):
                for x in range(c & ~15, c + bw4, 16):
                    self.cdef_idx[(y, x)] = v
        if self.read_deltas and not (bsize == (B128X128 if self.sb128 else B64X64) and skip):
            self.write_delta_q()
            if self.deltas:
                self.write_delta_lf()
        self.read_deltas = False
        if self.intrabc is not None:
            sym.symbol(0, cdf["kIntrabc"][0], 2)
        above = _MODE_CTX[self.y_modes[r - 1, c]] if self.avail_u else 0
        left = _MODE_CTX[self.y_modes[r, c - 1]] if self.avail_l else 0
        sym.symbol(self.y_mode, cdf["kKfYMode"][above * 5 + left], 13)
        if bsize >= B8X8 and 1 <= self.y_mode <= 8:
            sym.symbol(self.angle_y + 3, cdf["kAngleDelta"][self.y_mode - 1], 7)
        if self.has_chroma:
            if self.cfl_allowed:
                sym.symbol(self.uv_mode, cdf["kUvModeCfl"][self.y_mode], 14)
            else:
                sym.symbol(self.uv_mode, cdf["kUvModeNoCfl"][self.y_mode], 13)
            if self.uv_mode == 13:
                sym.symbol(self.signs, cdf["kCflSign"][0], 8)
                sign_u, sign_v = (self.signs + 1) // 3, (self.signs + 1) % 3
                if sign_u:
                    sym.symbol(self.cfl_codes[0], cdf["kCflAlpha"][(sign_u - 1) * 3 + sign_v], 16)
                if sign_v:
                    sym.symbol(self.cfl_codes[1], cdf["kCflAlpha"][(sign_v - 1) * 3 + sign_u], 16)
            if bsize >= B8X8 and 1 <= self.uv_mode <= 8:
                sym.symbol(self.angle_uv + 3, cdf["kAngleDelta"][self.uv_mode - 1], 7)
        if self.palette_allowed:
            self.write_palette_mode_info(r, c, bsize)
        if self.y_mode == 0 and not self.pal[0] and max(bw4, bh4) <= 8:
            sym.symbol(self.use_filter_intra, cdf["kFilterIntra"][bsize], 2)
            if self.use_filter_intra:
                sym.symbol(self.filter_mode, cdf["kFilterIntraMode"][0], 5)
        for k in range(2):
            if self.pal[k]:
                self.write_color_map(k)
        if skip:
            self.clear_contexts(r, c, bsize)
        rr, cc = min(r + bh4, self.mi_rows), min(c + bw4, self.mi_cols)
        self.mi_size[r:rr, c:cc] = bsize
        self.skips[r:rr, c:cc] = skip
        self.y_modes[r:rr, c:cc] = self.y_mode
        if self.has_chroma:
            self.uv_modes[r:rr, c:cc] = self.uv_mode
        for k in range(2):
            self.pal_n[k, r:rr, c:cc] = self.pal[k]
            self.pal_c[k, r:rr, c:cc, : self.pal[k]] = self.pal_colors[k]
        if not skip:
            for p, x4, y4, lv in levels:
                self.coeffs(p, x4, y4, lv)

    def write_delta_value(self, d, cdf):
        """delta_q_abs or delta_lf_abs (the remaining bits past 2), then the sign."""
        a = abs(d)
        self.sym.symbol(min(a, 3), cdf, 4)
        if a >= 3:
            n = (a - 1).bit_length() - 1
            self.literal(n - 1, 3)
            self.literal(a - (1 << n) - 1, n)
        if a:
            self.sym.bool(int(d < 0))

    def write_delta_q(self):
        """The superblock's delta q: with ``delta_q``, drawn at ``odds``
        (0.5), 1 to ``range`` (3) in size, either sign; else 0."""
        dq, d = self.delta_q, 0
        if dq and self.dq_rng.random() < dq.get("odds", 0.5):
            d = int(self.dq_rng.integers(1, dq.get("range", 3) + 1)) * (1 if self.dq_rng.random() < 0.5 else -1)
        self.write_delta_value(d, self.cdf["kDeltaQ"][0])

    # ---- delta loop filter levels (5.11.41, libaom's read_delta_lflevel) ----
    def write_delta_lf(self):
        """The superblock's deltas: each running delta's (one, or one per
        plane and direction) drawn at ``odds``, 1 to ``range`` in size, of
        ``sign`` (0 either), coded in its own CDF; the running deltas move
        by it times 1 << ``res``, clamped to +-63 as the decoder's, and are
        appended to ``log`` where given."""
        dlf = self.delta_lf or {}
        multi, rng = dlf.get("multi", 0), self.dlf_rng
        for i in range((2 if self.mono else 4) if multi else 1):
            d = 0
            if dlf and rng.random() < dlf.get("odds", 0.7):
                d = int(rng.integers(1, dlf.get("range", 3) + 1))
                sign = dlf.get("sign", 0)
                d = -d if sign < 0 or (sign == 0 and rng.random() < 0.5) else d
            self.write_delta_value(d, self.cdf["kDeltaLfMulti"][i] if multi else self.cdf["kDeltaLf"][0])
            self.delta_lf_running[i] = min(63, max(-63, self.delta_lf_running[i] + d * (1 << dlf.get("res", 0))))
        if "log" in dlf:
            dlf["log"].append(tuple(self.delta_lf_running))

    def seg_qindex_zero(self):
        return self.seg is not None and self.seg_qindex[self.segment_id] == 0

    # ---- palette mode (5.11.46, 5.11.49) ----
    def palette_cache(self, r, c, k):
        """get_palette_cache: the ascending distinct colours of the above
        (within the 64-row band) and left blocks' palettes of Y or U."""
        above = self.pal_c[k, r - 1, c, : self.pal_n[k, r - 1, c]] if r * 4 % 64 and self.avail_u else []
        left = self.pal_c[k, r, c - 1, : self.pal_n[k, r, c - 1]] if self.avail_l else []
        out = []
        for v in sorted([int(x) for x in above] + [int(x) for x in left]):
            if not out or out[-1] != v:
                out.append(v)
        return out

    def map_size(self, k, r, c, bsize):
        """The colour index map of Y (k 0) or UV: (width, height, visible width, visible height)."""
        w, h = _WIDE[bsize] * 4, _HIGH[bsize] * 4
        ow, oh = min(w, (self.mi_cols - c) * 4), min(h, (self.mi_rows - r) * 4)
        if k:
            w, h, ow, oh = w >> self.ssx, h >> self.ssy, ow >> self.ssx, oh >> self.ssy
            if w < 4:
                w, ow = w + 2, ow + 2
            if h < 4:
                h, oh = h + 2, oh + 2
        return w, h, ow, oh

    def draw_palettes(self, r, c, bsize):
        """Each plane type in turn, at the odds ``palette["odds"]``: a palette
        (its mode DC, of ``palette["sizes"]`` in turn or 2-8 colours, each
        of the cache taken at the odds ``palette["cache"]``, the rest new),
        and a colour index map whose indices repeat a neighbour's now and
        then; V's colours within a small step of each other at the odds
        ``palette["v_near"]``, so that they code as deltas."""
        rng, pal, bd = self.rng, self.palette, self.bd
        for k in range(2 if self.has_chroma else 1):
            if rng.random() >= pal.get("odds", 0.5):
                continue
            sizes = pal.get("sizes")
            n = int(sizes[self.palette_count % len(sizes)]) if sizes else int(rng.integers(2, 9))
            self.palette_count += 1
            if k == 0:
                self.y_mode, self.angle_y, self.use_filter_intra = 0, 0, 0
            else:
                self.uv_mode, self.angle_uv, self.cfl = 0, 0, (0, 0)
            cached = [v for v in self.palette_cache(r, c, k) if rng.random() < pal.get("cache", 0.5)][:n]
            colors = set(cached)
            while len(colors) < n:
                colors.add(int(rng.integers(0, 1 << bd)))
            self.pal[k], self.pal_colors[k], self.pal_cached[k] = n, sorted(colors), cached
            if k:
                if rng.random() < pal.get("v_near", 0.6):
                    step = 1 << int(rng.integers(0, bd - 1))
                    v = [int(rng.integers(0, 1 << bd))]
                    for _ in range(n - 1):
                        v.append((v[-1] + int(rng.integers(-step + 1, step))) % (1 << bd))
                else:
                    v = [int(x) for x in rng.integers(0, 1 << bd, n)]
                self.pal_colors[2] = v
            w, h, ow, oh = self.map_size(k, r, c, bsize)
            m = np.zeros((h, w), np.int64)
            for i in range(oh):
                for j in range(ow):
                    u = rng.random()
                    m[i, j] = m[i, j - 1] if j and u < 0.4 else m[i - 1, j] if i and u < 0.7 else rng.integers(0, n)
            m[:oh, ow:] = m[:oh, ow - 1 : ow]
            m[oh:] = m[oh - 1]
            self.color_maps[k] = m

    def write_palette_mode_info(self, r, c, bsize):
        sym, cdf = self.sym, self.cdf
        bsize_ctx = (_WIDE[bsize].bit_length() - 1) + (_HIGH[bsize].bit_length() - 1) - 2
        if self.y_mode == 0:
            ctx = int(self.avail_u and self.pal_n[0, r - 1, c] > 0) + int(self.avail_l and self.pal_n[0, r, c - 1] > 0)
            sym.symbol(int(self.pal[0] > 0), cdf["kPaletteYMode"][bsize_ctx * 3 + ctx], 2)
            if self.pal[0]:
                sym.symbol(self.pal[0] - 2, cdf["kPaletteYSize"][bsize_ctx], 7)
                self.write_colors(r, c, 0)
        if self.has_chroma and self.uv_mode == 0:
            sym.symbol(int(self.pal[1] > 0), cdf["kPaletteUvMode"][int(self.pal[0] > 0)], 2)
            if self.pal[1]:
                sym.symbol(self.pal[1] - 2, cdf["kPaletteUvSize"][bsize_ctx], 7)
                self.write_colors(r, c, 1)
                self.write_v()

    def literal(self, v, bits):
        for i in range(bits - 1, -1, -1):
            self.sym.bool((v >> i) & 1)

    def write_colors(self, r, c, k):
        """Y's (k 0) or U's colours: the cache's flags, then the others as a
        literal and ascending deltas (less 1 for Y) in the narrowest width
        that holds them, shrinking with the room left above."""
        n, bd, y = self.pal[k], self.bd, int(k == 0)
        cached, idx = self.pal_cached[k], 0
        for v in self.palette_cache(r, c, k):
            if idx >= n:
                break
            self.sym.bool(int(v in cached))
            idx += v in cached
        rest = sorted(set(self.pal_colors[k]) - set(cached))
        if not rest:
            return
        self.literal(rest[0], bd)
        if len(rest) == 1:
            return
        deltas = [b - a - y for a, b in zip(rest, rest[1:])]
        bits = max(bd - 3, max(d.bit_length() for d in deltas))
        self.literal(bits - (bd - 3), 2)
        for cur, d in zip(rest[1:], deltas):
            self.literal(d, bits)
            bits = min(bits, _ceil_log2((1 << bd) - cur - y))

    def write_v(self):
        """V's colours: signed deltas that wrap around 1 << BitDepth where they
        fit in BitDepth - 1 bits (at the odds 0.8), else literals."""
        v, bd = self.pal_colors[2], self.bd
        half = 1 << (bd - 1)
        deltas = [((b - a + half) % (1 << bd)) - half for a, b in zip(v, v[1:])]
        bits = max([bd - 4] + [abs(d).bit_length() for d in deltas])
        delta_coded = bits <= bd - 1 and self.rng.random() < 0.8
        self.sym.bool(int(delta_coded))
        if not delta_coded:
            for x in v:
                self.literal(x, bd)
            return
        self.literal(bits - (bd - 4), 2)
        self.literal(v[0], bd)
        for d in deltas:
            self.literal(abs(d), bits)
            if d:
                self.sym.bool(int(d < 0))

    def write_color_map(self, k):
        """palette_tokens: the first index in NS(n), the others wavefront by wavefront by their rank in the context's
        order."""
        m, n = self.color_maps[k], self.pal[k]
        _, _, ow, oh = self.map_size(k, self.mi_row, self.mi_col, self.bsize)
        nbits = n.bit_length()
        mm = (1 << nbits) - n
        first = int(m[0, 0])
        if first < mm:
            self.literal(first, nbits - 1)
        else:
            self.literal(mm + ((first - mm) >> 1), nbits - 1)
            self.sym.bool((first - mm) & 1)
        cdfs = self.cdf["kPaletteUvColor" if k else "kPaletteYColor"]
        for i in range(1, oh + ow - 1):
            for j in range(min(i, ow - 1), max(0, i - oh + 1) - 1, -1):
                order, ctx = color_context(m, i - j, j, n)
                self.sym.symbol(order.index(int(m[i - j, j])), cdfs[(n - 2) * 5 + ctx], n)

    def lossy_levels(self, r, c, bsize):
        """A lossy frame's coefficients: random ones in each plane of a 4x4
        block (DC and up to two more), none elsewhere -> [(plane, x4, y4,
        levels)]; the luma transform type is drawn too."""
        self.coded_empty = False
        if bsize != B4X4 or (r >> 4, c >> 4) in self.skip64 or self.forced_skip:
            return []
        rng = self.rng
        if self.empty and rng.random() < self.empty:  # skip 0, and no coefficient in any plane
            self.coded_empty = True
            self.tx_symbol = 0
            return [(p, c >> self.sub(p)[0], r >> self.sub(p)[1], np.zeros((4, 4), np.int64))
                    for p in range(3 if self.has_chroma else 1)]
        self.tx_symbol = int(rng.choice([0, 1, 4, 5, 6]))  # IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST
        out = []
        for p in range(3 if self.has_chroma else 1):
            ssx, ssy = self.sub(p)
            lv = np.zeros(16, np.int64)
            lv[0] = rng.integers(-8, 9)
            for _ in range(int(rng.integers(0, 3))):
                lv[int(rng.integers(1, 16))] = rng.integers(-3, 4)
            out.append((p, c >> ssx, r >> ssy, lv.reshape(4, 4)))
        return out

    def chroma_size(self, bsize):
        """Subsampled_Size of a block, as its (4x4 columns, 4x4 rows)."""
        w, h = max(1, _WIDE[bsize] >> self.ssx), max(1, _HIGH[bsize] >> self.ssy)
        for b in range(22):
            if _WIDE[b] == w and _HIGH[b] == h:
                return b
        return -1

    def predict_block(self, r, c, bsize):
        """The block's 4x4 transform blocks in the decoder's order (64x64
        chunks, then planes, each at its subsampling): each predicted from
        the frame, whose samples are the decoded ones (lossless) ->
        [(plane, x4, y4, levels)]."""
        bw4, bh4 = _WIDE[bsize], _HIGH[bsize]
        sb_mask = 31 if self.sb128 else 15
        out = []
        for cy in range(max(1, bh4 >> 4)):
            for cx in range(max(1, bw4 >> 4)):
                for p in range(3 if self.has_chroma else 1):
                    ssx, ssy = self.sub(p)
                    psz = self.chroma_size(bsize) if p else bsize
                    base_x, base_y = (c >> ssx) * 4, (r >> ssy) * 4
                    for y in range(min(_HIGH[psz], 16 >> ssy)):
                        for x in range(min(_WIDE[psz], 16 >> ssx)):
                            xx, yy = x + ((cx << 4) >> ssx), y + ((cy << 4) >> ssy)
                            sx, sy = base_x + 4 * xx, base_y + 4 * yy
                            if sx >= (self.mi_cols * 4) >> ssx or sy >= (self.mi_rows * 4) >> ssy:
                                continue
                            row, col = (((sy << ssy) >> 2) & sb_mask) >> ssy, (((sx << ssx) >> 2) & sb_mask) >> ssx
                            bd = self.block_decoded[p]
                            mode = self.y_mode if p == 0 else (0 if self.uv_mode == 13 else self.uv_mode)
                            left = (self.avail_lc if p else self.avail_l) or xx > 0
                            up = (self.avail_uc if p else self.avail_u) or yy > 0
                            if self.pal[int(p > 0)]:
                                m = self.color_maps[int(p > 0)][4 * yy : 4 * yy + 4, 4 * xx : 4 * xx + 4]
                                pred = np.asarray(self.pal_colors[p], np.int64)[m]
                            else:
                                pred = self.predict(p, sx, sy, left, up, bd[row, col + 2], bd[row + 2, col], mode)
                            if p and self.uv_mode == 13:
                                pred = self.predict_cfl(p, sx, sy, pred)
                            if p == 0:
                                self.max_luma = (sx + 4, sy + 4)
                            if self.forced_skip:  # SEG_LVL_SKIP: the prediction is the decoded block
                                self.pix[p][sy : sy + 4, sx : sx + 4] = pred
                            out.append((p, sx >> 2, sy >> 2, _wht_levels(self.pix[p][sy : sy + 4, sx : sx + 4] - pred)))
                            bd[row + 1, col + 1] = 1
        return out

    def clear_block_decoded(self, r, c):
        sb4 = 32 if self.sb128 else 16
        _, r1, _, c1 = self.tile
        for p in range(1 if self.mono else 3):
            ssx, ssy = self.sub(p)
            w4, h4 = (c1 - c) >> ssx, (r1 - r) >> ssy
            bd = np.zeros((sb4 + 2, sb4 + 2), np.int64)  # index [y + 1, x + 1]
            for y in range(-1, (sb4 >> ssy) + 1):
                for x in range(-1, (sb4 >> ssx) + 1):
                    bd[y + 1, x + 1] = int((y < 0 and x < w4) or (x < 0 and y < h4))
            bd[(sb4 >> ssy) + 1, 0] = 0
            self.block_decoded[p] = bd

    # ---- intra prediction (7.11.2), a 4x4 block ----
    def predict(self, p, x, y, have_left, have_above, have_rt, have_bl, mode):
        pix, bd_ = self.pix[p], self.bd
        w = h = 4
        ssx, ssy = self.sub(p)
        max_x, max_y = ((self.mi_cols * 4) >> ssx) - 1, ((self.mi_rows * 4) >> ssy) - 1
        above = {}
        left = {}
        for i in range(w + h):
            if not have_above and have_left:
                above[i] = int(pix[y, x - 1])
            elif not have_above:
                above[i] = (1 << (bd_ - 1)) - 1
            else:
                lim = min(max_x, x + (2 * w if have_rt else w) - 1)
                above[i] = int(pix[y - 1, min(lim, x + i)])
            if not have_left and have_above:
                left[i] = int(pix[y - 1, x])
            elif not have_left:
                left[i] = (1 << (bd_ - 1)) + 1
            else:
                lim = min(max_y, y + (2 * h if have_bl else h) - 1)
                left[i] = int(pix[min(lim, y + i), x - 1])
        if have_above and have_left:
            corner = int(pix[y - 1, x - 1])
        elif have_above:
            corner = int(pix[y - 1, x])
        elif have_left:
            corner = int(pix[y, x - 1])
        else:
            corner = 1 << (bd_ - 1)
        above[-1] = left[-1] = corner
        maxv = (1 << bd_) - 1
        pred = np.zeros((4, 4), np.int64)
        t = self.base
        if p == 0 and self.use_filter_intra:
            taps = t["kFilterIntraTaps"][self.filter_mode]
            for i2 in range(2):
                pp = [0] * 7
                for i in range(7):
                    if i < 5:
                        if i2 == 0:
                            pp[i] = above[i - 1]
                        elif i == 0:
                            pp[i] = left[1]
                        else:
                            pp[i] = int(pred[1, i - 1])
                    else:
                        pp[i] = left[2 * i2 + i - 5]
                for i in range(8):
                    v = sum(taps[i * 7 + j] * pp[j] for j in range(7))
                    v = (v + 8) >> 4 if v >= 0 else -((-v + 8) >> 4)
                    pred[2 * i2 + (i >> 2), i & 3] = min(max(v, 0), maxv)
            return pred
        if 1 <= mode <= 8:
            p_angle = t["kModeToAngle"][0][mode] + (self.angle_y if p == 0 else self.angle_uv) * 3
            up_a = up_l = 0
            if p_angle not in (90, 180):
                ftype = 0
                if self.avail_uc if p else self.avail_u:
                    rr, cc = self.mi_row - 1, self.mi_col
                    if p and self.ssx and not self.mi_col & 1:
                        cc += 1
                    if p and self.ssy and self.mi_row & 1:
                        rr -= 1
                    ftype |= self.is_smooth(rr, cc, p)
                if self.avail_lc if p else self.avail_l:
                    rr, cc = self.mi_row, self.mi_col - 1
                    if p and self.ssx and self.mi_col & 1:
                        cc -= 1
                    if p and self.ssy and not self.mi_row & 1:
                        rr += 1
                    ftype |= self.is_smooth(rr, cc, p)
                if have_above:
                    self.edge_filter(above, min(w, max_x - x + 1) + (h if p_angle < 90 else 0) + 1,
                                     self.strength(ftype, p_angle - 90))
                if have_left:
                    self.edge_filter(left, min(h, max_y - y + 1) + (w if p_angle > 180 else 0) + 1,
                                     self.strength(ftype, p_angle - 180))
                up_a = int(0 < abs(p_angle - 90) < 40)
                if up_a:
                    self.upsample(above, w + (h if p_angle < 90 else 0), maxv)
                up_l = int(0 < abs(p_angle - 180) < 40)
                if up_l:
                    self.upsample(left, h + (w if p_angle > 180 else 0), maxv)
            dr = t["kDrIntraDerivative"][0]
            dx = dr[p_angle] if p_angle < 90 else dr[180 - p_angle] if 90 < p_angle < 180 else 0
            dy = dr[p_angle - 90] if 90 < p_angle < 180 else dr[270 - p_angle] if p_angle > 180 else 0
            for i in range(h):
                for j in range(w):
                    if p_angle < 90:
                        idx = (i + 1) * dx
                        base = (idx >> (6 - up_a)) + (j << up_a)
                        shift = ((idx << up_a) >> 1) & 0x1F
                        max_base = (w + h - 1) << up_a
                        v = ((above[base] * (32 - shift) + above[base + 1] * shift + 16) >> 5 if base < max_base
                             else above[max_base])
                    elif 90 < p_angle < 180:
                        idx = (j << 6) - (i + 1) * dx
                        base = idx >> (6 - up_a)
                        if base >= -(1 << up_a):
                            shift = ((idx * (1 << up_a)) >> 1) & 0x1F
                            v = (above[base] * (32 - shift) + above[base + 1] * shift + 16) >> 5
                        else:
                            idx = (i << 6) - (j + 1) * dy
                            base = idx >> (6 - up_l)
                            shift = ((idx * (1 << up_l)) >> 1) & 0x1F
                            v = (left[base] * (32 - shift) + left[base + 1] * shift + 16) >> 5
                    elif p_angle > 180:
                        idx = (j + 1) * dy
                        base = (idx >> (6 - up_l)) + (i << up_l)
                        shift = ((idx << up_l) >> 1) & 0x1F
                        v = (left[base] * (32 - shift) + left[base + 1] * shift + 16) >> 5
                    elif p_angle == 90:
                        v = above[j]
                    else:
                        v = left[i]
                    pred[i, j] = v
            return pred
        wts = t["kSmWeights4"][0]
        for i in range(h):
            for j in range(w):
                if mode == 9:
                    v = (wts[i] * above[j] + (256 - wts[i]) * left[h - 1] + wts[j] * left[i]
                         + (256 - wts[j]) * above[w - 1] + 256) >> 9
                elif mode == 10:
                    v = (wts[i] * above[j] + (256 - wts[i]) * left[h - 1] + 128) >> 8
                elif mode == 11:
                    v = (wts[j] * left[i] + (256 - wts[j]) * above[w - 1] + 128) >> 8
                elif mode == 0:
                    if have_left and have_above:
                        v = (sum(left[k] for k in range(4)) + sum(above[k] for k in range(4)) + 4) // 8
                    elif have_left:
                        v = (sum(left[k] for k in range(4)) + 2) >> 2
                    elif have_above:
                        v = (sum(above[k] for k in range(4)) + 2) >> 2
                    else:
                        v = 1 << (bd_ - 1)
                else:  # PAETH
                    base = above[j] + left[i] - corner
                    pl, pt, ptl = abs(base - left[i]), abs(base - above[j]), abs(base - corner)
                    v = left[i] if pl <= pt and pl <= ptl else above[j] if pt <= ptl else corner
                pred[i, j] = v
        return pred

    def is_smooth(self, r, c, p):
        m = self.y_modes[r, c] if p == 0 else self.uv_modes[r, c]
        return int(m in (9, 10, 11))

    @staticmethod
    def strength(ftype, delta):
        d = abs(delta)
        if ftype == 0:
            return 1 if d >= 56 else 0
        return 2 if d >= 64 else 1 if d >= 40 else 0

    @staticmethod
    def edge_filter(edge, sz, strength):
        if not strength:
            return
        kernel = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))[strength - 1]
        e = [edge[i - 1] for i in range(sz)]
        for i in range(1, sz):
            s = sum(kernel[j] * e[min(max(i - 2 + j, 0), sz - 1)] for j in range(5))
            edge[i - 1] = (s + 8) >> 4

    @staticmethod
    def upsample(buf, num, maxv):
        dup = [0] * (num + 3)
        dup[0] = buf[-1]
        for i in range(-1, num):
            dup[i + 2] = buf[i]
        dup[num + 2] = buf[num - 1]
        buf[-2] = dup[0]
        for i in range(num):
            s = (-dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3] + 8) >> 4
            buf[2 * i - 1] = min(max(s, 0), maxv)
            buf[2 * i] = dup[i + 2]

    def predict_cfl(self, p, x, y, dc):
        alpha = self.cfl[p - 1]
        sx, sy = self.ssx, self.ssy
        ys = np.minimum((y + np.arange(4)) << sy, self.max_luma[1] - (1 << sy))
        xs = np.minimum((x + np.arange(4)) << sx, self.max_luma[0] - (1 << sx))
        luma = sum(self.pix[0][np.ix_(ys + dy, xs + dx)].astype(np.int64) for dy in range(sy + 1) for dx in range(sx + 1))
        luma = luma << (3 - sx - sy)
        avg = (int(luma.sum()) + 8) >> 4
        scaled = alpha * (luma - avg)
        scaled = np.where(scaled >= 0, (scaled + 32) >> 6, -((-scaled + 32) >> 6))
        return np.clip(dc + scaled, 0, (1 << self.bd) - 1)

    # ---- coefficients (5.11.39) ----
    def coeffs(self, p, x4, y4, lv):
        cdf, sym = self.cdf, self.sym
        ptype = int(p > 0)
        if p == 0:
            if self.bsize == B4X4:
                ctx = 0
            else:
                top, left = min(self.above_level[0][x4], 255), min(self.left_level[0][y4], 255)
                if not top and not left:
                    ctx = 1
                elif not top or not left:
                    ctx = 2 + (max(top, left) > 3)
                elif max(top, left) <= 3:
                    ctx = 4
                elif min(top, left) <= 3:
                    ctx = 5
                else:
                    ctx = 6
        else:
            above = self.above_level[p][x4] | self.above_dc[p][x4]
            left = self.left_level[p][y4] | self.left_dc[p][y4]
            ctx = 7 + (above != 0) + (left != 0) + (3 if self.chroma_size(self.bsize) != B4X4 else 0)
        q = lv.ravel()
        all_zero = int(not q.any())
        sym.symbol(all_zero, cdf["kTxbSkip"][ctx], 2)
        # the transform type, of the intra direction, where the segment's quantizer is above 0
        if self.lossy and p == 0 and not all_zero and not self.seg_qindex_zero():
            direction = (0, 1, 2, 6, 0)[self.filter_mode] if self.use_filter_intra else self.y_mode
            if self.reduced_tx_set:  # TX_SET_INTRA_2: the same five types, IDTX, DCT_DCT, then the ADSTs
                sym.symbol((0, 1, None, None, 2, 3, 4)[self.tx_symbol], cdf["kIntraTx2"][direction], 5)
            else:
                sym.symbol(self.tx_symbol, cdf["kIntraTx1"][direction], 7)
        cul, dc_cat = 0, 0
        if not all_zero:
            eob = max(k for k in range(16) if q[_SCAN[k]]) + 1
            eob_pt = {1: 1, 2: 2}.get(eob, (eob - 1).bit_length() + 1)
            sym.symbol(eob_pt - 1, cdf["kEobPt16"][ptype * 2], 5)
            if eob_pt >= 3:
                extra = eob - ((1 << (eob_pt - 2)) + 1)
                sym.symbol((extra >> (eob_pt - 3)) & 1, cdf["kEobExtra"][ptype * 9 + eob_pt - 3], 2)
                for i in range(1, max(1, eob_pt - 2)):
                    sym.bool((extra >> (eob_pt - 3 - i)) & 1)
            ctxq = np.zeros(16, np.int64)
            for k in range(eob - 1, -1, -1):
                pos = _SCAN[k]
                mag = abs(int(q[pos]))
                if k == eob - 1:
                    bctx = 0 if k == 0 else 1 if k <= 2 else 2 if k <= 4 else 3
                    sym.symbol(min(mag, 3) - 1, cdf["kCoeffBaseEob"][ptype * 4 + bctx], 3)
                else:
                    sym.symbol(min(mag, 3), cdf["kCoeffBase"][ptype * 42 + self.base_ctx(ctxq, pos)], 4)
                if mag > 2:
                    bctx = self.br_ctx(ctxq, pos)
                    rem = mag - 3
                    for _ in range(4):
                        s = min(rem, 3)
                        sym.symbol(s, cdf["kCoeffBr"][ptype * 21 + bctx], 4)
                        rem -= s
                        if s < 3:
                            break
                ctxq[pos] = min(mag, 15)
            for k in range(eob):
                pos = _SCAN[k]
                v = int(q[pos])
                if v:
                    if k == 0:
                        s = 0
                        for cat in (self.above_dc[p][x4], self.left_dc[p][y4]):
                            s += -1 if cat == 1 else 1 if cat == 2 else 0
                        sym.symbol(int(v < 0), cdf["kDcSign"][ptype * 3 + (1 if s < 0 else 2 if s > 0 else 0)], 2)
                    else:
                        sym.bool(int(v < 0))
                mag = abs(v)
                if mag > 14:
                    x = mag - 14
                    length = x.bit_length()
                    for _ in range(length - 1):
                        sym.bool(0)
                    sym.bool(1)
                    for i in range(length - 2, -1, -1):
                        sym.bool((x >> i) & 1)
                if pos == 0 and mag:
                    dc_cat = 1 if v < 0 else 2
                cul = min(63, cul + mag)
        self.above_level[p][x4] = self.left_level[p][y4] = cul
        self.above_dc[p][x4] = self.left_dc[p][y4] = dc_cat

    @staticmethod
    def base_ctx(q, pos):
        row, col = pos >> 2, pos & 3
        mag = 0
        for dr, dc in ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0)):
            if row + dr < 4 and col + dc < 4:
                mag += min(abs(int(q[(row + dr) * 4 + col + dc])), 3)
        if pos == 0:
            return 0
        return min((mag + 1) >> 1, 4) + _BASE_OFFSET[row][col]

    @staticmethod
    def br_ctx(q, pos):
        row, col = pos >> 2, pos & 3
        mag = 0
        for dr, dc in ((0, 1), (1, 0), (1, 1)):
            if row + dr < 4 and col + dc < 4:
                mag += min(int(q[(row + dr) * 4 + col + dc]), 15)
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        return mag + 7 if row < 2 and col < 2 else mag + 14


def _obu(kind: int, body: bytes) -> bytes:
    size, n = bytearray(), len(body)
    while True:
        b = n & 0x7F
        n >>= 7
        size.append(b | (0x80 if n else 0))
        if not n:
            break
    return bytes([kind << 3 | 2]) + bytes(size) + body


def encode(planes, bit_depth: int = 8, sb128: bool = False, tiles=("uniform", 0, 0), reduced: bool = True,
           disable_cdf_update: int = 0, split_obus: bool = False, tile_groups: int = 1, extra_obus=(),
           seed: int = 0, weights=None, modes: bool = True, subsampling=(0, 0), matrix: int = 0,
           full_range: bool = True, lossy=None, palette=None, intrabc=None, film_grain=None,
           segmentation=None) -> bytes:
    """A lossless AV1 key frame of ``planes`` ([Y] or [Y, U, V]: 4:4:4 with
    the identity matrix, or with ``matrix`` (colour primaries BT.709,
    sRGB transfer, ``full_range`` or not) at ``subsampling`` (x, y): (0,
    0) 4:4:4, (1, 0) 4:2:2, (1, 1) 4:2:0, the chroma planes at their
    subsampled size) -> its OBUs: a temporal
    delimiter, a sequence header (``reduced``: a reduced still picture
    header; else a full one with timing and decoder model information and
    two operating points), then a frame OBU, or with ``split_obus`` a frame
    header OBU and ``tile_groups`` tile group OBUs; ``extra_obus`` ([(type,
    body)]) after the sequence header. ``tiles``: ("uniform", cols log2,
    rows log2) or ("sizes", [widths], [heights]) in superblocks;
    ``weights``: {block size: [a weight per partition type]}, the odds of
    each where both halves of a square lie in the frame; ``modes``: every
    intra mode drawn (angle deltas, CFL, filter intra), else DC only (all
    drawn from ``seed``). ``lossy``: {"q": base_q_idx (1-20), "levels":
    (Y vertical, Y horizontal, U, V), "sharpness": 0-7, "delta": the
    INTRA_FRAME ref delta written with loop_filter_delta_update, or None
    for deltas off (any level may be 0; U and V are written where a Y one
    is not); and, optionally, "delta_lf": delta_q_present and
    delta_lf_present on, True for each superblock's deltas 0, or {"multi":
    delta_lf_multi, "res": delta_lf_res as coded (0-3), "odds": of each
    delta not 0 (0.7), "range": the largest coded delta (3), "sign": 1 or
    -1 for deltas of that sign only, 0 either (0), "log": a list each
    superblock's running deltas are appended to} for deltas drawn (from
    ``seed``, apart from the blocks' draws) at each superblock's first
    block, no superblock left whole (it would skip and read none);
    "reduced_tx_set": reduced_tx_set 1, the 4x4 luma types coded in
    TX_SET_INTRA_2; "delta_q": {"odds", "range", "res": delta_q_res as
    coded} for delta_q_present on and each superblock's delta q drawn
    (``_Frame.write_delta_q``, from ``seed`` apart from the blocks'
    draws; without "delta_lf", delta_lf_present 0); "qm": (qm_y, qm_u) for
    using_qmatrix on; "dq": (DeltaQYDc, DeltaQUDc, DeltaQUAc) coded;
    "restoration":
    {"types": lr_type per plane as coded (0 NONE, 1 SWITCHABLE, 2
    WIENER, 3 SGRPROJ), "unit_shift": the specification's lr_unit_shift
    (units of 256 >> (2 - shift) samples; 1 or 2 under 128x128
    superblocks), "uv_shift": lr_uv_shift (4:2:0 only), and optionally
    "sets": the self-guided sets the units take in turn (else drawn),
    "extreme": every Wiener tap at one end of its range, "none": every
    unit RESTORE_NONE (the rest of the frame as without it), "log": a
    list the units are appended to as (plane, type, set or -1, extreme)}: loop
    restoration on in the sequence header, its parameters in the frame
    header and each unit's type and coefficients drawn (from ``seed``,
    apart from the blocks' draws) and coded where the specification
    reads them; "cdef": {"damping": 3-6,
    "bits": cdef_bits 0-3, "strengths": one [Y primary, Y secondary, UV
    primary, UV secondary] per index (two values where the frame is
    monochrome)}: CDEF on in the sequence header, its parameters in the
    frame header and a random index at each 64x64's first non-skip block;
    "skip64": [(row, column)] of 64x64s whose blocks all skip (their index
    is never written); "empty": the odds that a 4x4 block codes skip 0 and
    no coefficient} for a lossy frame whose planes are
    the prediction of random 4x4 residuals (``planes`` then give only the
    size; ``weights`` default to splitting down to 4x4 blocks now and then).
    ``palette`` ({"odds", "sizes", "cache", "v_near"}, ``_Frame.draw_palettes``;
    a reduced header only): allow_screen_content_tools on, and palettes in
    the blocks that may take one. ``intrabc`` ({"odds": of a block copying
    where it may, "shift": of its DV a pixel off the default one}; a reduced
    header only, no in-loop filter or delta LF): allow_intrabc on as well
    (palettes at ``palette``'s odds or none), and skipped blocks that copy
    (``_Frame.copy``). ``film_grain`` (a grain_seed):
    film_grain_params_present on, and the frame applies grain of three
    luma points (no chroma points, no auto-regression). ``segmentation``
    ({"features": {segment: {SEG_LVL_* index: value as coded}}, "odds": a
    weight per id up to the last segment with a feature, "repeat": the
    odds of an id equal to its prediction (0.4), "corrupt": one id coded
    past the last segment}):
    segmentation_enabled on, the features coded (signed values in
    su(1 + bits), so one past Segmentation_Feature_Max is written too), and
    each block's id drawn (from ``seed``, apart from the blocks' draws;
    ``_Frame.seg_begin``). In a lossless frame every segment is lossless;
    a lossy frame whose segments are all lossless (CodedLossless) codes no
    filter parameters and no tx_mode."""
    rng = np.random.default_rng(seed)
    assert matrix or tuple(subsampling) == (0, 0), "the identity matrix needs 4:4:4"
    if lossy:
        assert 0 < lossy["q"] <= 20, "q-context 0"
        big = [1.0, 0.3, 0.3, 5.0] + [0.3] * 6  # mostly SPLIT, down to 4x4 blocks now and then
        weights = weights or {B8X8: [1.0, 0.3, 0.3, 2.0], 6: big, 9: big, B64X64: big, B128X128: big}
    if intrabc is not None:
        assert reduced and not (lossy and any(lossy.get(k) for k in ("delta_lf", "cdef", "restoration"))), \
            "intra block copy: a reduced header, no in-loop filter parameters, no delta LF"
        palette = palette or {"odds": 0.0}
    lossy_ = lossy or {}
    q, dq = lossy_.get("q", 0), tuple(lossy_.get("dq", (0, 0, 0)))
    # CodedLossless: every segment's quantizer 0 and every delta q 0; no filter parameters, no tx_mode
    coded_lossless = not any(segment_qindex(segmentation, q)) and not any(dq)
    assert lossy or coded_lossless, "a lossless frame: every segment lossless"
    cdef = lossy_.get("cdef") if not coded_lossless else None
    fr = _Frame(planes, bit_depth, sb128, tiles, disable_cdf_update, rng, weights or {}, modes, tuple(subsampling),
                lossy=bool(lossy), deltas=lossy_.get("delta_lf") or False,
                cdef=cdef["bits"] if cdef else None, empty=lossy_.get("empty", 0.0), skip64=lossy_.get("skip64", ()),
                restoration=lossy_.get("restoration") if not coded_lossless else None, seed=seed, palette=palette,
                intrabc=intrabc, reduced_tx_set=bool(lossy_.get("reduced_tx_set")), segmentation=segmentation, q=q,
                dq=dq, delta_q=lossy_.get("delta_q"))
    assert reduced or not palette, "screen content tools under a reduced header only"
    restoration = int(bool(lossy_.get("restoration")))
    mono = fr.mono
    profile = _profile(bit_depth, mono, tuple(subsampling))
    # the sequence header
    b = Bits()
    b.f(3, profile)  # seq_profile: 0 mono or 4:2:0, 1 4:4:4, 2 12-bit or 4:2:2
    b.f(1, 1)  # still_picture
    b.f(1, int(reduced))
    if reduced:
        b.f(5, 8)  # seq_level_idx
    else:
        b.f(1, 1)  # timing_info_present_flag
        b.f(32, 1)
        b.f(32, 25)
        b.f(1, 1)  # equal_picture_interval
        b.f(1, 1)  # num_ticks_per_picture_minus_1 = 0 (uvlc '1')
        b.f(1, 1)  # decoder_model_info_present_flag
        b.f(5, 9)  # buffer_delay_length_minus_1
        b.f(32, 1)
        b.f(5, 9)  # buffer_removal_time_length_minus_1
        b.f(5, 9)  # frame_presentation_time_length_minus_1
        b.f(1, 1)  # initial_display_delay_present_flag
        b.f(5, 1)  # two operating points
        for idc in (0x101, 0):
            b.f(12, idc)
            b.f(5, 9)  # seq_level_idx > 7: a tier bit
            b.f(1, 0)
            b.f(1, 1)  # decoder_model_present_for_this_op
            b.f(10, 100), b.f(10, 50), b.f(1, 0)
            b.f(1, 1), b.f(4, 3)  # initial_display_delay
    wb, hb = max(fr.w - 1, 1).bit_length(), max(fr.h - 1, 1).bit_length()
    b.f(4, wb - 1), b.f(4, hb - 1), b.f(wb, fr.w - 1), b.f(hb, fr.h - 1)
    if not reduced:
        b.f(1, 0)  # frame_id_numbers_present_flag
    b.f(1, int(sb128)), b.f(1, 1), b.f(1, 1)  # sb128, enable_filter_intra, enable_intra_edge_filter
    if not reduced:
        b.f(4, 0)  # interintra, masked compound, warped motion, dual filter
        b.f(1, 1), b.f(1, 0), b.f(1, 0)  # enable_order_hint, jnt_comp, ref_frame_mvs
        b.f(1, 0), b.f(1, 0)  # seq_choose_screen_content_tools 0, seq_force_screen_content_tools 0
        b.f(3, 6)  # order_hint_bits_minus_1
    b.f(1, 0), b.f(1, int(bool(cdef))), b.f(1, restoration)  # superres, cdef, restoration
    b.f(1, int(bit_depth > 8))  # high_bitdepth
    if profile == 2 and bit_depth > 8:
        b.f(1, int(bit_depth == 12))  # twelve_bit
    if profile != 1:
        b.f(1, int(mono))
    if mono:  # no colour description; the range read
        b.f(1, 0), b.f(1, 1)
    elif not matrix:  # BT.709 primaries, sRGB transfer, identity matrix: full range 4:4:4 implied
        b.f(1, 1), b.f(8, 1), b.f(8, 13), b.f(8, 0)
        b.f(1, 0)  # separate_uv_delta_q
    else:
        b.f(1, 1), b.f(8, 1), b.f(8, 13), b.f(8, matrix)
        b.f(1, int(full_range))
        if profile == 2 and bit_depth == 12:
            b.f(1, subsampling[0])
            if subsampling[0]:
                b.f(1, subsampling[1])
        if subsampling[0] and subsampling[1]:
            b.f(2, 0)  # chroma_sample_position: unknown
        b.f(1, 0)  # separate_uv_delta_q
    b.f(1, int(film_grain is not None))  # film_grain_params_present
    b.trailing()
    seq = b.bytes()
    # the frame header
    cols, rows, sb_cols, sb_rows = fr.tile_layout()
    h = Bits()
    if not reduced:
        h.f(1, 0), h.f(2, 0), h.f(1, 1)  # show_existing_frame, KEY_FRAME, show_frame
    h.f(1, disable_cdf_update)
    if reduced:  # allow_screen_content_tools (seq_force_screen_content_tools is SELECT), then force_integer_mv
        h.f(1, int(bool(palette)))
        if palette:
            h.f(1, 1)
    else:
        h.f(1, 0)  # frame_size_override_flag
        h.f(7, 0)  # order_hint
        h.f(1, 1)  # buffer_removal_time_present_flag: op 0 (idc 0x101 holds layer 0) and op 1 (idc 0)
        h.f(10, 0), h.f(10, 0)
    h.f(1, 0)  # render_and_frame_size_different
    if palette:
        h.f(1, int(intrabc is not None))  # allow_intrabc
    if not reduced and not disable_cdf_update:
        h.f(1, 1)  # disable_frame_end_update_cdf
    sb_shift = 5 if sb128 else 4
    sb_size = sb_shift + 2
    max_w_sb = 4096 >> sb_size

    def tile_log2(blk, target):
        k = 0
        while (blk << k) < target:
            k += 1
        return k

    min_cols = tile_log2(max_w_sb, sb_cols)
    max_cols, max_rows = tile_log2(1, min(sb_cols, 64)), tile_log2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, tile_log2((4096 * 2304) >> (2 * sb_size), sb_rows * sb_cols))
    kind, a, bb = tiles
    if kind == "uniform":
        h.f(1, 1)
        for k in range(min_cols, max_cols):
            h.f(1, int(k < a))
            if k >= a:
                break
        for k in range(max(min_tiles - a, 0), max_rows):
            h.f(1, int(k < bb))
            if k >= bb:
                break
        cols_log2, rows_log2 = a, bb
    else:
        h.f(1, 0)
        start = 0
        for w in a:
            h.ns(min(sb_cols - start, max_w_sb), w - 1)
            start += w
        area = (sb_rows * sb_cols) >> (min_tiles + 1) if min_tiles > 0 else sb_rows * sb_cols
        max_h = max(area // max(a), 1)
        start = 0
        for hh in bb:
            h.ns(min(sb_rows - start, max_h), hh - 1)
            start += hh
        cols_log2, rows_log2 = tile_log2(1, len(a)), tile_log2(1, len(bb))
    if cols_log2 or rows_log2:
        h.f(cols_log2 + rows_log2, 0)  # context_update_tile_id
        h.f(2, 3)  # tile_size_bytes_minus_1: 4 bytes
    h.f(8, q)  # base_q_idx
    for v in dq[: 1 if mono else 3]:  # DeltaQYDc, DeltaQUDc, DeltaQUAc
        h.f(1, int(v != 0))
        if v:
            h.f(7, v & 0x7F)
    qm = lossy_.get("qm")
    h.f(1, int(qm is not None))  # using_qmatrix
    if qm is not None:
        h.f(4, qm[0]), h.f(4, qm[1])  # qm_y, qm_u (qm_v = qm_u: no separate_uv_delta_q)
    h.f(1, int(segmentation is not None))  # segmentation_enabled
    if segmentation is not None:  # segmentation_update_data is implied on a key frame
        for f in fr.seg_features:
            for j in range(8):
                h.f(1, int(j in f))
                if j in f:
                    n = SEG_BITS[j] + SEG_SIGNED[j]
                    h.f(n, f[j] & ((1 << n) - 1))
    if lossy:
        delta_q = bool(fr.deltas or fr.delta_q)
        h.f(1, int(delta_q))  # delta_q_present
        if delta_q:
            h.f(2, (fr.delta_q or {}).get("res", 0))  # delta_q_res
            if intrabc is None:
                h.f(1, int(bool(fr.deltas)))  # delta_lf_present
                if fr.deltas:
                    dlf = fr.delta_lf or {}
                    h.f(2, dlf.get("res", 0)), h.f(1, dlf.get("multi", 0))  # delta_lf_res, delta_lf_multi
    if lossy and not coded_lossless:
        if intrabc is None:  # intra block copy codes no in-loop filter parameters
            levels = lossy["levels"]
            h.f(6, levels[0]), h.f(6, levels[1])
            if not mono and (levels[0] or levels[1]):
                h.f(6, levels[2]), h.f(6, levels[3])
            h.f(3, lossy.get("sharpness", 0))
            delta = lossy.get("delta")
            h.f(1, int(delta is not None))  # loop_filter_delta_enabled
            if delta is not None:
                h.f(1, 1), h.f(1, 1), h.f(7, delta & 0x7F)  # update; the INTRA_FRAME ref delta
                h.f(9, 0)  # the other seven ref deltas and the two mode deltas kept
            if cdef:  # cdef_params
                h.f(2, cdef["damping"] - 3), h.f(2, cdef["bits"])
                assert len(cdef["strengths"]) == 1 << cdef["bits"]
                for entry in cdef["strengths"]:
                    assert len(entry) == (2 if mono else 4)
                    for k, v in enumerate(entry):
                        h.f(4 if k % 2 == 0 else 2, v)
            if restoration:  # lr_params
                lr = lossy["restoration"]
                types = tuple(lr["types"])
                assert len(types) == (1 if mono else 3)
                for t in types:
                    h.f(2, t)
                if any(types):
                    shift = lr["unit_shift"]
                    if sb128:
                        assert shift in (1, 2)
                        h.f(1, shift - 1)
                    else:
                        h.f(1, int(shift > 0))
                        if shift:
                            h.f(1, shift - 1)
                    if tuple(fr.sub(1)) == (1, 1) and not mono and any(types[1:]):
                        h.f(1, lr.get("uv_shift", 0))
                    else:
                        assert not lr.get("uv_shift", 0), "lr_uv_shift: 4:2:0 with chroma restoration only"
        h.f(1, 0)  # tx_mode_select: TX_MODE_LARGEST
    h.f(1, int(fr.reduced_tx_set))
    if film_grain is not None:  # film_grain_params (update_grain is implied on a key frame)
        h.f(1, 1), h.f(16, film_grain)  # apply_grain, grain_seed
        h.f(4, 3)  # num_y_points, then each (point_y_value, point_y_scaling)
        for value, scaling in ((0, 48), (96, 64), (255, 40)):
            h.f(8, value), h.f(8, scaling)
        if not mono:
            h.f(1, 0)  # chroma_scaling_from_luma
            h.f(4, 0), h.f(4, 0)  # num_cb_points, num_cr_points
        h.f(2, 0), h.f(2, 0)  # grain_scaling_minus_8, ar_coeff_lag: no auto-regressive coefficients
        h.f(2, 0), h.f(2, 0)  # ar_coeff_shift_minus_6, grain_scale_shift
        h.f(1, 0), h.f(1, 0)  # overlap_flag, clip_to_restricted_range
    # the tiles
    n_cols, n_rows = len(cols) - 1, len(rows) - 1
    data = [fr.encode_tile(rows[t // n_cols], rows[t // n_cols + 1], cols[t % n_cols], cols[t % n_cols + 1])
            for t in range(n_cols * n_rows)]
    n_tiles = len(data)
    groups = np.array_split(np.arange(n_tiles), min(tile_groups, n_tiles))

    def tile_group(first, last):
        g = Bits()
        if n_tiles > 1:
            g.f(1, int(len(groups) > 1))
            if len(groups) > 1:
                g.f(cols_log2 + rows_log2, first), g.f(cols_log2 + rows_log2, last)
        g.align()
        body = g.bytes()
        for t in range(first, last + 1):
            if t < last:
                body += (len(data[t]) - 1).to_bytes(4, "little")
            body += data[t]
        return body

    out = _obu(2, b"") + _obu(1, seq)
    for kind_, body in extra_obus:
        out += _obu(kind_, body)
    if split_obus:
        h.trailing()
        out += _obu(3, h.bytes())
        for g in groups:
            out += _obu(4, tile_group(int(g[0]), int(g[-1])))
    else:
        h.align()
        out += _obu(6, h.bytes() + tile_group(0, n_tiles - 1))
    return out


def _profile(bit_depth: int, mono: bool, subsampling) -> int:
    if bit_depth == 12:
        return 2
    if mono or subsampling == (1, 1):
        return 0
    return 1 if subsampling == (0, 0) else 2


def av1c(bit_depth: int, mono: bool, subsampling=(0, 0)) -> bytes:
    """The av1C box body of what ``encode`` writes."""
    sx, sy = (1, 1) if mono else subsampling
    profile = _profile(bit_depth, mono, tuple(subsampling))
    flags = (bit_depth > 8) << 6 | (bit_depth == 12) << 5 | mono << 4 | (sx << 3) | (sy << 2)
    return bytes([0x81, profile << 5 | 8, flags, 0])

"""Write ``deepemia_tpu_torch/native/av1_tables.h``: the AV1 tables of the
lossy intra path that the specification lists and ``native/av1.cpp``
needs (the quantizer lookups, the quantizer matrices, the default
coefficient, transform type, transform depth, delta q, palette, loop
restoration, intra block copy and segment id CDFs, the self-guided filter's parameters and lookups, the scans,
the smooth weights and the cosine and sine constants of the inverse
transforms), read from a libaom build.

The tables are found in the library's read-only data by their opening
values, then read at their known shapes and checked: each CDF is a
libaom ``AOM_ICDF`` record (decreasing values, then 0 and the adaptation
counter), converted to the specification's form (the cumulative values
ending in 32768, then the counter); the quantizer lookups rise with the
index; each scan visits every position once and equals the one the
specification's rule gives (libaom keeps its coefficients column by
column, so its scans and quantizer matrices are the transposes of the
specification's row-major ones); the constants equal their closed forms.

    python tools/extract_av1_tables.py [path/to/libaom.so]

The default path is the libaom that the ``opencv-python`` wheel bundles
(OpenCV 5.0 reads AVIF through it). The package never reads the library:
the header is generated once and committed.
"""

from __future__ import annotations

import glob
import math
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "deepemia_tpu_torch" / "native" / "av1_tables.h"

# tx sizes in the specification's order: (width, height)
TX_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32), (32, 16),
            (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
# the sizes a scan or quantizer matrix is kept for (the 64 sizes use their top-left 32x32 part)
CODED = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32), (32, 16), (4, 16), (16, 4),
         (8, 32), (32, 8))
QM_TOTAL = 3344


def default_library() -> str:
    import cv2  # noqa: F401  (only to locate the wheel)

    libs = glob.glob(str(Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs" / "libaom-*.so*"))
    if not libs:
        raise SystemExit("no libaom beside cv2: pass the library's path")
    return libs[0]


class Library:
    def __init__(self, path: str):
        self.path = path
        self.data = open(path, "rb").read()

    def find(self, values, dtype) -> int:
        """The one offset of ``values`` (as ``dtype``) in the library."""
        pat = np.asarray(values, dtype).tobytes()
        k = self.data.find(pat)
        if k < 0:
            raise SystemExit(f"{self.path}: {list(values)[:8]}... not found")
        return k

    def read(self, offset: int, count: int, dtype) -> np.ndarray:
        return np.frombuffer(self.data, dtype, count, offset).copy()


def icdf_records(lib: Library, opening_spec, symbols: int, stride: int, count: int) -> np.ndarray:
    """``count`` CDFs of ``symbols`` symbols, ``stride`` uint16 apart in
    libaom's form, starting where the first opens with ``opening_spec``
    (its first values in the specification's form) -> [count, symbols + 1]
    in the specification's form."""
    start = lib.find(_opening(opening_spec, stride), "<u2")
    return spec_form(lib.read(start, count * stride, "<u2").reshape(count, stride), symbols)


def _opening(opening_spec, stride: int) -> list:
    """The uint16 libaom stores for the opening records (each whole: its
    values, AOM_ICDF(32768), the counter, padding to ``stride``)."""
    if not isinstance(opening_spec[0], (list, tuple)):
        opening_spec = [opening_spec]
    pattern = []
    for rec in opening_spec:
        pattern += [32768 - v for v in rec] + [0] * (stride - len(rec))
    return pattern


def spec_form(raw: np.ndarray, symbols: int) -> np.ndarray:
    """libaom's CDF records [count, stride], checked -> [count, symbols + 1]
    in the specification's form."""
    count = len(raw)
    out = np.zeros((count, symbols + 1), np.int64)
    for k, r in enumerate(raw):
        vals = r[: symbols - 1].astype(np.int64)
        if not (np.all(vals > 0) and np.all(vals < 32768) and np.all(np.diff(vals) <= 0)):
            raise SystemExit(f"not a CDF of {symbols} symbols at record {k}: {r}")
        if r[symbols - 1] != 0 or np.any(r[symbols:] != 0):  # AOM_ICDF(32768), the counter, padding
            raise SystemExit(f"a CDF record of {symbols} symbols that does not end in zeros: {r}")
        out[k, : symbols - 1] = 32768 - vals
        out[k, symbols - 1] = 32768
    return out


def zigzag(w: int, h: int):
    """The specification's default scan of a w x h block (row-major
    positions): square blocks zigzag along the anti-diagonals, starting
    right; a wide block walks each anti-diagonal up, a tall one down."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]  # top-right to bottom-left
        if w == h:
            forward = d % 2 == 1
        else:
            forward = h > w
        out += [r * w + c for r, c in (cells if forward else cells[::-1])]
    return out


def transposed(scan, w: int, h: int):
    """A row-major scan in libaom's column-major positions."""
    return [(p % w) * h + p // w for p in scan]


def scans(lib: Library) -> dict:
    """{(w, h): (default, mrow, mcol)} of the specification, each held
    to libaom's own (the default scans of every coded size; the mrow and
    mcol scans of the sizes a 1D transform takes, both 16 or less)."""
    out = {}
    for w, h in CODED:
        default = zigzag(w, h)
        mrow = list(range(w * h))
        mcol = [r * w + c for c in range(w) for r in range(h)]
        assert sorted(default) == mrow
        lib.find(transposed(default, w, h), "<i2")
        if w <= 16 and h <= 16:
            lib.find(transposed(mrow, w, h), "<i2")
            lib.find(transposed(mcol, w, h), "<i2")
        out[(w, h)] = (default, mrow, mcol)
    return out


def quantizer_matrices(lib: Library) -> np.ndarray:
    """[15 levels][2 plane types][QM_TOTAL_SIZE], row-major per tx size in
    the specification's order of sizes; level 15 (no weighting) is not
    stored."""
    start = lib.find([32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200], "u1")
    raw = lib.read(start, 15 * 2 * QM_TOTAL, "u1").reshape(15, 2, QM_TOTAL)
    out = np.zeros_like(raw)
    at = 0
    for w, h in TX_SIZES:
        if (w, h) not in CODED:
            continue
        n = w * h
        for lv in range(15):
            for pt in range(2):
                libaom = raw[lv, pt, at : at + n]
                out[lv, pt, at : at + n] = [libaom[(p % w) * h + p // w] for p in range(n)]
        at += n
    assert at == QM_TOTAL
    # weights about 32 (one), chroma's first 4x4 matrix as the specification opens it
    assert raw.min() >= 1 and list(raw[0, 1, :4]) == [35, 46, 57, 66]
    return out


def quantizer_lookups(lib: Library):
    """dc_qlookup and ac_qlookup at 8, 10 and 12 bits -> ([3][256], [3][256])."""
    openings = {"dc": ([4, 8, 8, 9, 10, 11, 12, 12], [4, 9, 10, 13, 15, 17, 20, 22], [4, 12, 18, 25, 33, 41, 50, 60]),
                "ac": ([4, 8, 9, 10, 11, 12, 13, 14], [4, 9, 11, 13, 16, 18, 21, 24], [4, 13, 19, 27, 35, 44, 54, 64])}
    last = {"dc": (1336, 5347, 21387), "ac": (1828, 7312, 29247)}
    out = {}
    for kind, firsts in openings.items():
        t = np.stack([lib.read(lib.find(f, "<i2"), 256, "<i2") for f in firsts])
        assert np.all(np.diff(t.astype(np.int64), axis=1) >= 0) and tuple(t[:, 255]) == last[kind]
        out[kind] = t
    return out["dc"], out["ac"]


def coefficient_cdfs(lib: Library) -> dict:
    """The default coefficient CDFs of the four q contexts."""
    t = {}
    t["kTxbSkipCdf"] = icdf_records(lib, [[31849], [5892], [12112]], 2, 3, 4 * 5 * 13).reshape(4, 5, 13, 3)
    t["kEobExtraCdf"] = icdf_records(lib, [[16961], [17223], [7621]], 2, 3, 4 * 5 * 2 * 9).reshape(4, 5, 2, 9, 3)
    t["kDcSignCdf"] = icdf_records(lib, [[16000], [13056], [18816]], 2, 3, 4 * 2 * 3).reshape(4, 2, 3, 3)
    t["kCoeffBaseEobCdf"] = icdf_records(lib, [17837, 29055], 3, 4, 4 * 5 * 2 * 4).reshape(4, 5, 2, 4, 4)
    t["kCoeffBaseCdf"] = icdf_records(lib, [4034, 8930, 12727], 4, 5, 4 * 5 * 2 * 42).reshape(4, 5, 2, 42, 5)
    t["kCoeffBrCdf"] = icdf_records(lib, [14298, 20718, 24174], 4, 5, 4 * 5 * 2 * 21).reshape(4, 5, 2, 21, 5)
    # eob_pt: [q][plane type][1D class][...]; 512 and 1024 keep the 2D class only
    openings = {16: [840, 1039, 1980, 4895], 32: [400, 520, 977, 2102, 6542], 64: [329, 498, 1101, 1784, 3265, 7758],
                128: [219, 482, 1140, 2091, 3680, 6028, 12586],
                256: [310, 584, 1887, 3589, 6168, 8611, 11352, 15652],
                512: [641, 983, 3707, 5430, 10234, 14958, 18788, 23412, 26061],
                1024: [393, 421, 751, 1623, 3160, 6352, 13345, 18047, 22571, 25830]}
    for k, (size, opening) in enumerate(openings.items()):
        n = 5 + k
        recs = icdf_records(lib, opening, n, n + 1, 4 * 2 * 2).reshape(4, 2, 2, n + 1)
        t[f"kEobPt{size}Cdf"] = recs[:, :, 0] if size >= 512 else recs
    return t


def other_cdfs(lib: Library) -> dict:
    t = {}
    # intra_ext_tx: libaom keeps [set][square tx size][intra mode][17]; set 1 has 7 symbols, set 2 five
    s1 = icdf_records(lib, [1535, 8035, 9461, 12751, 23467, 27825], 7, 17, 4 * 13).reshape(4, 13, 8)
    set1_bytes = lib.find([32768 - v for v in (1535, 8035, 9461, 12751, 23467, 27825)], "<u2")
    s2_raw = lib.read(set1_bytes + 4 * 13 * 17 * 2, 17, "<u2")
    s2_opening = [32768 - int(v) for v in s2_raw[:4]]
    s2 = icdf_records(lib, s2_opening, 5, 17, 4 * 13).reshape(4, 13, 6)
    t["kIntraTxTypeSet1Cdf"] = s1[:2]
    t["kIntraTxTypeSet2Cdf"] = s2[:3]
    # tx depth: [max tx category][context], 2 symbols for 8x8, 3 above
    start = lib.find([32768 - 19968, 0, 0, 0, 32768 - 19968, 0, 0, 0, 32768 - 24320, 0, 0, 0], "<u2")
    raw = lib.read(start, 4 * 3 * 4, "<u2").reshape(4, 3, 4)
    t["kTx8x8Cdf"] = icdf_records(lib, [[19968], [19968], [24320]], 2, 4, 3).reshape(3, 3)
    assert np.array_equal(32768 - raw[0, :, 0], t["kTx8x8Cdf"][:, 0])
    for cat, name in ((1, "kTx16x16Cdf"), (2, "kTx32x32Cdf"), (3, "kTx64x64Cdf")):
        opening = [32768 - int(v) for v in raw[cat, 0, :2]]
        recs = icdf_records(lib, opening, 3, 4, 3)
        assert np.array_equal(32768 - raw[cat, :, :2], recs[:, :2])
        t[name] = recs
    t["kDeltaQCdf"] = icdf_records(lib, [28160, 32120, 32677], 4, 5, 1).reshape(5)
    return t


def split_copy(lib: Library, start: int) -> np.ndarray:
    """A table of 63 uint16 that libaom's frame context setup copies as its
    first 112 bytes, then its last 16 in an overlapping load: the library
    holds those two runs one after the other."""
    head, tail = lib.read(start, 56, "<u2"), lib.read(start + 112, 8, "<u2")
    assert tail[0] == head[55], (head, tail)
    return np.concatenate([head, tail[1:]])


def palette_cdfs(lib: Library) -> dict:
    """The default palette CDFs: the palette sizes of Y and UV (7 block size
    contexts, 7 sizes; the UV table follows the Y one), whether Y has a
    palette ([7 block size contexts][3 neighbour contexts]), whether UV
    has one (2 contexts), and the colour index CDFs of Y and UV ([7 palette
    sizes][5 colour contexts], n = 2 .. 8 symbols in records of 9 uint16).
    The Y mode table is a ``split_copy``. The UV mode table
    is an immediate (``movabs r64, imm64``: its first value, the end of
    its first record, then the second value)."""
    t = {}
    sizes = icdf_records(lib, [7952, 13000, 18149, 21478, 25527, 29241], 7, 8, 14)
    t["kPaletteYSizeCdf"], t["kPaletteUvSizeCdf"] = sizes[:7], sizes[7:]
    start = lib.find(_opening([[31676], [3419], [1261]], 3), "<u2")
    t["kPaletteYModeCdf"] = spec_form(split_copy(lib, start).reshape(21, 3), 2).reshape(7, 3, 3)
    first = np.array([32768 - 32461, 0, 0], "<u2").tobytes()
    k = lib.data.find(first)
    while k >= 0 and not (lib.data[k - 2] == 0x48 and 0xB8 <= lib.data[k - 1] <= 0xBF):
        k = lib.data.find(first, k + 1)
    assert k >= 0, "no movabs of the UV palette mode CDF"
    uv = lib.read(k, 4, "<u2")
    t["kPaletteUvModeCdf"] = spec_form(np.concatenate([uv, [0, 0]]).reshape(2, 3), 2)
    for name, opening in (("kPaletteYColorCdf", [[28710], [16384], [10553], [27036], [31603]]),
                          ("kPaletteUvColorCdf", [[29089], [16384], [8713], [29257], [31610]])):
        raw = lib.read(lib.find(_opening(opening, 9), "<u2"), 7 * 5 * 9, "<u2").reshape(7, 5, 9)
        out = np.zeros((7, 5, 9), np.int64)
        for n in range(2, 9):
            out[n - 2, :, : n + 1] = spec_form(raw[n - 2], n)
        t[name] = out
    return t


def intrabc_cdfs(lib: Library) -> dict:
    """The default CDFs of intra block copy: ``use_intrabc``, which
    libaom's frame context setup stores as an immediate (``mov [rax +
    disp32], imm32``: its value and the end of its record); the MV CDFs of
    MV_INTRABC_CONTEXT, a copy of libaom's ``default_nmv_context`` (the
    joints, then per component, row first, the classes, the class 0 and
    other fractions, the sign, the two high-precision bits, class 0's
    integer bit and the 10 bits of the larger classes; 143 uint16); the
    transform split flag of inter blocks (21 contexts, a ``split_copy``); and the inter
    transform type CDFs (libaom's [4 sets][4 square sizes][17]: set 0 is
    DCT only and holds zeros, sets 1, 2 and 3 have 16, 12 and 2 symbols)."""
    t = {}
    stores = re.findall(rb"\xc7\x80..\x00\x00(..)\x00\x00", lib.data, re.DOTALL)
    values = [int.from_bytes(v, "little") for v in stores if int.from_bytes(v, "little") == 32768 - 30531]
    assert len(values) == 1, "no single immediate store of the intra block copy CDF"
    t["kIntrabcCdf"] = np.array([32768 - values[0], 32768, 0])
    start = lib.find(_opening([4096, 11264, 19328], 5), "<u2")
    raw = lib.read(start, 143, "<u2")
    t["kMvJointCdf"] = spec_form(raw[None, :5], 4)[0]
    comps = raw[5:].reshape(2, 69)
    t["kMvClassCdf"] = spec_form(comps[:, :12], 11)
    t["kMvSignCdf"] = spec_form(comps[:, 27:30], 2)
    t["kMvClass0BitCdf"] = spec_form(comps[:, 36:39], 2)
    t["kMvBitsCdf"] = spec_form(comps[:, 39:69].reshape(20, 3), 2).reshape(2, 10, 3)
    assert np.array_equal(t["kMvClassCdf"][0], t["kMvClassCdf"][1]) and t["kMvSignCdf"][0, 0] == 16384
    start = lib.find(_opening([[28581], [23846], [20847]], 3), "<u2")
    t["kTxfmSplitCdf"] = spec_form(split_copy(lib, start).reshape(21, 3), 2)
    at = lib.find([32768 - v for v in (4458, 5560, 7695, 9709)], "<u2")
    raw = lib.read(at - 4 * 17 * 2, 4 * 4 * 17, "<u2").reshape(4, 4, 17)
    assert not raw[0].any(), "set 0 of the inter transform types is not empty"
    for s, n in ((1, 16), (2, 12), (3, 2)):
        t[f"kInterTxTypeSet{s}Cdf"] = spec_form(raw[s], n)
    return t


def segmentation_cdfs(lib: Library) -> dict:
    """The default CDFs of the spatially predicted segment id
    (``default_spatial_pred_seg_tree_cdf``: 3 contexts, MAX_SEGMENTS
    symbols). The library holds each record without its counter (the frame
    context setup stores the counters apart): 8 uint16 apart."""
    return {"kSpatialPredSegCdf": icdf_records(lib, [5622, 7893, 16093, 18233, 27809, 28373, 32533], 8, 8, 3)}


def restoration_tables(lib: Library) -> dict:
    """The loop restoration tables: the default CDFs of restoration_type,
    use_wiener and use_sgrproj, which libaom's frame context setup stores
    as immediates (``mov [rax + disp32], imm32``, the three in a row, the
    first with REX.W: its two values and two zeros), the self-guided
    filter's parameters (``av1_sgr_params``: the radii r0, r1 and the
    scales s0, s1 of each of the 16 sets, s = round(2^20 / (n^2 eps)), -1
    where the radius is 0), ``av1_x_by_xplus1`` (256 values) and
    ``av1_one_by_x`` (round(2^12 / n), n = 1 .. 25)."""
    at = lib.find([32768 - 9413, 32768 - 22581], "<u2")  # the opening values of the switchable CDF
    d, k, stores = lib.data, at - 6, []
    while len(stores) < 3 and k < at + 96:
        if d[k] == 0xC7 and d[k + 1] == 0x80:  # mov dword/qword [rax + disp32], imm32
            stores.append((int.from_bytes(d[k + 2 : k + 6], "little"), int.from_bytes(d[k + 6 : k + 10], "little")))
            k += 10
        else:
            k += 1
    (d0, sw), (d1, wiener), (d2, sgr) = stores
    assert d0 < d1 < d2 and sw >> 16 and not wiener >> 16 and not sgr >> 16, stores
    t = {"kSwitchableRestoreCdf": np.array([32768 - (sw & 0xFFFF), 32768 - (sw >> 16), 32768, 0]),
         "kWienerRestoreCdf": np.array([32768 - wiener, 32768, 0]),
         "kSgrprojRestoreCdf": np.array([32768 - sgr, 32768, 0])}
    for cdf in t.values():
        assert np.all(np.diff(cdf[:-1]) > 0) and cdf[-2] == 32768, cdf
    params = lib.read(lib.find([2, 1, 140, 3236, 2, 1, 112, 2158], "<i4"), 64, "<i4").reshape(16, 4)
    for r0, r1, s0, s1 in params:
        for r, s in ((r0, s0), (r1, s1)):
            assert (r == 0 and s == -1) or (r in (1, 2) and 0 < s < 1 << 12), params
    t["kSgrParams"] = params
    x_by = lib.read(lib.find([1, 128, 171, 192, 205, 213, 219, 224], "<i4"), 256, "<i4")
    assert x_by[255] == 256 and all(x_by[z] == ((z << 8) + z // 2) // (z + 1) for z in range(1, 255))
    t["kXByXplus1"] = x_by
    one_by = lib.read(lib.find([4096, 2048, 1365, 1024, 819], "<i4"), 25, "<i4")
    assert all(one_by[n - 1] == round(4096 / n) for n in range(1, 26))
    t["kOneByX"] = one_by
    return t


def constants(lib: Library) -> dict:
    cos128 = [round(4096 * math.cos(i * math.pi / 128)) for i in range(65)]
    libaom = lib.read(lib.find(cos128[:8], "<i4"), 64, "<i4")
    assert list(libaom) == cos128[:64]
    lib.find([0, 1321, 2482, 3344, 3803], "<i4")
    sm = lib.read(lib.find([255, 149, 85, 64, 255, 197, 146, 105], "u1"), 4 + 8 + 16 + 32 + 64, "u1")
    runs, at = {}, 0
    for n in (4, 8, 16, 32, 64):
        run = sm[at : at + n]
        assert run[0] == 255 and np.all(np.diff(run.astype(int)) <= 0)
        runs[n] = run
        at += n
    return {"kCos128": np.array(cos128), "kSinpi": np.array([0, 1321, 2482, 3344, 3803]), "kSmWeights": sm}


def c_array(name: str, ctype: str, a: np.ndarray, per_line: int = 24) -> str:
    dims = "".join(f"[{d}]" for d in a.shape)
    flat = [str(int(v)) for v in np.asarray(a).ravel()]
    lines = [", ".join(flat[k : k + per_line]) for k in range(0, len(flat), per_line)]
    return f"static const {ctype} {name}{dims} = {{\n  " + ",\n  ".join(lines) + "};\n"


def version_of(path: str) -> str:
    m = re.search(r"\.so\.(\d+\.\d+\.\d+)", path)
    return m.group(1) if m else "unknown"


def main(path: str | None = None) -> str:
    path = path or default_library()
    lib = Library(path)
    dc, ac = quantizer_lookups(lib)
    qm = quantizer_matrices(lib)
    cdfs = {**coefficient_cdfs(lib), **other_cdfs(lib), **palette_cdfs(lib), **intrabc_cdfs(lib),
            **segmentation_cdfs(lib)}
    restoration = restoration_tables(lib)
    consts = constants(lib)
    sc = scans(lib)
    out = [f"// Generated by tools/extract_av1_tables.py from libaom {version_of(path)} "
           f"({Path(path).name}); do not edit.\n"
           "// The AV1 specification's tables of the lossy intra path: CDFs in the specification's form (N\n"
           "// cumulative values ending in 32768, then the adaptation counter), scans and quantizer matrices\n"
           "// row-major. Quantizer matrix level 15 applies no weighting and is not stored.\n",
           "#pragma once\n#include <cstdint>\n\nnamespace av1t {\n\n",
           c_array("kDcQLookup", "int16_t", dc), c_array("kAcQLookup", "int16_t", ac),
           c_array("kQuantizerMatrix", "uint8_t", qm, 32)]
    for name, a in cdfs.items():
        out.append(c_array(name, "uint16_t", a))
    for name in ("kSwitchableRestoreCdf", "kWienerRestoreCdf", "kSgrprojRestoreCdf"):
        out.append(c_array(name, "uint16_t", restoration[name]))
    for name in ("kSgrParams", "kXByXplus1", "kOneByX"):
        out.append(c_array(name, "int32_t", restoration[name]))
    out.append(c_array("kCos128", "int32_t", consts["kCos128"]))
    out.append(c_array("kSinpi", "int32_t", consts["kSinpi"]))
    out.append(c_array("kSmWeights", "uint8_t", consts["kSmWeights"], 32))
    for (w, h), (default, mrow, mcol) in sc.items():
        out.append(c_array(f"kDefaultScan{w}x{h}", "int16_t", np.array(default)))
        if w <= 16 and h <= 16:
            out.append(c_array(f"kMrowScan{w}x{h}", "int16_t", np.array(mrow)))
            out.append(c_array(f"kMcolScan{w}x{h}", "int16_t", np.array(mcol)))
    out.append("\n}  // namespace av1t\n")
    return "".join(out)


if __name__ == "__main__":
    text = main(sys.argv[1] if len(sys.argv) > 1 else None)
    HEADER.write_text(text)
    print(f"wrote {HEADER.relative_to(ROOT)} ({len(text)} bytes)")

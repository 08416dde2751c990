"""Lossy and subsampled AVIF against the JAX package's reader
(``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with libavif 1.4 and
libaom 3.14), bit for bit: every entry of
``tests/data/torch_avif_lossy_fixtures.npz`` (cv2's files at quality 92-99,
8, 10 and 12 bits, BGR and gray; odd sizes from 1x1 to 512x512; frames with
TX_MODE_SELECT; cv2's quality 75 and 50 frames with their in-loop filters
rewritten off; ``tools/av1_writer.py``'s lossless 4:2:0, 4:2:2 and 4:4:4
frames under every matrix libavif converts, at both ranges; phase 22's
frames; YCgCo-Re at every subsampling) reads as cv2 reads it, deblocked
where its loop filter level is not 0 and filtered where it applies CDEF;
each inverse transform holds its float64 matrix within its
rounding; the generated tables are what their script extracts; a seeded fuzz
of damaged and cut copies gives cv2's outcome; and the JAX package's loader,
evaluator and pipeline read the same quality-95 frames as the port's."""

import hashlib
import importlib.util
import math
import os
import re
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import deepemia_tpu.data.datasets as jax_ds
import deepemia_tpu.data.loader as jax_loader
import deepemia_tpu_torch.data.datasets as port_ds
import deepemia_tpu_torch.data.loader as port_loader
from deepemia_tpu.inference.pipeline import _load_image
from deepemia_tpu_torch import native
from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_lossy_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})
# the frames cv2 reads that the port refuses -> the words of the refusal
NAMED = {n: FIXTURES[f"{n}/named"].tobytes().decode() for n in NAMES if f"{n}/named" in FIXTURES.files}
# the frames that apply an in-loop filter or a form the port refuses: those named, those that deblock only and
# those that apply CDEF
FILTERED = sorted(set(NAMED) | {n for n in NAMES if {f"{n}/deblocked", f"{n}/cdef"} & set(FIXTURES.files)})


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(path):
    """What the JAX package reads: ``cv2.imread``'s BGR array, or None."""
    got = _load_image(str(path))
    return None if got is None else got[0]


def _committed(name, ref):
    """Whether cv2's array here is the one the fixture file holds."""
    if f"{name}/none" in FIXTURES.files:
        return ref is None
    if ref is None:
        return False
    if f"{name}/bgr" in FIXTURES.files:
        return np.array_equal(ref, FIXTURES[f"{name}/bgr"])
    return hashlib.sha256(ref.tobytes()).hexdigest() == FIXTURES[f"{name}/sha256"].tobytes().decode()


def _write(tmp_path, name):
    path = tmp_path / "f.avif"
    path.write_bytes(FIXTURES[f"{name}/file"].tobytes())
    return path


@pytest.mark.parametrize("name", [n for n in NAMES if n not in FILTERED])
def test_fixture_reads_as_opencv(tmp_path, name):
    """Each fixture: cv2 here reads it as when it was written, and the port
    reads it to the same array bit for bit (or, where cv2 returns None,
    raises a ``ValueError`` that is not ``UnsupportedImageError``)."""
    path = _write(tmp_path, name)
    ref = reference(path)
    assert _committed(name, ref), name
    if ref is None:
        with pytest.raises(ValueError) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError), (name, e.value)
        return
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape, name
    np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("name", FILTERED)
def test_filtered_frames_are_named(tmp_path, name):
    """A frame whose chroma-derived matrix libavif works out from colour
    primaries in float: cv2 reads it; the port raises
    ``UnsupportedImageError`` naming the form, never an array. A frame that
    deblocks (a loop filter level other than 0), applies CDEF, or both: the
    port reads it as cv2 does, bit for bit."""
    path = _write(tmp_path, name)
    ref = reference(path)
    assert _committed(name, ref), name
    if name not in NAMED:
        np.testing.assert_array_equal(read_image(str(path)), ref, err_msg=name)
        return
    with pytest.raises(UnsupportedImageError, match=re.escape(NAMED[name])):
        read_image(str(path))


def test_fixtures_cover_every_form():
    for prefix in ("q92-bgr8", "q99-bgr8", "q92-gray8", "q99-bgr10", "q99-gray12", "size-bgr-1x1", "size-gray-1x1",
                   "size-bgr-9x1", "size-bgr-1x9", "size-bgr-65x65", "size-bgr-512x512", "txsel-", "plain-q75",
                   "plain-q50", "plain-qdefault", "filter-cdef", "filter-q75", "writer-420", "writer-422",
                   "writer-444", "box-colr-nclx-twice", "box-colr-icc-nclx", "smoke-"):
        assert any(n.startswith(prefix) for n in NAMES), prefix
    for mc in (1, 2, 4, 5, 6, 7, 8, 9, 12, 15):
        for sub in ("420", "422"):
            for rng in ("full", "limited"):
                assert any(n.startswith(f"writer-{sub}-mc{mc}-{rng}-") for n in NAMES), (sub, mc, rng)
    assert {"chroma-derived matrix coefficients under colour primaries 2",
            "chroma-derived matrix coefficients under colour primaries 4"} == set(NAMED.values())
    cdef = {n for n in NAMES if f"{n}/cdef" in FIXTURES.files}
    assert {"filter-q75-bgr8-61x45", "filter-q50-bgr8-61x45", "filter-cdef-bgr8-61x45", "smoke-q75"} <= cdef


# ---------------------------------------------------------------------------
# The inverse transforms
# ---------------------------------------------------------------------------

# TxSize -> (log2 width, log2 height), in the specification's order
TX_LOG2 = ((2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (2, 3), (3, 2), (3, 4), (4, 3), (4, 5), (5, 4), (5, 6), (6, 5),
           (2, 4), (4, 2), (3, 5), (5, 3), (4, 6), (6, 4))
ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX, V_DCT, H_DCT = 0, 1, 2, 3, 9, 10, 11
# the 1D kinds of each type: (columns, rows)
KINDS = {DCT_DCT: ("dct", "dct"), ADST_DCT: ("adst", "dct"), DCT_ADST: ("dct", "adst"),
         ADST_ADST: ("adst", "adst"), IDTX: ("id", "id"), V_DCT: ("dct", "id"), H_DCT: ("id", "dct")}


def _pairs():
    out = []
    for tx, (lw, lh) in enumerate(TX_LOG2):
        big = max(lw, lh)
        for t in KINDS:
            if (t in (ADST_DCT, DCT_ADST, ADST_ADST, V_DCT, H_DCT) and big > 4) or (t == IDTX and big > 5):
                continue
            out.append((tx, t))
    return out


def _matrix(kind, n):
    """The float64 matrix of a 1D inverse transform as the integer one
    scales it: out = M @ in."""
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    if kind == "dct":
        m = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
        m[:, 0] = np.sqrt(0.5)
        return m
    if kind == "id":
        return np.eye(n) * {4: np.sqrt(2), 8: 2, 16: 2 * np.sqrt(2), 32: 4}[n]
    if n == 4:  # sinpi(k) / 4096 = 2 sqrt(2) / 3 sin(k pi / 9)
        return 2 * np.sqrt(2) / 3 * np.sin(np.pi * (i + 1) * (2 * k + 1) / 9)
    return np.sin(np.pi * (2 * i + 1) * (2 * k + 1) / (4 * n))


@pytest.mark.parametrize("tx,tx_type", _pairs())
def test_inverse_transform_matches_float(tx, tx_type):
    """``av1.cpp``'s 2D inverse transform of random coefficients (the
    coded top-left part, at most 32x32) against its float64 matrices: the
    rectangular 1/sqrt(2), the rows, Round2 by the row shift, the columns,
    Round2 by 4. Each butterfly rounds, so the integer residual may differ
    by a unit per two stages of the longer side; the bound is 1 + log2 of
    the larger size over 2."""
    lw, lh = TX_LOG2[tx]
    w, h = 1 << lw, 1 << lh
    tw, th = min(w, 32), min(h, 32)
    rng = np.random.default_rng(tx * 16 + tx_type)
    cols, rows = KINDS[tx_type]
    bound = 1 + max(lw, lh) // 2
    for trial in range(4):
        coef = np.zeros((th, tw), np.int64)
        k = int(rng.integers(1, th * tw + 1))  # a random number of the first coefficients, as an eob leaves them
        flat = coef.reshape(-1)
        flat[:k] = rng.integers(-600, 601, k) >> (trial % 3)
        got = native.av1_inverse_transform(coef, tx, tx_type, 8).astype(np.float64)
        full = np.zeros((h, w))
        full[:th, :tw] = coef
        if abs(lw - lh) == 1:
            full = full / np.sqrt(2)
        r = full @ _matrix(rows, w).T / (1 << ROW_SHIFT[tx])
        want = (_matrix(cols, h) @ r) / 16
        assert np.abs(got - want).max() <= bound, (tx, tx_type, trial, np.abs(got - want).max())


def test_inverse_transform_refuses_what_intra_does_not_pair():
    with pytest.raises(ValueError):
        native.av1_inverse_transform(np.zeros((32, 32), np.int32), 3, ADST_ADST, 8)
    with pytest.raises(ValueError):
        native.av1_inverse_transform(np.zeros((32, 32), np.int32), 4, IDTX, 8)


# ---------------------------------------------------------------------------
# The tables
# ---------------------------------------------------------------------------

HEADER = ROOT / "deepemia_tpu_torch" / "native" / "av1_tables.h"


def _table(name):
    src = HEADER.read_text()
    m = re.search(rf"\b{name}\b\s*(?:\[[^\]]*\]\s*)*=\s*\{{(.*?)\}};", src, re.S)
    assert m, name
    return [int(v) for v in re.findall(r"-?\d+", m.group(1))]


# the tables av1.cpp once held typed in, for the lossless path (the TX_4X4 q-context-0 coefficient CDFs, the
# 4x4 smooth weights, scan and base-context offsets), as it held them before the generated header replaced them
TYPED_TABLES = {
    "kTxbSkip": [31849, 32768, 0, 5892, 32768, 0, 12112, 32768, 0, 21935, 32768, 0, 20289, 32768, 0, 27473, 32768, 0, 32487,
        32768, 0, 7654, 32768, 0, 19473, 32768, 0, 29984, 32768, 0, 9961, 32768, 0, 30242, 32768, 0, 32117, 32768, 0],
    "kEobPt16": [840, 1039, 1980, 4895, 32768, 0, 370, 671, 1883, 4471, 32768, 0, 3247, 4950, 9688, 14563, 32768, 0, 1904,
        3354, 7763, 14647, 32768, 0],
    "kEobExtra": [16961, 32768, 0, 17223, 32768, 0, 7621, 32768, 0, 16384, 32768, 0, 16384, 32768, 0, 16384, 32768, 0, 16384,
        32768, 0, 16384, 32768, 0, 16384, 32768, 0, 19069, 32768, 0, 22525, 32768, 0, 13377, 32768, 0, 16384, 32768,
        0, 16384, 32768, 0, 16384, 32768, 0, 16384, 32768, 0, 16384, 32768, 0, 16384, 32768, 0],
    "kCoeffBaseEob": [17837, 29055, 32768, 0, 29600, 31446, 32768, 0, 30844, 31878, 32768, 0, 24926, 28948, 32768, 0, 21365,
        30026, 32768, 0, 30512, 32423, 32768, 0, 31658, 32621, 32768, 0, 29630, 31881, 32768, 0],
    "kCoeffBase": [4034, 8930, 12727, 32768, 0, 18082, 29741, 31877, 32768, 0, 12596, 26124, 30493, 32768, 0, 9446, 21118,
        27005, 32768, 0, 6308, 15141, 21279, 32768, 0, 2463, 6357, 9783, 32768, 0, 20667, 30546, 31929, 32768, 0,
        13043, 26123, 30134, 32768, 0, 8151, 18757, 24778, 32768, 0, 5255, 12839, 18632, 32768, 0, 2820, 7206,
        11161, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0,
        8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384,
        24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0,
        15736, 27553, 30604, 32768, 0, 11210, 23794, 28787, 32768, 0, 5947, 13874, 19701, 32768, 0, 4215, 9323,
        13891, 32768, 0, 2833, 6462, 10059, 32768, 0, 19605, 30393, 31582, 32768, 0, 13523, 26252, 30248, 32768, 0,
        8446, 18622, 24512, 32768, 0, 3818, 10343, 15974, 32768, 0, 1481, 4117, 6796, 32768, 0, 22649, 31302, 32190,
        32768, 0, 14829, 27127, 30449, 32768, 0, 8313, 17702, 23304, 32768, 0, 3022, 8301, 12786, 32768, 0, 1536,
        4412, 7184, 32768, 0, 22354, 29774, 31372, 32768, 0, 14723, 25472, 29214, 32768, 0, 6673, 13745, 18662,
        32768, 0, 2068, 5766, 9322, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 6302,
        16444, 21761, 32768, 0, 23040, 31538, 32475, 32768, 0, 15196, 28452, 31496, 32768, 0, 10020, 22946, 28514,
        32768, 0, 6533, 16862, 23501, 32768, 0, 3538, 9816, 15076, 32768, 0, 24444, 31875, 32525, 32768, 0, 15881,
        28924, 31635, 32768, 0, 9922, 22873, 28466, 32768, 0, 6527, 16966, 23691, 32768, 0, 4114, 11303, 17220,
        32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192,
        16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576,
        32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0, 20201,
        30770, 32209, 32768, 0, 14754, 28071, 31258, 32768, 0, 8378, 20186, 26517, 32768, 0, 5916, 15299, 21978,
        32768, 0, 4268, 11583, 17901, 32768, 0, 24361, 32025, 32581, 32768, 0, 18673, 30105, 31943, 32768, 0, 10196,
        22244, 27576, 32768, 0, 5495, 14349, 20417, 32768, 0, 2676, 7415, 11498, 32768, 0, 24678, 31958, 32585,
        32768, 0, 18629, 29906, 31831, 32768, 0, 9364, 20724, 26315, 32768, 0, 4641, 12318, 18094, 32768, 0, 2758,
        7387, 11579, 32768, 0, 25433, 31842, 32469, 32768, 0, 18795, 29289, 31411, 32768, 0, 7644, 17584, 23592,
        32768, 0, 3408, 9014, 15047, 32768, 0, 8192, 16384, 24576, 32768, 0, 8192, 16384, 24576, 32768, 0],
    "kCoeffBr": [14298, 20718, 24174, 32768, 0, 12536, 19601, 23789, 32768, 0, 8712, 15051, 19503, 32768, 0, 6170, 11327,
        15434, 32768, 0, 4742, 8926, 12538, 32768, 0, 3803, 7317, 10546, 32768, 0, 1696, 3317, 4871, 32768, 0,
        14392, 19951, 22756, 32768, 0, 15978, 23218, 26818, 32768, 0, 12187, 19474, 23889, 32768, 0, 9176, 15640,
        20259, 32768, 0, 7068, 12655, 17028, 32768, 0, 5656, 10442, 14472, 32768, 0, 2580, 4992, 7244, 32768, 0,
        12136, 18049, 21426, 32768, 0, 13784, 20721, 24481, 32768, 0, 10836, 17621, 21900, 32768, 0, 8372, 14444,
        18847, 32768, 0, 6523, 11779, 16000, 32768, 0, 5337, 9898, 13760, 32768, 0, 3034, 5860, 8462, 32768, 0,
        15967, 22905, 26286, 32768, 0, 13534, 20654, 24579, 32768, 0, 9504, 16092, 20535, 32768, 0, 6975, 12568,
        16903, 32768, 0, 5364, 10091, 14020, 32768, 0, 4357, 8370, 11857, 32768, 0, 2506, 4934, 7218, 32768, 0,
        23032, 28815, 30936, 32768, 0, 19540, 26704, 29719, 32768, 0, 15158, 22969, 27097, 32768, 0, 11408, 18865,
        23650, 32768, 0, 8885, 15448, 20250, 32768, 0, 7108, 12853, 17416, 32768, 0, 4231, 8041, 11480, 32768, 0,
        19823, 26490, 29156, 32768, 0, 18890, 25929, 28932, 32768, 0, 15660, 23491, 27433, 32768, 0, 12147, 19776,
        24488, 32768, 0, 9728, 16774, 21649, 32768, 0, 7919, 14277, 19066, 32768, 0, 5440, 10170, 14185, 32768, 0],
    "kDcSign": [16000, 32768, 0, 13056, 32768, 0, 18816, 32768, 0, 15232, 32768, 0, 12928, 32768, 0, 17280, 32768, 0],
    "kSmWeights4": [255, 149, 85, 64],
    "kDefaultScan4x4": [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
    "kCoeffBaseCtxOffset4x4": [0, 1, 6, 6, 0, 1, 6, 6, 21, 0, 6, 6, 21, 21, 0, 6, 21, 21, 21, 0, 0, 0, 0, 0, 0],
}
# where each lies in the generated header: (its name there, how many values from the start)
TYPED_IN_HEADER = {"kTxbSkip": ("kTxbSkipCdf", 39), "kEobPt16": ("kEobPt16Cdf", 24), "kEobExtra": ("kEobExtraCdf", 54),
                  "kCoeffBaseEob": ("kCoeffBaseEobCdf", 32), "kCoeffBase": ("kCoeffBaseCdf", 420),
                  "kCoeffBr": ("kCoeffBrCdf", 210), "kDcSign": ("kDcSignCdf", 18), "kSmWeights4": ("kSmWeights", 4),
                  "kDefaultScan4x4": ("kDefaultScan4x4", 16)}


@pytest.mark.parametrize("name", sorted(TYPED_IN_HEADER))
def test_extracted_tables_hold_the_typed_in_ones(name):
    """Each table once typed into ``av1.cpp`` equals the start of the one
    extracted from libaom (q context 0, TX_4X4 first), its only copy now."""
    header_name, n = TYPED_IN_HEADER[name]
    assert _table(header_name)[:n] == TYPED_TABLES[name]


def test_base_context_offsets_hold_the_typed_in_ones():
    """``av1.cpp``'s square Coeff_Base_Ctx_Offset holds the typed-in 4x4 one."""
    src = (ROOT / "deepemia_tpu_torch" / "native" / "av1.cpp").read_text()
    m = re.search(r"kCoeffBaseCtxOffset\[3\]\[5\]\[5\]\s*=\s*\{(.*?)\};", src, re.S)
    square = [int(v) for v in re.findall(r"-?\d+", m.group(1))][:25]
    old = TYPED_TABLES["kCoeffBaseCtxOffset4x4"]
    assert all(square[r * 5 + c] == old[r * 5 + c] for r in range(4) for c in range(4))


def _bundled_libaom():
    libs = sorted((Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs").glob("libaom-*.so*"))
    return str(libs[0]) if libs else None


@pytest.mark.skipif(_bundled_libaom() is None, reason="no libaom bundled with cv2 here to extract the tables from")
def test_extraction_reproduces_the_header():
    """``tools/extract_av1_tables.py`` run again on the libaom that cv2
    bundles writes the committed header byte for byte."""
    assert _tool("extract_av1_tables").main(_bundled_libaom()) == HEADER.read_text()


def test_header_holds_the_specification_values():
    """A few values of the AV1 specification's tables, by name:
    Dc_Qlookup and Ac_Qlookup (8, 10 and 12 bits), the first quantizer
    matrix (level 0, luma, 4x4), the q-context-3 Default_Txb_Skip_Cdf,
    Default_Eob_Pt_1024_Cdf, Default_Intra_Tx_Type_Set1_Cdf,
    Default_Tx_8x8_Cdf, Default_Delta_Q_Cdf, Sm_Weights_Tx_64x64 and
    Default_Scan_8x4; and the rows the tables have."""
    dc, ac = _table("kDcQLookup"), _table("kAcQLookup")
    assert len(dc) == len(ac) == 768
    assert dc[:4] == [4, 8, 8, 9] and dc[255] == 1336 and dc[511] == 5347 and dc[767] == 21387
    assert ac[:4] == [4, 8, 9, 10] and ac[255] == 1828 and ac[511] == 7312 and ac[767] == 29247
    qm = _table("kQuantizerMatrix")
    assert len(qm) == 15 * 2 * 3344 and qm[:16] == [32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110,
                                                    150, 200]
    assert len(_table("kTxbSkipCdf")) == 4 * 5 * 13 * 3
    assert _table("kEobPt1024Cdf")[:12] == [393, 421, 751, 1623, 3160, 6352, 13345, 18047, 22571, 25830, 32768, 0]
    assert _table("kIntraTxTypeSet1Cdf")[:8] == [1535, 8035, 9461, 12751, 23467, 27825, 32768, 0]
    assert _table("kTx8x8Cdf") == [19968, 32768, 0, 19968, 32768, 0, 24320, 32768, 0]
    assert _table("kDeltaQCdf") == [28160, 32120, 32677, 32768, 0]
    sm = _table("kSmWeights")
    assert len(sm) == 124 and sm[60:64] == [255, 248, 240, 233] and sm[-1] == 4
    assert _table("kDefaultScan8x4")[:10] == [0, 8, 1, 16, 9, 2, 24, 17, 10, 3]
    assert _table("kDefaultScan4x4") == [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]


def test_segment_id_cdfs_hold_the_specification_values():
    """The segment id CDFs extracted from libaom hold the AV1
    specification's Default_Segment_Id_Cdf: three contexts of eight
    symbols, each record N values ending in 32768, then the counter."""
    assert _table("kSpatialPredSegCdf") == [5622, 7893, 16093, 18233, 27809, 28373, 32533, 32768, 0,
                                            14274, 18230, 22557, 24935, 29980, 30851, 32344, 32768, 0,
                                            27527, 28487, 28723, 28890, 32397, 32647, 32679, 32768, 0]


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("q95-bgr8-53x37", "q95-gray8-41x29", "q99-bgr10-53x37", "txsel-bgr-77x65", "writer-422-mc6-full-10")
# copies the port refuses by name: (where cv2 fails: the damage switches on a tool the port refuses in the
# header, and libaom fails on the rest of the stream; where cv2 reads: the damage changes the ispe). The
# txsel copy whose damage switches segmentation on, once named here, fails in the port as in cv2 now that
# segmentation is parsed
NAMED_COPIES = {"q95-bgr8-53x37": (0, 0), "q95-gray8-41x29": (0, 0), "q99-bgr10-53x37": (0, 0),
                "txsel-bgr-77x65": (0, 0), "writer-422-mc6-full-10": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None, the port raises a ``ValueError``; but for
    the copies it refuses by name, counted as pinned."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 60)
    copies = []
    for _ in range(40):
        b = bytearray(data)
        k = int(rng.integers(16, len(data)))
        b[k] ^= int(rng.integers(1, 256))
        copies.append(bytes(b))
    copies += [data[: len(data) * frac // 100] for frac in (5, 20, 35, 50, 65, 80, 95, 99)]
    path, bad, named = tmp_path / "f.avif", [], [0, 0]
    for i, copy in enumerate(copies):
        path.write_bytes(copy)
        try:
            ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
        except cv2.error:
            ref = None
        try:
            got = read_image(str(path))
        except UnsupportedImageError:
            named[ref is not None] += 1
            continue
        except ValueError:
            got = None
        if (ref is None) != (got is None) or (ref is not None and not np.array_equal(ref, got)):
            bad.append((i, "cv2 None" if ref is None else "port None" if got is None else "pixels"))
    assert not bad, bad
    assert tuple(named) == NAMED_COPIES[base]


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub", [(1, 1), (1, 0)])
def test_writer_subsampled_frames_are_lossless(sub):
    """``tools/av1_writer.py``'s 4:2:0 and 4:2:2 frames (every intra mode,
    odd sizes): the port's decoder returns the planes that were written."""
    aw = _tool("av1_writer")
    rng = np.random.default_rng(sub[1])
    for h, w, depth in ((11, 19, 8), (6, 9, 10)):
        y = rng.integers(0, 1 << depth, (h, w))
        u = rng.integers(0, 1 << depth, ((h + sub[1]) >> sub[1], (w + 1) >> 1))
        v = rng.integers(0, 1 << depth, u.shape)
        payload = aw.encode([y, u, v], depth, subsampling=sub, matrix=6, full_range=False, seed=h)
        status, meta, planes = native.av1_decode(payload)
        assert status == 0 and (int(meta[9]), int(meta[10])) == sub
        for a, b in zip(planes, (y, u, v)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The loader, the evaluator and the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lossy_root(tmp_path_factory):
    """Four records whose images are cv2's quality-95 AVIF files of the
    dataset's PNGs: BGR 4:2:0 (two), gray, and BGR at 10 bits and quality
    99 (each file named ``img<i>.png`` as its label says)."""
    root = make_dataset(tmp_path_factory.mktemp("avif_lossy") / "ds", 4, seed=22, size=(48, 64))
    for i in range(4):
        img = cv2.imread(os.path.join(root, f"img{i}.png"))
        if i == 1:
            img = img[..., 1]
        params = [cv2.IMWRITE_AVIF_QUALITY, 95]
        if i == 3:
            img, params = img.astype(np.uint16) << 2, [cv2.IMWRITE_AVIF_QUALITY, 99, cv2.IMWRITE_AVIF_DEPTH, 10]
        ok, buf = cv2.imencode(".avif", img, params)
        assert ok
        Path(root, f"img{i}.png").write_bytes(buf.tobytes())
    return root


def test_loaders_read_lossy_frames_as_jax(lossy_root):
    """The JAX loader and the port's on the same lossy AVIF records: equal
    samples, plain and augmented."""
    files = sorted(f for f in os.listdir(lossy_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(lossy_root, f), lossy_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_lossy_frames_as_jax(tmp_path, monkeypatch, lossy_root):
    """Both packages' ``evaluate_model`` over the four lossy test records
    (models and inference replaced by stand-ins that record the images
    they get): every record is read, and the same arrays reach
    inference."""
    import deepemia_tpu.train.workflow as jax_wf
    import deepemia_tpu_torch.train.workflow as port_wf
    from test_torch_containers import _fake_eval, _register

    seen = {"jax": [], "port": []}
    metrics = {}
    for tag, wf, prefix, ds in (("jax", jax_wf, "deepemia_tpu", jax_ds),
                                ("port", port_wf, "deepemia_tpu_torch", port_ds)):
        _fake_eval(monkeypatch, prefix, tag == "port", seen[tag])
        split, config = _register(tmp_path, lossy_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_pipeline_loads_lossy_frames_as_jax(lossy_root):
    """The inference pipelines' image loads (the JAX package's
    ``_load_image``, cv2; the port's, ``read_image``) give equal arrays,
    and the port's tensor holds them."""
    from deepemia_tpu_torch.inference.pipeline import _load_image as port_load_image

    for i in range(4):
        path = os.path.join(lossy_root, f"img{i}.png")
        want = _load_image(path)[0]
        got, tensor = port_load_image(path, torch.device("cpu"))
        np.testing.assert_array_equal(got, want)
        assert torch.equal(tensor, torch.from_numpy(want))


def test_size_heuristic_reads_lossy_frames(lossy_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads a lossy
    frame rather than raise: its engine gets cv2's array."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    path = os.path.join(lossy_root, "img0.png")
    try:
        calculate_average_mask_sizes(Engine(), [path], None)
    except StopIteration:
        pass
    assert seen and np.array_equal(seen[0], _load_image(path)[0])


def test_phase22_frames_hold_their_drawing(tmp_path):
    """Phase 22's frames decode near the drawing they were written from:
    the lossless 4:2:0 frame to it exactly, the lossy ones within a few
    levels (quality 95 and 99)."""
    flat, instances = _tool("make_torch_avif_lossy_fixtures").smoke_frame()
    assert len(instances) >= 10
    for name, tol in (("smoke-writer420", 0), ("smoke-gray95", 12), ("smoke-bgr95", 14), ("smoke-bgr10-99", 14),
                      ("smoke-bgr12-99", 14)):
        got = read_image(str(_write(tmp_path, name)))
        assert hashlib.sha256(got.tobytes()).hexdigest() == FIXTURES[f"{name}/sha256"].tobytes().decode(), name
        err = np.abs(got[..., 1].astype(np.int16) - flat - (12 if name.startswith("smoke-bgr") else 0))
        assert err.max() <= tol, (name, int(err.max()))
        assert math.isclose(float(err.mean()), 0.0, abs_tol=1.0), name

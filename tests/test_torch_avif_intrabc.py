"""AVIF whose AV1 frame allows intra block copy, against the JAX package's
reader (``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with libavif 1.4
and libaom 3.14), bit for bit: every entry of
``tests/data/torch_avif_intrabc_fixtures.npz`` (cv2's frames of masks,
blobs, label images and random blocky frames at speeds 0-7, 8, 10 and 12
bits, gray and BGR, lossless and lossy, TX_MODE_SELECT and
TX_MODE_LARGEST, non-empty DV stacks, half-pixel chroma DVs, the inter
transform sets and split transforms, palettes beside the copies;
``tools/av1_writer.py``'s frames in 4:2:2, with 128x128 superblocks and
with two tile rows; phase 22's 1024x768 and 2048x2048 frames) reads as cv2
reads it, and the writer's frame whose DV points at its own undecoded
block fails where cv2 fails; the 16 inverse transform types hold their
float64 matrices; a seeded fuzz of damaged and cut copies gives cv2's
outcome; and the JAX package's loader, evaluator and size heuristic read
cv2's intra block copy frames as the port's."""

import hashlib
import importlib.util
import os
import re
import sys
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
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_intrabc_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})
FAILED = [n for n in NAMES if f"{n}/none" in FIXTURES.files]
READ = [n for n in NAMES if n not in FAILED]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_torch_avif_intrabc_fixtures")
FIELDS = {n: dict(zip(TOOL.FIELDS, (int(v) for v in FIXTURES[f"{n}/fields"]))) for n in NAMES}


def _cv2(path):
    try:
        return cv2.imread(str(path), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def _sha(a) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


def _held(name, ref) -> bool:
    """Whether cv2's array here is the one the fixture file holds."""
    if ref is None:
        return False
    if f"{name}/bgr" in FIXTURES.files:
        return np.array_equal(ref, FIXTURES[f"{name}/bgr"])
    return _sha(ref) == FIXTURES[f"{name}/sha256"].tobytes().decode()


def _write(tmp_path, name, data=None):
    path = tmp_path / "f.avif"
    path.write_bytes(FIXTURES[f"{name}/file"].tobytes() if data is None else data)
    return path


@pytest.mark.parametrize("name", READ)
def test_fixture_reads_as_opencv(tmp_path, name):
    """Each fixture: cv2 here reads it as when it was written, and the port
    reads it to the same array bit for bit."""
    path = _write(tmp_path, name)
    ref = _cv2(path)
    assert _held(name, ref), name
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape, name
    np.testing.assert_array_equal(got, ref, err_msg=name)


def test_dv_into_the_undecoded_block_fails_as_libaom(tmp_path):
    """The writer's frame whose first copy takes the DV (0, 0), its own
    block, not decoded yet: libaom's av1_is_dv_valid marks the frame
    corrupt and cv2 reads nothing; the decoder fails as on a corrupt
    stream (status -1), never predicting from the undecoded pixels, and
    ``read_image`` raises a ``ValueError`` that is not
    ``UnsupportedImageError``."""
    assert FAILED == ["writer-invalid-dv"]
    path = _write(tmp_path, "writer-invalid-dv")
    assert _cv2(path) is None
    status, meta, planes = native.av1_decode(TOOL.fx.payload_of(path.read_bytes())[0])
    assert status == -1 and meta[4] < 0 and planes is None
    with pytest.raises(ValueError) as e:
        read_image(str(path))
    assert not isinstance(e.value, UnsupportedImageError)


def test_fixtures_cover_every_path():
    """Every frame allows intra block copy and codes blocks that copy.
    cv2's frames reach TOOL.WANT between them: every speed 0-7, 8, 10 and
    12 bits, gray and BGR, lossless and lossy, TX_MODE_SELECT and
    TX_MODE_LARGEST, a non-empty DV stack, half-pixel chroma across and
    down, a split transform, the three inter transform sets, the default
    DV a superblock up, palettes beside the copies. The writer's hold
    4:2:2 with half-pixel chroma across, 128x128 superblocks and two tile
    rows with the default DV 256 pixels left of a superblock."""
    reached = set()
    for n in READ:
        assert FIELDS[n]["intrabc"], n
        c = TOOL.coded(FIXTURES[f"{n}/file"].tobytes())
        assert c["blocks"] > 0, n
        if n.startswith("cv2-"):
            reached |= TOOL.features(FIXTURES[f"{n}/file"].tobytes(), FIELDS[n]["speed"])
    assert TOOL.WANT <= reached, sorted(TOOL.WANT - reached, key=str)
    wr = {n: TOOL.coded(FIXTURES[f"{n}/file"].tobytes()) for n in READ if n.startswith("writer-")}
    assert any((FIELDS[n]["ssx"], FIELDS[n]["ssy"]) == (1, 0) and "half-x" in c["paths"] for n, c in wr.items())
    assert any(FIELDS[n]["sb128"] and {"default-above", "default-left"} & c["paths"] for n, c in wr.items())
    assert any(FIELDS[n]["tile_rows"] == 2 and "default-left" in c["paths"] for n, c in wr.items())
    assert any(FIELDS[n]["lossless"] for n in wr) and any(not FIELDS[n]["lossless"] for n in wr)


# ---------------------------------------------------------------------------
# The 16 inverse transform types
# ---------------------------------------------------------------------------

TX_LOG2 = ((2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (2, 3), (3, 2), (3, 4), (4, 3), (4, 5), (5, 4), (5, 6), (6, 5),
           (2, 4), (4, 2), (3, 5), (5, 3), (4, 6), (6, 4))
ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)
# the 1D kinds of each type, DCT_DCT .. H_FLIPADST: (columns, rows); "flip" is the ADST with its outputs reversed
KINDS = (("dct", "dct"), ("adst", "dct"), ("dct", "adst"), ("adst", "adst"), ("flip", "dct"), ("dct", "flip"),
         ("flip", "flip"), ("adst", "flip"), ("flip", "adst"), ("id", "id"), ("dct", "id"), ("id", "dct"),
         ("adst", "id"), ("id", "adst"), ("flip", "id"), ("id", "flip"))


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
    if kind == "flip":
        return _matrix("adst", n)[::-1]
    if n == 4:  # sinpi(k) / 4096 = 2 sqrt(2) / 3 sin(k pi / 9)
        return 2 * np.sqrt(2) / 3 * np.sin(np.pi * (i + 1) * (2 * k + 1) / 9)
    return np.sin(np.pi * (2 * i + 1) * (2 * k + 1) / (4 * n))


def _paired(tx_type, lw, lh):
    """Whether a transform set pairs the type with the size: DCT_DCT at
    every size, IDTX up to 32, every other type up to 16."""
    big = max(lw, lh)
    return tx_type == 0 or (tx_type == 9 and big <= 5) or big <= 4


@pytest.mark.parametrize("tx_type", range(16))
def test_inverse_transform_matches_float(tx_type):
    """``av1.cpp``'s 2D inverse transform of random coefficients of each
    size the type pairs with, against its float64 matrices (a flipped ADST
    reverses its outputs; a 1D type is the identity across): the
    rectangular 1/sqrt(2), the rows, Round2 by the row shift, the columns,
    Round2 by 4. Each butterfly rounds; the bound is 1 + log2 of the larger
    size over 2, as for the intra types. A size no set pairs is refused."""
    cols, rows = KINDS[tx_type]
    for tx, (lw, lh) in enumerate(TX_LOG2):
        w, h = 1 << lw, 1 << lh
        tw, th = min(w, 32), min(h, 32)
        if not _paired(tx_type, lw, lh):
            with pytest.raises(ValueError):
                native.av1_inverse_transform(np.zeros((th, tw), np.int32), tx, tx_type, 8)
            continue
        rng = np.random.default_rng(tx * 16 + tx_type + 500)
        bound = 1 + max(lw, lh) // 2
        for trial in range(3):
            coef = np.zeros((th, tw), np.int64)
            k = int(rng.integers(1, th * tw + 1))
            coef.reshape(-1)[:k] = rng.integers(-600, 601, k) >> (trial % 3)
            got = native.av1_inverse_transform(coef, tx, tx_type, 8).astype(np.float64)
            full = np.zeros((h, w))
            full[:th, :tw] = coef
            if abs(lw - lh) == 1:
                full = full / np.sqrt(2)
            r = full @ _matrix(rows, w).T / (1 << ROW_SHIFT[tx])
            want = (_matrix(cols, h) @ r) / 16
            assert np.abs(got - want).max() <= bound, (tx, tx_type, trial, np.abs(got - want).max())
    with pytest.raises(ValueError):
        native.av1_inverse_transform(np.zeros((4, 4), np.int32), 0, 16, 8)


def test_intra_block_copy_cdfs_hold_the_specification_values():
    """The CDFs extracted from libaom hold the AV1 specification's defaults
    (section 9.4): Default_Intrabc_Cdf, the MV CDFs MV_INTRABC_CONTEXT
    starts from, Default_Txfm_Split_Cdf and the inter transform type
    sets' first values."""
    text = (ROOT / "deepemia_tpu_torch" / "native" / "av1_tables.h").read_text()

    def table(name):
        m = re.search(rf"\b{name}\b\s*(?:\[[^\]]*\]\s*)*=\s*\{{(.*?)\}};", text, re.S)
        return [int(v) for v in re.findall(r"-?\d+", m.group(1))]

    assert table("kIntrabcCdf") == [30531, 32768, 0]
    assert table("kMvJointCdf") == [4096, 11264, 19328, 32768, 0]
    assert table("kMvClassCdf")[:12] == [28672, 30976, 31858, 32320, 32551, 32656, 32740, 32757, 32762, 32767,
                                         32768, 0]
    assert table("kMvClass0BitCdf") == [27648, 32768, 0] * 2 and table("kMvSignCdf") == [16384, 32768, 0] * 2
    assert table("kMvBitsCdf")[0::3][:10] == [17408, 17920, 18944, 20480, 22528, 24576, 28672, 29952, 29952, 30720]
    assert table("kTxfmSplitCdf")[0::3] == [28581, 23846, 20847, 24315, 18196, 12133, 18791, 10887, 11005, 27179,
                                            20004, 11281, 26549, 19308, 14224, 28015, 21546, 14400, 28165, 22401,
                                            16088]
    assert table("kInterTxTypeSet1Cdf")[:4] == [4458, 5560, 7695, 9709]
    assert table("kInterTxTypeSet2Cdf")[2 * 13 : 2 * 13 + 3] == [770, 2421, 5225]
    assert table("kInterTxTypeSet3Cdf")[0::3] == [16384, 4167, 1998, 748]


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------


# a lossless and a lossy cv2 frame with the most blocks that copy (328 and 326), and the writer's 4:2:2 frame
FUZZ_BASES = ("cv2-random-111-gray8-218x208-s6-q100", "cv2-random-20-gray10-203x235-s5-q50", "writer-422-8-lossless")
# copies the port refuses by name: (where cv2 fails, where cv2 reads: the damage changes the ispe, which libavif
# scales to)
NAMED_COPIES = {"cv2-random-111-gray8-218x208-s6-q100": (0, 0), "cv2-random-20-gray10-203x235-s5-q50": (0, 1),
                "writer-422-8-lossless": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None (a DV the damage makes invalid among the
    causes), the port raises a ``ValueError`` that is not
    ``UnsupportedImageError``; the copies the port refuses by name are
    counted as pinned. No copy crashes the decoder."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 250)
    copies = []
    for _ in range(40):
        b = bytearray(data)
        i = int(rng.integers(16, len(data)))
        b[i] ^= int(rng.integers(1, 256))
        copies.append(bytes(b))
    copies += [data[: len(data) * frac // 100] for frac in (5, 20, 35, 50, 65, 80, 95, 99)]
    path, bad, named = tmp_path / "f.avif", [], [0, 0]
    for i, copy in enumerate(copies):
        path.write_bytes(copy)
        ref = _cv2(path)
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
# Phase 22's frame, the loader, the evaluator and the size heuristic
# ---------------------------------------------------------------------------


def test_phase22_intrabc_frame_holds_its_drawing(tmp_path):
    """Phase 22's intra block copy frame (the flattened labelled frame with
    its colour, as cv2 writes it at speed 4) decodes to the SHA-256 of
    cv2's array, copies blocks, and lies near the drawing it was written
    from; the tolerance is the one phase 22 holds it to."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    flat, _ = TOOL.lossy.smoke_frame()
    got = read_image(str(_write(tmp_path, "smoke-intrabc-bgr8")))
    assert _sha(got) == FIXTURES["smoke-intrabc-bgr8/sha256"].tobytes().decode()
    assert TOOL.coded(FIXTURES["smoke-intrabc-bgr8/file"].tobytes())["blocks"] > 0
    err = np.abs(got[..., 1].astype(np.int16) - flat - 12)
    assert err.max() <= chip_smoke.AVIF_PALETTE_FORMS["intrabc-bgr8"] and err.mean() < 2, (int(err.max()),
                                                                                            float(err.mean()))


def _intrabc_avif(img: np.ndarray) -> bytes:
    """cv2's AVIF of ``img`` at the first speed of 4, 7, 5, 3, 6 whose frame copies blocks."""
    for speed in (4, 7, 5, 3, 6):
        data = TOOL.cv2_lossy(img, None, 8, speed)
        if TOOL.frame_fields(data)["intrabc"] and TOOL.coded(data)["blocks"]:
            return data
    raise AssertionError("no cv2 frame with intra block copy")


@pytest.fixture(scope="module")
def intrabc_root(tmp_path_factory):
    """Four records whose images are cv2's AVIF files, with blocks that
    copy, of the dataset's 320x128 PNGs cut to levels 32 apart, their lower
    superblock row a repeat of the upper one (each file named ``img<i>.png``
    as its label says), two of them in colour."""
    root = make_dataset(tmp_path_factory.mktemp("avif_intrabc") / "ds", 4, seed=25, size=(128, 320))
    for i in range(4):
        gray = cv2.imread(os.path.join(root, f"img{i}.png"), cv2.IMREAD_GRAYSCALE)
        levels = (gray // 32 * 32).astype(np.uint8)
        levels[64:] = levels[:64]
        img = TOOL.lossy.smoke_bgr(levels) if i % 2 else levels
        Path(root, f"img{i}.png").write_bytes(_intrabc_avif(img))
    return root


def test_loaders_read_intrabc_frames_as_jax(intrabc_root):
    """The JAX loader and the port's on the same intra block copy records:
    equal samples, plain and augmented."""
    files = sorted(f for f in os.listdir(intrabc_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(intrabc_root, f), intrabc_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_intrabc_frames_as_jax(tmp_path, monkeypatch, intrabc_root):
    """Both packages' ``evaluate_model`` over the four intra block copy
    test records (models and inference replaced by stand-ins that record
    the images they get): every record is read, and the same arrays reach
    inference."""
    import deepemia_tpu.train.workflow as jax_wf
    import deepemia_tpu_torch.train.workflow as port_wf
    from test_torch_containers import _fake_eval, _register

    seen = {"jax": [], "port": []}
    metrics = {}
    for tag, wf, prefix, ds in (("jax", jax_wf, "deepemia_tpu", jax_ds),
                                ("port", port_wf, "deepemia_tpu_torch", port_ds)):
        _fake_eval(monkeypatch, prefix, tag == "port", seen[tag])
        split, config = _register(tmp_path, intrabc_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_size_heuristic_reads_intrabc_frames(intrabc_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads an intra
    block copy frame rather than raise: its engine gets the JAX package's
    array (cv2's)."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    for i in range(4):
        path = os.path.join(intrabc_root, f"img{i}.png")
        try:
            calculate_average_mask_sizes(Engine(), [path], None)
        except StopIteration:
            pass
        assert len(seen) == i + 1 and np.array_equal(seen[i], _load_image(path)[0]), i

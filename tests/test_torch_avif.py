"""AVIF against the JAX package's reader (``cv2.imread(path,
cv2.IMREAD_COLOR)``, OpenCV 5.0 with libavif and libaom 3.14), bit for
bit: every entry of ``tests/data/torch_avif_fixtures.npz`` (cv2's lossless
files at odd sizes, BGR and gray, 8, 10 and 12 bits, with alpha; the box
writer's container forms around cv2's AV1 payloads; ``tools/av1_writer.py``'s
streams in the forms cv2 does not write: a full sequence header, frame
header and tile group OBUs, uniform and sized tiles, 128x128 superblocks,
every partition type, CDF updates off, metadata and padding OBUs; cut and
damaged copies) reads as cv2 reads it here and as the committed array says, or
raises where cv2 returns None; every form outside the port's decoder is
refused by name beside what cv2 does with it; a seeded fuzz of damaged and
cut copies gives cv2's outcome; the decoder's tables hold the AV1
specification's values; and the JAX loader and the port's give equal
samples on a dataset of AVIF frames."""

import hashlib
import importlib.util
import os
import re
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import deepemia_tpu.data.datasets as jax_ds
import deepemia_tpu.data.loader as jax_loader
import deepemia_tpu_torch.data.loader as port_loader
from deepemia_tpu.inference.pipeline import _load_image
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files} - {"c12"})
_spec = importlib.util.spec_from_file_location("make_torch_avif_fixtures", ROOT / "tools" / "make_torch_avif_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

# what OpenCV reads (or, for a header rewritten to switch a tool on, fails on) and the port names:
# fixture -> the words of the refusal (the fixture file's ``<name>/named``)
REFUSED = {n: FIXTURES[f"{n}/named"].tobytes().decode() for n in NAMES if f"{n}/named" in FIXTURES.files}
# the forms the port refused by name until it applied CDEF, and reads now (``<name>/cdef``)
CDEF = sorted(n for n in NAMES if f"{n}/cdef" in FIXTURES.files)
# the header rewrite the port refused by name until it parsed segmentation, and fails on now as cv2 does
# (``<name>/segmentation``)
SEGMENTATION = sorted(n for n in NAMES if f"{n}/segmentation" in FIXTURES.files)


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


@pytest.mark.parametrize("name", [n for n in NAMES if n not in REFUSED and n not in CDEF and n not in SEGMENTATION])
def test_fixture_reads_as_opencv(tmp_path, name):
    """Each fixture: cv2 here reads it as when it was written (or refuses
    it again), and the port reads it to the same array bit for bit, or
    refuses it with a ``ValueError`` that is not ``UnsupportedImageError``."""
    path = _write(tmp_path, name)
    ref = reference(path)
    assert _committed(name, ref), name
    if ref is None:
        with pytest.raises(ValueError) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError), (name, e.value)
    else:
        got = read_image(str(path))
        assert got.dtype == np.uint8 and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("name", sorted(REFUSED) + CDEF + SEGMENTATION)
def test_forms_outside_the_decoder_are_named(tmp_path, name):
    """An image sequence (cv2's animation), a grid, premultiplied alpha, an
    ispe libavif scales to, and a lossless header rewritten to switch on
    film grain: ``UnsupportedImageError`` naming the form, never an array;
    cv2 reads each file, or for the rewrite fails, as the fixture file
    holds. Lossy 4:2:0 that applies CDEF (cv2 at quality 75), once refused
    here, reads as cv2 reads it, bit for bit. A lossless header rewritten
    to switch on screen content tools (whose next two header bits then
    switch intra block copy on, and the shifted fields after them
    segmentation), once refused by name for segmentation: cv2 returns None,
    and the port, which parses segmentation, fails on the rest of the
    stream with a ``ValueError`` that is not ``UnsupportedImageError``."""
    path = _write(tmp_path, name)
    ref = reference(path)
    if name in CDEF:
        assert _committed(name, ref) and ref is not None, name
        np.testing.assert_array_equal(read_image(str(path)), ref, err_msg=name)
        return
    if name in SEGMENTATION:
        assert _committed(name, ref) and ref is None, name
        with pytest.raises(ValueError) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError), (name, e.value)
        return
    words = REFUSED[name]
    assert _committed(name, ref) and (ref is None) == name.startswith("box-film"), name
    with pytest.raises(UnsupportedImageError, match=re.escape(words)):
        read_image(str(path))


def test_opencv_refusals_are_refused_images(tmp_path):
    """A file OpenCV does not take for AVIF (no avif brand, its meta box
    past the first 500 bytes, a handler other than pict) raises
    ``RefusedImageError``, as every reader skips it."""
    for name in ("box-mif1-brand-only", "box-mdat-first-past-signature", "box-handler-vide"):
        path = _write(tmp_path, name)
        assert reference(path) is None
        with pytest.raises(RefusedImageError):
            read_image(str(path))


@pytest.mark.parametrize("width,height", [(65535, 65535), (32769, 8), (16385, 16385)])
def test_frames_past_libavif_limits_are_refused_before_allocation(tmp_path, width, height):
    """cv2's 7x5 payload with its sequence header rewritten to a larger
    frame (the largest a header holds; more than 32768 a side; more than
    16384² pixels) under its 7x5 ispe: the decoder refuses the frame
    before it allocates a plane (status -3, the frame's size), and
    ``read_image`` raises a ``ValueError`` that every reader skips. cv2 is
    run on the small frame only: libaom fails on its frame header too; the
    others would have libaom allocate gigabytes."""
    from deepemia_tpu_torch import native

    payload, av1c, colr = fx.payload_of(FIXTURES["bgr-7x5/file"].tobytes())
    big = fx.resize(payload, width, height)
    status, meta, planes = native.av1_decode(big)
    assert (status, int(meta[0]), int(meta[1]), planes) == (-3, width, height, None)
    path = tmp_path / "f.avif"
    path.write_bytes(fx.avif([fx.image_item(big, av1c, 7, 5, 8, 3, colr)]))
    if width * height < 1 << 20:
        assert reference(path) is None
    with pytest.raises(ValueError, match="libavif's limits") as e:
        read_image(str(path))
    assert not isinstance(e.value, UnsupportedImageError)


def test_fixtures_cover_every_form():
    for prefix in ("bgr-1x1", "gray-7x5", "bgr-257x191", "bgr10-", "gray12-", "bgra-", "box-iloc1-idat",
                   "box-iloc2-sizes8", "box-extents", "box-irot", "box-imir", "box-clap", "box-alpha",
                   "box-unknown-property", "box-limited-range", "cut-", "damaged-", "smoke-gray-2048", "dataset-",
                   "av1-full-header", "av1-frame-header-and-tile-groups", "av1-tiles-uniform", "av1-tiles-sizes",
                   "av1-sb128", "av1-sb128-none", "av1-partitions", "av1-no-cdf-update", "av1-metadata-padding"):
        assert any(n.startswith(prefix) for n in NAMES), prefix


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("bgr-7x5", "gray-7x5", "bgr10-7x5", "gray12-7x5", "bgra-33x17", "box-extents-idat",
              "box-iloc2-sizes8", "gray-65x129")
# copies the port refuses by name: (where cv2 fails: the damage switches on an AV1 tool the port refuses
# in the header, and libaom fails on the rest of the stream; where cv2 reads: the damage changes the ispe,
# and libavif scales the frame to it).
NAMED = {"bgr-7x5": (0, 0), "gray-7x5": (0, 0), "bgr10-7x5": (0, 0), "gray12-7x5": (0, 2), "bgra-33x17": (0, 0),
         "box-extents-idat": (0, 0), "box-iloc2-sizes8": (0, 0), "gray-65x129": (0, 0)}


def _fuzz(tmp_path, base):
    """-> ([(copy, what differs)], named where cv2 fails, named where cv2
    reads) over the copies of ``base``."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 40)
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
    return bad, tuple(named)


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies of the fixture with one byte past the first 16 XORed,
    and cuts at eight fractions: the port's outcome is cv2's (its array
    bit for bit, or a ``ValueError`` where cv2 returns None), but for the
    copies it refuses by name, counted as pinned."""
    bad, named = _fuzz(tmp_path, base)
    assert not bad, bad
    assert named == NAMED[base]


# ---------------------------------------------------------------------------
# The decoder's tables
# ---------------------------------------------------------------------------


def _table(name):
    """The integers of a table of ``native/av1.cpp`` or of its generated
    ``native/av1_tables.h``, in order."""
    native = ROOT / "deepemia_tpu_torch" / "native"
    src = (native / "av1.cpp").read_text() + (native / "av1_tables.h").read_text()
    m = re.search(rf"\b{name}\b\s*(?:\[[^\]]*\]\s*)*=\s*\{{(.*?)\}};", src, re.S)  # its definition
    assert m, name
    return [int(v) for v in re.findall(r"-?\d+", m.group(1))]


def test_tables_hold_the_specification_values():
    """A few values of the AV1 specification's tables, by name: the first
    CDFs of Default_Partition_W8_Cdf, Default_Intra_Frame_Y_Mode_Cdf,
    Default_Uv_Mode_Cfl_Allowed_Cdf, Default_Skip_Cdf, Default_Cfl_Sign_Cdf,
    the TX_4X4 q-context-0 Default_Txb_Skip_Cdf, Default_Eob_Pt_16_Cdf and
    Default_Coeff_Base_Cdf, Default_Dc_Sign_Cdf, Dr_Intra_Derivative,
    Sm_Weights_Tx_4x4, Mode_To_Angle, Intra_Filter_Taps and the 4x4
    default scan (each CDF N cumulative values ending in 32768, then a
    counter; the coefficient CDFs, weights and scans from the generated
    ``av1_tables.h``, indexed by q context first)."""
    assert _table("kPartition8")[:5] == [19132, 25510, 30392, 32768, 0]
    assert _table("kKfYMode")[:14] == [15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165,
                                       29093, 30466, 32768, 0]
    assert _table("kUvModeCfl")[:15] == [10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986, 20086,
                                         20995, 22455, 24212, 32768, 0]
    assert _table("kSkip") == [31671, 32768, 0, 16515, 32768, 0, 4576, 32768, 0]
    assert _table("kCflSign") == [1418, 2123, 13340, 18405, 26972, 28343, 32294, 32768, 0]
    assert _table("kTxbSkipCdf")[:6] == [31849, 32768, 0, 5892, 32768, 0]
    assert _table("kEobPt16Cdf")[:6] == [840, 1039, 1980, 4895, 32768, 0]
    assert _table("kCoeffBaseCdf")[:5] == [4034, 8930, 12727, 32768, 0]
    assert _table("kDcSignCdf")[:18] == [128 * 125, 32768, 0, 128 * 102, 32768, 0, 128 * 147, 32768, 0,
                                         128 * 119, 32768, 0, 128 * 101, 32768, 0, 128 * 135, 32768, 0]
    dr = _table("kDrIntraDerivative")
    assert len(dr) == 90 and (dr[3], dr[6], dr[45], dr[87]) == (1023, 547, 64, 3)
    assert _table("kSmWeights")[:4] == [255, 149, 85, 64]
    assert _table("kModeToAngle") == [0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0]
    assert _table("kFilterIntraTaps")[:14] == [-6, 10, 0, 0, 0, 12, 0, -5, 2, 10, 0, 0, 9, 0]
    assert _table("kDefaultScan4x4") == [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]


# ---------------------------------------------------------------------------
# The loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def avif_records(tmp_path_factory):
    """Five records whose images are AVIF files of the dataset's PNGs:
    lossless BGR, gray, 10-bit, with irot, and (the third) lossy 4:2:0 at
    quality 95."""
    root = make_dataset(tmp_path_factory.mktemp("avif") / "ds", 5, seed=19, size=(48, 64))
    for i in range(5):
        bgr = cv2.imread(os.path.join(root, f"img{i}.png"))
        h, w = bgr.shape[:2]
        if i == 0:
            data = fx.cv2_file(bgr)
        elif i == 1:
            data = fx.cv2_file(bgr[..., 1])
        elif i == 2:
            data = fx.cv2_file(bgr, cv2.IMWRITE_AVIF_QUALITY, 95)
        elif i == 3:
            data = fx.cv2_file(bgr.astype(np.uint16) * 4, cv2.IMWRITE_AVIF_DEPTH, 10)
        else:
            payload, av1c, colr = fx.cv2_payload(bgr)
            data = fx.avif([fx.image_item(payload, av1c, w, h, 8, 3, colr,
                                          extra=[(fx.box(b"irot", b"\x01"), True)])])
        Path(root, f"img{i}.png").write_bytes(data)
    files = sorted(f for f in os.listdir(root) if f.endswith(".json"))
    return [jax_ds.parse_instance_json(os.path.join(root, f), root, i, {"a": 0, "b": 1}) for i, f in enumerate(files)]


def test_loaders_read_avif_frames_as_jax(avif_records):
    """The JAX loader and the port's on the same AVIF records: equal
    samples, plain and augmented, the lossy 4:2:0 frame among them."""
    for i, rec in enumerate(avif_records):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)

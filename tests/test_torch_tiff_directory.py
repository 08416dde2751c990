"""A damaged TIFF directory read as libtiff 4.7.1 reads it (C12), against
the JAX package's reader (``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV
5.0): a seeded fuzz of damaged and cut copies of the C11 TIFFs of
``tests/data/torch_jpeg2000_fixtures.npz`` gives cv2's outcome (an array,
bit for bit, or a ``ValueError`` where cv2 returns None) on every copy;
one pinned case for each rule of ``TIFFReadDirectory`` and
``TIFFFetchNormalTag`` the port follows; and the undamaged files read as
before."""

import hashlib
import importlib.util
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from test_torch_tiff_codings import fx

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_jpeg2000_fixtures.npz")
C11 = sorted({k.split("/")[0] for k in FIXTURES.files if k.startswith("c11-")})
S, L = fx.SHORT, fx.LONG


def reference(path):
    """``cv2.imread``'s BGR array, or None (an image too large for OpenCV
    raises, and reads as None here)."""
    try:
        return cv2.imread(str(path), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def outcome_matches(path):
    """Whether ``read_image`` gives cv2's outcome on ``path``: its array
    bit for bit, or a ``ValueError`` that is not ``UnsupportedImageError``
    where cv2 returns None. -> (matches, description)."""
    ref = reference(path)
    try:
        got = read_image(str(path))
    except UnsupportedImageError as e:
        return False, f"unsupported: {e}"
    except ValueError as e:
        return ref is None, f"raises {type(e).__name__}: {e}"
    if ref is None:
        return False, "cv2 returns None, the port reads"
    same = got.shape == ref.shape and np.array_equal(got, ref)
    return same, "pixels" if not same else ""


_spec = importlib.util.spec_from_file_location("make_torch_avif_fixtures", ROOT / "tools" / "make_torch_avif_fixtures.py")
avif_fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(avif_fx)
COPIES = avif_fx.c12_copies(FIXTURES)  # 24 damaged copies and 8 cuts of each C11 TIFF, seeded
COMMITTED = np.load(ROOT / "tests" / "data" / "torch_avif_fixtures.npz")["c12/sha256"]


def test_fuzz_covers_800_copies():
    assert len(C11) == 25 and len(COPIES) == 800 == len(COMMITTED)


@pytest.mark.parametrize("name", C11)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, name):
    """Every damaged or cut copy of the fixture: the port's outcome is
    cv2's (49 of the 800 differed before the directory rules; none does now),
    and cv2's is the one ``tests/data/torch_avif_fixtures.npz`` holds for
    ``chip_smoke.py`` phase 21."""
    path = tmp_path / "f.tif"
    bad = []
    for i, (copy, data) in enumerate(COPIES):
        if not copy.startswith(name + "/"):
            continue
        path.write_bytes(data)
        ref = reference(path)
        want = COMMITTED[i].tobytes().decode() if COMMITTED[i].any() else None
        assert (None if ref is None else hashlib.sha256(ref.tobytes()).hexdigest()) == want, copy
        ok, what = outcome_matches(path)
        if not ok:
            bad.append((copy, what))
    assert not bad, bad


@pytest.mark.parametrize("name", C11)
def test_undamaged_files_read_as_before(tmp_path, name):
    path = tmp_path / "f.tif"
    path.write_bytes(FIXTURES[f"{name}/file"].tobytes())
    if f"{name}/none" in FIXTURES.files:
        assert reference(path) is None
        with pytest.raises(ValueError):
            read_image(str(path))
    else:
        np.testing.assert_array_equal(read_image(str(path)), FIXTURES[f"{name}/bgr"])


# ---------------------------------------------------------------------------
# One pinned case per rule
# ---------------------------------------------------------------------------


def _entries(data: bytes):
    """The first IFD of a little-endian classic TIFF -> [[tag, type, count,
    4-byte value field]]."""
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd : ifd + 2])
    return [list(struct.unpack("<HHI4s", data[ifd + 2 + 12 * i : ifd + 14 + 12 * i])) for i in range(n)]


def _rewrite(data: bytes, entries) -> bytes:
    """``data`` with a new first IFD of ``entries`` appended (in the order
    given), the old one left where it was."""
    at = len(data) + (len(data) & 1)
    ifd = struct.pack("<H", len(entries)) + b"".join(struct.pack("<HHI4s", *e) for e in entries) + bytes(4)
    return data[:4] + struct.pack("<I", at) + data[8:] + b"\0" * (at - len(data)) + ifd


def _value(v: int, typ: int = S) -> bytes:
    return struct.pack("<H", v) + bytes(2) if typ == S else struct.pack("<I", v)


def _palette(spp: int = 1, bits: int = 8, extra: bool = True) -> bytes:
    """A 6x5 palette TIFF of ``spp`` samples (the extra ones in an
    ExtraSamples tag, unless not ``extra``), its ColorMap after the IFD."""
    rng = np.random.default_rng(spp + bits)
    idx = rng.integers(0, 1 << bits, (5, 6, spp)).astype(np.uint8)
    seg = idx.tobytes() if bits == 8 else np.packbits(np.unpackbits(idx[..., 0].reshape(5, 6, 1), axis=2)[..., -4:]
                                                      .reshape(5, -1), axis=1).tobytes()
    tags = {256: (L, [6]), 257: (L, [5]), 258: (S, [bits] * spp), 259: (S, [1]), 262: (S, [3]), 277: (S, [spp]),
            278: (L, [5]), 320: (S, rng.integers(0, 65536, 3 << bits).tolist())}
    if spp > 1 and extra:
        tags[338] = (S, [0] * (spp - 1))
    return fx.tiff_bytes(tags, [seg])


def _rgb(comp: int = 5, rows: int = 2, tags_extra=None, h: int = 6) -> bytes:
    img = (np.random.default_rng(comp + rows).random((h, 8, 3)) * 255).astype(np.uint8)
    tags = {256: (L, [8]), 257: (L, [h]), 258: (S, [8] * 3), 259: (S, [comp]), 262: (S, [2]), 277: (S, [3]),
            278: (L, [rows])}
    tags.update(tags_extra or {})
    return fx.tiff_bytes(tags, [fx.ENCODERS[comp](img[y : y + rows].tobytes()) for y in range(0, h, rows)])


def _retag(data: bytes, tag: int, **changes) -> bytes:
    ents = _entries(data)
    for e in ents:
        if e[0] == tag:
            e[1] = changes.get("typ", e[1])
            e[2] = changes.get("count", e[2])
            e[3] = changes.get("field", e[3])
    return _rewrite(data, ents)


def _cut_colormap(data: bytes) -> bytes:
    """The file cut inside its ColorMap, which a writer put after the IFD."""
    cmap = [e for e in _entries(data) if e[0] == 320][0]
    return data[: struct.unpack("<I", cmap[3])[0] + 10]


def _drop(data: bytes, tag: int) -> bytes:
    return _rewrite(data, [e for e in _entries(data) if e[0] != tag])


def _pinned():
    """{name: (file bytes, what cv2 does: "reads" or "none")}."""
    out = {}
    # a tag whose data lies past the end of the file is dropped: a palette without a ColorMap reads as gray,
    # fails below 8 bits, and with 3 samples turns RGB after its last two were counted as extra (one colour
    # channel: TIFFRGBAImageOK fails)
    out["colormap-past-end-gray"] = (_cut_colormap(_palette(2)), "reads")
    out["colormap-past-end-gray-4"] = (_cut_colormap(_palette(4, extra=False)), "reads")
    out["colormap-past-end-rgb"] = (_cut_colormap(_palette(3, extra=False)), "none")
    out["colormap-past-end-rgb-extra"] = (_cut_colormap(_palette(3)), "none")
    out["colormap-past-end-4bit"] = (_cut_colormap(_palette(1, 4)), "none")
    # a ColorMap of the wrong count is dropped too; one before BitsPerSample in the directory's order as well
    pal = _palette(1)
    out["colormap-wrong-count"] = (_retag(pal, 320, count=3 * 255), "reads")
    ents = _entries(pal)
    out["colormap-before-bits"] = (_rewrite(pal, [e for e in ents if e[0] == 320] + [e for e in ents if e[0] != 320]),
                                   "reads")
    # the first of two entries of a tag counts
    ents = _entries(pal)
    photo = [e for e in ents if e[0] == 262][0]
    out["duplicate-tag-first-counts"] = (_rewrite(pal, ents + [[262, S, 1, _value(1)]]), "reads")
    out["duplicate-tag-first-counts-2"] = (_rewrite(pal, [[262, S, 1, _value(1)]] + ents), "reads")
    assert photo[3][:2] == b"\x03\x00"
    # no readable PhotometricInterpretation: OpenCV fails
    out["photometric-missing"] = (_drop(pal, 262), "none")
    out["photometric-bad-type"] = (_retag(pal, 262, typ=205), "none")
    out["photometric-count-2"] = (_retag(pal, 262, count=2), "none")
    # a single-valued tag of another count is dropped: the Predictor of count 3 reads as none
    out["predictor-count-3"] = (_retag(_rgb(5, tags_extra={317: (S, [2])}), 317, count=3), "reads")
    out["predictor-rational"] = (_retag(_rgb(8, tags_extra={317: (S, [2])}), 317, typ=5), "reads")
    # a Predictor outside 1-3 under LZW or Deflate fails every strip (PredictorSetup), under others is no tag
    out["predictor-4-lzw"] = (_rgb(5, tags_extra={317: (S, [4])}), "none")
    out["predictor-4-packbits"] = (_rgb(32773, tags_extra={317: (S, [4])}), "reads")
    # BitsPerSample of one value per sample: more values than samples, the extra ones differing
    rgb = _rgb(1)
    bits = [e for e in _entries(rgb) if e[0] == 258][0]
    at = struct.unpack("<I", bits[3])[0]
    out["bits-per-sample-extra-values"] = (_retag(rgb[:at + 6] + struct.pack("<H", 16) + rgb[at + 8 :], 258, count=4),
                                           "reads")
    out["bits-per-sample-too-few"] = (_retag(rgb, 258, count=2), "none")
    # YCbCrSubsampling of another count than 2 is dropped (libtiff's default, 2x2)
    ycc = fx.tiff_bytes({256: (L, [4]), 257: (L, [2]), 258: (S, [8] * 3), 259: (S, [1]), 262: (S, [6]),
                         277: (S, [3]), 278: (L, [2]), 530: (S, [2, 2])},
                        [np.random.default_rng(5).integers(0, 256, 12).astype(np.uint8).tobytes()])
    out["ycbcr-subsampling-count-3"] = (_retag(ycc, 530, count=3), "reads")
    # strip arrays: no more values read than there are strips; fewer read as zeros (those strips fail)
    lzw = _rgb(5)
    off = [e for e in _entries(lzw) if e[0] == 273][0]
    out["strip-offsets-count-large"] = (_retag(lzw, 273, count=100000), "reads")
    out["strip-byte-counts-count-large"] = (_retag(lzw, 279, count=4870), "reads")
    out["strip-offsets-count-short"] = (_retag(lzw, 273, count=2), "reads")
    assert off[2] == 3
    out["strip-offsets-past-end"] = (_retag(lzw, 273, field=struct.pack("<I", len(lzw) - 4)), "none")
    # no StripByteCounts: one strip's estimated (uncompressed: from the image size; compressed: from the file
    # size less the directory), several fail
    out["byte-counts-missing-one-strip"] = (_drop(_rgb(1, rows=6), 279), "reads")
    out["byte-counts-missing-lzw"] = (_drop(_rgb(5, rows=6), 279), "reads")
    out["byte-counts-missing-strips"] = (_drop(_rgb(1), 279), "none")
    # one compressed strip of no bytes: ByteCountLooksBad, estimated from the file size
    one = _rgb(8, rows=6)
    out["byte-count-zero-deflate"] = (_retag(one, 279, field=bytes(4)), "reads")
    # ExtraSamples: more values than samples, or a value above 2, fail; 999 reads as 2
    rgba = _rgb(1, tags_extra={277: (S, [4]), 258: (S, [8] * 4), 338: (S, [2])}, h=6)
    out["extra-samples-value-3"] = (_retag(rgba, 338, field=_value(3)), "none")
    out["extra-samples-999"] = (_retag(rgba, 338, field=_value(999)), "reads")
    out["extra-samples-count-5"] = (_retag(rgba, 338, count=5), "none")
    out["rgb-two-extra-of-three"] = (_rgb(1, tags_extra={338: (S, [0, 0])}), "none")
    # a compression libtiff has no codec for: every strip fails to decode, the image reads as zeros
    out["compression-105"] = (_retag(_rgb(1), 259, field=_value(105)), "reads")
    out["compression-50002"] = (_retag(ycc, 259, field=_value(50002)), "reads")
    # LZW: a new-style strip not starting with a Clear code decodes to nothing; the style of the first strip
    # decoded holds for the others
    out["lzw-no-clear"] = (fx.tiff_bytes({256: (L, [8]), 257: (L, [2]), 258: (S, [8]), 259: (S, [5]), 262: (S, [1]),
                                          277: (S, [1]), 278: (L, [2])}, [bytes([0x14, 0xAB, 0xF1, 0x5C])]), "reads")
    gray = (np.random.default_rng(9).random((4, 8)) * 255).astype(np.uint8)
    mixed = [fx.lzw_encode(gray[:2].tobytes()), fx.lzw_compat_encode(gray[2:].tobytes())]
    tags = {256: (L, [8]), 257: (L, [4]), 258: (S, [8]), 259: (S, [5]), 262: (S, [1]), 277: (S, [1]), 278: (L, [2])}
    out["lzw-style-of-first-strip"] = (fx.tiff_bytes(tags, mixed), "reads")
    out["lzw-style-of-first-strip-compat"] = (fx.tiff_bytes(tags, mixed[::-1]), "reads")
    # a first tile whose buffer would pass 1e8 bytes from a compressed tile under a thousandth of it
    tiled = fx.tiff_bytes({256: (L, [16]), 257: (L, [16]), 258: (S, [8] * 3), 259: (S, [8]), 262: (S, [2]),
                           277: (S, [3]), 322: (L, [16]), 323: (L, [16])},
                          [fx.ENCODERS[8](bytes(16 * 16 * 3))], tiled=True)
    out["tile-likely-invalid"] = (_retag(tiled, 323, field=struct.pack("<I", 3735568)), "none")
    out["tile-large-but-plausible"] = (_retag(tiled, 323, field=struct.pack("<I", 65536)), "reads")
    # OpenCV's validateInputImageSize
    out["width-past-opencv-limit"] = (_retag(_rgb(1), 256, field=struct.pack("<I", (1 << 20) + 1)), "none")
    return out


PINNED = _pinned()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_pinned_directory_rules(tmp_path, name):
    """Each rule of libtiff's directory reader on a file made to need it:
    cv2 reads it (or returns None) as pinned, and the port's outcome is
    cv2's."""
    data, expect = PINNED[name]
    path = tmp_path / "f.tif"
    path.write_bytes(data)
    assert (reference(path) is not None) == (expect == "reads"), f"cv2 no longer {expect}: {name}"
    ok, what = outcome_matches(path)
    assert ok, (name, what)

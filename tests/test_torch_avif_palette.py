"""AVIF whose AV1 frame codes palettes (screen content tools on, intra
block copy off), against the JAX package's reader (``cv2.imread(path,
cv2.IMREAD_COLOR)``, OpenCV 5.0 with libavif 1.4 and libaom 3.14), bit
for bit: every entry of ``tests/data/torch_avif_palette_fixtures.npz``
(cv2's frames of a mask, flat blobs, label images and random low-colour
frames at speeds 0-8, 8, 10 and 12 bits, gray and BGR, lossless and lossy,
deblocked and with CDEF, palette sizes 2-8 in Y and UV, the colour cache,
V's delta coding; ``tools/av1_writer.py``'s palette frames in 4:2:2, lossy
4:4:4, 128x128 superblocks and two and four tiles; phase 22's 1024x768
and 2048x2048 frames) reads as cv2 reads it; the frame that allows intra
block copy, once refused by name, reads as cv2 reads it; the decoder's palette
CDFs hold the AV1 specification's values; a seeded fuzz of damaged and
cut copies gives cv2's outcome; and the JAX package's loader, evaluator
and size heuristic read cv2's palette frames as the port's."""

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
from deepemia_tpu_torch.ops.avif import AV1_TOOLS
from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_palette_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})
REFUSED = [n for n in NAMES if f"{n}/named" in FIXTURES.files]
READ = [n for n in NAMES if n not in REFUSED]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_torch_avif_palette_fixtures")
FIELDS = {n: dict(zip(TOOL.PALETTE_FIELDS, (int(v) for v in FIXTURES[f"{n}/fields"]))) for n in NAMES}


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


def _coded(name) -> dict:
    """What the port's decoder read in the frame's palettes: the palette
    sizes of Y and of UV, the colours taken from a cache, the V colours
    coded as deltas."""
    status, meta, _ = native.av1_decode(TOOL.fx.payload_of(FIXTURES[f"{name}/file"].tobytes())[0])
    assert status == 0, (name, status)
    return {"y": {n for n in range(2, 9) if meta[11] >> n & 1}, "uv": {n for n in range(2, 9) if meta[12] >> n & 1},
            "cached": int(meta[13]), "v_deltas": int(meta[14])}


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


def test_fixtures_cover_every_rule():
    """Every frame read allows screen content tools and not intra block
    copy. cv2's frames hold every speed 0-8, 8, 10 and 12 bits, gray and
    BGR, lossless and lossy, deblocking and CDEF, palette sizes 2-8 in Y
    and in UV, colours from the cache and V coded as deltas; the writer's
    hold 4:2:2, lossy 4:4:4, 128x128 superblocks, two and four tiles,
    each palette size in Y and UV and the cache; cv2's default speed
    writes the 2048² frame with no screen content tools."""
    for n in READ:
        f = FIELDS[n]
        assert f["screen_content"] == (n != "smoke-2048-speed9") and not f["intrabc"], n
    cv = [n for n in READ if n.startswith("cv2-")]
    assert {FIELDS[n]["speed"] for n in cv} == set(range(9))
    forms = {(FIELDS[n]["depth"], FIELDS[n]["mono"], FIELDS[n]["lossless"]) for n in cv}
    assert forms == {(d, m, l) for d in (8, 10, 12) for m in (0, 1) for l in (0, 1)}
    assert any(FIELDS[n]["deblocked"] for n in cv) and any(FIELDS[n]["cdef"] for n in cv)
    coded = {n: _coded(n) for n in READ if n != "smoke-2048-speed9"}
    for kind in ("y", "uv"):
        assert set().union(*(coded[n][kind] for n in cv)) == set(range(2, 9)), kind
    assert any(coded[n]["cached"] for n in cv) and any(coded[n]["v_deltas"] for n in cv)
    wr = [n for n in READ if n.startswith("writer-")]
    subs = {(FIELDS[n]["ssx"], FIELDS[n]["ssy"], FIELDS[n]["lossless"]) for n in wr if not FIELDS[n]["mono"]}
    assert {(1, 0, 0), (1, 0, 1), (0, 0, 0)} <= subs
    assert any(FIELDS[n]["sb128"] and not FIELDS[n]["lossless"] for n in wr)
    assert {FIELDS[n]["tiles"] for n in wr} == {1, 2, 4}
    for kind in ("y", "uv"):
        assert set().union(*(coded[n][kind] for n in wr)) == set(range(2, 9)), kind
    assert all(coded[n]["cached"] for n in wr if "mono" not in n)
    assert not coded["smoke-2048-palette"]["uv"] and coded["smoke-2048-palette"]["y"]


def test_intra_block_copy_is_refused_by_name(tmp_path):
    """The frame the port refused by name until it decoded intra block copy
    (its ``<name>/named`` the words of that refusal): ``AV1_TOOLS`` names
    neither intra block copy nor palettes or screen content tools, and
    phase 22's frame at speed 4, which allows intra block copy, reads to
    cv2's array (its SHA-256) bit for bit."""
    assert not any(w in words for words in AV1_TOOLS.values()
                   for w in ("intra block copy", "palette", "screen content"))
    for name in REFUSED:
        assert FIELDS[name]["screen_content"] and FIELDS[name]["intrabc"], name
        assert FIXTURES[f"{name}/named"].tobytes().decode() == "AV1 intra block copy"
        path = _write(tmp_path, name)
        assert _held(name, _cv2(path)), name
        got = read_image(str(path))
        assert hashlib.sha256(got.tobytes()).hexdigest() == FIXTURES[f"{name}/sha256"].tobytes().decode(), name
    assert REFUSED == ["refused-intrabc-smoke"]


def _table(name):
    text = (ROOT / "deepemia_tpu_torch" / "native" / "av1_tables.h").read_text()
    m = re.search(rf"\b{name}\b\s*(?:\[[^\]]*\]\s*)*=\s*\{{(.*?)\}};", text, re.S)
    return [int(v) for v in re.findall(r"-?\d+", m.group(1))]


def test_palette_cdfs_hold_the_specification_values():
    """The palette CDFs extracted from libaom hold the AV1 specification's
    Default_Palette_Y_Mode_Cdf, Default_Palette_Uv_Mode_Cdf,
    Default_Palette_Y_Size_Cdf, Default_Palette_Uv_Size_Cdf and the colour
    index CDFs of sizes 2 and 8 (first and last contexts), each record N
    values ending in 32768, then the counter."""
    assert _table("kPaletteYModeCdf")[:9] == [31676, 32768, 0, 3419, 32768, 0, 1261, 32768, 0]
    assert _table("kPaletteYModeCdf")[-9:] == [32450, 32768, 0, 7946, 32768, 0, 129, 32768, 0]
    assert _table("kPaletteUvModeCdf") == [32461, 32768, 0, 21488, 32768, 0]
    assert _table("kPaletteYSizeCdf")[:8] == [7952, 13000, 18149, 21478, 25527, 29241, 32768, 0]
    assert _table("kPaletteUvSizeCdf")[-8:] == [1269, 5435, 10433, 18963, 21700, 25865, 32768, 0]
    y, uv = _table("kPaletteYColorCdf"), _table("kPaletteUvColorCdf")
    assert len(y) == len(uv) == 7 * 5 * 9
    assert y[:3] == [28710, 32768, 0] and uv[:3] == [29089, 32768, 0]
    assert y[-9:] == [31028, 31270, 31504, 31705, 31927, 32153, 32392, 32768, 0]
    assert uv[-9:] == [31190, 31329, 31516, 31679, 31825, 32026, 32322, 32768, 0]


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("cv2-labels-bgr-bgr8-s8-q75", "cv2-labels-bgr-bgr10-s8-q100", "cv2-blobs-gray12-s3-q50",
              "writer-422-10-lossy")
# copies the port refuses by name: (where cv2 fails: the damage switches on a tool the port refuses in the
# header, and libaom fails on the rest of the stream; where cv2 reads). The q75 copy whose damage switches
# segmentation on, once named here, fails in the port as in cv2 now that segmentation is parsed
NAMED_COPIES = {"cv2-labels-bgr-bgr8-s8-q75": (0, 0), "cv2-labels-bgr-bgr10-s8-q100": (0, 0),
                "cv2-blobs-gray12-s3-q50": (0, 0), "writer-422-10-lossy": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None, the port raises a ``ValueError`` that is
    not ``UnsupportedImageError``; the copies the port refuses by name are
    counted as pinned. No copy crashes the decoder."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 240)
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


def test_phase22_palette_frame_holds_its_drawing(tmp_path):
    """Phase 22's palette frame (the flattened labelled frame with its
    colour, as cv2 writes it at speed 8) decodes to the SHA-256 of cv2's
    array and near the drawing it was written from; the tolerance is the
    one phase 22 holds it to."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    flat, _ = TOOL.lossy.smoke_frame()
    got = read_image(str(_write(tmp_path, "smoke-palette-bgr8")))
    assert _sha(got) == FIXTURES["smoke-palette-bgr8/sha256"].tobytes().decode()
    err = np.abs(got[..., 1].astype(np.int16) - flat - 12)
    assert err.max() <= chip_smoke.AVIF_PALETTE_FORMS["palette-bgr8"] and err.mean() < 2, (int(err.max()),
                                                                                             float(err.mean()))


def _palette_avif(img: np.ndarray) -> bytes:
    """cv2's AVIF of ``img`` at the first speed from 8 down whose frame codes palettes without intra block copy."""
    for speed in range(8, -1, -1):
        data = TOOL.cv2_lossy(img, None, 8, speed)
        if TOOL.takes_palettes(data):
            return data
    raise AssertionError("no cv2 frame with palettes")


@pytest.fixture(scope="module")
def palette_root(tmp_path_factory):
    """Four records whose images are cv2's AVIF files, with palettes, of the
    dataset's PNGs cut to levels 32 apart (each file named ``img<i>.png``
    as its label says), two of them in colour."""
    root = make_dataset(tmp_path_factory.mktemp("avif_palette") / "ds", 4, seed=24, size=(48, 64))
    for i in range(4):
        gray = cv2.imread(os.path.join(root, f"img{i}.png"), cv2.IMREAD_GRAYSCALE)
        levels = (gray // 32 * 32).astype(np.uint8)
        img = TOOL.lossy.smoke_bgr(levels) if i % 2 else levels
        Path(root, f"img{i}.png").write_bytes(_palette_avif(img))
    return root


def test_loaders_read_palette_frames_as_jax(palette_root):
    """The JAX loader and the port's on the same palette records: equal
    samples, plain and augmented."""
    files = sorted(f for f in os.listdir(palette_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(palette_root, f), palette_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_palette_frames_as_jax(tmp_path, monkeypatch, palette_root):
    """Both packages' ``evaluate_model`` over the four palette test records
    (models and inference replaced by stand-ins that record the images
    they get): every record is read, and the same arrays reach inference."""
    import deepemia_tpu.train.workflow as jax_wf
    import deepemia_tpu_torch.train.workflow as port_wf
    from test_torch_containers import _fake_eval, _register

    seen = {"jax": [], "port": []}
    metrics = {}
    for tag, wf, prefix, ds in (("jax", jax_wf, "deepemia_tpu", jax_ds),
                                ("port", port_wf, "deepemia_tpu_torch", port_ds)):
        _fake_eval(monkeypatch, prefix, tag == "port", seen[tag])
        split, config = _register(tmp_path, palette_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_size_heuristic_reads_palette_frames(palette_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads a
    palette frame rather than raise: its engine gets cv2's array."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    for i in range(4):
        path = os.path.join(palette_root, f"img{i}.png")
        try:
            calculate_average_mask_sizes(Engine(), [path], None)
        except StopIteration:
            pass
        assert len(seen) == i + 1 and np.array_equal(seen[i], _load_image(path)[0]), i

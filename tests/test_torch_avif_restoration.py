"""AVIF whose AV1 frame libaom filters with loop restoration, against the
JAX package's reader (``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0
with libavif 1.4 and libaom 3.14), bit for bit: every entry of
``tests/data/torch_avif_restoration_fixtures.npz`` (cv2's frames at speeds
0-4, 8 and 10 bits, BGR and gray, Wiener and self-guided units in luma and
chroma, 128 and 256 px units, CDEF before restoration, 1x97 to 300x300 and
phase 22's 1024x768 and 2048x2048 frames; cv2's 12-bit frames, which
leave restoration off; ``tools/av1_writer.py``'s SWITCHABLE frames, 64 px
units, ``lr_uv_shift`` 1, 4:4:4, 4:2:2 and 4:0:0, 12 bits, 128x128
superblocks, two and four tiles, every self-guided set and Wiener taps at
the ends of their ranges) reads as cv2 reads it; each writer frame reads
to another array with its units RESTORE_NONE, and the port reads that
one as cv2 does; film grain is still refused by name; a
seeded fuzz of damaged and cut copies gives cv2's outcome; and the JAX
package's loader, evaluator and size heuristic read cv2's restoration
frames as the port's."""

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
from deepemia_tpu_torch.ops.avif import AV1_TOOLS
from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_restoration_fixtures.npz")
CDEF_FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_cdef_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})
WRITERS = [n for n in NAMES if n.startswith("writer-")]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_torch_avif_restoration_fixtures")
LR = {n: dict(zip(TOOL.LR_FIELDS, (int(v) for v in FIXTURES[f"{n}/lr"]))) for n in NAMES}


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


def _write(tmp_path, name, data=None, key="file"):
    path = tmp_path / "f.avif"
    path.write_bytes(FIXTURES[f"{name}/{key}"].tobytes() if data is None else data)
    return path


def _applies(f) -> bool:
    return max(f["y"], f["u"], f["v"]) > 0


@pytest.mark.parametrize("name", NAMES)
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
    """The fixtures hold what restoration's rules turn on: cv2's frames at
    speeds 0-4, 8 and 10 bits, BGR and gray, Wiener and self-guided frame
    types in luma and chroma, 128 and 256 px units, CDEF before
    restoration, one-sample rows and columns, heights that are not a
    multiple of 8 and several 64-row stripes, its 12-bit frames without
    restoration; the writer's SWITCHABLE frames, 64 px units,
    ``lr_uv_shift`` 1, 4:4:4, 4:2:2, 4:0:0 and 12 bits, 128x128
    superblocks, two and four tiles, all 16 self-guided sets (r0 = 0 and r1
    = 0 among them), Wiener taps at their ends, CDEF before restoration,
    and units of each type, RESTORE_NONE too."""
    cv = {n: f for n, f in LR.items() if f["speed"] >= 0 and _applies(f)}
    assert {f["speed"] for f in cv.values()} == {0, 1, 2, 3, 4}
    for depth in (8, 10):
        for mono in (0, 1):
            forms = [f for f in cv.values() if f["depth"] == depth and f["mono"] == mono]
            assert {f["y"] for f in forms} >= {2, 3}, (depth, mono)
    chroma = {t for f in cv.values() if not f["mono"] for t in (f["u"], f["v"])}
    assert chroma >= {2, 3}
    assert {f["unit_shift"] for f in cv.values()} == {1, 2}
    assert any(f["cdef"] for f in cv.values())
    sizes = [(f["width"], f["height"]) for f in cv.values()]
    assert any(1 in s for s in sizes) and any(h % 8 and h > 120 for _, h in sizes)
    assert any(w % 2 and h % 2 for w, h in sizes) and (300, 300) in sizes
    assert all(f["speed"] > 2 or f["width"] * f["height"] <= 200 * 200 for n, f in cv.items() if "smoke" not in n)
    twelve = [f for f in LR.values() if f["speed"] >= 0 and f["depth"] == 12]
    assert twelve and not any(_applies(f) for f in twelve)
    wr = [LR[n] for n in WRITERS]
    assert all(_applies(f) for f in wr)
    assert any(1 in (f["y"], f["u"], f["v"]) for f in wr)  # SWITCHABLE
    assert {f["unit_shift"] for f in wr} == {0, 1, 2} and any(f["uv_shift"] for f in wr)
    for mono, ssx, ssy in ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)):
        assert {f["depth"] for f in wr if (f["mono"], f["ssx"], f["ssy"]) == (mono, ssx, ssy)} == {8, 10, 12}
    assert any(f["sb128"] for f in wr) and {f["tiles"] for f in wr} >= {1, 2, 4} and any(f["cdef"] for f in wr)
    units = np.concatenate([FIXTURES[f"{n}/units"] for n in WRITERS])
    sgr = units[units[:, 1] == 2]
    assert set(sgr[:, 2].tolist()) == set(range(16))
    assert set(units[:, 1].tolist()) == {0, 1, 2} and (units[:, 3] == 1).any()


@pytest.mark.parametrize("name", WRITERS)
def test_writer_frames_change_without_their_units(tmp_path, name):
    """Each writer frame with every unit rewritten to RESTORE_NONE (the
    frame's blocks unchanged): cv2 reads it to another array than the
    frame's, and the port reads it as cv2 does."""
    path = _write(tmp_path, name, key="plain")
    plain = _cv2(path)
    assert plain is not None and _sha(plain) == FIXTURES[f"{name}/plain_sha256"].tobytes().decode(), name
    np.testing.assert_array_equal(read_image(str(path)), plain, err_msg=name)
    assert not np.array_equal(plain, read_image(str(_write(tmp_path, name)))), name


def test_restoration_is_no_longer_refused(tmp_path):
    """``AV1_TOOLS`` names no loop restoration; film grain (the writer's
    frame) is still refused by name, where cv2 reads the frame."""
    assert not any("restoration" in words for words in AV1_TOOLS.values())
    assert "AV1 film grain" in AV1_TOOLS.values()
    path = tmp_path / "f.avif"
    path.write_bytes(CDEF_FIXTURES["refused-film-grain-420-8/file"].tobytes())
    assert _cv2(path) is not None
    with pytest.raises(UnsupportedImageError, match=re.escape("AV1 film grain")):
        read_image(str(path))


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("cv2-s4-q75-bgr8-257x255-unit128", "cv2-s4-q60-gray8-113x97-y-sgrproj",
              "writer-420-8-switchable-unit64-uv1", "writer-444-12-switchable-sb128-tiles4")
# copies the port refuses by name: (where cv2 fails, where cv2 reads)
NAMED_COPIES = {"cv2-s4-q75-bgr8-257x255-unit128": (0, 0), "cv2-s4-q60-gray8-113x97-y-sgrproj": (0, 0),
                "writer-420-8-switchable-unit64-uv1": (0, 0), "writer-444-12-switchable-sb128-tiles4": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None, the port raises a ``ValueError`` that is
    not ``UnsupportedImageError``; the copies the port refuses by name are
    counted as pinned. No copy crashes the decoder."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 230)
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
# Phase 22's frames, the loader, the evaluator and the size heuristic
# ---------------------------------------------------------------------------


def test_phase22_restoration_frames_hold_their_drawing(tmp_path):
    """Phase 22's restoration frames (the labelled frame with its texture,
    as cv2 writes it at speed 4) decode to the SHA-256 of cv2's array and
    within a few levels of the textured drawing they were written from."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    flat, _ = TOOL.lossy.smoke_frame()
    for name, tol in chip_smoke.AVIF_RESTORATION_FORMS.items():
        name = f"smoke-{name}"
        got = read_image(str(_write(tmp_path, name)))
        assert _sha(got) == FIXTURES[f"{name}/sha256"].tobytes().decode(), name
        tex = chip_smoke.avif_textured(flat, int(FIXTURES[f"{name}/strength"][0])).astype(np.int16)
        err = np.abs(got[..., 1].astype(np.int16) - tex - (12 if "bgr" in name else 0))
        assert err.max() <= tol and err.mean() < 2, (name, int(err.max()), float(err.mean()))


def _restoration_avif(img: np.ndarray, depth: int) -> bytes:
    """cv2's AVIF of ``img`` at the first speed (4, then 2) and quality
    whose frame applies loop restoration."""
    for speed in (4, 2):
        for q in (75, 85, 95, 99):
            data = TOOL.cv2_lossy(img, q, depth, speed)
            if _applies(TOOL.lr_fields(data)):
                return data
    raise AssertionError("no cv2 frame with restoration")


@pytest.fixture(scope="module")
def lr_root(tmp_path_factory):
    """Four records whose images are cv2's AVIF files, with loop
    restoration, of the dataset's PNGs averaged with blurred noise (libaom
    restores none of the plain ones at this size): BGR at 8 and 10 bits
    (each file named ``img<i>.png`` as its label says)."""
    root = make_dataset(tmp_path_factory.mktemp("avif_lr") / "ds", 4, seed=23, size=(48, 64))
    for i in range(4):
        img = cv2.imread(os.path.join(root, f"img{i}.png")).astype(np.int16)
        img = np.clip(img // 2 + TOOL.blurred(48, 64, i, 3).astype(np.int16) // 2, 0, 255).astype(np.uint8)
        depth = (8, 10, 8, 10)[i]
        if depth > 8:
            img = img.astype(np.uint16) << (depth - 8)
        Path(root, f"img{i}.png").write_bytes(_restoration_avif(img, depth))
    return root


def test_loaders_read_restoration_frames_as_jax(lr_root):
    """The JAX loader and the port's on the same restoration records:
    equal samples, plain and augmented."""
    files = sorted(f for f in os.listdir(lr_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(lr_root, f), lr_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_restoration_frames_as_jax(tmp_path, monkeypatch, lr_root):
    """Both packages' ``evaluate_model`` over the four restoration test
    records (models and inference replaced by stand-ins that record the
    images they get): every record is read, and the same arrays reach
    inference."""
    import deepemia_tpu.train.workflow as jax_wf
    import deepemia_tpu_torch.train.workflow as port_wf
    from test_torch_containers import _fake_eval, _register

    seen = {"jax": [], "port": []}
    metrics = {}
    for tag, wf, prefix, ds in (("jax", jax_wf, "deepemia_tpu", jax_ds),
                                ("port", port_wf, "deepemia_tpu_torch", port_ds)):
        _fake_eval(monkeypatch, prefix, tag == "port", seen[tag])
        split, config = _register(tmp_path, lr_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_size_heuristic_reads_restoration_frames(lr_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads a
    restoration frame rather than raise: its engine gets cv2's array."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    for i in range(4):
        path = os.path.join(lr_root, f"img{i}.png")
        try:
            calculate_average_mask_sizes(Engine(), [path], None)
        except StopIteration:
            pass
        assert len(seen) == i + 1 and np.array_equal(seen[i], _load_image(path)[0]), i

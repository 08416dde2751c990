"""AVIF whose AV1 frame libaom deblocks, against the JAX package's reader
(``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with libavif 1.4 and
libaom 3.14), bit for bit: every entry of
``tests/data/torch_avif_deblock_fixtures.npz`` (cv2's files at the
qualities where libaom deblocks and applies no CDEF, at 8, 10 and 12 bits,
BGR and gray, 1x1 to 512x512, with TX_MODE_SELECT; cv2's lower qualities
with the CDEF strengths rewritten to 0; header rewrites of sharpness,
levels and the INTRA_FRAME delta; ``tools/av1_writer.py``'s lossy 4:4:4,
4:2:2 and 4:2:0 frames) reads as cv2 reads it; a seeded fuzz of damaged and
cut copies gives cv2's outcome; CDEF frames, with deblocking and without,
read as cv2 reads them, and so do the writer's frames with loop
restoration and with delta loop filter levels; film grain is still
refused by name; the JAX package's loader,
evaluator and size heuristic read cv2's quality-85 frames as the port's;
and YCgCo-Re (C13) reads as cv2 reads it at 10 bits and full range, and is
refused where cv2 returns None."""

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
import deepemia_tpu_torch.data.datasets as port_ds
import deepemia_tpu_torch.data.loader as port_loader
from deepemia_tpu.inference.pipeline import _load_image
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_deblock_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})
LOSSY = np.load(ROOT / "tests" / "data" / "torch_avif_lossy_fixtures.npz")
C13 = sorted({k.split("/")[0] for k in LOSSY.files if k.startswith("c13-")})
# [Y vertical level, Y horizontal, U, V, sharpness, INTRA_FRAME delta, TX_MODE_SELECT, 128x128 superblocks]
LF = {n: tuple(int(v) for v in FIXTURES[f"{n}/lf"]) for n in NAMES}


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cv2(path):
    try:
        return cv2.imread(str(path), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def _held(fixtures, name, ref):
    """Whether cv2's array here is the one the fixture file holds."""
    if f"{name}/none" in fixtures.files:
        return ref is None
    if ref is None:
        return False
    if f"{name}/bgr" in fixtures.files:
        return np.array_equal(ref, fixtures[f"{name}/bgr"])
    return hashlib.sha256(ref.tobytes()).hexdigest() == fixtures[f"{name}/sha256"].tobytes().decode()


def _write(tmp_path, name, fixtures=FIXTURES):
    path = tmp_path / "f.avif"
    path.write_bytes(fixtures[f"{name}/file"].tobytes())
    return path


@pytest.mark.parametrize("name", NAMES)
def test_fixture_reads_as_opencv(tmp_path, name):
    """Each fixture: cv2 here reads it as when it was written, and the port
    reads it to the same array bit for bit."""
    path = _write(tmp_path, name)
    ref = _cv2(path)
    assert _held(FIXTURES, name, ref), name
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape, name
    np.testing.assert_array_equal(got, ref, err_msg=name)


def test_fixtures_cover_the_loop_filter():
    """The fixtures hold what the filter's rules turn on: deblocking at
    every quality and depth of the table, levels 3-19 from cv2's lower
    qualities, each level 0 alone, levels both sides of 32, sharpness 0-7,
    the INTRA_FRAME delta from -64 to 63 and off, TX_MODE_SELECT, 128x128
    superblocks, every subsampling, 1x1 and 512x512."""
    deblock = _tool("make_torch_avif_deblock_fixtures")
    for depth, qualities in deblock.DEBLOCK_QUALITIES.items():
        for q in qualities:
            for form in ("bgr", "gray"):
                assert any(LF[n][:2] != (0, 0) for n in NAMES if n.startswith(f"q{q}-{form}{depth}-")), (q, form, depth)
    levels = {LF[n][0] for n in NAMES if n.startswith("nocdef-")}
    assert min(levels) <= 3 and max(levels) >= 19, levels
    lf = set(LF.values())
    assert any(v[0] == 0 and v[1] for v in lf) and any(v[1] == 0 and v[0] for v in lf)
    assert any(v[2] == 0 and v[3] for v in lf) and any(v[3] == 0 and v[2] for v in lf)
    assert any(v[0] >= 32 for v in lf) and any(0 < v[0] < 32 for v in lf)
    assert {v[4] for v in lf} == set(range(8))
    assert {-64, -1, 0, 1, 63} <= {v[5] for v in lf}
    assert any(v[6] for v in lf) and any(v[7] for v in lf)
    for prefix in ("writer-444-8", "writer-444-10", "writer-444-12", "writer-422-8", "writer-422-10", "writer-422-12",
                   "writer-420-", "writer-444-8-identity", "size-bgr8-1x1", "size-gray10-1x1", "size-bgr8-512x512",
                   "txsel-bgr", "txsel-gray"):
        assert any(n.startswith(prefix) for n in NAMES), prefix


def _decoded(name):
    """cv2's array, or its SHA-256, as the fixture holds it."""
    if f"{name}/bgr" in FIXTURES.files:
        return FIXTURES[f"{name}/bgr"].tobytes()
    return FIXTURES[f"{name}/sha256"].tobytes()


@pytest.mark.parametrize("group", ["lf-bgr8-sharpness", "lf-bgr8-levels", "lf-bgr8-delta", "lf-bgr10-",
                                   "lf-bgr12-", "lf-gray8-", "lf-gray12-"])
def test_rewrites_probe_the_filter(group):
    """Each group of header rewrites changes what cv2 reads: no two
    parameter sets give one array, but where the rules say they must
    (sharpness 0 and 1 at a level the cap does not reach, say) at most
    half of a group agrees."""
    names = [n for n in NAMES if n.startswith(group)]
    assert len(names) >= 5, group
    assert len({_decoded(n) for n in names}) > len(names) // 2, group


def test_writer_frames_deblock(tmp_path):
    """The writer's lossy frames: their loop filter changes the pixels
    (cv2 reads each rewritten with levels 0 to another array), so each
    probes the filter at its subsampling."""
    deblock = _tool("make_torch_avif_deblock_fixtures")
    path = tmp_path / "plain.avif"
    for name in (n for n in NAMES if n.startswith("writer-")):
        data = FIXTURES[f"{name}/file"].tobytes()
        payload = deblock.hd.rewrite_loop_filter(deblock.fx.payload_of(data)[0], levels=(0, 0, 0, 0))
        path.write_bytes(deblock.with_payload(data, payload))
        unfiltered = _cv2(path)
        assert unfiltered is not None and not np.array_equal(unfiltered, read_image(str(_write(tmp_path, name)))), name


# ---------------------------------------------------------------------------
# The in-loop filters still refused
# ---------------------------------------------------------------------------


def test_filters_other_than_deblocking_are_named(tmp_path):
    """Film grain (the writer's frame, three luma points): cv2 reads it;
    ``UnsupportedImageError`` naming the tool, never an array. CDEF (with
    deblocking or without), loop restoration (the writer's frame with
    Wiener luma units, which its tiles now carry) and delta loop filter
    levels (each superblock's deltas 0), once refused here too: cv2 and
    the port read each frame to the same array, bit for bit."""
    deblock = _tool("make_torch_avif_deblock_fixtures")
    aw, fx = deblock.aw, deblock.fx
    lossy = np.load(ROOT / "tests" / "data" / "torch_avif_lossy_fixtures.npz")
    cases = [(lossy[f"{n}/file"].tobytes(), None, True) for n in ("filter-q75-bgr8-61x45", "filter-cdef-bgr8-61x45",
                                                                "smoke-q75")]
    for tool, words, cv2_reads in (("delta_lf", None, True), ("restoration", None, True),
                                   ("film_grain", "AV1 film grain", True)):
        for sub, depth in (((1, 1), 8), ((1, 0), 10), ((0, 0), 12)):
            y = np.zeros((40, 72), np.int64)
            c = np.zeros(((40 + sub[1]) >> sub[1], (72 + sub[0]) >> sub[0]), np.int64)
            setting = {"types": (2, 0, 0), "unit_shift": 0} if tool == "restoration" else True
            lossy_params = {"q": 12, "levels": (5, 7, 3, 2), "sharpness": 1, "delta": 1}
            grain = depth if tool == "film_grain" else None
            if grain is None:
                lossy_params[tool] = setting
            payload = aw.encode([y, c, c], depth, subsampling=sub, matrix=1, seed=depth, lossy=lossy_params,
                                film_grain=grain)
            data = fx.avif([fx.image_item(payload, aw.av1c(depth, False, sub), 72, 40, depth, 3,
                                          fx.colr_nclx(1, 13, 1, 1))])
            cases.append((data, words, cv2_reads))
    path = tmp_path / "f.avif"
    for data, words, cv2_reads in cases:
        path.write_bytes(data)
        ref = _cv2(path)
        if cv2_reads:
            assert ref is not None, words
        if words is None:  # CDEF, loop restoration, delta LF
            np.testing.assert_array_equal(read_image(str(path)), ref)
            continue
        with pytest.raises(UnsupportedImageError, match=re.escape(words)):
            read_image(str(path))


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("q85-bgr8-53x37", "q90-gray12-41x29", "txsel-bgr-77x65", "nocdef-q50-bgr10-61x45",
              "writer-422-10-53x37-sb64")
# copies the port refuses by name: (where cv2 fails, where cv2 reads): none (one copy of q85-bgr8-53x37 whose
# damage switches CDEF on, refused until the port applied CDEF, now reads as cv2 reads it)
NAMED_COPIES = {"q85-bgr8-53x37": (0, 0), "q90-gray12-41x29": (0, 0), "txsel-bgr-77x65": (0, 0),
                "nocdef-q50-bgr10-61x45": (0, 0), "writer-422-10-53x37-sb64": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None, the port raises a ``ValueError``; the
    copies the port refuses by name are counted as pinned. No copy
    crashes the decoder."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 90)
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
# The loader, the evaluator and the size heuristic
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deblocked_root(tmp_path_factory):
    """Four records whose images are cv2's deblocked AVIF files of the
    dataset's PNGs: BGR and gray at quality 85, BGR at 10 bits and gray at
    12 at quality 90 (each file named ``img<i>.png`` as its label says)."""
    root = make_dataset(tmp_path_factory.mktemp("avif_deblock") / "ds", 4, seed=21, size=(48, 64))
    hd, fx = _tool("av1_headers"), _tool("make_torch_avif_fixtures")
    for i in range(4):
        img = cv2.imread(os.path.join(root, f"img{i}.png"))
        params = [cv2.IMWRITE_AVIF_QUALITY, 85]
        if i in (1, 3):
            img = img[..., 1]
        if i >= 2:
            img = img.astype(np.uint16) << (2 if i == 2 else 4)
            params = [cv2.IMWRITE_AVIF_QUALITY, 90, cv2.IMWRITE_AVIF_DEPTH, 10 if i == 2 else 12]
        ok, buf = cv2.imencode(".avif", img, params)
        assert ok and any(hd.fields(fx.payload_of(buf.tobytes())[0])["loop_filter"]), i
        Path(root, f"img{i}.png").write_bytes(buf.tobytes())
    return root


def test_loaders_read_deblocked_frames_as_jax(deblocked_root):
    """The JAX loader and the port's on the same deblocked records: equal
    samples, plain and augmented."""
    files = sorted(f for f in os.listdir(deblocked_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(deblocked_root, f), deblocked_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_deblocked_frames_as_jax(tmp_path, monkeypatch, deblocked_root):
    """Both packages' ``evaluate_model`` over the four deblocked test
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
        split, config = _register(tmp_path, deblocked_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_size_heuristic_reads_deblocked_frames(deblocked_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads a
    deblocked frame rather than raise: its engine gets cv2's array."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    for i in range(4):
        path = os.path.join(deblocked_root, f"img{i}.png")
        try:
            calculate_average_mask_sizes(Engine(), [path], None)
        except StopIteration:
            pass
        assert len(seen) == i + 1 and np.array_equal(seen[i], _load_image(path)[0]), i


def test_phase22_deblocked_frames_hold_their_drawing(tmp_path):
    """Phase 22's deblocked frames (cv2's quality 85 BGR, quality 90 at 10
    bits BGR and 12 bits gray) decode to the SHA-256 of cv2's array and
    within a few levels of the drawing they were written from."""
    flat, _ = _tool("make_torch_avif_lossy_fixtures").smoke_frame()
    for name, tol in (("smoke-bgr85", 22), ("smoke-bgr10-90", 8), ("smoke-gray12-90", 8)):
        got = read_image(str(_write(tmp_path, name, LOSSY)))
        assert hashlib.sha256(got.tobytes()).hexdigest() == LOSSY[f"{name}/sha256"].tobytes().decode(), name
        err = np.abs(got[..., 1].astype(np.int16) - flat - (12 if name.startswith("smoke-bgr") else 0))
        assert err.max() <= tol and err.mean() < 1.0, (name, int(err.max()), float(err.mean()))


# ---------------------------------------------------------------------------
# C13: YCgCo-Re
# ---------------------------------------------------------------------------


def test_ycgco_re_reads_as_opencv_at_10_bits_full_range(tmp_path):
    """The writer's YCgCo-Re (matrix 16) frames at 4:4:4, 4:2:2 and 4:2:0,
    odd sizes, colour primaries 1, 9 and 12: cv2 reads those at 10 bits
    and full range, and the port reads them to the same array bit for bit;
    at 8 and 12 bits and at limited range ``cv2.imread(...) is None``, and
    the port raises ``RefusedImageError``, which the loaders skip as
    OpenCV refused."""
    assert len(C13) >= 30
    read = set()
    for name in C13:
        path = _write(tmp_path, name, LOSSY)
        ref = _cv2(path)
        assert _held(LOSSY, name, ref), name
        if "-10-full-" in name:
            assert ref is not None, name
            np.testing.assert_array_equal(read_image(str(path)), ref, err_msg=name)
            read.add(name.split("-")[1])
        else:
            assert ref is None, name
            with pytest.raises(RefusedImageError, match="YCgCo-Re"):
                read_image(str(path))
    assert read == {"444", "422", "420"}

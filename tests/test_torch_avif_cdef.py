"""AVIF whose AV1 frame libaom filters with CDEF, against the JAX package's
reader (``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with libavif
1.4 and libaom 3.14), bit for bit: every entry of
``tests/data/torch_avif_cdef_fixtures.npz`` (cv2's files at every quality
of its CDEF table and its default, at 8, 10 and 12 bits, BGR and gray, 1x1
to 512x512, with TX_MODE_SELECT; cv2's chroma-strength and two-entry
frames at speeds 0-6; header rewrites of the damping and every strength;
``tools/av1_writer.py``'s lossy 4:4:4, 4:2:2, 4:2:0 and 4:0:0 frames with
``cdef_bits`` 0-3, 128x128 superblocks and 64x64s that skip) reads as cv2
reads it; each rewrite group changes what cv2 reads; cv2's speed-4 frame
with loop restoration and the writer's frame with delta loop filter
levels, once refused by name, read as cv2 reads them, and film grain is
still refused by name; a seeded fuzz of
damaged and cut copies gives cv2's outcome; the JAX package's loader,
evaluator and size heuristic read cv2's default-quality frames as the
port's; and (C15) a box nested in ``meta`` with size 0 fails as libavif
fails on it."""

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
from deepemia_tpu_torch.ops.avif import AV1_TOOLS
from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_cdef_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})
# the frames the port still refuses -> the words of the refusal
NAMED = {n: FIXTURES[f"{n}/named"].tobytes().decode() for n in NAMES if f"{n}/named" in FIXTURES.files}
READ = [n for n in NAMES if n not in NAMED]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_torch_avif_cdef_fixtures")


def _cdef(name) -> dict:
    """The fixture's ``<name>/cdef`` as {field: value, "entries": [[Y
    primary, Y secondary, UV primary, UV secondary]]} (-1: none)."""
    v = [int(x) for x in FIXTURES[f"{name}/cdef"]]
    k = len(TOOL.CDEF_FIELDS)
    out = dict(zip(TOOL.CDEF_FIELDS, v[:k]))
    out["entries"] = [v[k + 4 * i : k + 4 * i + 4] for i in range(1 << out["bits"])]
    return out


CDEF = {n: _cdef(n) for n in READ}


def _cv2(path):
    try:
        return cv2.imread(str(path), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def _held(name, ref) -> bool:
    """Whether cv2's array here is the one the fixture file holds."""
    if ref is None:
        return False
    if f"{name}/bgr" in FIXTURES.files:
        return np.array_equal(ref, FIXTURES[f"{name}/bgr"])
    return hashlib.sha256(ref.tobytes()).hexdigest() == FIXTURES[f"{name}/sha256"].tobytes().decode()


def _decoded(name) -> bytes:
    """cv2's array, or its SHA-256, as the fixture holds it."""
    return FIXTURES[f"{name}/bgr" if f"{name}/bgr" in FIXTURES.files else f"{name}/sha256"].tobytes()


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


def _applies(c) -> bool:
    return any(v > 0 for e in c["entries"] for v in e)


def test_fixtures_cover_every_rule():
    """The fixtures hold what CDEF's rules turn on: damping 3-6, every Y
    and UV primary (0-15) and secondary (0-3) strength, a primary without
    a secondary and the reverse, chroma strengths, index bits 0-3, every
    subsampling and depth, 128x128 superblocks, 64x64s whose blocks all
    skip, TX_MODE_SELECT, odd sizes from 1x1 to 512x512, and cv2's table at
    every quality and depth."""
    filtered = [c for c in CDEF.values() if _applies(c)]
    assert {c["damping"] for c in filtered} == {3, 4, 5, 6}
    entries = [e for c in filtered for e in c["entries"]]
    assert {e[0] for e in entries} == set(range(16)) and {e[1] for e in entries} == set(range(4))
    uv = [e for e in entries if e[2] >= 0]  # frames with chroma
    assert {e[2] for e in uv} == set(range(16)) and {e[3] for e in uv} == set(range(4))
    for k in (0, 2):  # Y, UV: a primary alone, a secondary alone
        assert any(e[k] > 0 and e[k + 1] == 0 for e in entries) and any(e[k] == 0 and e[k + 1] > 0 for e in entries)
    assert any(c["entries"][0][2] > 0 for n, c in CDEF.items() if n.startswith("speed"))  # cv2's chroma strengths
    assert {c["bits"] for c in filtered} == {0, 1, 2, 3}
    forms = {(c["mono"], c["ssx"], c["ssy"], c["depth"]) for c in filtered}
    for mono, ssx, ssy in ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)):
        for depth in (8, 10, 12):
            assert (mono, ssx, ssy, depth) in forms, (mono, ssx, ssy, depth)
    assert any(c["sb128"] for c in filtered) and any(c["skip64"] for c in filtered)
    assert any(c["tx_mode_select"] for c in filtered)
    sizes = {(c["width"], c["height"]) for c in filtered}
    assert (1, 1) in sizes and (512, 512) in sizes and (53, 37) in sizes and (193, 129) in sizes
    assert any(w % 8 and h % 8 and w > 64 and h > 64 for w, h in sizes)
    for q in TOOL.CDEF_QUALITIES:
        for form in ("bgr", "gray"):
            for depth in (8, 10, 12):
                assert any(n.startswith(f"q{q or 'default'}-{form}{depth}-") for n in CDEF), (q, form, depth)
    assert any(c["bits"] == 1 and not n.startswith("writer") for n, c in CDEF.items())  # cv2's two-entry frames


def _groups():
    return sorted({n.rstrip("0123456789") for n in NAMES if n.startswith("rw-")})


@pytest.mark.parametrize("group", _groups())
def test_rewrites_change_what_opencv_reads(group):
    """Each group of header rewrites (one parameter stepped) gives cv2 a
    different array at every step: no two of its frames decode alike."""
    names = [n for n in NAMES if n.rstrip("0123456789") == group]
    assert len(names) >= 4, group
    assert len({_decoded(n) for n in names}) == len(names), group


def test_writer_frames_apply_cdef(tmp_path):
    """The writer's lossy frames: cv2 reads each rewritten with every
    strength 0 to another array (CDEF changes its pixels), and the port
    reads that unfiltered frame as cv2 does too."""
    path = tmp_path / "zero.avif"
    writers = [n for n in READ if n.startswith("writer-")]
    assert len(writers) == 12
    for name in writers:
        data = FIXTURES[f"{name}/file"].tobytes()
        payload = TOOL.fx.payload_of(data)[0]
        zero = [[0] * (2 if CDEF[name]["mono"] else 4)] * (1 << CDEF[name]["bits"])
        path.write_bytes(TOOL.with_payload(data, TOOL.hd.rewrite_cdef(payload, strengths=zero)))
        unfiltered = _cv2(path)
        assert unfiltered is not None and not np.array_equal(unfiltered, read_image(str(_write(tmp_path, name)))), name
        np.testing.assert_array_equal(read_image(str(path)), unfiltered, err_msg=name)


def test_cdef_is_no_longer_refused():
    """Neither CDEF, loop restoration nor delta loop filter levels is
    named as a tool the port lacks; film grain is."""
    assert not any("CDEF" in words or "restoration" in words or "delta" in words for words in AV1_TOOLS.values())
    assert "AV1 film grain" in AV1_TOOLS.values()


@pytest.mark.parametrize("name", ["refused-delta-lf-420-8", "refused-restoration-bgr8-128x128",
                                  "refused-film-grain-420-8"])
def test_restoration_and_delta_lf_are_named(tmp_path, name):
    """The writer's frame with film grain: cv2 reads it (grain applied);
    the port raises ``UnsupportedImageError`` naming the tool. cv2's frame
    with loop restoration (speed 4) and the writer's with delta loop filter
    levels (each superblock's deltas 0), once refused by name too: the
    port reads each to cv2's array."""
    path = _write(tmp_path, name)
    ref = _cv2(path)
    assert _held(name, ref), name
    if name not in NAMED:
        np.testing.assert_array_equal(read_image(str(path)), ref)
        return
    with pytest.raises(UnsupportedImageError, match=re.escape(NAMED[name])):
        read_image(str(path))


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("qdefault-bgr8-53x37", "q20-gray12-41x29", "speed4-q20-bgr8-80x64", "rw-bits1-entries2",
              "writer-422-8-136x72-bits3-sb128")
# copies the port refuses by name: (where cv2 fails, where cv2 reads): the damage changes the ispe, which libavif
# would scale the frame to
NAMED_COPIES = {"qdefault-bgr8-53x37": (0, 0), "q20-gray12-41x29": (0, 3), "speed4-q20-bgr8-80x64": (0, 0),
                "rw-bits1-entries2": (0, 0), "writer-422-8-136x72-bits3-sb128": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None, the port raises a ``ValueError`` that is
    not ``UnsupportedImageError``; the copies the port refuses by name are
    counted as pinned. No copy crashes the decoder."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 120)
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
def cdef_root(tmp_path_factory):
    """Four records whose images are cv2's AVIF files of the dataset's PNGs
    at its default quality (CDEF and deblocking): BGR and gray at 8 bits,
    BGR at 10 bits and gray at 12 (each file named ``img<i>.png`` as its
    label says)."""
    root = make_dataset(tmp_path_factory.mktemp("avif_cdef") / "ds", 4, seed=22, size=(48, 64))
    for i in range(4):
        img = cv2.imread(os.path.join(root, f"img{i}.png"))
        if i in (1, 3):
            img = img[..., 1]
        depth = (8, 8, 10, 12)[i]
        if depth > 8:
            img = img.astype(np.uint16) << (depth - 8)
        data = TOOL.cv2_lossy(img, None, depth)
        assert any(any(e) for e in TOOL.hd.fields(TOOL.fx.payload_of(data)[0])["cdef_strengths"]), i
        Path(root, f"img{i}.png").write_bytes(data)
    return root


def test_loaders_read_cdef_frames_as_jax(cdef_root):
    """The JAX loader and the port's on the same default-quality records:
    equal samples, plain and augmented."""
    files = sorted(f for f in os.listdir(cdef_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(cdef_root, f), cdef_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_cdef_frames_as_jax(tmp_path, monkeypatch, cdef_root):
    """Both packages' ``evaluate_model`` over the four default-quality test
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
        split, config = _register(tmp_path, cdef_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_size_heuristic_reads_cdef_frames(cdef_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads a
    default-quality frame rather than raise: its engine gets cv2's
    array."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    for i in range(4):
        path = os.path.join(cdef_root, f"img{i}.png")
        try:
            calculate_average_mask_sizes(Engine(), [path], None)
        except StopIteration:
            pass
        assert len(seen) == i + 1 and np.array_equal(seen[i], _load_image(path)[0]), i


def test_phase22_cdef_frames_hold_their_drawing(tmp_path):
    """Phase 22's CDEF frames (cv2's default quality, BGR; quality 75 at 10
    bits, BGR; the default at 12 bits, gray) decode to the SHA-256 of cv2's
    array and within a few levels of the drawing they were written from;
    so does the 2048² default-quality raster of the decode time."""
    flat, _ = TOOL.lossy.smoke_frame()
    for name, tol in (("smoke-bgr-default", 104), ("smoke-bgr10-75", 32), ("smoke-gray12-default", 56)):
        got = read_image(str(_write(tmp_path, name)))
        assert hashlib.sha256(got.tobytes()).hexdigest() == FIXTURES[f"{name}/sha256"].tobytes().decode(), name
        err = np.abs(got[..., 1].astype(np.int16) - flat - (12 if name.startswith("smoke-bgr") else 0))
        assert err.max() <= tol and err.mean() < 0.5, (name, int(err.max()), float(err.mean()))
    got = read_image(str(_write(tmp_path, "smoke-2048-default")))
    assert hashlib.sha256(got.tobytes()).hexdigest() == FIXTURES["smoke-2048-default/sha256"].tobytes().decode()


# ---------------------------------------------------------------------------
# C15: a nested box of size 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [b"hdlr", b"pitm", b"iloc", b"iinf", b"iprp", b"ispe", b"colr", b"ipma"])
def test_nested_box_of_size_zero_fails_as_opencv(tmp_path, kind):
    """A box inside ``meta`` whose size field reads 0 (to the end of the
    file, which ISO BMFF allows at the top level only): libavif fails on
    the file and ``cv2.imread`` returns None; the port raises a
    ``ValueError`` that is not ``UnsupportedImageError``, as every reader
    skips it (the fuzz of cv2's default-quality frame found it)."""
    data = bytearray(FIXTURES["qdefault-bgr8-53x37/file"].tobytes())
    k = data.index(kind) - 4
    data[k : k + 4] = bytes(4)
    path = _write(tmp_path, "qdefault-bgr8-53x37", bytes(data))
    assert _cv2(path) is None, kind
    with pytest.raises(ValueError) as e:
        read_image(str(path))
    assert not isinstance(e.value, UnsupportedImageError), (kind, e.value)

"""AVIF whose AV1 frame codes delta loop filter levels, against the JAX
package's reader (``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with
libavif 1.4 and libaom 3.14), bit for bit: every entry of
``tests/data/torch_avif_delta_lf_fixtures.npz`` (``tools/av1_writer.py``'s
frames: every subsampling at 8, 10 and 12 bits, one delta or one per plane
and direction, every multiplier, running deltas at the +-63 clamp, a luma
level of 0 raised per block, a chroma level of 0 left unfiltered whatever
its deltas, 128x128 superblocks, two tile rows, CDEF and loop restoration
on top, reduced_tx_set 1) reads as cv2 reads it; no tool in ``AV1_TOOLS``
names delta LF; a seeded fuzz of damaged and cut copies gives cv2's
outcome; and the JAX package's loader, evaluator and size heuristic read
delta-LF records as the port's."""

import hashlib
import importlib.util
import os
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
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_delta_lf_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_torch_avif_delta_lf_fixtures")
FIELDS = {n: dict(zip(TOOL.FIELDS, (int(v) for v in FIXTURES[f"{n}/fields"]))) for n in NAMES}
CODED = {n: TOOL.coded(FIXTURES[f"{n}/file"].tobytes()) for n in NAMES}


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


def test_fixtures_cover_every_path():
    """Every frame but two codes delta LF, and all but the zero twin code a
    delta that is not 0. Between them they take every path of the
    decoder's (deltas per plane and direction, a multiplier above 1, the
    clamp, an edge filtered in a pass at level 0, a tile reset), every
    subsampling at 8, 10 and 12 bits, delta_lf_multi 0 and 1, every
    delta_lf_res, a luma level of 0 in each direction, a chroma level of
    0, 128x128 superblocks, two tile rows, CDEF and loop restoration on
    top, and reduced_tx_set 1 with delta LF and without."""
    dlf = [n for n in NAMES if FIELDS[n]["delta_lf_present"]]
    assert sorted(set(NAMES) - set(dlf)) == ["reduced-420-8"]
    assert [n for n in dlf if not CODED[n]["blocks"]] == ["timing-1024-zero-deltas"]
    assert set().union(*(CODED[n]["paths"] for n in dlf)) == set(TOOL.PATHS)
    forms = {(FIELDS[n]["mono"], FIELDS[n]["ssx"], FIELDS[n]["ssy"], FIELDS[n]["depth"]) for n in dlf}
    for mono, ssx, ssy in ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)):
        for depth in (8, 10, 12):
            assert (mono, ssx, ssy, depth) in forms, (mono, ssx, ssy, depth)
    assert {FIELDS[n]["delta_lf_multi"] for n in dlf} == {0, 1}
    assert {FIELDS[n]["delta_lf_res"] for n in dlf} == {0, 1, 2, 3}
    for k in ("level_y_v", "level_y_h"):
        assert any(FIELDS[n][k] == 0 and "base-zero" in CODED[n]["paths"] for n in dlf), k
    assert any(FIELDS[n]["level_y_v"] == 0 and not FIELDS[n]["lf_delta_enabled"] and "base-zero" in CODED[n]["paths"]
               for n in dlf)  # the deltas alone raise the pass's level
    for k in ("level_u", "level_v"):
        assert any(FIELDS[n][k] == 0 and not FIELDS[n]["mono"] and (FIELDS[n]["level_y_v"] or FIELDS[n]["level_y_h"])
                   for n in dlf), k
    assert any(FIELDS[n]["sb128"] for n in dlf)
    assert any(FIELDS[n]["tile_rows"] == 2 and "tile-reset" in CODED[n]["paths"] for n in dlf)
    assert any(FIELDS[n]["cdef"] for n in dlf) and any(FIELDS[n]["restoration"] for n in dlf)
    assert {FIELDS[n]["delta_lf_present"] for n in NAMES if FIELDS[n]["reduced_tx_set"]} == {0, 1}


def test_delta_lf_is_no_longer_refused():
    """No entry of ``AV1_TOOLS`` names delta loop filter levels; the tools
    still refused by name stay named."""
    assert not any("delta" in words or "loop filter" in words for words in AV1_TOOLS.values())
    for words in ("AV1 superres", "AV1 film grain"):
        assert words in AV1_TOOLS.values(), words


def test_zero_deltas_twin_reads_apart(tmp_path):
    """Phase 22's timing pair: the same blocks, one with deltas and one
    with every delta 0; both read as cv2 reads them, to different arrays
    (the deltas move the deblocking levels)."""
    got = [read_image(str(_write(tmp_path, n))) for n in ("timing-1024-delta-lf", "timing-1024-zero-deltas")]
    assert got[0].shape == got[1].shape == (1024, 1024, 3)
    assert not np.array_equal(*got)


@pytest.mark.parametrize("name", ["reduced-420-8", "reduced-444-10-delta-lf", "reduced-mono-12-delta-lf"])
def test_reduced_tx_set_reads_as_its_twin(tmp_path, name):
    """A frame with reduced_tx_set 1 codes its 4x4 luma types in
    TX_SET_INTRA_2; the writer's twin with reduced_tx_set 0 codes the same
    types in TX_SET_INTRA_1. cv2 and the port read both to one array."""
    row = next(r for r in TOOL.SPECIAL if r[0] == name)
    k = TOOL.SPECIAL.index(row)
    _, form, depth, h, w, dlf, kw = row
    twin = TOOL.writer_frame(form, depth, h, w, 2700 + k, dlf, **{**kw, "reduced_tx_set": False})
    ref = _cv2(_write(tmp_path, name))
    twin_path = tmp_path / "twin.avif"
    twin_path.write_bytes(twin)
    assert TOOL.frame_fields(twin)["reduced_tx_set"] == 0 and FIELDS[name]["reduced_tx_set"] == 1
    np.testing.assert_array_equal(_cv2(twin_path), ref)
    np.testing.assert_array_equal(read_image(str(twin_path)), ref)


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("clamp-420-8-multi-res3", "base0-mono-10", "sb128-tiles-420-10")
# copies the port refuses by name: (where cv2 fails, where cv2 reads: the damage changes the ispe, which libavif
# scales to)
NAMED_COPIES = {"clamp-420-8-multi-res3": (0, 1), "base0-mono-10": (0, 0), "sb128-tiles-420-10": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None, the port raises a ``ValueError`` that is
    not ``UnsupportedImageError``; the copies the port refuses by name are
    counted as pinned. No copy crashes the decoder."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 260)
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
# The loader, the evaluator and the size heuristic
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def delta_lf_root(tmp_path_factory):
    """Four records whose images are the fixtures' delta-LF frames at the
    dataset's size (two 4:2:0, two monochrome), each named ``img<i>.png``
    as its label says."""
    root = make_dataset(tmp_path_factory.mktemp("avif_delta_lf") / "ds", 4, seed=26, size=TOOL.RECORDS_HW)
    for i in range(4):
        Path(root, f"img{i}.png").write_bytes(FIXTURES[f"records-{i}/file"].tobytes())
    return root


def test_loaders_read_delta_lf_frames_as_jax(delta_lf_root):
    """The JAX loader and the port's on the same delta-LF records: equal
    samples, plain and augmented."""
    files = sorted(f for f in os.listdir(delta_lf_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(delta_lf_root, f), delta_lf_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_delta_lf_frames_as_jax(tmp_path, monkeypatch, delta_lf_root):
    """Both packages' ``evaluate_model`` over the four delta-LF test
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
        split, config = _register(tmp_path, delta_lf_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_size_heuristic_reads_delta_lf_frames(delta_lf_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads a
    delta-LF frame rather than raise: its engine gets the JAX package's
    array (cv2's)."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    for i in range(4):
        path = os.path.join(delta_lf_root, f"img{i}.png")
        try:
            calculate_average_mask_sizes(Engine(), [path], None)
        except StopIteration:
            pass
        assert len(seen) == i + 1 and np.array_equal(seen[i], _load_image(path)[0]), i

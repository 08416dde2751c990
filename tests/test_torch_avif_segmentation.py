"""AVIF whose AV1 frame codes segmentation, against the JAX package's reader
(``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with libavif 1.4 and
libaom 3.14), bit for bit: every entry of
``tests/data/torch_avif_segmentation_fixtures.npz``
(``tools/av1_writer.py``'s frames: every subsampling at 8, 10 and 12 bits,
lossy and lossless; a lossless segment among lossy ones, with quantizer
matrices and under delta q; ALT_Q under delta q; ALT_LF per plane and
direction, a frame level of 0 that a segment raises; SKIP, REF_FRAME and
GLOBALMV, which read the id before skip; LastActiveSegId 0, 2 and 7;
128x128 superblocks and tiles; CDEF, loop restoration, delta LF, palettes
and intra block copy on top) reads as cv2 reads it, and a segment id
coded past LastActiveSegId fails in both; no tool in ``AV1_TOOLS`` names
segmentation; a seeded fuzz of damaged and cut copies gives cv2's
outcome; and the JAX package's loader, evaluator and size heuristic read
segmented records as the port's."""

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
from deepemia_tpu_torch import native
from deepemia_tpu_torch.ops.avif import AV1_TOOLS
from deepemia_tpu_torch.ops.image import UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = np.load(ROOT / "tests" / "data" / "torch_avif_segmentation_fixtures.npz")
NAMES = sorted({k.split("/")[0] for k in FIXTURES.files})


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_torch_avif_segmentation_fixtures")
FIELDS = {n: dict(zip(TOOL.FIELDS, (int(v) for v in FIXTURES[f"{n}/fields"]))) for n in NAMES}
CODED = {n: TOOL.coded(FIXTURES[f"{n}/file"].tobytes()) for n in NAMES}
READ = [n for n in NAMES if f"{n}/none" not in FIXTURES.files]


def _cv2(path):
    try:
        return cv2.imread(str(path), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def _sha(a) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


def _held(name, ref) -> bool:
    """Whether cv2's outcome here is the one the fixture file holds."""
    if f"{name}/none" in FIXTURES.files:
        return ref is None
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
    reads it to the same array bit for bit; where cv2 returns None (an id
    coded past LastActiveSegId), the port raises a ``ValueError`` that is
    not ``UnsupportedImageError``."""
    path = _write(tmp_path, name)
    ref = _cv2(path)
    assert _held(name, ref), name
    if ref is None:
        with pytest.raises(ValueError) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError), (name, e.value)
        return
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape, name
    np.testing.assert_array_equal(got, ref, err_msg=name)


def test_fixtures_cover_every_path():
    """Every frame but the timing twin codes segmentation, and between them
    they take every path of the decoder's (the id read before skip, skip
    set by SEG_LVL_SKIP, the id predicted for a skipped block, a
    neighbour left out at a tile edge, a lossless block in a lossy frame,
    ALT_Q added to CurrentQIndex, an edge filtered at a level a segment
    raised from 0), every subsampling at 8, 10 and 12 bits lossy and
    lossless, every ALT_LF feature, LastActiveSegId 0, 2 and 7, every id,
    128x128 superblocks and tiles, and segmentation with CDEF, loop
    restoration, delta LF, palettes, intra block copy, quantizer matrices
    and a DC delta q, and in a lossy frame whose segments are all
    lossless."""
    seg = [n for n in NAMES if FIELDS[n]["segmentation"]]
    assert sorted(set(NAMES) - set(seg)) == ["timing-1024-no-segmentation"]
    read = [n for n in seg if CODED[n] is not None]
    assert sorted(set(seg) - set(read)) == ["corrupt-420-8"]
    assert set().union(*(CODED[n]["paths"] for n in read)) == set(TOOL.PATHS)
    assert set().union(*(CODED[n]["ids"] for n in read)) == set(range(8))
    forms = {(FIELDS[n]["mono"], FIELDS[n]["ssx"], FIELDS[n]["ssy"], FIELDS[n]["depth"], FIELDS[n]["coded_lossless"])
             for n in read}
    for mono, ssx, ssy in ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)):
        for depth in (8, 10, 12):
            for lossless in (0, 1):
                assert (mono, ssx, ssy, depth, lossless) in forms, (mono, ssx, ssy, depth, lossless)
    assert any("lossless-block" in CODED[n]["paths"] and FIELDS[n]["using_qmatrix"] for n in read)
    assert any("lossless-block" in CODED[n]["paths"] and "delta-q" in CODED[n]["paths"] for n in read)
    assert any(FIELDS[n]["dq_nonzero"] and FIELDS[n]["lossless_segments"] == 0 and FIELDS[n]["feature_mask"] & 1
               for n in read)  # a segment at quantizer 0 that a DC delta q keeps lossy
    for j in range(1, 5):
        assert any(FIELDS[n]["feature_mask"] >> j & 1 and not FIELDS[n]["coded_lossless"] for n in read), j
    for k in ("level_y_v", "level_y_h"):
        assert any(FIELDS[n][k] == 0 and "lf-raised" in CODED[n]["paths"] for n in read), k
    assert any(FIELDS[n]["level_u"] == 0 and FIELDS[n]["feature_mask"] >> 3 & 1 and not FIELDS[n]["mono"]
               for n in read)  # a chroma plane at level 0, which a segment does not raise
    assert any("skip" in CODED[n]["paths"] and not FIELDS[n]["coded_lossless"] for n in read)
    assert any("skip" in CODED[n]["paths"] and FIELDS[n]["coded_lossless"] for n in read)
    assert any(FIELDS[n]["preskip"] and FIELDS[n]["feature_mask"] >> 5 & 1 and not FIELDS[n]["feature_mask"] >> 6 & 1
               for n in read)  # REF_FRAME alone moves the id before skip
    assert any(FIELDS[n]["preskip"] and FIELDS[n]["feature_mask"] == 1 << 7 | 1 for n in read)  # GLOBALMV
    assert {FIELDS[n]["last_active"] for n in read} >= {0, 2, 7}
    assert any(FIELDS[n]["feature_mask"] == 0 for n in read)
    assert any(FIELDS[n]["sb128"] for n in read)
    assert any(FIELDS[n]["tile_cols"] * FIELDS[n]["tile_rows"] > 1 and "tile-edge" in CODED[n]["paths"] for n in read)
    assert any(FIELDS[n]["coded_lossless"] and FIELDS[n]["base_q_idx"] > 0 for n in read)
    for k in ("cdef", "restoration", "delta_lf_present", "screen_content", "intrabc"):
        assert any(FIELDS[n][k] and not FIELDS[n]["coded_lossless"] for n in read), k
    assert any(FIELDS[n]["intrabc"] and FIELDS[n]["coded_lossless"] for n in read)


def test_segmentation_is_no_longer_refused():
    """No entry of ``AV1_TOOLS`` names segmentation, and the decoder has no
    refusal of it; the tools still refused by name stay named."""
    assert not any("segment" in words for words in AV1_TOOLS.values())
    assert "kToolSegmentation" not in (ROOT / "deepemia_tpu_torch" / "native" / "av1.cpp").read_text()
    for words in ("AV1 superres", "AV1 film grain"):
        assert words in AV1_TOOLS.values(), words


def test_an_id_past_the_last_active_segment_is_corrupt():
    """libaom fails on a segment id that neg_deinterleave takes past
    LastActiveSegId ("Corrupted segment_ids"), where the specification
    clips it: the decoder's status is -1, a stream libaom fails on."""
    status, meta, planes = native.av1_decode(TOOL.fx.payload_of(FIXTURES["corrupt-420-8/file"].tobytes())[0])
    assert status == -1 and planes is None and meta[4] < 0


def test_segmentation_without_features_reads_as_its_twin(tmp_path):
    """Segmentation on with no feature (every id 0) reads as the same
    blocks written with segmentation off, in cv2 and in the port."""
    row = next(r for r in TOOL.SPECIAL if r[0] == "no-features-422-8")
    _, form, depth, h, w, _, kw = row
    twin = TOOL.writer_frame(form, depth, h, w, 2800 + TOOL.SPECIAL.index(row), None, **kw)
    assert TOOL.frame_fields(twin)["segmentation"] == 0
    ref = _cv2(_write(tmp_path, "no-features-422-8"))
    path = tmp_path / "twin.avif"
    path.write_bytes(twin)
    np.testing.assert_array_equal(_cv2(path), ref)
    np.testing.assert_array_equal(read_image(str(path)), ref)


def test_timing_twin_reads_apart(tmp_path):
    """Phase 22's timing pair: a 1024² frame with ALT_Q and ALT_LF segments
    and its twin written from the same seed with segmentation off; both
    read as cv2 reads them, to different arrays."""
    got = [read_image(str(_write(tmp_path, n))) for n in ("timing-1024-segmentation", "timing-1024-no-segmentation")]
    assert got[0].shape == got[1].shape == (1024, 1024, 3)
    assert not np.array_equal(*got)


def test_phase22_frame_holds_its_drawing(tmp_path):
    """Phase 22's segmented frame, eight lossless segments, decodes to the
    flattened drawing it was written from exactly (G, beside neutral
    chroma), and to the SHA-256 of cv2's array."""
    flat, _ = TOOL.lossy_fx.smoke_frame()
    got = read_image(str(_write(tmp_path, "smoke-writer-seg")))
    assert _sha(got) == FIXTURES["smoke-writer-seg/sha256"].tobytes().decode()
    np.testing.assert_array_equal(got[..., 1], flat)
    assert FIELDS["smoke-writer-seg"]["lossless_segments"] == 8 and FIELDS["smoke-writer-seg"]["last_active"] == 7
    assert CODED["smoke-writer-seg"]["ids"] == set(range(8))


# ---------------------------------------------------------------------------
# A seeded fuzz of damaged and cut copies
# ---------------------------------------------------------------------------

FUZZ_BASES = ("preskip-skip-lossy-420-8", "altq-delta-q-lossless-segment-444-10", "sb128-tiles-420-10")
# copies the port refuses by name: (where cv2 fails, where cv2 reads: the damage changes the ispe, which libavif
# scales to)
NAMED_COPIES = {"preskip-skip-lossy-420-8": (0, 0), "altq-delta-q-lossless-segment-444-10": (0, 0),
                "sb128-tiles-420-10": (0, 0)}


@pytest.mark.parametrize("base", FUZZ_BASES)
def test_damaged_and_cut_copies_read_as_opencv(tmp_path, base):
    """40 copies with one byte past the first 16 XORed, and cuts at eight
    fractions: where cv2 reads a copy the port reads the same array bit for
    bit; where cv2 returns None, the port raises a ``ValueError`` that is
    not ``UnsupportedImageError``; the copies the port refuses by name are
    counted as pinned. No copy crashes the decoder."""
    data = FIXTURES[f"{base}/file"].tobytes()
    rng = np.random.default_rng(FUZZ_BASES.index(base) + 270)
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
def segmentation_root(tmp_path_factory):
    """Four records whose images are the fixtures' segmented frames at the
    dataset's size (two 4:2:0, two monochrome), each named ``img<i>.png``
    as its label says."""
    root = make_dataset(tmp_path_factory.mktemp("avif_segmentation") / "ds", 4, seed=27, size=TOOL.RECORDS_HW)
    for i in range(4):
        Path(root, f"img{i}.png").write_bytes(FIXTURES[f"records-{i}/file"].tobytes())
    return root


def test_loaders_read_segmented_frames_as_jax(segmentation_root):
    """The JAX loader and the port's on the same segmented records: equal
    samples, plain and augmented."""
    files = sorted(f for f in os.listdir(segmentation_root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(segmentation_root, f), segmentation_root, i, {"a": 0, "b": 1})
            for i, f in enumerate(files)]
    for i, rec in enumerate(recs):
        for augment in (False, True):
            want = jax_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            got = port_loader.prepare_sample(rec, 64, 8, augment, np.random.default_rng(i))
            assert want is not None and set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, augment, k)


def test_evaluate_reads_segmented_frames_as_jax(tmp_path, monkeypatch, segmentation_root):
    """Both packages' ``evaluate_model`` over the four segmented test
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
        split, config = _register(tmp_path, segmentation_root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 4
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_size_heuristic_reads_segmented_frames(segmentation_root):
    """The size heuristic (``calculate_average_mask_sizes``) reads a
    segmented frame rather than raise: its engine gets the JAX package's
    array (cv2's)."""
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    seen = []

    class Engine:
        def infer(self, img, settings):
            seen.append(np.array(img))
            raise StopIteration

    for i in range(4):
        path = os.path.join(segmentation_root, f"img{i}.png")
        try:
            calculate_average_mask_sizes(Engine(), [path], None)
        except StopIteration:
            pass
        assert len(seen) == i + 1 and np.array_equal(seen[i], _load_image(path)[0]), i

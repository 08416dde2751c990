"""The JPEG codings the port reads beside Huffman-coded 8-bit YCbCr, gray
and RGB, against the JAX package's reader
(``deepemia_tpu.inference.pipeline._load_image``, which is
``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0 with libjpeg-turbo
3.1), bit for bit: arithmetic coding (SOF9, SOF10, DAC, restarts, cut and
damaged streams), four components (CMYK and YCCK, Adobe's inverted CMYK),
libjpeg's block smoothing of progressive files whose low coefficients are
not all refined, and lossless (SOF3) colour; and the codings OpenCV does
not read either (lossless gray or YCbCr, 12-bit, hierarchical, arithmetic
lossless, two components), which the port refuses by name. The files come
from OpenCV, PIL and the numpy writers of
``tools/make_torch_codings_fixtures.py``."""

import importlib.util
import io
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from deepemia_tpu.inference.pipeline import _load_image
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("make_torch_codings_fixtures",
                                               ROOT / "tools" / "make_torch_codings_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def reference(path):
    """What the JAX package reads: ``cv2.imread``'s BGR array, or None."""
    got = _load_image(str(path))
    return None if got is None else got[0]


def reads_as_reference(path):
    """The port's pixels, asserted equal to the JAX package's."""
    ref = reference(path)
    assert ref is not None, path
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def reads_as_reference_or_both_refuse(path):
    """A damaged file: the port reads OpenCV's pixels, or raises a
    ValueError (not an UnsupportedImageError) where OpenCV returns None."""
    if reference(path) is None:
        with pytest.raises(ValueError) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError)
    else:
        reads_as_reference(path)


def micrograph(h, w, seed, gray=False):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur((rng.random((h, w, 3)) * 255).astype(np.uint8), (5, 5), 2)
    img[h // 3 : h // 2 + 1, w // 4 : w // 2 + 1] = (250, 10, 120)
    img[: h // 5, -w // 5 :] = 255
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img


def write(path, data):
    path.write_bytes(data)
    return path


# ---------------------------------------------------------------------------
# arithmetic coding
# ---------------------------------------------------------------------------

ARITH = {
    "sequential": {},
    "progressive": {"progressive": True},
    "restart": {"restart": 3},
    "progressive-restart": {"progressive": True, "restart": 2},
    "dac": {"dac": {0: 0x52, 16: 2}},
    "progressive-dac": {"progressive": True, "dac": {0: 0x10, 16: 20}},
}
SHAPES = [("gray", (37, 45), None), ("444", (37, 45), (1, 1)), ("422", (16, 16), (2, 1)), ("420", (9, 130), (2, 2))]


@pytest.mark.parametrize("kind, shape, sampling", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("coding", list(ARITH))
def test_arithmetic_coding_reads_as_its_huffman_twin(tmp_path, kind, shape, sampling, coding):
    """One set of quantised coefficients, Huffman-coded and arithmetic-coded
    (SOF9 / SOF10 with restarts and DAC conditioning): both read to the
    same pixels in OpenCV and in the port."""
    img = micrograph(*shape, seed=shape[1], gray=sampling is None)
    parts = fx.jpeg_coefficients(img, 90, sampling or (1, 1))
    huff = write(tmp_path / "h.jpg", fx.huffman_jpeg(*parts))
    arith = write(tmp_path / "a.jpg", fx.arith_jpeg(*parts, **ARITH[coding]))
    np.testing.assert_array_equal(reference(arith), reference(huff))
    np.testing.assert_array_equal(reads_as_reference(arith), read_image(str(huff)))


@pytest.mark.parametrize("coding", ["sequential", "progressive", "restart", "progressive-restart"])
def test_arithmetic_coding_cut_and_damaged(tmp_path, coding):
    """libjpeg reads a cut arithmetic-coded stream as zeros from its end on
    (the source's EOI), and a damaged one as decoded: the port's pixels are
    OpenCV's, where the garbage overflows the IDCT too."""
    data = fx.arith_jpeg(*fx.jpeg_coefficients(micrograph(64, 80, 3), 90, (2, 2)), **ARITH[coding])
    scan = data.index(b"\xff\xda")
    for cut in list(range(scan + 10, len(data), len(data) // 17)) + [len(data) - 2]:
        reads_as_reference_or_both_refuse(write(tmp_path / f"cut{cut}.jpg", data[:cut]))
    rng = np.random.default_rng(4)
    for k in range(8):
        bad = bytearray(data)
        bad[int(rng.integers(scan + 14, len(data) - 2))] = int(rng.integers(0, 256))
        reads_as_reference_or_both_refuse(write(tmp_path / f"bad{k}.jpg", bytes(bad)))


# ---------------------------------------------------------------------------
# CMYK and YCCK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [{}, {"progressive": True}, {"subsampling": 2}, {"quality": 40}])
def test_cmyk_from_pil(tmp_path, params):
    """PIL writes Adobe's inverted CMYK (APP14 transform 0); OpenCV converts
    libjpeg's CMYK to BGR as k - ((255 - v) * k >> 8)."""
    buf = io.BytesIO()
    Image.fromarray(micrograph(37, 45, 5)).convert("CMYK").save(buf, "JPEG", **params)
    reads_as_reference(write(tmp_path / "c.jpg", buf.getvalue()))


@pytest.mark.parametrize("adobe", [2, 0, None, 1], ids=["ycck", "cmyk", "cmyk-no-marker", "unknown-transform"])
@pytest.mark.parametrize("coding", ["huffman", "arith", "arith-progressive"])
@pytest.mark.parametrize("factors", [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)]], ids=["1111", "2112"])
def test_four_components(tmp_path, adobe, coding, factors):
    """Four components: YCCK (Adobe transform 2, and any transform but 0)
    converted to CMYK by libjpeg's tables, CMYK as stored (transform 0, or
    no Adobe marker)."""
    img = micrograph(37, 45, 6)
    k = cv2.GaussianBlur(micrograph(37, 45, 7, gray=True), (5, 5), 2).astype(np.float64)
    planes = (fx.ycc_planes(img) if adobe not in (0, None) else [img[..., i].astype(np.float64) for i in (2, 1, 0)])
    parts = fx.plane_coefficients(planes + [k], factors, 90)
    data = (fx.huffman_jpeg(*parts, adobe=adobe) if coding == "huffman"
            else fx.arith_jpeg(*parts, progressive=coding == "arith-progressive", adobe=adobe))
    reads_as_reference(write(tmp_path / "y.jpg", data))


# ---------------------------------------------------------------------------
# block smoothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gray", "420", "444", "restart", "arith"])
def test_block_smoothing_of_cut_progressive_files(tmp_path, kind):
    """A progressive file cut at each of its scans and inside them:
    libjpeg-turbo estimates the first nine AC coefficients (with no AC scan
    yet, the DC too) from the 5x5 blocks' DC values wherever they are not
    fully known, with the previous scan's state on the iMCU rows the last
    scan did not reach; the port's pixels are OpenCV's."""
    img = micrograph(64, 80, 8, gray=kind == "gray")
    if kind == "arith":
        data = fx.arith_jpeg(*fx.jpeg_coefficients(img, 85, (2, 2)), progressive=True)
    else:
        params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85]
        params += {"444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
                   "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}.get(kind, [])
        data = cv2.imencode(".jpg", img, params)[1].tobytes()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    cuts = sorted(set(sos[1:] + [p + 40 for p in sos] + list(range(sos[0] + 20, len(data), len(data) // 11))))
    for cut in cuts:
        reads_as_reference_or_both_refuse(write(tmp_path / f"cut{cut}.jpg", data[:cut]))
    smoothed = sum(reference(tmp_path / f"cut{c}.jpg") is not None for c in cuts)
    assert smoothed >= len(cuts) // 2


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt, restart_rows", [(0, 0), (2, 0), (0, 2)])
def test_lossless_colour(tmp_path, predictor, pt, restart_rows):
    """Lossless RGB (SOF3, no JFIF marker) reads as stored, each sample cut
    to its point transform; every predictor, with restart intervals."""
    img = micrograph(37, 45, 9)
    rgb = [img[..., 2], img[..., 1], img[..., 0]]
    path = write(tmp_path / "l.jpg", fx.lossless_jpeg(rgb, [(1, 1)] * 3, predictor, pt, restart_rows))
    np.testing.assert_array_equal(reads_as_reference(path), (img >> pt) << pt)


def test_lossless_layouts_and_cuts(tmp_path):
    """Lossless with other component ids, an Adobe transform 0, 4:2:0
    (replicated, not fancy-upsampled), CMYK, and cut streams (the rows
    after the cut read as the initial predictor)."""
    img = micrograph(37, 45, 10)
    rgb = [img[..., 2], img[..., 1], img[..., 0]]
    k = micrograph(37, 45, 11, gray=True)
    cases = {
        "ids": fx.lossless_jpeg(rgb, [(1, 1)] * 3, ids=[0, 1, 2]),
        "rgb-ids": fx.lossless_jpeg(rgb, [(1, 1)] * 3, ids=[82, 71, 66]),
        "adobe0": fx.lossless_jpeg(rgb, [(1, 1)] * 3, adobe=0),
        "420": fx.lossless_jpeg([rgb[0], rgb[1][::2, ::2], rgb[2][::2, ::2]], [(2, 2), (1, 1), (1, 1)], 4),
        "cmyk": fx.lossless_jpeg(rgb + [k], [(1, 1)] * 4, 1, adobe=0),
    }
    for name, data in cases.items():
        reads_as_reference(write(tmp_path / f"{name}.jpg", data))
    data = fx.lossless_jpeg(rgb, [(1, 1)] * 3, 4, 0, 2)
    scan = data.index(b"\xff\xda")
    for cut in range(scan + 14, len(data), len(data) // 9):
        reads_as_reference_or_both_refuse(write(tmp_path / f"cut{cut}.jpg", data[:cut]))


# ---------------------------------------------------------------------------
# what OpenCV does not read either
# ---------------------------------------------------------------------------


def refused_by_both(path, match):
    assert reference(path) is None, f"OpenCV now reads {path.name}"
    with pytest.raises(RefusedImageError, match=match):
        read_image(str(path))


@pytest.mark.parametrize("case", ["gray", "jfif", "adobe1", "ycck"])
def test_lossless_opencv_refuses(tmp_path, case):
    """libjpeg-turbo converts no colour in a lossless frame: gray (to BGR)
    and YCbCr or YCCK frames make OpenCV return None."""
    img = micrograph(16, 20, 12)
    rgb = [img[..., 2], img[..., 1], img[..., 0]]
    data = {"gray": lambda: fx.lossless_jpeg([rgb[1]], [(1, 1)]),
            "jfif": lambda: fx.lossless_jpeg(rgb, [(1, 1)] * 3, jfif=True),
            "adobe1": lambda: fx.lossless_jpeg(rgb, [(1, 1)] * 3, adobe=1),
            "ycck": lambda: fx.lossless_jpeg(rgb + [rgb[0]], [(1, 1)] * 4, adobe=2)}[case]()
    refused_by_both(write(tmp_path / "l.jpg", data), r"lossless \(SOF3\)")


@pytest.mark.parametrize("sof, name", [
    (0xC5, r"differential sequential \(SOF5\)"), (0xC6, r"differential progressive \(SOF6\)"),
    (0xC7, r"differential lossless \(SOF7\)"), (0xCB, r"arithmetic-coded lossless \(SOF11\)"),
    (0xCD, r"differential arithmetic-coded sequential \(SOF13\)"),
    (0xCE, r"differential arithmetic-coded progressive \(SOF14\)"),
    (0xCF, r"differential arithmetic-coded lossless \(SOF15\)"),
])
def test_processes_opencv_refuses(tmp_path, sof, name):
    """libjpeg-turbo stops at the hierarchical processes and at arithmetic-
    coded lossless ("Unsupported JPEG process"): OpenCV returns None, the
    port names the process. Each is a lossless file's SOF3 retagged."""
    img = micrograph(16, 20, 13)
    data = bytearray(fx.lossless_jpeg([img[..., 2], img[..., 1], img[..., 0]], [(1, 1)] * 3))
    data[data.index(b"\xff\xc3") + 1] = sof
    refused_by_both(write(tmp_path / "p.jpg", bytes(data)), f"JPEG: {name} is not supported")


@pytest.mark.parametrize("sof", [0xC1, 0xC2])
def test_twelve_bit_opencv_refuses(tmp_path, sof):
    """A 12-bit extended (SOF1) file, and the same frame marked progressive:
    OpenCV returns None for every precision but 8 in every read mode. The
    stream is sound: retagged to 8 bits, OpenCV reads it."""
    rng = np.random.default_rng(14)
    g = cv2.GaussianBlur((rng.random((32, 40)) * 4095).astype(np.float32), (5, 5), 2).astype(np.uint16)
    data = bytearray(fx.twelve_bit_jpeg(g))
    path = write(tmp_path / "t.jpg", bytes(data))
    for flag in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_ANYDEPTH, cv2.IMREAD_UNCHANGED):
        assert cv2.imread(str(path), flag) is None
    if sof == 0xC2:
        data[data.index(b"\xff\xc1") + 1] = 0xC2
        path = write(tmp_path / "t2.jpg", bytes(data))
    refused_by_both(path, "12-bit")
    data[data.index(bytes([0xFF, sof])) + 4] = 8
    if sof == 0xC1:
        assert reference(write(tmp_path / "t8.jpg", bytes(data))) is not None


def test_two_components_opencv_refuses(tmp_path):
    img = micrograph(16, 16, 15)
    parts = fx.plane_coefficients(fx.ycc_planes(img)[:2], [(1, 1)] * 2, 90)
    refused_by_both(write(tmp_path / "two.jpg", fx.huffman_jpeg(*parts)), "two components")


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------


def test_committed_fixtures(tmp_path):
    """``tests/data/torch_codings_fixtures.npz`` (``python
    tools/make_torch_codings_fixtures.py``), which ``chip_smoke.py`` decodes
    on a host without OpenCV: each file decodes to its stored array, and
    the stored array is still what OpenCV reads."""
    fixtures = np.load(ROOT / "tests" / "data" / "torch_codings_fixtures.npz")
    names = sorted(k for k in fixtures.files if "." not in k)
    assert len(names) >= 30, names
    for name in names:
        (key,) = [k for k in fixtures.files if k.startswith(name + ".")]
        path = write(tmp_path / key, fixtures[key].tobytes())
        got = read_image(str(path))
        np.testing.assert_array_equal(got, fixtures[name], err_msg=name)
        np.testing.assert_array_equal(reference(path), fixtures[name], err_msg=name)

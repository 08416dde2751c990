"""JPEG input: the port's ``read_image`` against ``cv2.imread(path,
cv2.IMREAD_COLOR)`` (OpenCV 5.0 with libjpeg-turbo 3.1), bit for bit, on
files written here by OpenCV and PIL: gray and colour, the five sampling
factors, qualities 5-100, sizes that leave partial MCUs, restart
intervals, optimised Huffman tables, progressive scans, 16-bit
quantization tables, an RGB (not YCbCr) frame, EXIF orientations 1-8, and
files cut off inside their pixel data or their headers; and the named
refusals of the codings the port does not decode."""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image

torch.set_num_threads(2)

SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
CODING = {
    "baseline": [],
    "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
}


def _micrograph(h, w, seed, gray=False):
    """Smooth noise with a bright and a saturated block: edges and flat
    areas, as a micrograph with a scale bar has."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    if min(h, w) > 8:
        img = cv2.GaussianBlur(img, (5, 5), 2)
    img[h // 3 : h // 2 + 1, w // 4 : w // 2 + 1] = (250, 10, 120)
    img[: h // 5, -w // 5 :] = 255
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img


def _assert_reads_as_cv2(path):
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert ref is not None
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _write(path, img, params):
    assert cv2.imwrite(str(path), img, params)
    return path


@pytest.mark.parametrize("coding", list(CODING))
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_colour_sampling_and_coding(tmp_path, sampling, coding):
    """Every sampling factor under every coding, at a size that leaves a
    partial MCU on both edges, and at 1x1, 7x13 and 37x53."""
    for i, (h, w) in enumerate([(45, 67), (1, 1), (7, 13), (37, 53)]):
        path = _write(tmp_path / f"{i}.jpg", _micrograph(h, w, i),
                      [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
                      + CODING[coding])
        _assert_reads_as_cv2(path)


@pytest.mark.parametrize("coding", list(CODING))
def test_gray(tmp_path, coding):
    for i, (h, w) in enumerate([(45, 67), (1, 1), (7, 13), (37, 53)]):
        path = _write(tmp_path / f"{i}.jpg", _micrograph(h, w, i, gray=True), [cv2.IMWRITE_JPEG_QUALITY, 75]
                      + CODING[coding])
        _assert_reads_as_cv2(path)


@pytest.mark.parametrize("quality", [5, 10, 25, 50, 75, 90, 95, 100])
def test_qualities(tmp_path, quality):
    """Coarse tables (quality 5: quantizers in the hundreds) through
    quality 100 (all ones: large coefficients, the IDCT's range limit)."""
    for sampling in ("444", "420"):
        path = _write(tmp_path / f"{sampling}.jpg", _micrograph(64, 80, quality),
                      [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        _assert_reads_as_cv2(path)


def test_sharp_noise_at_quality_100(tmp_path):
    """Unfiltered noise with 0/255 extremes: samples the IDCT puts outside
    0..255 must clamp as libjpeg's range-limit table clamps them."""
    rng = np.random.default_rng(9)
    img = np.where(rng.random((40, 48, 3)) < 0.5, 0, 255).astype(np.uint8)
    for sampling in ("444", "422", "411"):
        path = _write(tmp_path / f"{sampling}.jpg", img,
                      [cv2.IMWRITE_JPEG_QUALITY, 100, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        _assert_reads_as_cv2(path)


def test_restart_intervals_and_chroma_quality(tmp_path):
    img = _micrograph(50, 70, 3)
    for interval in (1, 2, 5, 100):
        path = _write(tmp_path / f"r{interval}.jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                                                           cv2.IMWRITE_JPEG_CHROMA_QUALITY, 30])
        _assert_reads_as_cv2(path)
    path = _write(tmp_path / "all.jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                              cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]])
    _assert_reads_as_cv2(path)


def _segments(data: bytes):
    """(marker, start, end) of each marker segment before the first scan."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2 : pos + 4], "big")
        out.append((data[pos + 1], pos, pos + 2 + length))
        pos += 2 + length
    return out


def test_16_bit_quantization_tables(tmp_path):
    """Each 8-bit DQT table rewritten with 16-bit entries (the same
    values): the same pixels as cv2 reads from the rewritten file."""
    data = (_write(tmp_path / "a.jpg", _micrograph(40, 56, 4), [cv2.IMWRITE_JPEG_QUALITY, 60])).read_bytes()
    out, last = bytearray(data[:2]), 2
    for marker, start, end in _segments(data):
        out += data[last:start]
        seg = data[start:end]
        if marker == 0xDB:
            body, tables = seg[4:], b""
            while body:
                pq_tq, vals = body[0], body[1:65]
                assert pq_tq >> 4 == 0
                tables += bytes([0x10 | pq_tq]) + b"".join(int(v).to_bytes(2, "big") for v in vals)
                body = body[65:]
            seg = b"\xff\xdb" + (len(tables) + 2).to_bytes(2, "big") + tables
        out += seg
        last = end
    out += data[last:]
    (tmp_path / "b.jpg").write_bytes(bytes(out))
    _assert_reads_as_cv2(tmp_path / "b.jpg")


def test_rgb_frame(tmp_path):
    """No JFIF marker and component ids 'R', 'G', 'B': libjpeg takes the
    components as RGB and converts nothing."""
    data = _write(tmp_path / "a.jpg", _micrograph(30, 44, 5), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                                SAMPLING["444"]]).read_bytes()
    out, last = bytearray(data[:2]), 2
    for marker, start, end in _segments(data):
        out += data[last:start]
        seg = bytearray(data[start:end])
        if marker == 0xE0:
            seg = b""
        elif marker == 0xC0:
            for i, cid in enumerate(b"RGB"):
                seg[10 + 3 * i] = cid
        out += seg
        last = end
    sos = bytearray(data[last:])
    for i, cid in enumerate(b"RGB"):
        sos[5 + 2 * i] = cid
    out += sos
    (tmp_path / "rgb.jpg").write_bytes(bytes(out))
    _assert_reads_as_cv2(tmp_path / "rgb.jpg")
    assert not np.array_equal(read_image(str(tmp_path / "rgb.jpg")), read_image(str(tmp_path / "a.jpg")))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation):
    """A 24x40 image with EXIF Orientation written by PIL: OpenCV turns or
    flips it (5-8 come back 40x24), and so does the port; little- and
    big-endian EXIF blocks."""
    img = _micrograph(24, 40, orientation)
    for order in ("<", ">"):
        exif = Image.Exif()
        exif[0x0112] = orientation
        raw = exif.tobytes()
        if order == ">":  # the same IFD written big-endian
            raw = b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03\x00\x00\x00\x01" + \
                orientation.to_bytes(2, "big") + b"\x00\x00\x00\x00\x00\x00"
        buf = io.BytesIO()
        Image.fromarray(img[..., ::-1]).save(buf, "JPEG", quality=90, exif=raw)
        path = tmp_path / f"o{orientation}{order == '>'}.jpg"
        path.write_bytes(buf.getvalue())
        ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
        assert ref.shape == ((40, 24, 3) if orientation >= 5 else (24, 40, 3))
        _assert_reads_as_cv2(path)


def test_truncated_files(tmp_path):
    """Cut inside the pixel data: libjpeg pads with zero bits and leaves the
    rest of the image gray, and OpenCV returns that; cut inside the headers:
    OpenCV returns None and the port raises a ValueError."""
    data = _write(tmp_path / "a.jpg", _micrograph(64, 80, 6),
                  [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]).read_bytes()
    scan = data.index(b"\xff\xda")
    for cut in list(range(scan + 20, len(data), 97)) + [len(data) - 2, len(data) - 1]:
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        _assert_reads_as_cv2(path)
    for cut in (2, 10, scan // 2, scan + 4):
        path = tmp_path / f"head{cut}.jpg"
        path.write_bytes(data[:cut])
        assert cv2.imread(str(path)) is None
        with pytest.raises(ValueError, match="JPEG: corrupt"):
            read_image(str(path))
    (tmp_path / "tail.jpg").write_bytes(data + b"trailing bytes")
    _assert_reads_as_cv2(tmp_path / "tail.jpg")


@pytest.mark.parametrize("sof, name", [
    (0xC9, r"arithmetic-coded sequential \(SOF9\)"), (0xCA, r"arithmetic-coded progressive \(SOF10\)"),
    (0xC3, r"lossless \(SOF3\)"), (0xC5, r"differential sequential \(SOF5\)"),
])
def test_codings_it_does_not_decode_are_named(tmp_path, sof, name):
    data = bytearray(_write(tmp_path / "a.jpg", _micrograph(16, 16, 7), []).read_bytes())
    data[data.index(b"\xff\xc0") + 1] = sof
    (tmp_path / "b.jpg").write_bytes(bytes(data))
    if sof == 0xC9:
        # arithmetic coding decodes now (tests/test_torch_jpeg_codings.py):
        # Huffman data read as arithmetic-coded is what libjpeg makes of it
        _assert_reads_as_cv2(tmp_path / "b.jpg")
        return
    if sof in (0xCA, 0xC3):
        # lossless decodes now too (tests/test_torch_jpeg_codings.py); a
        # progressive frame whose scan is 0..63, or a lossless one whose
        # predictor is 0, is corrupt (JERR_BAD_PROGRESSION)
        assert cv2.imread(str(tmp_path / "b.jpg")) is None
        with pytest.raises(ValueError, match="JPEG: corrupt") as e:
            read_image(str(tmp_path / "b.jpg"))
        assert not isinstance(e.value, UnsupportedImageError)
        return
    with pytest.raises(RefusedImageError, match=f"JPEG: {name} is not supported"):
        read_image(str(tmp_path / "b.jpg"))


def test_precision_and_components_it_does_not_decode_are_named(tmp_path):
    data = bytearray(_write(tmp_path / "a.jpg", _micrograph(16, 16, 8), []).read_bytes())
    data[data.index(b"\xff\xc0") + 4] = 12
    (tmp_path / "p12.jpg").write_bytes(bytes(data))
    with pytest.raises(RefusedImageError, match="12-bit"):
        read_image(str(tmp_path / "p12.jpg"))
    # CMYK decodes now (tests/test_torch_jpeg_codings.py), as OpenCV converts it
    buf = io.BytesIO()
    Image.fromarray(_micrograph(16, 16, 8)).convert("CMYK").save(buf, "JPEG")
    (tmp_path / "cmyk.jpg").write_bytes(buf.getvalue())
    _assert_reads_as_cv2(tmp_path / "cmyk.jpg")


def test_block_smoothing_is_refused(tmp_path):
    """A progressive file cut before its refinement scans: libjpeg smooths
    the blocks whose low coefficients are still coarse, and so does the
    port now (tests/test_torch_jpeg_codings.py): it reads as OpenCV's."""
    data = _write(tmp_path / "a.jpg", _micrograph(64, 80, 10), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).read_bytes()
    path = tmp_path / "half.jpg"
    path.write_bytes(data[: len(data) // 2])
    _assert_reads_as_cv2(path)


def test_committed_fixtures(tmp_path):
    """``tests/data/torch_jpeg_fixtures.npz`` (``python
    tools/make_torch_jpeg_fixtures.py``), which ``chip_smoke.py`` decodes on
    a host without OpenCV: each file decodes to its stored array, and the
    stored array is still what OpenCV reads."""
    fixtures = np.load(__file__.rsplit("/", 1)[0] + "/data/torch_jpeg_fixtures.npz")
    names = sorted(k for k in fixtures.files if not k.endswith(".jpg"))
    assert names == ["exif6", "gray", "progressive", "s420", "s422_restart", "s444_optimize_restart"]
    for name in names:
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(fixtures[f"{name}.jpg"].tobytes())
        np.testing.assert_array_equal(read_image(str(path)), fixtures[name], err_msg=name)
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_COLOR), fixtures[name], err_msg=name)

"""WebP as the port's ``read_image`` decodes it (``native/webp.cpp``),
held to the JAX package's reader (``cv2.imread(path, cv2.IMREAD_COLOR)``,
libwebp 1.6 under OpenCV 5.0) bit for bit: VP8L from cv2 and PIL at every
method (the four transforms, colour-indexed images of 2 to 256 colours,
the colour cache, backward references), VP8 key frames from cv2 and PIL
over qualities 1 to 100 and odd sizes (segments, the 4x4 and 16x16 intra
modes, the normal loop filter, fancy upsampling), the forms of libwebp's
own encoder in ``tests/data/torch_container_fixtures.npz`` (the simple
filter, every sharpness, no filter, one or two segments), the numpy VP8
writer's forms (2 to 8 token partitions, segment maps, filter deltas,
skipped macroblocks), lossy images with
an ALPH chunk and lossless ones with alpha (dropped), VP8X files with
metadata chunks, and the first frame of an animation. A damaged ALPH chunk,
a VP8 inter frame and damaged or cut copies are held to OpenCV's None."""

import importlib.util
import io
import struct
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
_spec = importlib.util.spec_from_file_location("make_torch_container_fixtures",
                                               ROOT / "tools" / "make_torch_container_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def reference(path):
    got = _load_image(str(path))
    return None if got is None else got[0]


def reads_as_reference(path):
    ref = reference(path)
    assert ref is not None, f"OpenCV does not read {path.name}"
    np.testing.assert_array_equal(read_image(str(path)), ref)


def _pil(array, **kw):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, "WEBP", **kw)
    return buf.getvalue()


IMG = fx.micrograph(29, 37, 8)
RGB = np.ascontiguousarray(IMG[..., ::-1])
ALPHA = (np.arange(29 * 37).reshape(29, 37) * 7 % 256).astype(np.uint8)
RGBA = np.dstack([RGB, ALPHA])


@pytest.mark.parametrize("seed", range(12))
def test_lossy_sizes_and_qualities(tmp_path, seed):
    """VP8 from cv2 and from PIL (every method) at a random size and
    quality: a micrograph, noise, or gray."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 80)), int(rng.integers(1, 80))
    img = [fx.micrograph(h, w, seed), rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
           np.repeat(fx.micrograph(h, w, seed, gray=True)[..., None], 3, 2)][seed % 3]
    q = int(rng.integers(1, 101))
    (tmp_path / "a.webp").write_bytes(fx._cv2_write(".webp", img, (cv2.IMWRITE_WEBP_QUALITY, q)))
    reads_as_reference(tmp_path / "a.webp")
    (tmp_path / "b.webp").write_bytes(_pil(np.ascontiguousarray(img[..., ::-1]), quality=q, method=seed % 7))
    reads_as_reference(tmp_path / "b.webp")


@pytest.mark.parametrize("method", range(7))
def test_lossless_methods(tmp_path, method):
    (tmp_path / "a.webp").write_bytes(_pil(RGB, lossless=True, method=method, quality=method * 15))
    reads_as_reference(tmp_path / "a.webp")


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 11, 16, 17, 200, 256])
def test_lossless_colour_indexing(tmp_path, colours):
    """Colour-indexed VP8L: 8, 4, 2 or 1 pixels a byte."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    (tmp_path / "a.webp").write_bytes(_pil(pal[rng.integers(0, colours, (23, 31))], lossless=True))
    reads_as_reference(tmp_path / "a.webp")


LOSSLESS = {
    "cv2": fx._cv2_write(".webp", IMG, (cv2.IMWRITE_WEBP_QUALITY, 101)),
    "noise": _pil(np.random.default_rng(3).integers(0, 256, (33, 29, 3)).astype(np.uint8), lossless=True),
    "one-pixel": _pil(RGB[:1, :1], lossless=True),
    "one-row": _pil(RGB[:1], lossless=True),
    "flat": _pil(np.full((20, 20, 3), 77, np.uint8), lossless=True),
    "exact-alpha": _pil(RGBA, lossless=True, exact=True),
    "alpha": _pil(RGBA, lossless=True),
}
LOSSY_CONTAINERS = {
    "alpha": _pil(RGBA, quality=80),
    "alpha-q50": _pil(RGBA, quality=80, alpha_quality=50),
    "alpha-raw": fx.libwebp_encode(RGBA, quality=70, alpha_compression=0),
    "alpha-filtered": fx.libwebp_encode(RGBA, quality=70, alpha_filtering=2),
    "metadata": _pil(RGB, quality=80, icc_profile=b"\0" * 100, exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0", xmp=b"<x/>"),
    "lossless-metadata": _pil(RGB, lossless=True, icc_profile=b"\0" * 64),
}


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_lossless_forms(tmp_path, name):
    (tmp_path / "a.webp").write_bytes(LOSSLESS[name])
    reads_as_reference(tmp_path / "a.webp")


@pytest.mark.parametrize("name", sorted(LOSSY_CONTAINERS))
def test_alpha_and_metadata(tmp_path, name):
    """An ALPH chunk (compressed, raw or filtered) is decoded and dropped;
    ICCP, EXIF and XMP chunks are skipped."""
    (tmp_path / "a.webp").write_bytes(LOSSY_CONTAINERS[name])
    reads_as_reference(tmp_path / "a.webp")


def _animation(frames, **kw):
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], **kw)
    return buf.getvalue()


ANIMATIONS = {
    "lossy": _animation([Image.fromarray(RGB), Image.fromarray(np.ascontiguousarray(RGB[::-1]))], quality=80),
    "lossless": _animation([Image.fromarray(RGB), Image.fromarray(np.ascontiguousarray(RGB[::-1]))], lossless=True),
    "alpha": _animation([Image.fromarray(RGBA), Image.fromarray(np.ascontiguousarray(RGBA[::-1]))], quality=80),
    "sub-frames": _animation([Image.fromarray(np.zeros_like(RGB)), Image.fromarray(RGB), Image.fromarray(RGB)],
                             lossless=True, minimize_size=True, kmin=1, kmax=3),
    "keyframes-min": _animation([Image.fromarray(RGBA), Image.fromarray(np.ascontiguousarray(RGBA[::-1]))],
                                quality=80, minimize_size=True, kmin=1, kmax=2),
}


@pytest.mark.parametrize("name", sorted(ANIMATIONS))
def test_first_frame_of_an_animation(tmp_path, name):
    (tmp_path / "a.webp").write_bytes(ANIMATIONS[name])
    reads_as_reference(tmp_path / "a.webp")


def test_libwebp_encoder_forms(tmp_path):
    """The VP8 forms of libwebp's own encoder held in the fixtures (its
    simple filter, sharpness 1-7, no filter, one or two segments, no noise
    shaping, methods 0 and 6, sharp YUV), beside the arrays cv2 gives for
    them (``tests/test_torch_containers.py`` holds the file to cv2)."""
    fixtures = np.load(ROOT / "tests" / "data" / "torch_container_fixtures.npz")
    for name in (f"vp8-{k}" for k in fx.VP8_FORMS):
        path = tmp_path / f"{name}.webp"
        path.write_bytes(fixtures[f"{name}/file"].tobytes())
        np.testing.assert_array_equal(read_image(str(path)), fixtures[f"{name}/bgr"], err_msg=name)


VP8_WRITER = {
    "plain": {}, "2-partitions": dict(partitions=1), "4-partitions": dict(partitions=2),
    "8-partitions": dict(partitions=3), "segments": dict(segments=1),
    "segments-absolute": dict(segments=1, absolute=True),
    "simple-filter": dict(simple=True), "simple-sharp": dict(simple=True, sharpness=5, level=40),
    "filter-deltas": dict(lf_deltas=True), "skips": dict(skip_prob=100), "no-filter": dict(level=0),
    "strongest-filter": dict(level=63, sharpness=7),
    "everything": dict(partitions=3, segments=1, lf_deltas=True, skip_prob=60, sharpness=3, level=50),
}


@pytest.mark.parametrize("name", sorted(VP8_WRITER))
def test_vp8_writer_forms(tmp_path, name):
    """The forms no encoder here writes, from the numpy VP8 writer of
    ``tools/make_torch_container_fixtures.py``: 2, 4 and 8 token
    partitions, segment maps with relative or absolute quantizers and
    filter levels, filter deltas, skipped macroblocks, the simple filter
    and sharpness, at three sizes."""
    for i, (w, h) in enumerate(((33, 47), (100, 70), (16, 16))):
        path = tmp_path / f"{i}.webp"
        path.write_bytes(fx.vp8_frame(w, h, seed=i + len(name), **VP8_WRITER[name]))
        reads_as_reference(path)


def _sizes_patched(data):
    """The RIFF size and the last chunk's size set to what the (cut) data
    holds, so that the cut reaches the bitstream."""
    d = bytearray(data)
    d[4:8] = struct.pack("<I", len(d) - 8)
    i, last = 12, None
    while i + 8 <= len(d):
        last = i
        size = struct.unpack("<I", d[i + 4 : i + 8])[0]
        i += 8 + size + (size & 1)
    d[last + 4 : last + 8] = struct.pack("<I", len(d) - last - 8)
    return bytes(d)


FUZZED = {"lossy": fx._cv2_write(".webp", IMG, (cv2.IMWRITE_WEBP_QUALITY, 70)), "lossless": LOSSLESS["cv2"],
          "alpha": LOSSY_CONTAINERS["alpha"], "animated": ANIMATIONS["lossy"]}


@pytest.mark.parametrize("name", sorted(FUZZED))
def test_damaged_and_cut_copies_agree(tmp_path, name):
    """Copies with bytes overwritten in their bitstream and copies cut
    inside it (sizes patched to match): where OpenCV reads one the port
    gives its pixels, where it returns None the port raises a
    ``ValueError``."""
    data = FUZZED[name]
    rng = np.random.default_rng(len(data))
    start = 30 if data[12:16] == b"VP8X" else 20
    copies = []
    for _ in range(40):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(start, len(b)))] = int(rng.integers(0, 256))
        copies.append(bytes(b))
    for _ in range(12):
        cut = data[: int(rng.integers(start + 1, len(data)))]
        copies.append(cut if name == "animated" else _sizes_patched(cut))
    for i, d in enumerate(copies):
        path = tmp_path / f"c{i}.webp"
        path.write_bytes(d)
        ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if ref is None:
            with pytest.raises(ValueError) as e:
                read_image(str(path))
            assert not isinstance(e.value, UnsupportedImageError), (name, i)
        else:
            np.testing.assert_array_equal(read_image(str(path)), ref, err_msg=f"{name} copy {i}")


def test_what_opencv_refuses(tmp_path):
    """A VP8 inter frame (libwebp decodes key frames only) is refused by
    name; a damaged ALPH chunk, a cut file, a RIFF size past the file, a
    canvas unlike the bitstream, an invisible frame and an animation flag
    on a still image are ``ValueError``s; OpenCV returns None for each."""
    lossy = FUZZED["lossy"]
    inter = bytearray(lossy)
    inter[20] |= 1
    alpha = LOSSY_CONTAINERS["alpha"]
    at = alpha.index(b"ALPH")
    bad_alpha_header = bytearray(alpha)
    bad_alpha_header[at + 8] = 0xFF
    bad_alpha_data = bytearray(alpha)
    bad_alpha_data[at + 12 : at + 20] = b"\xff" * 8
    invisible = bytearray(lossy)
    invisible[20] &= ~0x10
    canvas = bytearray(LOSSY_CONTAINERS["metadata"])
    canvas[24] ^= 1
    anim_flag = bytearray(LOSSY_CONTAINERS["metadata"])
    anim_flag[20] |= 0x02
    riff = bytearray(lossy)
    riff[4:8] = struct.pack("<I", len(lossy))
    cases = {"inter": (bytes(inter), RefusedImageError), "alph-header": (bytes(bad_alpha_header), ValueError),
             "alph-data": (bytes(bad_alpha_data), ValueError), "cut": (lossy[:-10], ValueError),
             "riff-past-end": (bytes(riff), ValueError), "invisible": (bytes(invisible), ValueError),
             "canvas": (bytes(canvas), ValueError), "animation-flag": (bytes(anim_flag), ValueError)}
    for name, (data, error) in cases.items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(data)
        assert reference(path) is None, f"OpenCV now reads {name}"
        with pytest.raises(error) as e:
            read_image(str(path))
        assert not isinstance(e.value, UnsupportedImageError), name

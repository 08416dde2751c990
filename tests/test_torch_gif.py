"""GIF as the port's ``read_image`` decodes it, held to the JAX package's
reader (``cv2.imread(path, cv2.IMREAD_COLOR)``, OpenCV 5.0's own
``grfmt_gif.cpp``) bit for bit: files cv2 and PIL write, and files of the
numpy writer of ``tools/make_torch_container_fixtures.py`` (a first frame
smaller than the logical screen, the background colour and the
transparent index, local tables with or without a global one, interlaced
frames of every height to 21 rows, LZW code sizes 2 to 11, Clear codes
anywhere, a full table without a Clear, extensions, GIF87a). OpenCV's
reading of LZW data that goes on past the frame is pinned code sequence by
code sequence; the forms OpenCV refuses are pinned beside
``cv2.imread(...) is None``, and cut or damaged copies raise a
``ValueError`` where OpenCV returns None."""

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

_spec = importlib.util.spec_from_file_location(
    "make_torch_container_fixtures",
    Path(__file__).resolve().parents[1] / "tools" / "make_torch_container_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def reference(path):
    got = _load_image(str(path))
    return None if got is None else got[0]


def write(path, data):
    path.write_bytes(data)
    return path


RNG = np.random.default_rng(21)
PAL = RNG.integers(0, 256, (16, 3)).astype(np.uint8)
LPAL = RNG.integers(0, 256, (8, 3)).astype(np.uint8)
P256 = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
IDX = RNG.integers(0, 8, (6, 9)).astype(np.uint8)
BIG = RNG.integers(0, 256, (40, 70)).astype(np.uint8)
SMALL = IDX[:3, :4].copy()
SMALL[0, 0] = 3
IMG = fx.micrograph(19, 27, 6)


def _pil(rgb, **kw):
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "GIF", **kw)
    return buf.getvalue()


FORMS = {
    "cv2": fx._cv2_write(".gif", IMG),
    "pil": _pil(np.ascontiguousarray(IMG[..., ::-1])),
    "pil-interlaced": _pil(np.ascontiguousarray(IMG[..., ::-1]), interlace=True),
    "pil-palette-transparency": _pil(np.ascontiguousarray(IMG[..., 0] // 32 * 32), transparency=64),
    "plain": fx.gif([dict(indices=IDX)], (9, 6), PAL),
    "87a": fx.gif([dict(indices=IDX)], (9, 6), PAL, version=b"87a"),
    "small-frame-background": fx.gif([dict(indices=SMALL, left=2, top=1)], (9, 6), PAL, background=5),
    "local-table-no-global": fx.gif([dict(indices=SMALL, left=2, top=1, palette=LPAL)], (9, 6), None, background=3),
    "local-over-global": fx.gif([dict(indices=IDX, palette=LPAL)], (9, 6), PAL, background=3),
    "transparent-is-background": fx.gif([dict(indices=IDX, transparent=int(IDX[0, 0]))], (9, 6), PAL,
                                        background=int(IDX[0, 0])),
    "transparent-past-table": fx.gif([dict(indices=IDX, transparent=200)], (9, 6), PAL),
    "first-of-two-frames": fx.gif([dict(indices=IDX), dict(indices=IDX[::-1].copy(), left=0)], (9, 6), PAL),
    "full-table": fx.gif([dict(indices=BIG)], (70, 40), P256),
    "full-table-no-clear": fx.gif([dict(indices=BIG, lzw=fx.gif_lzw(BIG, 8, deferred=True))], (70, 40), P256),
    "clear-every-3": fx.gif([dict(indices=IDX, lzw=fx.gif_lzw(IDX, 3, clear_every=3))], (9, 6), PAL),
    "extensions": fx.gif([dict(indices=IDX)], (9, 6), PAL, extensions=(
        b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00" + b"\x21\xfe\x05hello\x00" + b"\x21\x01\x0c" + bytes(12)
        + b"\x02ab\x00" + b"\x21\xff\x0bXMP DataXMP\x05hello\x00" + b"\x21\x99\x02ab\x00")),
    # without a global or local table OpenCV maps indices through gray levels, 1 to white
    "no-table": fx.gif([dict(indices=np.arange(256, dtype=np.uint8).reshape(16, 16))], (16, 16), None),
    "no-table-small-frame": fx.gif([dict(indices=SMALL, left=2, top=1, transparent=2)], (9, 6), None, background=7),
    "netscape-odd-block": fx.gif([dict(indices=IDX)], (9, 6), PAL, extensions=b"\x21\xff\x0bNETSCAPE2.0\x04\x01\x00"
                                                                               b"\x00\x00\x00"),
}
for _disposal in range(4):
    for _t in (None, 3, 5):
        FORMS[f"disposal-{_disposal}-transparent-{_t}"] = fx.gif(
            [dict(indices=SMALL, left=1, top=1, disposal=_disposal, **({} if _t is None else {"transparent": _t}))],
            (9, 6), PAL, background=5)
for _h in range(1, 22, 2):
    FORMS[f"interlaced-{_h}-rows"] = fx.gif([dict(indices=RNG.integers(0, 16, (_h, 5)).astype(np.uint8),
                                                  interlace=True)], (5, _h), PAL)
for _size in (2, 3, 5, 7, 8, 9, 11):
    _ind = (BIG.astype(np.int64) % (1 << min(_size, 8))).astype(np.uint8)
    FORMS[f"code-size-{_size}"] = fx.gif([dict(indices=_ind, min_size=_size, lzw=fx.gif_lzw(_ind, _size))], (70, 40),
                                         P256)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_reads_as_opencv(tmp_path, name):
    path = write(tmp_path / "a.gif", FORMS[name])
    ref = reference(path)
    assert ref is not None
    np.testing.assert_array_equal(read_image(str(path)), ref)


def _codes(codes, width=4):
    acc = n = 0
    out = bytearray()
    for c in codes:
        acc |= c << n
        n += width
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    if n:
        out.append(acc & 255)
    return bytes(out)


# a 2x2 frame at code size 3 (Clear 8, End 9, codes of 4 bits), and whether OpenCV reads it: a code that
# arrives once the frame is full is read where its sub-block has no byte left and refused otherwise; an
# End stops the codes of its byte and decoding goes on after it; strings that overrun the frame fail it
LZW_CASES = {
    "end": ([8, 1, 2, 3, 4, 9], True), "no-clear": ([1, 2, 3, 4, 9], True), "no-end": ([8, 1, 2, 3, 4], True),
    "extra-literal-then-end": ([8, 1, 2, 3, 4, 5, 9], False), "extra-in-last-byte": ([8, 1, 2, 3, 4, 5], True),
    "extra-string": ([8, 1, 2, 3, 4, 10, 9], False), "literal-after-end": ([8, 1, 2, 3, 4, 9, 5], True),
    "clear-end-after-end": ([8, 1, 2, 3, 4, 9, 8, 9], True), "zeros-after-end": ([8, 1, 2, 3, 4, 9, 0, 0], True),
    "two-zero-bytes-after-end": ([8, 1, 2, 3, 4, 9, 0, 0, 0, 0], False),
    "clears-after-end": ([8, 1, 2, 3, 4, 9, 8, 8, 8, 8], True), "end-mid-frame": ([8, 1, 2, 9, 3, 4, 9], True),
    "clear-mid-frame": ([8, 1, 2, 8, 3, 4, 9], True), "literal-after-clear": ([8, 1, 2, 3, 4, 8, 5, 9], True),
    "two-after-clear": ([8, 1, 2, 3, 4, 8, 5, 6, 9], False), "kwkwk": ([8, 1, 10, 9], False),
    "past-next-entry": ([8, 1, 11, 9], False), "first-code-an-entry": ([8, 10, 1, 2, 3, 9], False),
    "string-overruns": ([8, 1, 2, 3, 11, 9], False), "string-fills": ([8, 1, 2, 10, 9], True),
    "after-string-last-byte": ([8, 1, 2, 10, 3], True), "after-string-then-more": ([8, 1, 2, 10, 3, 4, 5], False),
    "ends-after-end": ([8, 1, 2, 3, 4, 9, 9, 9, 9], True),
}


@pytest.mark.parametrize("name", sorted(LZW_CASES))
def test_lzw_past_the_frame_pinned(tmp_path, name):
    codes, reads = LZW_CASES[name]
    path = write(tmp_path / "a.gif", fx.gif([dict(indices=np.zeros((2, 2), np.uint8), min_size=3,
                                                  lzw=_codes(codes))], (2, 2), PAL[:8]))
    ref = reference(path)
    assert (ref is not None) is reads, f"OpenCV's reading of {codes} changed"
    if reads:
        np.testing.assert_array_equal(read_image(str(path)), ref)
    else:
        with pytest.raises(ValueError, match="LZW"):
            read_image(str(path))


def _damage(data, at, value):
    b = bytearray(data)
    b[at] = value
    return bytes(b)


_PLAIN = FORMS["plain"]
_GCT_END = 13 + 48
REFUSED = {
    "background-past-table": (fx.gif([dict(indices=IDX)], (9, 6), PAL[:8], background=12), ValueError,
                              "background index"),
    "frame-past-screen": (fx.gif([dict(indices=IDX, left=6, top=4)], (9, 6), PAL), ValueError, "screen"),
    "screen-smaller": (fx.gif([dict(indices=IDX)], (4, 3), PAL), ValueError, "screen"),
    "screen-empty": (fx.gif([dict(indices=IDX)], (0, 0), PAL), ValueError, "no pixels"),
    "no-trailer": (_PLAIN[:-1], ValueError, "corrupt or truncated"),
    "no-frames": (b"GIF89a" + bytes([9, 0, 6, 0, 0xF3, 0, 0]) + PAL.tobytes() + b"\x3b", ValueError, "no image"),
    "bad-block": (_PLAIN[:-1] + b"\x99\x3b", ValueError, "block of type"),
    "gce-of-5": (_PLAIN[:_GCT_END] + b"\x21\xf9\x05\x00\x00\x00\x00\x00\x00" + _PLAIN[_GCT_END:], ValueError,
                 "Graphic Control"),
    "index-past-table": (fx.gif([dict(indices=np.array([[6, 7, 1]], np.uint8), min_size=3)], (3, 1), PAL[:4]),
                         ValueError, "past a colour table"),
    "code-size-1": (fx.gif([dict(indices=IDX % 2, min_size=1, lzw=b"\x00")], (9, 6), PAL), ValueError, "LZW"),
    "code-size-12": (fx.gif([dict(indices=BIG, min_size=12, lzw=fx.gif_lzw(BIG, 11))], (70, 40), P256), ValueError,
                     "LZW"),
    "lzw-cut": (fx.gif([dict(indices=IDX, lzw=fx.gif_lzw(IDX, 3)[:10])], (9, 6), PAL), ValueError, "LZW"),
    "lzw-zero-bytes-after-end": (fx.gif([dict(indices=IDX, lzw=fx.gif_lzw(IDX, 3) + b"\x00\x00")], (9, 6), PAL),
                                 ValueError, "LZW"),
    "app-block-of-3": (fx.gif([dict(indices=IDX)], (9, 6), PAL, extensions=b"\x21\xff\x0bANIMEXTS1.0\x03\x01\x00"
                                                                          b"\x00\x00"), ValueError, "NETSCAPE2.0"),
    "netscape-damaged": (fx.gif([dict(indices=IDX)], (9, 6), PAL, extensions=b"\x21\xff\x0bNETSCAPE2.1\x03\x01\x00"
                                                                            b"\x00\x00"), ValueError, "NETSCAPE2.0"),
}
for _disposal in range(4, 8):
    REFUSED[f"disposal-{_disposal}"] = (fx.gif([dict(indices=IDX, disposal=_disposal)], (9, 6), PAL),
                                        RefusedImageError, "disposal method")


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_opencv_refuses(tmp_path, name):
    data, error, match = REFUSED[name]
    path = write(tmp_path / "a.gif", data)
    assert reference(path) is None, f"OpenCV now reads {name}"
    with pytest.raises(ValueError, match=match) as e:
        read_image(str(path))
    assert isinstance(e.value, error) and not isinstance(e.value, UnsupportedImageError)


@pytest.mark.parametrize("name", ["cv2", "pil-interlaced", "small-frame-background", "extensions", "full-table"])
def test_cut_and_damaged_copies_agree(tmp_path, name):
    """Copies cut short and copies with a byte overwritten (past the
    signature): where OpenCV reads one the port gives its pixels, where it
    returns None the port raises a ``ValueError``."""
    data = FORMS[name]
    rng = np.random.default_rng(len(data))
    copies = [data[: len(data) * k // 8] for k in range(1, 8)]
    copies += [_damage(data, int(rng.integers(6, len(data))), int(rng.integers(0, 256))) for _ in range(30)]
    for i, d in enumerate(copies):
        path = write(tmp_path / f"c{i}.gif", d)
        ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if ref is None:
            with pytest.raises(ValueError) as e:
                read_image(str(path))
            assert not isinstance(e.value, UnsupportedImageError), (name, i)
        else:
            np.testing.assert_array_equal(read_image(str(path)), ref, err_msg=f"{name} copy {i}")

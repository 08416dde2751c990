"""The BMP layouts OpenCV reads beside the common ones, against the JAX
package's reader (``deepemia_tpu.inference.pipeline._load_image``, which
is ``cv2.imread(path, cv2.IMREAD_COLOR)``), bit for bit: 16-bit 5:5:5 and
5:6:5, 32-bit whatever its bit fields, OS/2 core headers with 3-byte
palette entries, and every Windows header size; and the layouts OpenCV
refuses too, which the port names."""

import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from deepemia_tpu.inference.pipeline import _load_image
from deepemia_tpu_torch.ops.image import RefusedImageError, read_image

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "make_torch_codings_fixtures", Path(__file__).resolve().parents[1] / "tools" / "make_torch_codings_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

RGB555, RGB565, XRGB, XBGR = (0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F), (0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00,
                                                                                                     0xFF0000)


def _rows(rng, w, h, bits):
    return rng.integers(0, 256, (h, (w * bits + 31) // 32 * 4)).astype(np.uint8).tobytes()


def reference(path):
    got = _load_image(str(path))
    return None if got is None else got[0]


@pytest.mark.parametrize("bits", [1, 4, 8, 16, 24, 32])
@pytest.mark.parametrize("hsize", [12, 40, 56, 64, 108, 124])
def test_header_sizes(tmp_path, bits, hsize):
    """Every Windows header from 40 bytes (V2–V5 and OS/2 2.x sizes) and
    the OS/2 core header, whose palette entries are B, G, R without a pad
    byte; OpenCV refuses 16 bits in a core header."""
    rng = np.random.default_rng(bits + hsize)
    w, h = 13, 7
    palette = rng.integers(0, 256, (1 << bits) * (3 if hsize == 12 else 4)).astype(np.uint8).tobytes() \
        if bits <= 8 else b""
    path = tmp_path / "a.bmp"
    path.write_bytes(fx.bmp_raw(w, h, bits, _rows(rng, w, h, bits), hsize, palette=palette))
    ref = reference(path)
    if bits == 16 and hsize == 12:
        assert ref is None
        with pytest.raises(RefusedImageError, match="16-bit pixels"):
            read_image(str(path))
        return
    assert ref is not None
    np.testing.assert_array_equal(read_image(str(path)), ref)


@pytest.mark.parametrize("bits, comp, masks", [(16, 0, None), (16, 3, RGB555), (16, 3, RGB565), (16, 3, XRGB),
                                               (32, 3, XRGB), (32, 3, XBGR), (32, 3, RGB565), (32, 0, None)])
@pytest.mark.parametrize("topdown", [False, True])
def test_bit_fields(tmp_path, bits, comp, masks, topdown):
    """16 bits: 5:5:5 without masks or with 0x7C00/0x3E0/0x1F, 5:6:5 with
    0xF800/0x7E0/0x1F, each field's bits at the top of its byte; other
    16-bit masks refused by both. 32 bits: OpenCV takes the first three
    bytes as B, G, R whatever the masks say."""
    rng = np.random.default_rng(bits + comp)
    w, h = 21, 9
    path = tmp_path / "a.bmp"
    path.write_bytes(fx.bmp_raw(w, h, bits, _rows(rng, w, h, bits), comp=comp, masks=masks, top_down=topdown))
    ref = reference(path)
    if bits == 16 and masks == XRGB:
        assert ref is None
        with pytest.raises(RefusedImageError, match="bit fields"):
            read_image(str(path))
        return
    assert ref is not None
    np.testing.assert_array_equal(read_image(str(path)), ref)


def test_refusals_shared_with_opencv(tmp_path):
    """A 24-bit file with bit fields, a header of 20 bytes and more than 256
    palette colours: OpenCV returns None and the port raises."""
    rng = np.random.default_rng(3)
    head20 = bytearray(fx.bmp_raw(5, 5, 24, _rows(rng, 5, 5, 24)))
    head20[14:18] = struct.pack("<I", 20)
    cases = {"fields24": fx.bmp_raw(5, 5, 24, _rows(rng, 5, 5, 24), comp=3, masks=XRGB),
             "head20": bytes(head20),
             "colours": fx.bmp_raw(5, 5, 8, _rows(rng, 5, 5, 8), palette=bytes(4 * 300), colors_used=300)}
    for name, data in cases.items():
        path = tmp_path / f"{name}.bmp"
        path.write_bytes(data)
        assert reference(path) is None, name
        with pytest.raises(ValueError):
            read_image(str(path))

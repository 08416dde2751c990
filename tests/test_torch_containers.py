"""The image containers ``read_image`` reads beside PNG, TIFF, JPEG and BMP:
the PNM family (PBM, PGM and PPM, ASCII and binary), PAM, PFM, Sun raster
and Radiance HDR, held to the JAX package's reader
(``deepemia_tpu.inference.pipeline._load_image``, which is
``cv2.imread(path, cv2.IMREAD_COLOR)``) bit for bit on files written here
with cv2 and with the numpy writers of
``tools/make_torch_container_fixtures.py``. Also: OpenCV's own misreads
where the port copies them (ASCII samples scaled while binary ones are
not, PAM RGB kept in R, G, B order, old-style HDR runs read as pixels) and
where it cannot (the unset pixels of a PAM row with alpha); every form
OpenCV refuses, pinned beside ``cv2.imread(...) is None``; cut and damaged
files as a ``ValueError``; AVIF refused by name (JPEG 2000 is now read); the
committed fixtures ``chip_smoke.py`` decodes without OpenCV; and the C10
rule: the port's ``prepare_sample`` and ``evaluate_model`` skip a file
OpenCV refuses where the JAX package's skip it, and raise for one OpenCV
reads that the port does not decode, as the size heuristic does."""

import importlib.util
import json
import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import deepemia_tpu.data.datasets as jax_ds
import deepemia_tpu.data.loader as jax_loader
from deepemia_tpu.inference.pipeline import _load_image
import deepemia_tpu_torch.data.datasets as port_ds
import deepemia_tpu_torch.data.loader as port_loader
from deepemia_tpu_torch.ops.image import RefusedImageError, UnsupportedImageError, read_image
from test_torch_datasets import make_dataset

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "make_torch_container_fixtures", ROOT / "tools" / "make_torch_container_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)
FIXTURES = ROOT / "tests" / "data" / "torch_container_fixtures.npz"


def reference(path):
    got = _load_image(str(path))
    return None if got is None else got[0]


def write(path, data):
    path.write_bytes(data)
    return path


def reads_as_reference(path):
    ref = reference(path)
    assert ref is not None, f"OpenCV does not read {path.name}"
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


IMG = fx.micrograph(21, 29, 3)
GRAY = fx.micrograph(21, 29, 4, gray=True)
RGB = np.ascontiguousarray(IMG[..., ::-1])
RNG = np.random.default_rng(11)
F32 = np.array([0, 0.25, 0.5, 0.75, 1, 2, 1.5, 2.5, 3.5, 254.5, 255.5, 300, -3, -0.5, -0.6, 0.4999, np.nan, np.inf,
                -np.inf, 3e9, 2.1e9, 65535.6, 0.5001, 7], np.float32).reshape(2, 4, 3)


def _rgbe(rows):
    return np.array(rows, np.uint8).reshape(1, -1, 4)


PNM_FORMS = {
    "p1": (".pbm", fx.pnm(1, GRAY > 128)),
    "p1-digits-run": (".pbm", b"P1\n4 2\n1010\n0#c\n110 1\n"),
    "p1-other-digits": (".pbm", b"P1\n3 1\n2 0 9"),
    "p4-odd-width": (".pbm", fx.pnm(4, GRAY[:, :13] > 100)),
    "p2-255": (".pgm", fx.pnm(2, GRAY)),
    "p2-15": (".pgm", fx.pnm(2, GRAY // 17, 15)),
    "p2-100": (".pgm", fx.pnm(2, GRAY * 100 // 255, 100)),
    "p2-1000": (".pgm", fx.pnm(2, GRAY.astype(np.int64) * 4, 1000)),
    "p2-above-maxval": (".pgm", b"P2\n6 1\n15\n0 16 20 255 300 15\n"),
    "p2-comments": (".pgm", b"P2 #a\n#b\n3 #c\n1\n255 #d\n1 #e\n 2\r#f\r3\n"),
    "p2-eaten-terminators": (".pgm", b"P2\n3 2\n255\n1#2 3x4y5\x006 "),
    "p2-leading-zeros": (".pgm", b"P2\n2 1\n0255\n0001 00255\n"),
    "p3-7": (".ppm", fx.pnm(3, RGB // 37, 7)),
    "p3-300": (".ppm", fx.pnm(3, RGB.astype(np.int64) + 40, 300)),
    "p5-cv2": (".pgm", fx._cv2_write(".pgm", GRAY)),
    "p5-7-unscaled": (".pgm", b"P5\n4 1\n7\n" + bytes([0, 3, 7, 9])),
    "p5-65535": (".pgm", fx.pnm(5, GRAY.astype(np.uint16) * 257, 65535)),
    "p5-1000": (".pgm", fx.pnm(5, GRAY.astype(np.uint16) * 4, 1000)),
    "p5-whitespace-header": (".pgm", b"P5\t2\x0b1\x0c255\r\x01\x02"),
    "p5-letter-after-maxval": (".pgm", b"P5 2 1 255x\x01\x02"),
    "p5-hash-after-maxval": (".pgm", b"P5\n2 1\n255#\x05\x06"),
    "p6-cv2": (".ppm", fx._cv2_write(".ppm", IMG)),
    "p6-65535": (".ppm", fx.pnm(6, RGB.astype(np.uint16) * 257 + 5, 65535)),
}
PAM_FORMS = {
    "gray": (".pam", fx.pam(GRAY[..., None], 255, "GRAYSCALE")),
    "gray-16": (".pam", fx.pam(GRAY[..., None].astype(np.uint16) * 200, 65535, "GRAYSCALE")),
    "rgb-cv2": (".pam", fx._cv2_write(".pam", IMG)),
    "rgb-16": (".pam", fx.pam(RGB.astype(np.uint16) * 256 + 9, 65535, "RGB")),
    "rgb-15": (".pam", fx.pam(RGB // 17, 15, "RGB")),
    "bw-bits": (".pam", fx.pam((GRAY > 120)[..., None], 1, "BLACKANDWHITE")),
    "gray-bits": (".pam", fx.pam((GRAY > 90)[..., None], 1, "GRAYSCALE")),
    "rgb-bits": (".pam", fx.pam(RGB > 128, 1, "RGB")),
    "bw-maxval-3": (".pam", fx.pam(GRAY[..., None] % 4, 3, "BLACKANDWHITE")),
    "no-tupltype-1": (".pam", fx.pam(GRAY[..., None], 255)),
    "no-tupltype-3": (".pam", fx.pam(RGB, 255)),
    "no-tupltype-bits": (".pam", fx.pam((GRAY > 50)[..., None], 1)),
    "last-tupltype": (".pam", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE RGB\nTUPLTYPE GRAYSCALE\nENDHDR\n"
                              b"\x10\x20"),
    "empty-tupltype": (".pam", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE\nENDHDR\n\x10\x20"),
    "comments-indent-crlf": (".pam", b"P7\r\n# c\r\n\r\n  WIDTH 2\r\nHEIGHT \n1\r\nDEPTH\t1\t\nMAXVAL 255 \r\nENDHDR\r"
                                     b"\x10\x20"),
    "endhdr-with-value": (".pam", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR xx\n\x10\x20"),
    "maxval-0": (".pam", fx.pam(GRAY[..., None], 0)),
    "maxval-negative": (".pam", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL -1\nENDHDR\n\x10\x20"),
}
PFM_FORMS = {
    "le": (".pfm", fx.pfm(F32, -1.0)),
    "be": (".pfm", fx.pfm(F32, 1.0)),
    "scale-2": (".pfm", fx.pfm(F32, -2.0)),
    "scale-0.1": (".pfm", fx.pfm(F32 * 7, -0.1)),
    "scale-3.5-be": (".pfm", fx.pfm(F32, 3.5)),
    "hex-scale": (".pfm", fx.pfm(F32, -1.0, scale_text=b"-0x1p1")),
    "exponent-scale": (".pfm", fx.pfm(F32, -1.0, scale_text=b"-1e0")),
    "image": (".pfm", fx.pfm(RGB.astype(np.float32) / 64, -1 / 64)),
    "tab-separated": (".pfm", b"PF\n1\t1\x0b-1.0\r" + np.array([4, 8, 16], "<f4").tobytes()),
    "extra-newline": (".pfm", b"PF\n1 1\n-1.0\n\n" + np.array([1, 2, 3], "<f4").tobytes()),
    "wrapping-width": (".pfm", b"PF\n4294967297 1\n-1\n" + np.array([5, 6, 7], "<f4").tobytes()),
}
SUN_FORMS = {
    "1": (".ras", fx.sun(29, 21, 1, np.packbits(GRAY > 128, axis=1))),
    "1-map": (".ras", fx.sun(29, 21, 1, np.packbits(GRAY > 100, axis=1), maptype=1,
                             cmap=bytes([9, 200, 30, 40, 50, 250]))),
    "8-cv2": (".ras", fx._cv2_write(".sr", GRAY)),
    "8-odd": (".ras", fx.sun(13, 21, 8, GRAY[:, :13])),
    "8-map": (".ras", fx.sun(29, 21, 8, GRAY, maptype=1, cmap=RNG.integers(0, 256, 768, np.uint8).tobytes())),
    "8-short-map": (".ras", fx.sun(29, 21, 8, GRAY // 20, maptype=1,
                                   cmap=RNG.integers(0, 256, 31, np.uint8).tobytes())),
    "24-cv2": (".ras", fx._cv2_write(".sr", IMG)),
    "24-old-odd": (".ras", fx.sun(13, 21, 24, IMG[:, :13].reshape(21, -1), typ=0)),
    "32": (".ras", fx.sun(29, 21, 32, np.concatenate([np.full((21, 29, 1), 7, np.uint8), IMG], 2).reshape(21, -1))),
    "length-field-wrong": (".ras", fx.sun(29, 21, 24, IMG.reshape(21, -1))[:16] + bytes(4)
                           + fx.sun(29, 21, 24, IMG.reshape(21, -1))[20:]),
}
_HDR_RGB = RGB.astype(np.float32) / 200
HDR_FORMS = {
    "rle-cv2": (".hdr", fx._cv2_write(".hdr", _HDR_RGB[..., ::-1])),
    "narrow-cv2": (".hdr", fx._cv2_write(".hdr", _HDR_RGB[:, :6, ::-1].copy())),
    "rle": (".hdr", fx.hdr(fx.rgbe_of(_HDR_RGB))),
    "flat": (".hdr", fx.hdr(fx.rgbe_of(_HDR_RGB), rle=False)),
    # old-style runs (1, 1, 1, n) are read as pixels, the file short of them padded
    "old-style-runs": (".hdr", fx.hdr(np.repeat(fx.rgbe_of(_HDR_RGB[:, :3]), 4, axis=1), old_runs=True)
                       + bytes(21 * 12 * 4)),
    "rgbe-signature": (".hdr", fx.hdr(fx.rgbe_of(_HDR_RGB), head=b"#?RGBE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\n"
                                                                 b"GAMMA=2.2\n\n")),
    "size-without-spaces": (".hdr", fx.hdr(_rgbe([[128, 64, 32, 129]]), size=b"-Y1+X1\n")),
    "conversion": (".hdr", fx.hdr(_rgbe([[128, 64, 32, 129], [255, 255, 255, 136], [1, 2, 3, 0], [10, 20, 30, 100],
                                         [1, 2, 255, 160], [200, 100, 50, 152]]), rle=False)),
}
# 10 RLE scanlines, then pixels that do not start with 2, 2: the rest of the image read flat
HDR_FORMS["rle-then-flat"] = (".hdr", fx.hdr(fx.rgbe_of(_HDR_RGB[:10])).replace(b"-Y 10 +X", b"-Y 21 +X")
                              + fx.rgbe_of(_HDR_RGB[10:]).tobytes())
ALL_FORMS = {f"{k}-{n}": v for k, forms in (("pnm", PNM_FORMS), ("pam", PAM_FORMS), ("pfm", PFM_FORMS),
                                             ("sun", SUN_FORMS), ("hdr", HDR_FORMS)) for n, v in forms.items()}

@pytest.mark.parametrize("name", sorted(ALL_FORMS))
def test_reads_as_opencv(tmp_path, name):
    ext, data = ALL_FORMS[name]
    reads_as_reference(write(tmp_path / f"a{ext}", data))


def test_opencvs_conversions(tmp_path):
    """PFM [0, .25, .5, .75, 1, 2] -> [0, 0, 0, 1, 1, 2] (no x255, halves
    to even); P2 at maxval 1000 -> the high byte, not a rescale; P5 at
    maxval 65535 -> the high byte; PBM's 1 black; HDR 0.25 -> 64 and 2.0
    -> 255 (x255, rounded, saturated)."""
    cases = [
        (".pfm", fx.pfm(np.array([[[0, .25, .5], [.75, 1, 2]]], np.float32)), [0, 0, 0, 1, 1, 2]),
        (".pgm", b"P2\n6 1\n1000\n0 500 1000 250 750 999\n", [0, 1, 3, 0, 2, 3]),
        (".pgm", b"P5\n3 1\n65535\n" + struct.pack(">3H", 0, 256, 65535), [0, 1, 255]),
        (".pbm", b"P1\n2 1\n1 0\n", [0, 255]),
        (".hdr", fx.hdr(fx.rgbe_of(np.array([[[0.25] * 3, [2.0] * 3]], np.float32)), rle=False), [64, 255]),
    ]
    for i, (ext, data, want) in enumerate(cases):
        path = write(tmp_path / f"t{i}{ext}", data)
        got = read_image(str(path))
        np.testing.assert_array_equal(got, reference(path))
        values = got[..., ::-1].ravel() if ext == ".pfm" else got[..., 0].ravel()
        assert values.tolist() == want, ext


@pytest.mark.parametrize("depth, tupltype", [(2, "GRAYSCALE_ALPHA"), (4, "RGB_ALPHA")])
@pytest.mark.parametrize("maxval", [255, 65535])
def test_pam_with_alpha_unset_pixels_pinned(tmp_path, depth, tupltype, maxval):
    """OpenCV's ``basic_conversion`` stops at ``src + width``: it sets only
    the first ceil(W / DEPTH) pixels of each row of a PAM with alpha and
    leaves the rest of its buffer as it was (uninitialised: what a second
    read finds there differs). The port matches those pixels and gives
    the rest as the tuple type says (gray, or B, G, R)."""
    samples = RNG.integers(0, maxval + 1, (5, 11, depth)).astype(np.uint16)
    path = write(tmp_path / "a.pam", fx.pam(samples, maxval, tupltype))
    ref = reference(path)
    got = read_image(str(path))
    n = -(-11 // depth)
    np.testing.assert_array_equal(got[:, :n], ref[:, :n])
    hi = samples >> 8 if maxval > 255 else samples
    want = np.repeat(hi[..., :1], 3, 2) if depth == 2 else hi[..., 2::-1]
    np.testing.assert_array_equal(got, want.astype(np.uint8))


REFUSED = {
    "pam-unknown-type": (".pam", fx.pam(np.ones((2, 3, 1), np.uint8), 255, "FOO"), "TUPLTYPE"),
    "pam-depth-2-untyped": (".pam", fx.pam(np.ones((2, 3, 2), np.uint8), 255), "without a TUPLTYPE"),
    "pam-depth-4-untyped": (".pam", fx.pam(np.ones((2, 3, 4), np.uint8), 255), "without a TUPLTYPE"),
    "pam-16-rgb-untyped": (".pam", fx.pam(np.ones((2, 3, 3), np.uint16), 1000), "without a TUPLTYPE"),
    "pam-gray-of-depth-4": (".pam", fx.pam(np.ones((2, 3, 4), np.uint8), 255, "GRAYSCALE"), "DEPTH 4"),
    "pam-rgb-of-depth-2": (".pam", fx.pam(np.ones((2, 3, 2), np.uint8), 255, "RGB"), "DEPTH 2"),
    "pfm-gray": (".pfm", fx.pfm(F32[..., 0], -1.0, gray=True), "gray"),
    "sun-rle": (".ras", fx.sun(4, 2, 8, np.arange(8, dtype=np.uint8).reshape(2, 4), typ=2), "RLE"),
    "sun-rgb": (".ras", fx.sun(4, 2, 24, np.arange(24, dtype=np.uint8).reshape(2, 12), typ=3), "RGB-ordered"),
    "sun-type-5": (".ras", fx.sun(4, 2, 24, np.arange(24, dtype=np.uint8).reshape(2, 12), typ=5), "type 5"),
    "sun-depth-4": (".ras", fx.sun(4, 2, 4, np.arange(4, dtype=np.uint8).reshape(2, 2)), "depth 4"),
    "sun-map-type-2": (".ras", fx.sun(4, 2, 8, np.zeros((2, 4), np.uint8), maptype=2, cmap=bytes(768)), "colour map"),
    "sun-map-on-24": (".ras", fx.sun(4, 2, 24, np.zeros((2, 12), np.uint8), maptype=1, cmap=bytes(6)), "colour map"),
    "sun-map-type-1-empty": (".ras", fx.sun(4, 2, 8, np.zeros((2, 4), np.uint8), maptype=1), "colour map"),
    "hdr-no-format": (".hdr", b"#?RADIANCE\n\n-Y 1 +X 1\n" + bytes(4), "FORMAT"),
    "hdr-xyze": (".hdr", b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 1 +X 1\n" + bytes(4), "FORMAT"),
    "hdr-plus-y": (".hdr", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 1 +X 1\n" + bytes(4), "size line"),
    "hdr-minus-x": (".hdr", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 -X 1\n" + bytes(4), "size line"),
    "unknown-signature": (".pgm", b"P9\n1 1\n255\n\x00", "unknown image encoding"),
    "text": (".png", b"not an image at all\n", "unknown image encoding"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_opencv_refuses_is_refused_by_name(tmp_path, name):
    ext, data, match = REFUSED[name]
    path = write(tmp_path / f"a{ext}", data)
    assert reference(path) is None, f"OpenCV now reads {name}"
    with pytest.raises(RefusedImageError, match=match):
        read_image(str(path))


DAMAGED = {
    "pnm-cut-binary": (".pgm", b"P5\n4 2\n255\n\x05\x06\x07"),
    "pnm-cut-ascii": (".pgm", b"P2\n4 2\n255\n5 6 7"),
    "pnm-ends-after-number": (".pgm", b"P2\n2 1\n255\n1 2"),
    "pnm-negative": (".pgm", b"P2\n2 1\n255\n1 -2\n"),
    "pnm-past-int-max": (".pgm", b"P2\n2 1\n255\n2147483648 1\n"),
    "pnm-past-int64": (".pgm", b"P2\n2 1\n255\n99999999999999999999999 1\n"),
    "pnm-maxval-0": (".pgm", b"P5\n2 1\n0\n\x00\x00"),
    "pnm-maxval-65536": (".pgm", b"P5\n2 1\n65536\n" + bytes(4)),
    "pnm-width-0": (".pgm", b"P5\n0 1\n255\n"),
    "pnm-comment-after-number": (".pgm", b"P2 #c1\n#c2\n6#c3\n 1\n100\n0 1 50 51 99 100\n"),
    # OpenCV reads header values of at most 16 characters: it cannot parse TUPLTYPE BLACKANDWHITE_ALPHA
    "pam-bw-alpha": (".pam", fx.pam(np.ones((2, 3, 2), np.uint8), 1, "BLACKANDWHITE_ALPHA")),
    "pam-cut": (".pam", fx.pam(np.ones((2, 2, 1), np.uint8), 255)[:-1]),
    "pam-lowercase": (".pam", b"P7\nwidth 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x10\x20"),
    "pam-same-line": (".pam", b"P7 WIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x10\x20"),
    "pam-endhdr-trailing": (".pam", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR  \n\x10\x20\n"),
    "pam-two-widths": (".pam", b"P7\nWIDTH 3\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x10\x20\x30"),
    "pam-no-maxval": (".pam", b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nENDHDR\n\x10\x20"),
    "pam-value-garbage": (".pam", b"P7\nWIDTH 2x\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x10\x20"),
    "pam-ident-9": (".pam", b"P7\nWIDTHWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x10\x20"),
    "pam-maxval-65536": (".pam", fx.pam(np.ones((1, 2, 1), np.uint16), 65536)),
    "pfm-cut": (".pfm", fx.pfm(F32, -1.0)[:-5]),
    "pfm-scale-0": (".pfm", fx.pfm(F32, -1.0, scale_text=b"0")),
    "pfm-scale-minus-0": (".pfm", fx.pfm(F32, -1.0, scale_text=b"-0.0")),
    "pfm-no-newline": (".pfm", b"PF 1 1 -1.0\n" + bytes(12)),
    "pfm-cr": (".pfm", b"PF\r1 1\n-1.0\n" + bytes(12)),
    "sun-cut": (".ras", fx._cv2_write(".sr", IMG)[:-3]),
    "sun-cut-map": (".ras", fx.sun(4, 2, 8, np.zeros((2, 4), np.uint8), maptype=1, cmap=bytes(768))[:100]),
    "hdr-cut-flat": (".hdr", fx.hdr(fx.rgbe_of(_HDR_RGB), rle=False)[:-9]),
    "hdr-cut-rle": (".hdr", fx.hdr(fx.rgbe_of(_HDR_RGB))[:-9]),
    "hdr-wrong-width": (".hdr", fx.hdr(fx.rgbe_of(_HDR_RGB)).replace(b"+X 29\n", b"+X 28\n")),
    "hdr-old-style-runs": (".hdr", fx.hdr(np.repeat(fx.rgbe_of(_HDR_RGB[:, :3]), 4, axis=1), old_runs=True)),
    "hdr-crlf": (".hdr", b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 1 +X 1\r\n" + bytes([1, 2, 3, 129])),
}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_files_are_value_errors(tmp_path, name):
    """Where OpenCV returns None (or, past imread's size limits, raises),
    the port raises a ``ValueError`` (not ``UnsupportedImageError``)."""
    ext, data = DAMAGED[name]
    path = write(tmp_path / f"a{ext}", data)
    try:
        assert reference(path) is None
    except cv2.error:
        pass
    with pytest.raises(ValueError) as e:
        read_image(str(path))
    assert not isinstance(e.value, UnsupportedImageError)


FUZZED = ["pnm-p5-cv2", "pnm-p2-100", "pnm-p1", "pam-rgb-cv2", "pam-gray-16", "pfm-image", "sun-8-map", "sun-24-cv2",
          "sun-1", "hdr-rle", "hdr-flat"]


@pytest.mark.parametrize("name", FUZZED)
def test_cut_and_damaged_copies_agree(tmp_path, name):
    """Copies cut short and copies with bytes overwritten: where OpenCV
    reads one the port gives the same pixels, where OpenCV returns None (or
    raises) the port raises a ``ValueError``."""
    ext, data = ALL_FORMS[name]
    rng = np.random.default_rng(len(data))
    copies = [data[: len(data) * k // 9] for k in range(1, 9)]
    for _ in range(12):
        b = bytearray(data)
        b[int(rng.integers(0, min(len(b), 40)))] = int(rng.integers(0, 256))
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        copies.append(bytes(b))
    for i, d in enumerate(copies):
        path = write(tmp_path / f"c{i}{ext}", d)
        try:
            ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
        except cv2.error:
            ref = None
        if ref is None:
            with pytest.raises(ValueError) as e:
                read_image(str(path))
            assert not isinstance(e.value, UnsupportedImageError), (name, i)
        else:
            np.testing.assert_array_equal(read_image(str(path)), ref, err_msg=f"{name} copy {i}")


# an AVIF form OpenCV reads and the port refuses by name: the AV1 writer's frame with film grain (cv2's frames with
# CDEF or loop restoration and the writer's with delta loop filter levels, once refused here too, decode)
AVIF_FILM_GRAIN = np.load(ROOT / "tests" / "data" / "torch_avif_cdef_fixtures.npz")[
    "refused-film-grain-420-8/file"].tobytes()


@pytest.mark.parametrize("ext, name", [(".jp2", "JPEG 2000"), (".j2k", "JPEG 2000"), (".avif", "AVIF")])
def test_unported_formats_are_named(tmp_path, ext, name):
    """AVIF in a form OpenCV reads and the port does not decode (the AV1
    writer's frame with film grain; its frame with delta loop filter levels
    and cv2's speed-4 frame with loop restoration, named so until the port
    applied them) raises
    ``UnsupportedImageError`` naming the format, never "unknown". JPEG 2000
    (the JP2 box and a bare codestream), named so until the port read it,
    now decodes to OpenCV's array (``tests/test_torch_jpeg2000.py``)."""
    big = fx.micrograph(64, 80, 5)
    data = AVIF_FILM_GRAIN if ext == ".avif" else fx._cv2_write(".jp2", big)
    if ext == ".j2k":  # the codestream of the JP2 file's jp2c box
        data = data[data.index(b"\xff\x4f\xff\x51"):]
    path = write(tmp_path / f"a{ext}", data)
    ref = reference(path)
    assert ref is not None
    if name == "JPEG 2000":
        np.testing.assert_array_equal(read_image(str(path)), ref)
        return
    with pytest.raises(UnsupportedImageError, match=f"{name}, which OpenCV reads"):
        read_image(str(path))


def test_avif_named_by_a_compatible_brand(tmp_path):
    """An ISO BMFF file whose major brand is mif1 and whose compatible
    brands list avif is AVIF too (a form the port does not decode: film
    grain)."""
    path = tmp_path / "a.avif"
    data = bytearray(AVIF_FILM_GRAIN)
    assert data[4:8] == b"ftyp"
    data[8:12] = b"mif1"
    size = int.from_bytes(data[:4], "big")
    if b"avif" not in data[16:size]:
        data[16:20] = b"avif"
    path.write_bytes(bytes(data))
    with pytest.raises(UnsupportedImageError, match="AVIF"):
        read_image(str(path))


def test_fixtures_still_match_opencv(tmp_path):
    """Every entry of ``tests/data/torch_container_fixtures.npz`` (each
    container's forms, the WebP ones cv2 cannot write on the card's host
    included): cv2 here still returns the stored array, and so does the
    port."""
    import hashlib

    fixtures = np.load(FIXTURES)
    names = sorted({k.split("/")[0] for k in fixtures.files})
    assert len(names) >= 40 and FIXTURES.stat().st_size < 1_000_000
    for name in names:
        ext = fixtures[f"{name}/ext"].tobytes().decode()
        path = write(tmp_path / f"{name}{ext}", fixtures[f"{name}/file"].tobytes())
        ref, got = cv2.imread(str(path), cv2.IMREAD_COLOR), read_image(str(path))
        if name in fx.HASHED:  # the larger files: the SHA-256 of cv2's array
            want = fixtures[f"{name}/sha256"].tobytes().decode()
            assert hashlib.sha256(ref.tobytes()).hexdigest() == want, name
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_array_equal(ref, fixtures[f"{name}/bgr"], err_msg=name)
            np.testing.assert_array_equal(got, fixtures[f"{name}/bgr"], err_msg=name)


# ---------------------------------------------------------------------------
# C10: a file OpenCV refuses is skipped where the JAX package skips it
# ---------------------------------------------------------------------------


@pytest.fixture()
def c10_records(tmp_path):
    """Four records: a PNG, a hierarchical (SOF5) JPEG that OpenCV refuses
    too, a binary PGM and a Sun raster (containers the port now reads), each
    file named ``img<i>.png`` as its label says."""
    root = make_dataset(tmp_path / "ds", 4, seed=6, size=(48, 64))
    img1 = cv2.imread(os.path.join(root, "img1.png"))
    jpg = bytearray(cv2.imencode(".jpg", img1)[1].tobytes())
    jpg[jpg.index(b"\xff\xc0") + 1] = 0xC5
    Path(root, "img1.png").write_bytes(bytes(jpg))
    Path(root, "img2.png").write_bytes(fx._cv2_write(".pgm", cv2.imread(os.path.join(root, "img2.png"), 0)))
    Path(root, "img3.png").write_bytes(fx._cv2_write(".sr", cv2.imread(os.path.join(root, "img3.png"))))
    files = sorted(f for f in os.listdir(root) if f.endswith(".json"))
    recs = [jax_ds.parse_instance_json(os.path.join(root, f), root, i, {"a": 0, "b": 1}) for i, f in enumerate(files)]
    return root, recs


def test_c10_prepare_sample_skips_as_jax(c10_records):
    _, recs = c10_records
    assert cv2.imread(recs[1]["file_name"]) is None
    for i, rec in enumerate(recs):
        want = jax_loader.prepare_sample(rec, 64, 8, True, np.random.default_rng(i))
        got = port_loader.prepare_sample(rec, 64, 8, True, np.random.default_rng(i))
        assert (got is None) == (want is None) == (i == 1), i
        if want is not None:
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")


class _FakeInstances:
    """No detections, in whichever array type the package's evaluator
    reads."""

    def __init__(self, torch_side):
        z = torch.zeros if torch_side else np.zeros
        self.valid = z(0, dtype=torch.bool) if torch_side else np.zeros(0, bool)
        self.boxes = z((0, 4))
        self.scores = z(0)
        self.classes = z(0, dtype=torch.int64) if torch_side else np.zeros(0, np.int32)
        self.mask_probs = z((0, 28, 28))
        self.capacity = 0


def _fake_eval(monkeypatch, prefix, torch_side, seen):
    import importlib

    engine = importlib.import_module(f"{prefix}.inference.engine")
    detections = importlib.import_module(f"{prefix}.inference.detections")
    masks = importlib.import_module(f"{prefix}.ops.masks")
    models = importlib.import_module(f"{prefix}.data.models")

    class FakeEngine:
        def __init__(self, *a, **k):
            pass

        def infer(self, img, settings):
            seen.append(np.array(img))
            return _FakeInstances(torch_side), None

    monkeypatch.setattr(engine, "TileEngine", FakeEngine)
    monkeypatch.setattr(models, "load_model", lambda *a, **k: None if torch_side else (None, None))
    monkeypatch.setattr(detections, "compact_instances", lambda inst: inst)
    monkeypatch.setattr(detections, "slice_instances", lambda inst, k: inst)
    monkeypatch.setattr(detections, "bucket_size", lambda n, cap: 0)
    z = (lambda n, h, w: torch.zeros((n, h, w), dtype=torch.bool)) if torch_side else \
        (lambda n, h, w: np.zeros((n, h, w), bool))
    monkeypatch.setattr(masks, "paste_masks", lambda probs, boxes, h, w: z(0, h, w))


def _register(tmp_path, root, tag):
    """A home with the four records as the test split of dataset ds, in
    either package's default configuration."""
    import importlib

    cfg_mod = importlib.import_module("deepemia_tpu.config.config" if tag == "jax" else
                                      "deepemia_tpu_torch.config.config")
    home = tmp_path / f"home_{tag}"
    config = cfg_mod.default_config(home)
    config["performance"]["use_bf16"] = False
    os.makedirs(home, exist_ok=True)
    with open(config["paths"]["category_json"], "w") as f:
        json.dump({"ds": [root, root, ["a", "b"]]}, f)
    split = home / "split_dir"
    split.mkdir(exist_ok=True)
    (split / "ds_split.json").write_text(json.dumps({"train": [], "test": [f"img{i}.json" for i in range(4)]}))
    return split, config


def test_c10_evaluate_skips_as_jax(tmp_path, monkeypatch, c10_records):
    """Both packages' ``evaluate_model`` over the four test records (models
    and inference replaced by stand-ins that record the images they get):
    the same record is skipped and the same arrays reach inference."""
    import deepemia_tpu.train.workflow as jax_wf
    import deepemia_tpu_torch.train.workflow as port_wf

    root, _ = c10_records
    seen = {"jax": [], "port": []}
    metrics = {}
    for tag, wf, prefix, ds in (("jax", jax_wf, "deepemia_tpu", jax_ds),
                                ("port", port_wf, "deepemia_tpu_torch", port_ds)):
        _fake_eval(monkeypatch, prefix, tag == "port", seen[tag])
        split, config = _register(tmp_path, root, tag)
        kw = {"device": "cpu"} if tag == "port" else {}
        metrics[tag] = wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt",
                                         visualize=False, **kw)
        ds.catalog_clear()
    assert metrics["port"]["num_images"] == metrics["jax"]["num_images"] == 3
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)


def test_c10_unported_file_still_raises(tmp_path, monkeypatch, c10_records):
    """An AVIF record in a form OpenCV reads and the port does not decode
    (the AV1 writer's frame with film grain; its frame with delta loop
    filter levels and cv2's speed-2 frame with loop restoration until the
    port applied them): the port's
    ``evaluate_model`` and size heuristic (``calculate_average_mask_sizes``)
    raise ``UnsupportedImageError`` rather than skip it."""
    import deepemia_tpu_torch.train.workflow as port_wf
    from deepemia_tpu_torch.inference.multiscale import calculate_average_mask_sizes

    root, _ = c10_records
    Path(root, "img0.png").write_bytes(AVIF_FILM_GRAIN)
    assert cv2.imread(os.path.join(root, "img0.png")) is not None
    _fake_eval(monkeypatch, "deepemia_tpu_torch", True, [])
    split, config = _register(tmp_path, root, "port")
    with pytest.raises(UnsupportedImageError, match="AVIF"):
        port_wf.evaluate_model("ds", str(split), rcnn=50, config=config, checkpoint="unused.pt", visualize=False,
                               device="cpu")
    port_ds.catalog_clear()

    class Engine:
        def infer(self, img, settings):
            raise AssertionError("not reached")

    with pytest.raises(UnsupportedImageError, match="AVIF"):
        calculate_average_mask_sizes(Engine(), [os.path.join(root, "img0.png")], None)
    # a file OpenCV refuses too is skipped there, as the JAX heuristic skips it
    assert calculate_average_mask_sizes(Engine(), [os.path.join(root, "img1.png")], None) == {}

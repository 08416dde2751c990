"""ctypes bindings of the native host libraries: the measurement kernels
(``measure.cpp``), the LZW, PackBits, CCITT fax, JPEG, Radiance HDR and
GIF LZW decoders of ``read_image`` (``codecs.cpp``), its WebP decoders
(``webp.cpp``), its JPEG 2000 codestream decoder (``jpeg2000.cpp``) and
its AV1 decoder of still pictures (``av1.cpp``, with the tables of
``av1_tables.h``).

Each library compiles on first use with ``g++ -O2 -shared -fPIC`` into
``build/torch_native/lib<name>-<hash>.so`` at the root of the checkout
(the hash covers the source, the headers it includes from this directory
and the flags, so an edited source rebuilds).
A failed build raises; there is no numpy fallback. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# name -> {function: (argtypes, restype)}
_SIGNATURES = {
    "measure": {
        "trace_outer_contour": ([_P, _I, _I, _P, _I], _I),
        "polygon_area_perimeter": ([_P, _I, _P], None),
        "min_area_rect": ([_P, _I, _P], None),
        "fit_ellipse": ([_P, _I, _P], _I),
    },
    "codecs": {
        "lzw_decode": ([_P, _L, _P, _L, _P, _I], _L),
        "packbits_decode": ([_P, _L, _P, _L], _L),
        "jpeg_decode": ([_P, _L, _P, _L, _P, _I], _I),
        "fax_decode": ([_P, _L, _P, _L, _L, _I, _I, _I], _I),
        "hdr_decode": ([_P, _L, _P, _L, _L], _I),
        "gif_lzw_decode": ([_P, _L, _P, _L, _I], _I),
        "float_to_u8": ([_P, _L, _I, ctypes.c_float, _P], None),
    },
    "webp": {
        "webp_vp8l_decode": ([_P, _L, _P, _L, _L], _I),
        "webp_vp8_decode": ([_P, _L, _P, _L, _L], _I),
        "webp_alpha_check": ([_P, _L, _L, _L], _I),
    },
    "jpeg2000": {
        "j2k_decode": ([_P, _L, _P, _L, _P, _L], _I),
    },
    "av1": {
        "av1_decode": ([_P, _L, _P], _I),
        "av1_planes": ([_P, _L], _I),
        "yuv_to_bgr_libyuv": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P], None),
        "av1_inverse_transform": ([_P, _I, _I, _I, _P], _I),
    },
}


def library_path(name: str = "measure") -> Path:
    src = SRC_DIR / f"{name}.cpp"
    text = src.read_bytes()
    # the headers of this directory that the source includes count as source
    headers = sorted(set(re.findall(rb'#include "([\w.]+)"', text)))
    digest = hashlib.sha256(text + b"".join((SRC_DIR / h.decode()).read_bytes() for h in headers)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(src: Path, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)


def get_lib(name: str = "measure") -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                _build(SRC_DIR / f"{name}.cpp", path)
            lib = ctypes.CDLL(str(path))
            for fn, (args, res) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _libs[name] = lib
        return _libs[name]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def trace_outer_contour(mask: np.ndarray, max_pts: int = 16384) -> np.ndarray:
    """[H,W] bool/uint8 -> [N,2] float64 (x, y) outer-border points of the
    first component in raster order (cv2 RETR_EXTERNAL analog)."""
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    buf = np.zeros((max_pts, 2), np.int32)
    n = get_lib().trace_outer_contour(_ptr(m), m.shape[0], m.shape[1], _ptr(buf), max_pts)
    return buf[:n].astype(np.float64)


def polygon_area_perimeter(pts: np.ndarray) -> Tuple[float, float]:
    """Closed-polygon (shoelace area, perimeter) — cv2 contourArea/arcLength."""
    pts = np.ascontiguousarray(pts, np.float64)
    if len(pts) < 2:
        return 0.0, 0.0
    out = np.zeros(2)
    get_lib().polygon_area_perimeter(_ptr(pts), len(pts), _ptr(out))
    return float(out[0]), float(out[1])


def min_area_rect(pts: np.ndarray) -> Tuple[float, float]:
    """Minimum-area enclosing rectangle side lengths (cv2.minAreaRect dims)."""
    pts = np.ascontiguousarray(pts, np.float64)
    if len(pts) == 0:
        return 0.0, 0.0
    out = np.zeros(2)
    get_lib().min_area_rect(_ptr(pts), len(pts), _ptr(out))
    return float(out[0]), float(out[1])


def fit_ellipse(pts: np.ndarray) -> Optional[Tuple[float, float, float]]:
    """(major_axis, minor_axis, eccentricity) by a direct least-squares
    ellipse fit (cv2.fitEllipse analog); None for fewer than 5 points or a
    degenerate fit."""
    pts = np.ascontiguousarray(pts, np.float64)
    if len(pts) < 5:
        return None
    out = np.zeros(6)
    if get_lib().fit_ellipse(_ptr(pts), len(pts), _ptr(out)) != 0:
        return None
    return float(out[0]), float(out[1]), float(out[2])


def lzw_decode(data: bytes, size: int, old_style: bool = False) -> Tuple[bytes, bool]:
    """A TIFF LZW strip or tile, new-style or old-style (LSB-first) -> (at
    most ``size`` decoded bytes, whether the stream was sound): a corrupt
    one gives the bytes decoded before its first bad code, as libtiff
    leaves them, and a new-style one that does not start with a Clear code
    none."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(size, 1), np.uint8)
    corrupt = np.zeros(1, np.int32)
    n = get_lib("codecs").lzw_decode(_ptr(src), src.size, _ptr(out), size, _ptr(corrupt), int(old_style))
    return out[:n].tobytes(), not corrupt[0]


def packbits_decode(data: bytes, size: int) -> bytes:
    """A PackBits strip or tile -> at most ``size`` decoded bytes."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(size, 1), np.uint8)
    n = get_lib("codecs").packbits_decode(_ptr(src), src.size, _ptr(out), size)
    return out[:n].tobytes()


def fax_decode(data: bytes, compression: int, rows: int, width: int, options: int, lsb_first: bool) -> bytes:
    """A CCITT strip or tile (TIFF compression 2, 3, 4 or 32771; T4Options
    or T6Options ``options``; FillOrder 2 if ``lsb_first``) -> its ``rows``
    rows of ``width`` pixels, packed MSB first, black 1. Where libtiff's
    decoder gives up on damaged data, the rows it wrote stand and the rest
    stay 0, as OpenCV reads them."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    status = get_lib("codecs").fax_decode(_ptr(src), src.size, _ptr(out), rows, width, compression, options,
                                         int(lsb_first))
    if status == -2:
        raise ValueError(f"TIFF: a fax strip or tile of {rows}x{width} pixels")
    return out.tobytes()


def jpeg_decode(data: bytes, color: int = -1) -> Tuple[int, np.ndarray, Optional[np.ndarray]]:
    """A JPEG stream's bytes -> (status, meta, pixels): status 0 with [H,W,3]
    BGR uint8 pixels, else a negative status of ``codecs.cpp:jpeg_decode``
    and no pixels; meta = (height, width, components, SOF marker). ``color``
    is the colour space of three components: -1 as libjpeg guesses it, 0
    YCbCr, 1 as stored (R, G, B; four components as stored too, [H,W,4])."""
    src = np.frombuffer(data, np.uint8)
    meta = np.zeros(4, np.int32)
    lib = get_lib("codecs")
    status = lib.jpeg_decode(_ptr(src), src.size, None, 0, _ptr(meta), color)
    if status != 1:
        return status, meta, None
    out = np.empty((int(meta[0]), int(meta[1]), 4 if color == 1 and meta[2] == 4 else 3), np.uint8)
    status = lib.jpeg_decode(_ptr(src), src.size, _ptr(out), out.size, _ptr(meta), color)
    return status, meta, out if status == 0 else None


def hdr_decode(data: bytes, width: int, height: int) -> np.ndarray:
    """A Radiance file's pixel data (after its header) -> [height, width, 4]
    uint8 R, G, B, E, flat or new-style RLE scanlines as ``rgbe.cpp``
    reads them; data that ends early or a bad scanline raises."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    if get_lib("codecs").hdr_decode(_ptr(src), src.size, _ptr(out), width, height):
        raise ValueError("HDR: the pixel data ends early or holds a bad scanline")
    return out


def gif_lzw_decode(data: bytes, npix: int, min_size: int) -> np.ndarray:
    """A GIF frame's LZW data sub-blocks (from the first block's length
    byte) -> [npix] uint8 palette indices, read as OpenCV's GIF decoder
    reads them; data it refuses, or a code size outside 2 to 11, raises."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(max(npix, 1), np.uint8)
    if get_lib("codecs").gif_lzw_decode(_ptr(src), src.size, _ptr(out), npix, min_size):
        raise ValueError(f"GIF: LZW data (code size {min_size}) short, corrupt or past the frame")
    return out[:npix]


def webp_decode(data: bytes, lossless: bool, width: int, height: int) -> np.ndarray:
    """A WebP image's VP8L or VP8 bitstream (from its first byte to the end
    of the file, as libwebp reads it) -> [height, width, 3] BGR uint8, as
    libwebp decodes it into BGR; a stream libwebp fails on raises a
    ``ValueError``."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 3), np.uint8)
    lib = get_lib("webp")
    fn = lib.webp_vp8l_decode if lossless else lib.webp_vp8_decode
    status = fn(_ptr(src), src.size, _ptr(out), width, height)
    if status:
        raise ValueError(f"WebP: a {'VP8L' if lossless else 'VP8'} bitstream that libwebp does not decode "
                         f"(status {status})")
    return out


def webp_alpha_check(data: bytes, width: int, height: int) -> bool:
    """Whether libwebp decodes this ALPH payload for a width x height image
    (its alpha is not kept)."""
    src = np.frombuffer(data, np.uint8)
    return get_lib("webp").webp_alpha_check(_ptr(src), src.size, width, height) == 0


def jpeg2000_decode(data: bytes, header_only: bool = False) -> Tuple[int, list, Optional[list]]:
    """A JPEG 2000 codestream (from its SOC marker to the end of the file,
    as OpenJPEG reads it) -> (status, header, planes). The header is
    (x0, y0, x1, y1, [(precision, signed, dx, dy) per component]); the
    planes, unless ``header_only``, each component's [h, w] int32 samples,
    decoded as OpenJPEG decodes them, with status 0. A negative status
    (``jpeg2000.cpp``): -1 a codestream OpenJPEG fails on, -2 a
    High-Throughput one, -3 one with a Part 2 marker; header and planes are
    then None."""
    src = np.frombuffer(data, np.uint8)
    meta = np.zeros(5 + 4 * 16384, np.int64)
    lib = get_lib("jpeg2000")
    status = lib.j2k_decode(_ptr(src), src.size, None, 0, _ptr(meta), meta.size)
    if status != 1:
        return status, None, None
    n, x1, y1, x0, y0 = (int(v) for v in meta[:5])
    comps = [tuple(int(v) for v in meta[5 + 4 * c : 9 + 4 * c]) for c in range(n)]
    header = (x0, y0, x1, y1, comps)
    if header_only:
        return status, header, None
    shapes = [(-(-y1 // dy) - -(-y0 // dy), -(-x1 // dx) - -(-x0 // dx)) for _, _, dx, dy in comps]
    out = np.zeros(sum(h * w for h, w in shapes), np.int32)
    status = lib.j2k_decode(_ptr(src), src.size, _ptr(out), out.size, _ptr(meta), meta.size)
    if status:
        return status, None, None
    planes, at = [], 0
    for h, w in shapes:
        planes.append(out[at : at + h * w].reshape(h, w))
        at += h * w
    return status, header, planes


def av1_decode(data: bytes) -> Tuple[int, np.ndarray, Optional[list]]:
    """An AV1 payload (the OBUs of an AVIF item) -> (status, meta, planes):
    status 0 with a list of [height, width] uint16 planes (Y, then U and V
    at their subsampled size),
    -1 a stream libaom fails on, -2 one that uses a tool ``av1.cpp`` does
    not have (meta[4] its number, ``ops/avif.py:AV1_TOOLS``), -3 a frame
    past libavif's size limits (meta[0] x meta[1]); planes are then None. meta (``av1.cpp:av1_decode``): width, height, bit depth,
    planes, tool, colour range, matrix coefficients, colour primaries,
    transfer characteristics, subsampling x, subsampling y, then what the
    frame's palettes coded: a bit per palette size (1 << n) of Y, of UV,
    the colours taken from a colour cache, the V colours coded as
    deltas, then what intra block copy coded: its blocks, those whose DV
    stack held a candidate, a bit per path taken, then what delta loop
    filter levels coded: the blocks whose deltas are not all 0, a bit per
    path taken, then what segmentation coded: a bit per segment id a block
    took, a bit per path taken."""
    src = np.frombuffer(data, np.uint8)
    meta = np.zeros(22, np.int32)
    lib = get_lib("av1")
    status = lib.av1_decode(_ptr(src), src.size, _ptr(meta))
    if status:
        return status, meta, None
    w, h, _, n = (int(v) for v in meta[:4])
    sx, sy = int(meta[9]), int(meta[10])
    shapes = [(h, w)] + [((h + sy) >> sy, (w + sx) >> sx)] * (n - 1)
    out = np.empty(sum(a * b for a, b in shapes), np.uint16)
    lib.av1_planes(_ptr(out), out.size)
    planes, at = [], 0
    for ph, pw in shapes:
        planes.append(out[at : at + ph * pw].reshape(ph, pw))
        at += ph * pw
    return status, meta, planes


def av1_inverse_transform(coef: np.ndarray, tx: int, tx_type: int, bit_depth: int) -> np.ndarray:
    """``av1.cpp``'s 2D inverse transform: the dequantized coefficients
    [min(h, 32), min(w, 32)] of transform size ``tx`` (the AV1
    specification's TxSize) and type ``tx_type`` -> the residual [h, w]
    int32."""
    c = np.ascontiguousarray(coef, np.int32)
    lw = (2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6)[tx]
    lh = (2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4)[tx]
    assert c.shape == (min(1 << lh, 32), min(1 << lw, 32)), c.shape
    out = np.empty((1 << lh, 1 << lw), np.int32)
    if get_lib("av1").av1_inverse_transform(_ptr(c), tx, tx_type, bit_depth, _ptr(out)):
        raise ValueError(f"no inverse transform of type {tx_type} at size {tx}")
    return out


def yuv_to_bgr_libyuv(y: np.ndarray, u: np.ndarray, v: np.ndarray, depth: int, constants) -> np.ndarray:
    """Y, U, V uint16 planes (chroma at its subsampled size) -> [H,W,3]
    BGR uint8 as libyuv's I4xxToRGB24MatrixFilter makes it from their top
    8 bits (``av1.cpp:yuv_to_bgr_libyuv``); ``constants``: YG, YB, UB, UG,
    VG, VR."""
    y, u, v = (np.ascontiguousarray(p, np.uint16) for p in (y, u, v))
    k = np.asarray(constants, np.int32)
    out = np.empty(y.shape + (3,), np.uint8)
    get_lib("av1").yuv_to_bgr_libyuv(_ptr(y), _ptr(u), _ptr(v), y.shape[1], y.shape[0], u.shape[1], u.shape[0],
                                     depth, _ptr(k), _ptr(out))
    return out


def float_to_u8(samples: np.ndarray, scale: float = 1.0, rgbe: bool = False) -> np.ndarray:
    """[H,W,3] float32 R, G, B times float32 ``scale`` (or [H,W,4] Radiance
    R, G, B, E bytes, decoded and x255) -> [H,W,3] BGR (R, G, B for float
    input) uint8 as OpenCV's ``convertTo`` rounds and saturates it."""
    src = np.ascontiguousarray(samples)
    out = np.empty(src.shape[:2] + (3,), np.uint8)
    get_lib("codecs").float_to_u8(_ptr(src), src.shape[0] * src.shape[1], int(rgbe), scale, _ptr(out))
    return out

"""ctypes bindings of the native measurement kernels (``measure.cpp``).

The library compiles on first use with ``g++ -O2 -shared -fPIC`` into
``build/torch_native/libmeasure-<hash>.so`` at the root of the checkout
(the hash covers the source and the flags, so an edited source rebuilds).
A failed build raises; there is no numpy fallback. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "measure.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmeasure-{digest}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.trace_outer_contour.argtypes = [_P, _I, _I, _P, _I]
            lib.trace_outer_contour.restype = _I
            lib.polygon_area_perimeter.argtypes = [_P, _I, _P]
            lib.polygon_area_perimeter.restype = None
            lib.min_area_rect.argtypes = [_P, _I, _P]
            lib.min_area_rect.restype = None
            lib.fit_ellipse.argtypes = [_P, _I, _P]
            lib.fit_ellipse.restype = _I
            _lib = lib
        return _lib


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

"""Write ``tests/data/torch_avif_delta_lf_fixtures.npz``: AVIF files whose
AV1 frame codes delta loop filter levels (``delta_lf_present``), and what
``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV 5.0, libavif 1.4 and libaom
3.14) reads from each, for ``tests/test_torch_avif_delta_lf.py`` and
``chip_smoke.py`` phase 22.

libaom's encoder writes delta LF only under ``--deltalf-mode``, which cv2
does not set, so every frame here is ``tools/av1_writer.py``'s: a lossy
frame whose superblocks each code deltas drawn at random (one delta, or
one per plane and direction under ``delta_lf_multi``, times 1 << the
coded ``delta_lf_res``), deblocked at a level per block, its planes the
intra prediction of random 4x4 residuals. Each entry ``<name>/file`` holds
the file's bytes; ``<name>/bgr`` cv2's BGR array (at most 40x40 pixels)
or ``<name>/sha256`` the SHA-256 of its bytes; ``<name>/fields``
(``fields_of``) the frame's FIELDS, read off its headers by
``tools/av1_headers.py``. The entries:

- ``form-<subsampling>-<depth>-*``: every subsampling (4:4:4, 4:2:2,
  4:2:0, monochrome) at 8, 10 and 12 bits, delta_lf_multi 0 and 1 and
  every delta_lf_res in turn, both superblock sizes;
- ``clamp-*``: deltas large enough that the running ones reach the
  +-63 clamp; ``high-*``: frame levels near 63;
- ``base0-*``: a luma level of 0 in one direction (with the INTRA_FRAME
  ref delta and without), raised per block by positive deltas; ``u0-*``,
  ``v0-*``, ``uv0-*``: a chroma level of 0, whose plane libaom leaves
  unfiltered whatever its deltas;
- ``negative-*``: negative deltas, taking blocks to level 0 (an edge then
  takes the level across it, or none);
- ``sb128-*``, ``tile-rows-*``, ``sb128-tiles-*``: 128x128 superblocks
  and two tile rows (the running deltas reset at each tile);
- ``cdef-*``, ``lr-*``, ``cdef-lr-*``: CDEF and loop restoration on top;
- ``reduced-*``: reduced_tx_set 1 (the 4x4 luma types coded in
  TX_SET_INTRA_2), with delta LF and without;
- ``records-<i>``: four 128x96 frames (two monochrome) for the loader,
  evaluator and size heuristic tests;
- ``timing-1024-delta-lf`` and ``timing-1024-zero-deltas``: a 1024x1024
  4:2:0 frame and its twin (the same blocks, every delta 0), phase 22's
  decode times.

    python tools/make_torch_avif_delta_lf_fixtures.py

needs cv2; it is deterministic (~30 s).
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_delta_lf_fixtures.npz"
HASHED_PIXELS = 40 * 40
# the layout of ``<name>/fields``
FIELDS = ("depth", "mono", "ssx", "ssy", "sb128", "tile_rows", "delta_lf_present", "delta_lf_res", "delta_lf_multi",
          "level_y_v", "level_y_h", "level_u", "level_v", "sharpness", "lf_delta_enabled", "cdef", "restoration",
          "reduced_tx_set", "width", "height")
# meta[19]'s bits (av1.cpp: Decoder::kLf*), in order
PATHS = ("multi", "res", "clamp", "base-zero", "tile-reset")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lossy = _tool("make_torch_avif_lossy_fixtures")
fx, aw, hd = lossy.fx, lossy.aw, lossy.hd


def fields_of(data: bytes) -> np.ndarray:
    """A file's frame: its FIELDS."""
    f = hd.fields(fx.payload_of(data)[0])
    levels = tuple(f["loop_filter"]) + tuple(f.get("loop_filter_uv", (0, 0)))
    return np.array([f["depth"], f["mono"], *f["subsampling"], f["sb128"], 1 << f["tiles_log2"][1],
                     f["delta_lf_present"], f["delta_lf_res"], f["delta_lf_multi"], *levels, f["sharpness"],
                     f["lf_delta_enabled"], int(bool(f["cdef_strengths"])), int(any(f["lr_type"])),
                     f["reduced_tx_set"], f["width"], f["height"]], np.int16)


def frame_fields(data: bytes) -> dict:
    return dict(zip(FIELDS, (int(v) for v in fields_of(data))))


def coded(data: bytes) -> dict:
    """What the port's decoder read in the frame: its blocks whose deltas are not all 0, and the paths its delta LF
    took (PATHS)."""
    sys.path.insert(0, str(ROOT))
    from deepemia_tpu_torch import native

    status, meta, _ = native.av1_decode(fx.payload_of(data)[0])
    assert status == 0, status
    return {"blocks": int(meta[18]), "paths": {p for k, p in enumerate(PATHS) if meta[19] >> k & 1}}


SUBSAMPLINGS = {"444": ((0, 0), False), "422": ((1, 0), False), "420": ((1, 1), False), "mono": ((1, 1), True)}


def writer_frame(form: str, depth: int, h: int, w: int, seed: int, delta_lf, sb128: bool = False,
                 tiles=("uniform", 0, 0), **lossy_params) -> bytes:
    """The writer's lossy frame in ``form`` (a SUBSAMPLINGS key; BT.709 matrix, full range) at q 18 under the loop
    filter parameters given (levels (6, 9, 4, 5), sharpness 1 and the INTRA_FRAME ref delta 1 by default), with
    ``delta_lf`` (``encode``'s lossy "delta_lf")."""
    sub, mono = SUBSAMPLINGS[form]
    y = np.zeros((h, w), np.int64)
    c = np.zeros(((h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]), np.int64)
    params = {"q": 18, "levels": (6, 9, 4, 5), "sharpness": 1, "delta": 1, **lossy_params}
    if delta_lf is not None:
        params["delta_lf"] = delta_lf
    payload = aw.encode([y] if mono else [y, c, c], depth, subsampling=sub, matrix=1, full_range=True, seed=seed,
                        sb128=sb128, tiles=tiles, lossy=params)
    return fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                  fx.colr_nclx(1, 13, 1, 1))])


def form_cases() -> dict:
    """Every subsampling at 8, 10 and 12 bits, multi and delta_lf_res in turn, a third with 128x128 superblocks."""
    out = {}
    k = 0
    for form in SUBSAMPLINGS:
        for depth in (8, 10, 12):
            multi, res, sb128 = k % 2, (k // 2) % 4, k % 3 == 2
            h, w = (72, 136) if sb128 else ((45, 61) if k % 2 else (64, 96))
            dlf = {"multi": multi, "res": res, "range": 3 + 4 * (k % 3)}
            out[f"form-{form}-{depth}-{'multi' if multi else 'single'}-res{res}-{w}x{h}"] = writer_frame(
                form, depth, h, w, 2600 + k, dlf, sb128=sb128, sharpness=k % 8)
            k += 1
    return out


_CDEF = {"damping": 4, "bits": 1, "strengths": [[6, 1, 3, 1], [9, 2, 5, 0]]}
_CDEF_MONO = {"damping": 5, "bits": 0, "strengths": [[7, 3]]}
_LR = {"types": (1, 2, 3), "unit_shift": 0}
# (name, form, depth, h, w, delta_lf, keywords)
SPECIAL = (
    ("clamp-420-8-multi-res3", "420", 8, 64, 96, {"multi": 1, "res": 3, "range": 40}, {}),
    ("clamp-444-10-single-res2", "444", 10, 64, 96, {"res": 2, "range": 30, "sign": 1}, {}),
    ("high-422-8-multi", "422", 8, 48, 80, {"multi": 1, "res": 1, "range": 6}, {"levels": (60, 50, 63, 40)}),
    ("base0-y-vert-420-8", "420", 8, 64, 96, {"multi": 1, "range": 8, "sign": 1}, {"levels": (0, 9, 4, 5)}),
    ("base0-y-horz-444-10", "444", 10, 64, 96, {"multi": 1, "range": 8, "sign": 1}, {"levels": (9, 0, 4, 5)}),
    ("base0-y-single-422-12", "422", 12, 64, 96, {"range": 8, "sign": 1}, {"levels": (0, 12, 6, 3)}),
    ("base0-y-no-ref-delta-420-8", "420", 8, 64, 96, {"multi": 1, "range": 8, "sign": 1},
     {"levels": (0, 9, 4, 5), "delta": None}),
    ("base0-mono-10", "mono", 10, 64, 96, {"multi": 1, "res": 1, "range": 8, "sign": 1}, {"levels": (7, 0, 0, 0)}),
    ("u0-420-8", "420", 8, 64, 96, {"multi": 1, "range": 8, "sign": 1}, {"levels": (6, 9, 0, 5)}),
    ("v0-444-8", "444", 8, 64, 96, {"multi": 1, "range": 8, "sign": 1}, {"levels": (6, 9, 4, 0)}),
    ("uv0-422-10", "422", 10, 64, 96, {"range": 8, "sign": 1}, {"levels": (6, 9, 0, 0)}),
    ("negative-420-8", "420", 8, 64, 96, {"multi": 1, "range": 10, "sign": -1}, {}),
    ("negative-ref-delta-444-12", "444", 12, 64, 96, {"multi": 1, "res": 1, "range": 10}, {"delta": -3}),
    ("sb128-420-8", "420", 8, 136, 264, {"multi": 1, "res": 1, "range": 12}, {"sb128": True}),
    ("tile-rows-444-8", "444", 8, 140, 80, {"res": 2, "range": 30, "sign": 1}, {"tiles": ("uniform", 0, 1)}),
    ("sb128-tiles-420-10", "420", 10, 264, 264, {"multi": 1, "res": 1, "range": 40},
     {"sb128": True, "tiles": ("uniform", 1, 1)}),
    ("cdef-420-10", "420", 10, 64, 96, {"multi": 1, "range": 10}, {"cdef": _CDEF}),
    ("cdef-mono-12", "mono", 12, 64, 96, {"multi": 1, "res": 2, "range": 10}, {"cdef": _CDEF_MONO}),
    ("lr-420-8", "420", 8, 64, 96, {"multi": 1, "range": 10}, {"restoration": _LR}),
    ("cdef-lr-444-10", "444", 10, 64, 96, {"res": 1, "range": 10}, {"cdef": _CDEF, "restoration": _LR}),
    ("reduced-420-8", "420", 8, 64, 96, None, {"reduced_tx_set": True}),
    ("reduced-444-10-delta-lf", "444", 10, 64, 96, {"multi": 1, "range": 8}, {"reduced_tx_set": True}),
    ("reduced-mono-12-delta-lf", "mono", 12, 45, 61, {"res": 1, "range": 8}, {"reduced_tx_set": True}),
)


def special_cases() -> dict:
    """SPECIAL's frames; the clamp ones held to reach +-63 in the writer's own running deltas."""
    out = {}
    for k, (name, form, depth, h, w, dlf, kw) in enumerate(SPECIAL):
        log = []
        out[name] = writer_frame(form, depth, h, w, 2700 + k, dlf and {**dlf, "log": log}, **kw)
        assert not name.startswith("clamp-") or max(abs(v) for deltas in log for v in deltas) == 63, name
    return out


RECORDS_HW = (96, 128)  # tests/test_torch_datasets.make_dataset's size


def record_cases() -> dict:
    """Four records' images: 4:2:0 BGR and monochrome in turn, multi deltas."""
    return {f"records-{i}": writer_frame("mono" if i % 2 else "420", 8, *RECORDS_HW, 2800 + i,
                                         {"multi": 1, "res": i % 4, "range": 8})
            for i in range(4)}


def timing_cases() -> dict:
    """Phase 22's pair: a 1024x1024 4:2:0 frame with deltas and its twin with every delta 0 (the deltas draw from
    their own rng, so the blocks are the same)."""
    dlf = {"multi": 1, "res": 1, "range": 12}
    return {"timing-1024-delta-lf": writer_frame("420", 8, 1024, 1024, 2900, dlf),
            "timing-1024-zero-deltas": writer_frame("420", 8, 1024, 1024, 2900, {**dlf, "odds": 0.0})}


def cases() -> dict:
    return {**form_cases(), **special_cases(), **record_cases(), **timing_cases()}


def _sha(ref) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)


def main(out: str = str(DEFAULT_OUT)) -> str:
    import cv2

    arrays, reached = {}, set()
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for name, data in cases().items():
            Path(path).write_bytes(data)
            ref = cv2.imread(path, cv2.IMREAD_COLOR)
            assert ref is not None, name
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/fields"] = fields_of(data)
            if ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = _sha(ref)
            else:
                arrays[f"{name}/bgr"] = ref
            reached |= coded(data)["paths"]
    assert reached == set(PATHS), reached
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

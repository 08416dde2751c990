"""Write ``tests/data/torch_avif_restoration_fixtures.npz``: AVIF files
whose AV1 frame libaom filters with loop restoration (Wiener and
self-guided units, after deblocking and CDEF), and what
``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV 5.0, libavif 1.4 and
libaom 3.14) reads from each, for ``tests/test_torch_avif_restoration.py``
and ``chip_smoke.py`` phase 22.

Each entry ``<name>/file`` holds the file's bytes; ``<name>/bgr`` cv2's
BGR array (at most 40x40 pixels) or ``<name>/sha256`` the SHA-256 of its
bytes; ``<name>/lr`` (``lr_of``) the frame's LR_FIELDS. A writer frame
also holds ``<name>/plain``, the same frame with every unit RESTORE_NONE
(its ``/plain_sha256`` cv2's array of it), and ``<name>/units``, the
units it codes as (plane, type, the self-guided set or -1, whether every
Wiener tap lies at an end of its range). The entries:

- ``cv2-s<S>-q<Q>-<form><depth>-<w>x<h>-<what>``: cv2's frames at speeds
  0-4 (0-2 at 200x200 or less), qualities 60-99, 8 and 10 bits (cv2's
  12-bit frames leave restoration off), BGR (4:2:0) and gray, of blurred
  or plain noise: the first quality (and seed) whose frame applies
  ``what`` (``CV2_TARGETS``): Wiener and self-guided frames in luma and in
  chroma, 128 and 256 px units, sizes from 1x97 to 300x300 (odd sizes,
  heights that are not a multiple of 8, several 64-row stripes), and at
  1x1 and 1x93, where libaom turns restoration off;
- ``cv2-12bit-*``: cv2's 12-bit frames at the same settings, which apply
  no restoration (its sequence header leaves it off);
- ``writer-<sub>-<depth>-*``: ``tools/av1_writer.py``'s lossy frames
  with restoration, the forms cv2 does not write: SWITCHABLE, 64 px units,
  ``lr_uv_shift`` 1, 4:4:4, 4:2:2 and 4:0:0, 12 bits, 128x128
  superblocks, two and four tiles (the references reset at each), every
  self-guided set (those with r0 = 0 and r1 = 0 too), Wiener taps at the
  ends of their ranges, CDEF before restoration;
- ``smoke-lr-*``: phase 22's restoration frames: the labelled frame
  (``chip_smoke.draw_labelled``, seed 22, its background flattened) with
  ``chip_smoke.avif_textured``'s texture at the strength in
  ``<name>/strength``, as cv2 writes it at speed 4, 3 or 2 (the first
  whose frame applies the form, the lower qualities first: 8-bit BGR with a
  Wiener luma, 10-bit BGR, 8- and 10-bit gray with a self-guided luma;
  ``smoke-lr-cdef-gray8``, 8-bit gray with CDEF before restoration, the
  one cv2 frame here that applies both: libaom turns CDEF on with
  restoration on such larger textured frames, not on the small ones);
  ``smoke-2048-speed4``: a 2048x2048 BGR frame of blurred noise (sigma 10,
  contrast x4) at speed 4, quality 75 (self-guided units in every plane,
  256 px), for the decode time.

    python tools/make_torch_avif_restoration_fixtures.py

needs cv2; it is deterministic (~3 minutes).
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
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_restoration_fixtures.npz"
HASHED_PIXELS = 40 * 40
# the layout of ``<name>/lr``: lr_type of Y, U, V as coded (0 NONE, 1 SWITCHABLE, 2 WIENER, 3 SGRPROJ; -1 where
# the frame has no such plane), lr_unit_shift (units of 256 >> (2 - shift) luma samples), lr_uv_shift, then the
# frame's form, whether it applies CDEF, its tile count and cv2's speed (-1 for the writer's)
LR_FIELDS = ("y", "u", "v", "unit_shift", "uv_shift", "depth", "mono", "ssx", "ssy", "sb128", "width", "height",
             "cdef", "tiles", "speed")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cdef_fx = _tool("make_torch_avif_cdef_fixtures")
lossy, fx, hd, aw = cdef_fx.lossy, cdef_fx.fx, cdef_fx.hd, cdef_fx.aw
blurred, noise, cv2_lossy, with_payload = lossy.blurred, cdef_fx.noise, cdef_fx.cv2_lossy, lossy.with_payload


def lr_of(data: bytes, speed: int = -1) -> np.ndarray:
    """A file's frame: its LR_FIELDS."""
    f = hd.fields(fx.payload_of(data)[0])
    types = list(f["lr_type"]) + [-1] * (3 - len(f["lr_type"]))
    cols, rows = f["tiles_log2"]
    return np.array(types + [f["lr_unit_shift"], f["lr_uv_shift"], f["depth"], f["mono"], *f["subsampling"],
                             f["sb128"], f["width"], f["height"], int(any(any(e) for e in f["cdef_strengths"])),
                             (1 << cols) * (1 << rows), speed], np.int16)


def lr_fields(data: bytes) -> dict:
    """LR_FIELDS by name; all -1 for a frame ``av1_headers`` does not read.
    A frame with intra block copy (libaom picks screen content tools for
    flat content, and intra block copy with them at some speeds) codes no
    restoration parameters: its types read as 0."""
    try:
        return dict(zip(LR_FIELDS, (int(v) for v in lr_of(data))))
    except ValueError:
        return dict.fromkeys(LR_FIELDS, -1)


# (h, w, channels, depth, content, speeds, what): the first (seed, content, speed, quality) in turn whose frame
# applies ``what`` (CV2_WANT) is kept; "either" tries blurred, then plain noise
CV2_TARGETS = (
    (128, 128, 3, 8, "blurred", (4, 3), "y-wiener"),
    (128, 128, 3, 8, "blurred", (4, 3), "y-sgrproj"),
    (200, 264, 3, 8, "blurred", (4,), "uv-wiener"),
    (150, 180, 3, 8, "either", (4, 3), "uv-sgrproj"),
    (161, 139, 3, 10, "blurred", (4, 3), "y-wiener"),
    (161, 139, 3, 10, "either", (4, 3), "uv-sgrproj"),
    (97, 113, 1, 8, "blurred", (4, 3), "y-wiener"),
    (97, 113, 1, 8, "noise", (4, 3), "y-sgrproj"),
    (99, 75, 1, 10, "blurred", (4, 3), "y-wiener"),
    (99, 75, 1, 10, "noise", (4, 3), "y-sgrproj"),
    (300, 300, 3, 8, "blurred", (4,), "unit256"),
    (255, 257, 3, 8, "blurred", (4,), "unit128"),
    (299, 151, 1, 10, "blurred", (4,), "unit256"),
    (150, 200, 3, 8, "blurred", (0,), "any"),
    (120, 90, 3, 10, "noise", (1,), "any"),
    (77, 200, 1, 8, "blurred", (2,), "any"),
    (200, 181, 3, 8, "either", (3,), "any"),
    (96, 128, 3, 8, "either", (4, 3), "uv-wiener"),
    (1, 1, 3, 8, "noise", (4,), "none"),  # libaom applies no restoration to a frame this small
    (93, 1, 1, 10, "noise", (4,), "none"),
    (1, 97, 3, 8, "noise", (4, 2), "any"),
    (17, 13, 1, 8, "noise", (4, 2), "any"),
    (33, 21, 3, 8, "noise", (4, 2), "any"),
    (9, 300, 3, 8, "noise", (4,), "any"),
    (67, 41, 3, 8, "noise", (4, 2), "any"),
    (134, 190, 3, 10, "either", (4,), "any"),
)
CV2_WANT = {
    "y-wiener": lambda f: f["y"] == 2,
    "y-sgrproj": lambda f: f["y"] == 3,
    "uv-wiener": lambda f: 2 in (f["u"], f["v"]),
    "uv-sgrproj": lambda f: 3 in (f["u"], f["v"]),
    "unit256": lambda f: f["unit_shift"] == 2,
    "unit128": lambda f: f["unit_shift"] == 1,
    "cdef": lambda f: f["cdef"] and max(f["y"], f["u"], f["v"]) > 0,
    "any": lambda f: max(f["y"], f["u"], f["v"]) > 0,
    "none": lambda f: f["y"] == 0,
}
QUALITIES = (75, 85, 95, 99, 90, 80, 70, 60, 65, 97)


def cv2_target(h, w, ch, depth, content, speeds, what):
    for seed in range(1, 8):
        for kind in ("blurred", "noise") if content == "either" else (content,):
            img = blurred(h, w, seed, ch, depth) if kind == "blurred" else noise(h, w, seed, ch, depth)
            for speed in speeds:
                for q in QUALITIES:
                    data = cv2_lossy(img, q, depth, speed)
                    if CV2_WANT[what](lr_fields(data)):
                        return data, speed, q
    raise AssertionError(f"no cv2 frame applies {what} at {(h, w, ch, depth, content, speeds)}")


def writer_lr(sub, depth: int, h: int, w: int, seed: int, lr: dict, sb128: bool = False, tiles=("uniform", 0, 0),
              mono: bool = False, cdef=None):
    """The writer's lossy frame under loop restoration ``lr`` (deblocked,
    and filtered with CDEF where ``cdef``), from the first seed from
    ``seed`` on whose frame cv2 reads to another array with every unit
    RESTORE_NONE -> (the file, its plain twin, the units it codes)."""
    import cv2

    y = np.zeros((h, w), np.int64)
    c = np.zeros(((h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]), np.int64)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for s in range(seed, seed + 20):
            log = []
            files = []
            for none in (False, True):
                params = {"q": 18, "levels": (6, 9, 4, 5), "sharpness": 1, "delta": 1,
                          "restoration": {**lr, "none": none, "log": log if not none else []}}
                if cdef:
                    params["cdef"] = cdef
                payload = aw.encode([y] if mono else [y, c, c], depth, subsampling=sub, matrix=1, full_range=True,
                                    seed=s, sb128=sb128, tiles=tiles, lossy=params)
                files.append(fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth,
                                                    1 if mono else 3, fx.colr_nclx(1, 13, 1, 1))]))
            reads = []
            for frame in files:
                Path(path).write_bytes(frame)
                reads.append(cv2.imread(path, cv2.IMREAD_COLOR))
            if reads[0] is not None and reads[1] is not None and not np.array_equal(*reads):
                return files[0], files[1], np.array(log, np.int16).reshape(-1, 4)
    raise AssertionError("no seed whose frame restoration changes")


# the writer's frames: (name, subsampling, depth, h, w, restoration, keywords)
WRITER_CASES = (
    ("420-8-switchable-unit64-uv1", (1, 1), 8, 70, 90, {"types": (1, 1, 1), "unit_shift": 0, "uv_shift": 1}, {}),
    ("420-10-mixed-uv1-tiles2", (1, 1), 10, 96, 200, {"types": (2, 3, 1), "unit_shift": 0, "uv_shift": 1},
     {"tiles": ("uniform", 1, 0)}),
    ("420-12-switchable-unit128", (1, 1), 12, 150, 140, {"types": (1, 0, 3), "unit_shift": 1, "uv_shift": 0}, {}),
    ("444-8-wiener-extreme", (0, 0), 8, 50, 70, {"types": (2, 2, 2), "unit_shift": 0, "extreme": True}, {}),
    ("444-10-sgrproj-sets", (0, 0), 10, 130, 140, {"types": (3, 3, 3), "unit_shift": 0, "sets": list(range(16))},
     {}),
    ("444-12-switchable-sb128-tiles4", (0, 0), 12, 200, 260, {"types": (1, 1, 1), "unit_shift": 1},
     {"sb128": True, "tiles": ("uniform", 1, 1)}),
    ("422-8-sgrproj-sets", (1, 0), 8, 66, 260, {"types": (3, 3, 3), "unit_shift": 0, "sets": list(range(15, -1, -1))},
     {}),
    ("422-10-wiener-extreme-cdef", (1, 0), 10, 60, 80, {"types": (2, 2, 2), "unit_shift": 0, "extreme": True},
     {"cdef": {"damping": 4, "bits": 1, "strengths": [[9, 3, 5, 1], [4, 1, 7, 2]]}}),
    ("422-12-switchable-sb128-unit256", (1, 0), 12, 140, 270, {"types": (1, 2, 3), "unit_shift": 2},
     {"sb128": True}),
    ("mono-8-sgrproj-sets", (1, 1), 8, 130, 140, {"types": (3,), "unit_shift": 0, "sets": list(range(16))},
     {"mono": True}),
    ("mono-10-switchable-tiles2", (1, 1), 10, 70, 140, {"types": (1,), "unit_shift": 0},
     {"mono": True, "tiles": ("uniform", 1, 0)}),
    ("mono-12-wiener-extreme-sb128", (1, 1), 12, 66, 130, {"types": (2,), "unit_shift": 1, "extreme": True},
     {"mono": True, "sb128": True}),
    ("420-8-sgrproj-cdef-unit64", (1, 1), 8, 90, 100, {"types": (3, 3, 3), "unit_shift": 0, "uv_shift": 1,
                                                       "sets": [10, 14, 11, 15, 12, 13, 0, 5]},
     {"cdef": {"damping": 3, "bits": 0, "strengths": [[12, 2, 9, 2]]}}),
)


def smoke_cases() -> dict:
    """Phase 22's restoration frames (their texture strength) and its 2048²
    speed-4 raster."""
    import cv2

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    flat, _ = lossy.smoke_frame()
    out, strengths, speeds = {}, {}, {}
    # (name, channels, depth, what)
    for name, ch, depth, what, tries in (("smoke-lr-bgr8", 3, 8, "y-wiener", (6, 3, 4, 5, 8)),
                                         ("smoke-lr-bgr10", 3, 10, "any", (6, 3, 4, 5, 8)),
                                         ("smoke-lr-gray8", 1, 8, "y-sgrproj", (6, 3, 4, 5, 8)),
                                         ("smoke-lr-gray10", 1, 10, "y-sgrproj", (6, 3, 4, 5, 8)),
                                         ("smoke-lr-cdef-gray8", 1, 8, "cdef", (3, 2, 4))):
        found = None
        for strength in tries:
            tex = chip_smoke.avif_textured(flat, strength)
            img = lossy.smoke_bgr(tex) if ch == 3 else tex
            if depth > 8:
                img = img.astype(np.uint16) << (depth - 8)
            for q in (75, 80, 85, 70, 90):
                for speed in (4, 3, 2):
                    data = cv2_lossy(img, q, depth, speed)
                    if CV2_WANT[what](lr_fields(data)):
                        found = data
                        break
                if found:
                    break
            if found:
                break
        assert found, name
        out[name], strengths[name], speeds[name] = found, strength, speed
    rng = np.random.default_rng(3)
    b = cv2.GaussianBlur(rng.random((2048, 2048, 3)).astype(np.float32) * 255, (0, 0), 10)
    b = np.clip((np.asarray(b) - float(np.mean(b))) * 4 + 128, 0, 255).astype(np.uint8)
    out["smoke-2048-speed4"], speeds["smoke-2048-speed4"] = cv2_lossy(b, 75, 8, 4), 4
    assert min(lr_fields(out["smoke-2048-speed4"])[k] for k in ("y", "u", "v")) > 0
    return out, strengths, speeds


def cases():
    """-> ({name: file}, {name: speed}, {name: (plain file, units)}, {name: texture strength})."""
    out, speeds, writers = {}, {}, {}
    tag = {3: "bgr", 1: "gray"}
    for h, w, ch, depth, content, sp, what in CV2_TARGETS:
        data, speed, q = cv2_target(h, w, ch, depth, content, sp, what)
        name = f"cv2-s{speed}-q{q}-{tag[ch]}{depth}-{w}x{h}-{what}"
        out[name], speeds[name] = data, speed
    for ch in (3, 1):  # cv2's 12-bit frames: no restoration
        data = cv2_lossy(blurred(128, 128, 1, ch, 12), 85, 12, 4)
        assert max(lr_fields(data)[k] for k in ("y", "u", "v")) <= 0
        out[f"cv2-12bit-s4-q85-{tag[ch]}12-128x128"], speeds[f"cv2-12bit-s4-q85-{tag[ch]}12-128x128"] = data, 4
    for k, (name, sub, depth, h, w, lr, kw) in enumerate(WRITER_CASES):
        data, plain, units = writer_lr(sub, depth, h, w, 900 + 20 * k, lr, **kw)
        out[f"writer-{name}"], writers[f"writer-{name}"] = data, (plain, units)
    smoke, strengths, smoke_speeds = smoke_cases()
    out.update(smoke)
    speeds.update(smoke_speeds)
    return out, speeds, writers, strengths


def _reference(path: str, data: bytes):
    import cv2

    Path(path).write_bytes(data)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    assert ref is not None
    return ref


def _sha(ref) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)


def main(out: str = str(DEFAULT_OUT)) -> str:
    files, speeds, writers, strengths = cases()
    arrays = {}
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for name, data in files.items():
            ref = _reference(path, data)
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/lr"] = lr_of(data, speeds.get(name, -1))
            if name.startswith("smoke-") or ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = _sha(ref)
            else:
                arrays[f"{name}/bgr"] = ref
            if name in writers:
                plain, units = writers[name]
                arrays[f"{name}/plain"] = np.frombuffer(plain, np.uint8)
                arrays[f"{name}/plain_sha256"] = _sha(_reference(path, plain))
                arrays[f"{name}/units"] = units
            if name in strengths:
                arrays[f"{name}/strength"] = np.array([strengths[name]], np.int16)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

"""Write ``tests/data/torch_avif_intrabc_fixtures.npz``: AVIF files whose AV1
frame allows intra block copy, and what ``cv2.imread(path,
cv2.IMREAD_COLOR)`` (OpenCV 5.0, libavif 1.4 and libaom 3.14) reads from
each, for ``tests/test_torch_avif_intrabc.py`` and ``chip_smoke.py`` phase 22.

libaom's all-intra encoder, which cv2 calls, switches intra block copy on
beside palettes for flat, blocky frames of few colours at speeds 0-7: label
images, masks, flattened micrographs. Its lossless frames are 4:4:4 (gray:
4:0:0) under ONLY_4X4, its lossy ones 4:2:0 with TX_MODE_SELECT at speeds
0-6 and TX_MODE_LARGEST at speed 7.

Each entry ``<name>/file`` holds the file's bytes; ``<name>/bgr`` cv2's
BGR array (at most 40x40 pixels) or ``<name>/sha256`` the SHA-256 of its
bytes, or ``<name>/none`` (empty) where cv2 reads nothing;
``<name>/fields`` (``fields_of``) the frame's FIELDS, read off its
headers by ``tools/av1_headers.py``. The entries:

- ``cv2-<content>-<form><depth>-s<S>-q<Q>``: cv2's frames of a binary
  mask, flat blobs on a flat background, a label image in colour and a
  label image of 8-pixel cells (gray and BGR), at odd sizes, 8, 10 and 12
  bits, each the first (speed, quality) of a rotating schedule over
  speeds 0-7 and qualities 30-100 and the default whose frame allows intra
  block copy: one lossless (quality 100) and one lossy, where any does;
- ``cv2-random-<k>-*``: seeded random blocky frames (cells of 1-8 pixels,
  some tiled with a period and touched up, 24-259 px a side, 2-7 colours,
  gray or BGR, 8, 10 or 12 bits, quality 30-100 or the default, speed
  0-7) that allow intra block copy, those that add a path of ``features``
  to the ones before them, until every path of WANT is held;
- ``writer-*``: ``tools/av1_writer.py``'s frames with skipped blocks that
  copy (``WRITER_CASES``), in the paths cv2's frames do not take: 4:2:2
  (half-pixel chroma across), 128x128 superblocks (their default DV),
  two tile rows (a tile's first superblock row takes the DV 256 pixels
  left of a superblock); ``writer-invalid-dv``: a frame whose first copy
  takes its own, undecoded, position, which libaom marks corrupt;
- ``smoke-intrabc-bgr8``: phase 22's labelled frame
  (``make_torch_avif_lossy_fixtures.smoke_bgr``) as cv2 writes it at
  speed 4 (intra block copy and palettes), which joins phase 22's
  dataset; ``smoke-2048-intrabc``: the frame tiled to 2048x2048 at speed
  4, for the decode time beside the palette fixtures' speed 8 and 9 ones.

    python tools/make_torch_avif_intrabc_fixtures.py

needs cv2; it is deterministic (~2 minutes). It prints the paths cv2's
frames reach, counted by the port's decoder (``native.av1_decode``'s meta).
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
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_intrabc_fixtures.npz"
HASHED_PIXELS = 40 * 40
# the layout of ``<name>/fields``; speed is cv2's (-1 for the writer's)
FIELDS = ("intrabc", "depth", "mono", "ssx", "ssy", "lossless", "tx_mode_select", "reduced_tx_set", "sb128",
          "tile_rows", "width", "height", "speed")
# meta[17]'s bits (av1.cpp: Decoder::kPath*), in order
PATHS = ("half-x", "half-y", "vartx-1", "vartx-2", "set-1", "set-2", "set-3", "default-above", "default-left")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


palette = _tool("make_torch_avif_palette_fixtures")
lossy, fx, aw, hd, cv2_lossy = palette.lossy, palette.fx, palette.aw, palette.hd, palette.cv2_lossy


def fields_of(data: bytes, speed: int = -1) -> np.ndarray:
    """A file's frame: its FIELDS."""
    f = hd.fields(fx.payload_of(data)[0])
    return np.array([f["intrabc"], f["depth"], f["mono"], *f["subsampling"], int(f["base_q_idx"] == 0),
                     f["tx_mode_select"], f["reduced_tx_set"], f["sb128"], 1 << f["tiles_log2"][1], f["width"],
                     f["height"], speed], np.int16)


def frame_fields(data: bytes) -> dict:
    return dict(zip(FIELDS, (int(v) for v in fields_of(data))))


def coded(data: bytes) -> dict:
    """What the port's decoder read in the frame: its blocks that copy, those whose DV stack held a candidate,
    the paths they took (PATHS), and whether palettes were coded too."""
    sys.path.insert(0, str(ROOT))
    from deepemia_tpu_torch import native

    status, meta, _ = native.av1_decode(fx.payload_of(data)[0])
    assert status == 0, status
    return {"blocks": int(meta[15]), "stacked": int(meta[16]),
            "paths": {p for k, p in enumerate(PATHS) if meta[17] >> k & 1}, "palette": bool(meta[11] or meta[12])}


# ---------------------------------------------------------------------------
# Content
# ---------------------------------------------------------------------------


def cells(h: int, w: int, colours: int, channels: int, depth: int, rng, cell: int = 8) -> np.ndarray:
    """A label image of ``cell``-pixel squares in ``colours`` random colours (at ``depth`` bits)."""
    table = rng.integers(0, 1 << depth, (colours, channels))
    index = np.kron(rng.integers(0, colours, (-(-h // cell), -(-w // cell))), np.ones((cell, cell), np.int64))
    img = table[index[:h, :w]].astype(np.uint8 if depth == 8 else np.uint16)
    return img[..., 0] if channels == 1 else img


def tiled(h: int, w: int, colours: int, channels: int, depth: int, rng) -> np.ndarray:
    """Cells of 1-4 pixels tiled with a period of 8-47 pixels, a few spots touched up."""
    ph, pw = (int(v) for v in rng.integers(8, 48, 2))
    base = cells(ph, pw, colours, channels, depth, rng, int(rng.integers(1, 5)))
    img = np.tile(base, (h // ph + 1, w // pw + 1) + ((1,) if channels == 3 else ()))[:h, :w].astype(np.int64)
    for _ in range(int(rng.integers(0, 30))):
        y, x = (int(v) for v in rng.integers(0, (h, w)))
        dy, dx, step = int(rng.integers(1, 6)), int(rng.integers(1, 6)), int(rng.integers(-40, 40))
        img[y : y + dy, x : x + dx] += step << (depth - 8)
    return np.clip(img, 0, (1 << depth) - 1).astype(np.uint8 if depth == 8 else np.uint16)


ODD = (203, 147)  # height, width
CONTENTS = {"mask": lambda: palette.mask(*ODD, 1), "blobs": lambda: palette.blobs(*ODD, 2),
            "labels": lambda: palette.colour(palette.labels(*ODD, 3)),
            "cells": lambda: cells(*ODD, 5, 1, 8, np.random.default_rng(4)),
            "cells-bgr": lambda: cells(*ODD, 6, 3, 8, np.random.default_rng(5))}
# (speed, quality) tried in turn, from a rotating start; quality 100 is lossless
LOSSY_SCHEDULE = [(s, q) for q in (None, 70, 50, 90, 30) for s in (7, 5, 3, 1, 6, 4, 2, 0)]
LOSSLESS_SCHEDULE = [(s, 100) for s in (7, 5, 3, 1, 6, 4, 2, 0)]
# what cv2's frames must reach between them (``features``)
WANT = ({("form", d, m, l) for d in (8, 10, 12) for m in (0, 1) for l in (0, 1)} | {("speed", s) for s in range(8)}
        | {("tx_mode_select", v) for v in (0, 1)}
        | {"stacked", "palette", "half-x", "half-y", "vartx-1", "set-1", "set-2", "set-3", "default-above"})


def features(data: bytes, speed: int) -> set:
    """What a frame reaches: its form, speed and (lossy) tx mode, a non-empty DV stack, palette blocks beside
    the copies, and the paths of ``coded``."""
    f, c = frame_fields(data), coded(data)
    out = {("form", f["depth"], f["mono"], f["lossless"]), ("speed", speed)} | c["paths"]
    if not f["lossless"]:
        out.add(("tx_mode_select", f["tx_mode_select"]))
    out |= {"stacked"} if c["stacked"] else set()
    out |= {"palette"} if c["palette"] else set()
    return out


def named_cases() -> dict:
    """cv2's frames of each content: {name: (file, speed)}."""
    out = {}
    for k, (content, make) in enumerate(CONTENTS.items()):
        img = make()
        form = "bgr" if img.ndim == 3 else "gray"
        for depth in (8, 10, 12):
            for schedule in (LOSSLESS_SCHEDULE, LOSSY_SCHEDULE):
                start = (3 * k + depth) % len(schedule)
                for speed, q in schedule[start:] + schedule[:start]:
                    data = cv2_lossy(palette.at_depth(img, depth), q, depth, speed)
                    if frame_fields(data)["intrabc"]:
                        out[f"cv2-{content}-{form}{depth}-s{speed}-q{q or 'default'}"] = (data, speed)
                        break
    return out


def random_cases(n: int = 600, seed: int = 25) -> dict:
    """Seeded random blocky frames that allow intra block copy and each add what the frames before them did not
    reach, until WANT is reached or ``n`` are tried: {name: (file, speed)}."""
    rng = np.random.default_rng(seed)
    out, reached = {}, set()
    for i in range(n):
        h, w = (int(v) for v in rng.integers(24, 260, 2))
        colours, ch, depth = int(rng.integers(2, 8)), int(rng.choice([1, 3])), int(rng.choice([8, 10, 12]))
        q = [None, 100, 90, 70, 50, 30][int(rng.integers(0, 6))]
        speed = int(rng.integers(0, 8))
        make = tiled if rng.random() < 0.6 else cells
        data = cv2_lossy(make(h, w, colours, ch, depth, rng), q, depth, speed)
        if not frame_fields(data)["intrabc"]:
            continue
        new = features(data, speed) - reached
        if new & WANT:
            reached |= new
            out[f"cv2-random-{i}-{'bgr' if ch == 3 else 'gray'}{depth}-{w}x{h}-s{speed}-q{q or 'default'}"] = (data,
                                                                                                           speed)
        if WANT <= reached:
            break
    return out


# the writer's frames: (name, subsampling, depth, h, w, lossy, keywords); the copies are skipped blocks
_LOSSY = {"q": 12}
_WEIGHTS = {12: [1.0, 0.3, 0.3, 2.0] + [0.3] * 6, 9: [1.0, 0.3, 0.3, 1.0] + [0.3] * 6,
            15: [0.5, 0.2, 0.2, 2.0] + [0.2] * 6}
WRITER_CASES = (
    ("422-8-lossless", (1, 0), 8, 72, 360, None, {}),
    ("422-10-lossy", (1, 0), 10, 136, 344, _LOSSY, {}),
    ("420-8-sb128-lossy", (1, 1), 8, 200, 424, _LOSSY, {"sb128": True}),
    ("444-12-tile-rows-lossy", (0, 0), 12, 184, 336, _LOSSY, {"tiles": ("uniform", 0, 1)}),
    ("mono-10-sb128-tile-rows-lossy", (1, 1), 10, 296, 400, _LOSSY,
     {"mono": True, "sb128": True, "tiles": ("uniform", 0, 1)}),
    ("invalid-dv", (1, 1), 8, 72, 344, _LOSSY, {"invalid": True}),
)


def writer_frame(sub, depth: int, h: int, w: int, lossy_params, seed: int, mono: bool = False, sb128: bool = False,
                 tiles=("uniform", 0, 0), invalid: bool = False) -> bytes:
    """The writer's frame of random planes (BT.709 matrix, full range; the planes give only the size where the
    frame is lossy) with blocks that copy, at high odds, a pixel off the default DV at even odds."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1 << depth, (h, w))
    c = rng.integers(0, 1 << depth, (2, (h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]))
    intrabc = {"odds": 0.5, "shift": 0.5, "invalid": invalid}
    payload = aw.encode([y] if mono else [y, c[0], c[1]], depth, subsampling=sub, matrix=1, full_range=True,
                        seed=seed, sb128=sb128, tiles=tiles, lossy=lossy_params, weights=_WEIGHTS, intrabc=intrabc)
    return fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                  fx.colr_nclx(1, 13, 1, 1))])


def smoke_cases() -> dict:
    """Phase 22's intra block copy frame and its 2048² twin: {name: (file, speed)}."""
    flat, _ = lossy.smoke_frame()
    out = {"smoke-intrabc-bgr8": (cv2_lossy(lossy.smoke_bgr(flat), None, 8, 4), 4)}
    tiled_flat = lossy.smoke_bgr(np.tile(flat, (3, 2))[:2048, :2048])
    out["smoke-2048-intrabc"] = (cv2_lossy(tiled_flat, None, 8, 4), 4)
    for name, (data, _) in out.items():
        assert frame_fields(data)["intrabc"], name
    return out


def cases() -> dict:
    """-> {name: (file, speed)}."""
    out = {**named_cases(), **random_cases()}
    for k, (name, sub, depth, h, w, lossy_params, kw) in enumerate(WRITER_CASES):
        out[f"writer-{name}"] = (writer_frame(sub, depth, h, w, lossy_params, 2500 + k, **kw), -1)
    out.update(smoke_cases())
    return out


def _sha(ref) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)


def main(out: str = str(DEFAULT_OUT)) -> str:
    import cv2

    arrays, reached = {}, set()
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for name, (data, speed) in cases().items():
            Path(path).write_bytes(data)
            ref = cv2.imread(path, cv2.IMREAD_COLOR)
            assert (ref is None) == (name == "writer-invalid-dv"), name
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/fields"] = fields_of(data, speed)
            if ref is None:
                arrays[f"{name}/none"] = np.zeros(0, np.uint8)
            elif name.startswith("smoke-") or ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = _sha(ref)
            else:
                arrays[f"{name}/bgr"] = ref
            if name.startswith("cv2-"):
                reached |= features(data, speed)
    missing = WANT - reached
    assert not missing, f"cv2's frames reach no {sorted(missing, key=str)}"
    print("cv2's frames reach:", sorted(reached, key=str))
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

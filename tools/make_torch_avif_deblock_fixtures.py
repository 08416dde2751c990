"""Write ``tests/data/torch_avif_deblock_fixtures.npz``: AVIF files whose
AV1 frame libaom deblocks (a loop filter level other than 0) and filters
no other way, and what ``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV 5.0,
libavif 1.4 and libaom 3.14) reads from each, for
``tests/test_torch_avif_deblock.py``.

Each entry ``<name>/file`` holds the file's bytes; ``<name>/bgr`` cv2's
BGR array (at most 64x64 pixels) or ``<name>/sha256`` the SHA-256 of its
bytes; ``<name>/lf`` the frame's loop filter levels (Y vertical edges, Y
horizontal, U, V), sharpness, INTRA_FRAME level delta (0 with the deltas
off), whether it selects transform sizes per block (TX_MODE_SELECT) and
whether it has 128x128 superblocks. The entries:

- ``q<Q>-<form><depth>-<w>x<h>``: cv2's files at the qualities where
  libaom deblocks and applies no CDEF (8 bits 85 and 90, 10 bits 85-97,
  12 bits 85-95), BGR (4:2:0) and gray (4:0:0), of a blurred-noise image;
- ``size-*``: 1x1, one row, one column, odd sizes up to 512x512;
- ``txsel-*``: deblocked frames libaom writes with TX_MODE_SELECT;
- ``nocdef-q<Q>-*``: cv2's files at quality 80, 75, 50 and its default,
  which deblock at levels 3-19 and apply CDEF, with the CDEF strengths
  rewritten to 0 (``av1_headers.strip_filters(keep_loop_filter=True)``),
  which cv2 then decodes deblocked only;
- ``lf-*``: those rewritten further (``av1_headers.rewrite_loop_filter``)
  to probe each rule of the filter against cv2: sharpness 0-7, levels 0
  and 1 apart (each 0 alone), U and V apart (each 0 alone), levels on
  both sides of 32, the INTRA_FRAME ref delta written, at 8, 10 and 12
  bits, BGR and gray;
- ``writer-<sub>-<depth>-*``: ``tools/av1_writer.py``'s lossy frames
  (random 4x4 residuals, every other block its prediction alone) in
  4:4:4 (a BT.709 matrix, and the identity, whose planes cv2 returns as
  they are), 4:2:2 and 4:2:0, at 8, 10 and 12 bits, the deltas on and
  off, 64x64 and 128x128 superblocks: the subsamplings cv2 does not
  write lossy.

    python tools/make_torch_avif_deblock_fixtures.py

needs cv2; it is deterministic (~1 minute).
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_deblock_fixtures.npz"
HASHED_PIXELS = 64 * 64
# the qualities at which libaom deblocks and applies no CDEF, by bit depth
DEBLOCK_QUALITIES = {8: (85, 90), 10: (85, 90, 92, 95, 97), 12: (85, 90, 92, 95)}


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lossy = _tool("make_torch_avif_lossy_fixtures")
fx, aw, hd = lossy.fx, lossy.aw, lossy.hd
blurred, cv2_lossy, with_payload = lossy.blurred, lossy.cv2_lossy, lossy.with_payload


def loop_filter_of(data: bytes) -> np.ndarray:
    """[Y vertical level, Y horizontal, U, V, sharpness, INTRA_FRAME
    delta, TX_MODE_SELECT, 128x128 superblocks] of a file's frame."""
    f = hd.fields(fx.payload_of(data)[0])
    assert not any(any(c) for c in f["cdef_strengths"]), "a frame that applies CDEF"
    delta = f["lf_deltas"].get(0, 1) if f["lf_delta_enabled"] else 0
    return np.array(list(f["loop_filter"]) + list(f.get("loop_filter_uv", (0, 0))) +
                    [f["sharpness"], delta, f["tx_mode_select"], f["sb128"]], np.int16)


def nocdef(data: bytes) -> bytes:
    return with_payload(data, hd.strip_filters(fx.payload_of(data)[0], keep_loop_filter=True))


def rewritten(data: bytes, **kw) -> bytes:
    return with_payload(data, hd.rewrite_loop_filter(fx.payload_of(data)[0], cdef=False, **kw))


def writer_lossy(sub, depth: int, h: int, w: int, seed: int, levels, sharpness: int = 0, delta=1, mc: int = 1,
                 sb128: bool = False) -> bytes:
    """The writer's lossy frame at subsampling ``sub`` under matrix ``mc``
    (full range, BT.709 primaries), from the first seed from ``seed`` on
    whose frame cv2 reads otherwise with levels 0 (one whose blocks the
    filter changes)."""
    import cv2

    y = np.zeros((h, w), np.int64)
    c = np.zeros(((h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]), np.int64)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for s in range(seed, seed + 20):
            payload = aw.encode([y, c, c], depth, subsampling=sub, matrix=mc, full_range=True, seed=s, sb128=sb128,
                                lossy={"q": 18, "levels": levels, "sharpness": sharpness, "delta": delta})
            data = fx.avif([fx.image_item(payload, aw.av1c(depth, False, sub), w, h, depth, 3,
                                          fx.colr_nclx(1, 13, mc, 1))])
            reads = []
            for frame in (data, with_payload(data, hd.rewrite_loop_filter(payload, levels=(0, 0, 0, 0)))):
                Path(path).write_bytes(frame)
                reads.append(cv2.imread(path, cv2.IMREAD_COLOR))
            if not np.array_equal(*reads):
                return data
    raise AssertionError("no seed whose frame the filter changes")


def cases() -> dict:
    out = {}
    tag = {3: "bgr", 1: "gray"}
    # cv2's deblocked files
    for depth, qualities in DEBLOCK_QUALITIES.items():
        for q in qualities:
            out[f"q{q}-bgr{depth}-53x37"] = cv2_lossy(blurred(37, 53, q * 3 + depth, 3, depth), q, depth)
            out[f"q{q}-gray{depth}-41x29"] = cv2_lossy(blurred(29, 41, q * 5 + depth, 1, depth), q, depth)
    for h, w, ch, depth, q in ((1, 1, 3, 8, 85), (1, 1, 1, 10, 90), (1, 9, 3, 8, 85), (9, 1, 3, 12, 90),
                               (3, 5, 1, 8, 85), (7, 33, 3, 10, 85), (65, 65, 3, 8, 85), (33, 66, 1, 12, 85),
                               (100, 3, 3, 10, 90), (255, 257, 3, 10, 90), (512, 512, 3, 8, 85)):
        out[f"size-{tag[ch]}{depth}-{w}x{h}"] = cv2_lossy(blurred(h, w, h * 7 + w + depth, ch, depth), q, depth)
    for h, w, ch in ((65, 77, 3), (129, 193, 1), (129, 193, 3)):
        for seed in range(1, 60):  # the first seed whose frame libaom writes so
            data = cv2_lossy(blurred(h, w, seed, ch), 85)
            f = hd.fields(fx.payload_of(data)[0])
            if f["tx_mode_select"] and any(f["loop_filter"]):
                break
        assert f["tx_mode_select"] and any(f["loop_filter"]), (h, w, ch)
        out[f"txsel-{tag[ch]}-{w}x{h}"] = data
    # the CDEF strengths rewritten to 0
    for q in (80, 75, 50, None):
        for depth in (8, 10, 12):
            for ch, (h, w) in ((3, (45, 61)), (1, (50, 70))):
                data = cv2_lossy(blurred(h, w, 300 + (q or 0) + depth + ch, ch, depth), q, depth)
                out[f"nocdef-q{q or 'default'}-{tag[ch]}{depth}-{w}x{h}"] = nocdef(data)
    out["nocdef-q50-bgr8-193x129"] = nocdef(cv2_lossy(blurred(129, 193, 77, 3), 50))
    # header rewrites of the loop filter parameters
    base = out["nocdef-q75-bgr8-61x45"]
    for s in range(8):
        out[f"lf-bgr8-sharpness{s}"] = rewritten(base, sharpness=s)
        out[f"lf-bgr8-sharpness{s}-level30"] = rewritten(base, levels=(30, 30, 20, 20), sharpness=s)
    for levels in ((9, 2, 4, 4), (4, 0, 3, 3), (0, 4, 3, 3), (6, 6, 0, 7), (6, 6, 7, 0), (6, 6, 12, 3),
                   (31, 32, 32, 31), (40, 33, 63, 20), (63, 63, 63, 63), (1, 1, 1, 1)):
        out[f"lf-bgr8-levels{'-'.join(map(str, levels))}"] = rewritten(base, levels=levels)
    for d in (-64, -8, -1, 0, 2, 5, 63):
        out[f"lf-bgr8-delta{d}"] = rewritten(base, levels=(20, 40, 10, 2), ref_delta_intra=d)
        out[f"lf-bgr8-delta{d}-level33"] = rewritten(base, levels=(33, 2, 40, 0), ref_delta_intra=d)
    for name, src in (("bgr10", out["nocdef-q75-bgr10-61x45"]), ("bgr12", out["nocdef-q50-bgr12-61x45"]),
                      ("gray8", out["nocdef-qdefault-gray8-70x50"]), ("gray12", out["nocdef-q80-gray12-70x50"])):
        for s in (1, 4, 5, 7):
            out[f"lf-{name}-sharpness{s}"] = rewritten(src, levels=(24, 24, 24, 24), sharpness=s)
        for levels in ((5, 0, 9, 9), (0, 5, 9, 9), (12, 3, 0, 30), (44, 37, 30, 0)):
            out[f"lf-{name}-levels{'-'.join(map(str, levels))}"] = rewritten(src, levels=levels)
        out[f"lf-{name}-delta-5"] = rewritten(src, levels=(20, 40, 10, 2), ref_delta_intra=-5)
    # the writer's lossy frames: the subsamplings cv2 does not write lossy
    k = 0
    for sub, stag in (((0, 0), "444"), ((1, 0), "422"), ((1, 1), "420")):
        for depth in (8, 10, 12):
            for (h, w), levels, sharpness, delta, sb128 in (((37, 53), (20, 40, 30, 63), 0, 1, False),
                                                            ((64, 45), (9, 5, 3, 17), 3, None, True)):
                out[f"writer-{stag}-{depth}-{w}x{h}-{'sb128' if sb128 else 'sb64'}"] = writer_lossy(
                    sub, depth, h, w, 500 + k, levels, sharpness, delta, sb128=sb128)
                k += 1
    for h, w, seed in ((37, 53, 600), (64, 61, 601)):  # the identity matrix: cv2 returns the planes as they are
        out[f"writer-444-8-identity-{w}x{h}"] = writer_lossy((0, 0), 8, h, w, seed, (14, 22, 8, 35), 2, -2, mc=0)
    return out


def main(out: str = str(DEFAULT_OUT)) -> str:
    import cv2

    arrays = {}
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for name, data in cases().items():
            Path(path).write_bytes(data)
            ref = cv2.imread(path, cv2.IMREAD_COLOR)
            assert ref is not None, name
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/lf"] = loop_filter_of(data)
            if ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)
            else:
                arrays[f"{name}/bgr"] = ref
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

"""Write ``tests/data/torch_avif_cdef_fixtures.npz``: AVIF files whose AV1
frame libaom filters with CDEF (the Constrained Directional Enhancement
Filter, after deblocking), and what ``cv2.imread(path, cv2.IMREAD_COLOR)``
(OpenCV 5.0, libavif 1.4 and libaom 3.14) reads from each, for
``tests/test_torch_avif_cdef.py`` and ``chip_smoke.py`` phases 21 and 22.

Each entry ``<name>/file`` holds the file's bytes; ``<name>/bgr`` cv2's
BGR array (at most 40x40 pixels) or ``<name>/sha256`` the SHA-256 of its
bytes; ``<name>/cdef`` (``cdef_of``) the frame's damping, index bits,
superblock size, TX_MODE_SELECT, depth, monochrome, subsampling, size,
whether whole 64x64s skip, and its strength entries; ``<name>/named``
instead, for a frame the port still refuses, the words of the refusal.
The entries:

- ``q<Q>-<form><depth>-<w>x<h>``: cv2's files at every quality of its
  CDEF table (83 down to 20, and its default), 8, 10 and 12 bits, BGR
  (4:2:0) and gray (4:0:0), of a blurred-noise image at odd sizes;
- ``size-*``: 1x1, one row, one column, odd sizes up to 512x512;
- ``txsel-*``: frames libaom writes with TX_MODE_SELECT;
- ``speed<S>-*``: cv2's frames at speeds 0-6 that carry chroma
  strengths, secondary strengths alone, or two index entries
  (``cdef_bits`` 1), and no loop restoration;
- ``rw-*``: cv2 frames whose damping and strengths
  ``av1_headers.rewrite_cdef`` rewrote: damping 3-6, each Y and UV
  primary 0-15 and secondary 0-3 (3 is read as 4), primary 0 with a
  secondary and the reverse, two different entries on a ``cdef_bits`` 1
  frame, the damping steps on a noisy frame, at 8, 10 and 12 bits;
- ``writer-<sub>-<depth>-*``: ``tools/av1_writer.py``'s lossy frames
  under CDEF in 4:4:4, 4:2:2, 4:2:0 and 4:0:0 at 8, 10 and 12 bits,
  ``cdef_bits`` 0-3, 64x64 and 128x128 superblocks, one 64x64 whose
  blocks all skip (its index never written, -1) and 4x4 blocks that code
  skip 0 and no coefficient (filtered: libaom's skip is the flag read):
  the forms cv2 does not write;
- ``refused-*``: cv2's frame at speed 4 with loop restoration and the
  writer's with delta loop filter levels (each superblock's deltas 0),
  which the port refused by name until it applied each and now reads,
  and the writer's with film grain (``apply_grain``, three luma points:
  cv2's pixels differ from the frame's without grain), which it still
  refuses by name (phases 21 and 22 and every "refused by name" test
  check that refusal);
- ``smoke-*``: phase 22's labelled frame (``chip_smoke.draw_labelled``,
  seed 22, its background flattened) as cv2 writes it by default (BGR),
  at quality 75 and 10 bits (BGR) and by default at 12 bits (gray); a
  2048² BGR micrograph at cv2's default quality, for the decode time.

    python tools/make_torch_avif_cdef_fixtures.py

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
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_cdef_fixtures.npz"
HASHED_PIXELS = 40 * 40
# cv2's CDEF table at speed 9: the qualities whose frames carry CDEF strengths (None: its default, 50)
CDEF_QUALITIES = (83, 80, 75, 70, 60, 50, 40, 20, None)
# the layout of ``<name>/cdef``: these fields, then 8 strength entries of 4 (-1 where there is none)
CDEF_FIELDS = ("damping", "bits", "sb128", "tx_mode_select", "depth", "mono", "ssx", "ssy", "width", "height",
               "skip64")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lossy = _tool("make_torch_avif_lossy_fixtures")
fx, aw, hd = lossy.fx, lossy.aw, lossy.hd
blurred, with_payload = lossy.blurred, lossy.with_payload


def cv2_lossy(img: np.ndarray, quality, depth: int = 8, speed=None) -> bytes:
    import cv2

    params = [] if quality is None else [cv2.IMWRITE_AVIF_QUALITY, quality]
    if depth > 8:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    if speed is not None:
        params += [cv2.IMWRITE_AVIF_SPEED, speed]
    ok, buf = cv2.imencode(".avif", img, params)
    assert ok
    return buf.tobytes()


def noise(h: int, w: int, seed: int, channels: int = 3, depth: int = 8) -> np.ndarray:
    v = np.random.default_rng(seed).integers(0, 1 << depth, (h, w, channels))
    v = v.astype(np.uint8 if depth == 8 else np.uint16)
    return v[..., 0] if channels == 1 else v


def cdef_of(data: bytes, skip64: bool = False) -> np.ndarray:
    """A file's frame: CDEF_FIELDS, then its strength entries ([Y primary,
    Y secondary, UV primary, UV secondary], as coded: 3 is read as 4)
    padded to 8 with -1."""
    f = hd.fields(fx.payload_of(data)[0])
    head = [f.get("cdef_damping", 0), f.get("cdef_bits", 0), f["sb128"], f["tx_mode_select"], f["depth"], f["mono"],
            *f["subsampling"], f["width"], f["height"], int(skip64)]
    entries = [list(e) + [-1] * (4 - len(e)) for e in f["cdef_strengths"]]
    entries += [[-1] * 4] * (8 - len(entries))
    return np.array(head + [v for e in entries for v in e], np.int16)


def rewritten(data: bytes, **kw) -> bytes:
    return with_payload(data, hd.rewrite_cdef(fx.payload_of(data)[0], **kw))


def writer_cdef(sub, depth: int, h: int, w: int, seed: int, cdef: dict, sb128: bool = False, skip64=(),
                empty: float = 0.0, mono: bool = False, film_grain=None, search: bool = True, **extra) -> bytes:
    """The writer's lossy frame under CDEF (deblocked too), from the first
    seed from ``seed`` on whose frame cv2 reads otherwise with every
    strength 0 (one whose blocks the filter changes); without ``search``,
    the frame of ``seed``."""
    import cv2

    y = np.zeros((h, w), np.int64)
    c = np.zeros(((h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]), np.int64)
    zero = [[0] * len(e) for e in cdef["strengths"]]
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for s in range(seed, seed + 20):
            payload = aw.encode([y] if mono else [y, c, c], depth, subsampling=sub, matrix=1, full_range=True,
                                seed=s, sb128=sb128, film_grain=film_grain,
                                lossy={"q": 18, "levels": (6, 9, 4, 5), "sharpness": 1, "delta": 1, "cdef": cdef,
                                       "skip64": skip64, "empty": empty, **extra})
            data = fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                          fx.colr_nclx(1, 13, 1, 1))])
            if not search:
                return data
            reads = []
            for frame in (data, with_payload(data, hd.rewrite_cdef(payload, strengths=zero))):
                Path(path).write_bytes(frame)
                reads.append(cv2.imread(path, cv2.IMREAD_COLOR))
            if reads[0] is not None and not np.array_equal(*reads):
                return data
    raise AssertionError("no seed whose frame CDEF changes")


def smoke_cases() -> dict:
    """Phase 22's CDEF frames and its 2048² default-quality raster."""
    out = {}
    flat, _ = lossy.smoke_frame()
    bgr = lossy.smoke_bgr(flat)
    out["smoke-bgr-default"] = cv2_lossy(bgr, None)
    out["smoke-bgr10-75"] = cv2_lossy(bgr.astype(np.uint16) << 2, 75, 10)
    out["smoke-gray12-default"] = cv2_lossy(flat.astype(np.uint16) << 4, None, 12)
    for name in ("smoke-bgr-default", "smoke-bgr10-75", "smoke-gray12-default"):
        assert any(any(e) for e in hd.fields(fx.payload_of(out[name])[0])["cdef_strengths"]), name
    p = fx.particles(2048, 0).astype(np.int16)
    particles = np.stack([p, np.clip(p + 10, 0, 255), np.clip(p - 8, 0, 255)], -1).astype(np.uint8)
    out["smoke-2048-default"] = cv2_lossy(particles, None)
    return out


def cases() -> dict:
    out = {}
    tag = {3: "bgr", 1: "gray"}
    # cv2's table: every CDEF quality, 8/10/12 bits, BGR and gray
    for q in CDEF_QUALITIES:
        for depth in (8, 10, 12):
            name = q or "default"
            out[f"q{name}-bgr{depth}-53x37"] = cv2_lossy(blurred(37, 53, (q or 1) * 3 + depth, 3, depth), q, depth)
            out[f"q{name}-gray{depth}-41x29"] = cv2_lossy(blurred(29, 41, (q or 1) * 5 + depth, 1, depth), q, depth)
    for h, w, ch, depth, q in ((1, 1, 3, 8, None), (1, 1, 1, 12, 40), (1, 9, 3, 8, 20), (9, 1, 3, 10, None),
                               (3, 5, 1, 8, 60), (7, 33, 3, 12, 50), (37, 53, 3, 8, 20), (65, 65, 3, 10, None),
                               (33, 66, 1, 8, None), (100, 3, 3, 12, 20), (129, 193, 3, 8, None),
                               (255, 257, 3, 10, 40), (299, 151, 1, 12, None), (512, 512, 3, 8, None)):
        out[f"size-{tag[ch]}{depth}-{w}x{h}"] = cv2_lossy(blurred(h, w, h * 7 + w + depth, ch, depth), q, depth)
    for h, w, ch in ((65, 77, 3), (129, 193, 1), (129, 193, 3)):
        for seed in range(1, 80):  # the first seed and quality whose frame libaom writes so
            for q in (None, 60, 75):
                data = cv2_lossy(blurred(h, w, seed, ch), q)
                f = hd.fields(fx.payload_of(data)[0])
                if f["tx_mode_select"] and any(any(e) for e in f["cdef_strengths"]):
                    break
            else:
                continue
            break
        assert f["tx_mode_select"] and any(any(e) for e in f["cdef_strengths"]), (h, w, ch)
        out[f"txsel-{tag[ch]}-{w}x{h}"] = data
    # cv2's slower speeds: chroma strengths, secondary strengths alone, two index entries
    b64, b256 = blurred(64, 80, 7, 3), blurred(256, 256, 7, 3)
    for speed, q, img, name in ((0, 20, b64, "bgr8-80x64"), (3, 5, b64, "bgr8-80x64"), (4, 20, b64, "bgr8-80x64"),
                                (6, 5, b64, "bgr8-80x64"), (3, 20, b256, "bgr8-256x256"),
                                (4, 20, b256, "bgr8-256x256"), (5, 50, b256, "bgr8-256x256"),
                                (5, 75, b256, "bgr8-256x256"), (6, 83, b256, "bgr8-256x256")):
        out[f"speed{speed}-q{q}-{name}"] = cv2_lossy(img, q, speed=speed)
    out["speed4-q20-bgr10-80x64"] = cv2_lossy(blurred(64, 80, 7, 3, 10), 20, 10, speed=4)
    out["speed6-q40-gray12-80x64"] = cv2_lossy(blurred(64, 80, 8, 1, 12), 40, 12, speed=6)
    # header rewrites of cv2's frames
    base = out["qdefault-bgr8-53x37"]
    for d in range(3, 7):
        out[f"rw-bgr8-damping{d}"] = rewritten(base, damping=d, strengths=[[12, 2, 9, 2]])
    for v in range(16):
        out[f"rw-bgr8-ypri{v}"] = rewritten(base, strengths=[[v, 0, 0, 0]])
        out[f"rw-bgr8-uvpri{v}"] = rewritten(base, strengths=[[0, 0, v, 0]])
    for v in range(4):
        out[f"rw-bgr8-ysec{v}"] = rewritten(base, strengths=[[0, v, 0, 0]])
        out[f"rw-bgr8-uvsec{v}"] = rewritten(base, strengths=[[0, 0, 0, v]])
        out[f"rw-bgr8-both{v}"] = rewritten(base, strengths=[[5 + v, v, 3 + 2 * v, 3 - v]])
    two = out["speed5-q75-bgr8-256x256"]  # cdef_bits 1
    assert hd.fields(fx.payload_of(two)[0])["cdef_bits"] == 1
    for k, entries in enumerate(([[9, 1, 0, 0], [0, 0, 0, 0]], [[0, 0, 0, 0], [9, 1, 0, 0]],
                                 [[3, 0, 8, 3], [12, 3, 1, 0]], [[15, 3, 15, 3], [1, 1, 1, 1]])):
        out[f"rw-bits1-entries{k}"] = rewritten(two, damping=3 + k, strengths=entries)
    noisy = cv2_lossy(noise(48, 56, 5), None)
    for d in range(3, 7):
        out[f"rw-noisy-damping{d}"] = rewritten(noisy, damping=d, strengths=[[10, 2, 10, 2]])
    for name in ("qdefault-bgr10-53x37", "q40-gray12-41x29", "qdefault-gray8-41x29", "q20-bgr12-53x37"):
        src, form = out[name], name.split("-")[1]
        per = 2 if form.startswith("gray") else 4
        for k, entry in enumerate(([7, 3, 5, 1], [0, 2, 0, 3], [15, 0, 15, 0], [4, 1, 0, 2])):
            out[f"rw-{form}-{k}"] = rewritten(src, damping=3 + k, strengths=[entry[:per]])
    # the writer's lossy frames: every subsampling and depth, cdef_bits 0-3, both superblock sizes
    k = 0
    for sub, stag, mono in (((0, 0), "444", False), ((1, 0), "422", False), ((1, 1), "420", False),
                            ((1, 1), "mono", True)):
        for depth in (8, 10, 12):
            bits, sb128 = k % 4, bool(k % 2)
            rng = np.random.default_rng(700 + k)
            entries = [[int(rng.integers(0, 16)), int(rng.integers(0, 4)), int(rng.integers(0, 16)),
                        int(rng.integers(0, 4))][: 2 if mono else 4] for _ in range(1 << bits)]
            entries[0][:2] = [9, 3]
            cdef = {"damping": 3 + k % 4, "bits": bits, "strengths": entries}
            h, w = (72, 136) if sb128 else (45, 61)
            out[f"writer-{stag}-{depth}-{w}x{h}-bits{bits}-{'sb128' if sb128 else 'sb64'}"] = writer_cdef(
                sub, depth, h, w, 800 + 20 * k, cdef, sb128=sb128, skip64=[(0, 1)] if sb128 else (),
                empty=0.1, mono=mono)
            k += 1
    # loop restoration (cv2 at speed 4) and delta loop filter levels (the writer's), refused by name until the port
    # applied each; film grain (the writer's), refused by name
    for seed in range(1, 40):
        data = cv2_lossy(blurred(128, 128, seed, 3), 75, speed=4)
        if any(hd.fields(fx.payload_of(data)[0])["lr_type"]):
            out["refused-restoration-bgr8-128x128"] = data
            break
    out["refused-delta-lf-420-8"] = writer_cdef((1, 1), 8, 40, 72, 900, {"damping": 4, "bits": 0,
                                                                          "strengths": [[6, 1, 3, 1]]}, delta_lf=True,
                                              search=False)
    out["refused-film-grain-420-8"] = film_grain_frame()
    out.update(smoke_cases())
    return out


NAMED = {"refused-film-grain-420-8": "AV1 film grain"}


def film_grain_frame() -> bytes:
    """The writer's 4:2:0 frame with film grain, held to change what cv2 reads from the same frame without it."""
    import cv2

    cdef = {"damping": 4, "bits": 0, "strengths": [[6, 1, 3, 1]]}
    grain, plain = (writer_cdef((1, 1), 8, 40, 72, 901, cdef, film_grain=g, search=False)
                    for g in (2026, None))
    with tempfile.TemporaryDirectory() as d:
        reads = []
        for data in (grain, plain):
            path = Path(d) / "f.avif"
            path.write_bytes(data)
            reads.append(cv2.imread(str(path), cv2.IMREAD_COLOR))
    assert reads[0] is not None and not np.array_equal(*reads), "film grain changes no pixel"
    return grain


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
            if name in NAMED:
                arrays[f"{name}/named"] = np.frombuffer(NAMED[name].encode(), np.uint8)
            else:
                arrays[f"{name}/cdef"] = cdef_of(data, skip64="sb128" in name and name.startswith("writer-"))
            if name.startswith("smoke-") or ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)
            else:
                arrays[f"{name}/bgr"] = ref
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

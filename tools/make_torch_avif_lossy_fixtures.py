"""Write ``tests/data/torch_avif_lossy_fixtures.npz``: lossy and subsampled
AVIF files and what ``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV 5.0,
libavif 1.4 and libaom 3.14) reads from each, for
``tests/test_torch_avif_lossy.py`` and ``chip_smoke.py`` phase 22.

Each entry ``<name>/file`` holds the file's bytes; ``<name>/bgr`` cv2's
BGR array (at most 64x64 pixels) or ``<name>/sha256`` the SHA-256 of its
bytes, or ``<name>/none`` where cv2 returns None (YCgCo at limited range,
YCgCo-Re other than at 10 bits and full range, two colour properties of
one type); ``<name>/named`` the words with which the port refuses a frame
(``WRITER_NAMED``: a chroma-derived matrix libavif works out in float);
``<name>/deblocked`` (empty) marks a frame whose loop filter level is not
0 and that applies no CDEF, which the port deblocks; ``<name>/cdef``
(empty) a frame that applies CDEF (a CDEF strength other than 0, read off
the frame header by ``tools/av1_headers.py``), which the port filters
too. The entries:

- ``q<Q>-<form>``: cv2's files at quality 92-99, 8, 10 and 12 bits, BGR
  (4:2:0) and gray (4:0:0), of a blurred-noise image at odd sizes;
- ``size-*``: 1x1, one row, one column, odd sizes, 64x64+1 and 512x512;
- ``txsel-*``: frames libaom writes with TX_MODE_SELECT (transform depths
  read per block) and no in-loop filter;
- ``plain-*``: cv2's files at qualities 75 and 50 (and its default) with
  the loop filter levels and CDEF strengths rewritten to 0
  (``av1_headers.strip_filters``), which cv2 then decodes without
  them: the larger quantizers, q-contexts 2 and 3, delta q for chroma and
  per superblock;
- ``filter-*``: frames that deblock or apply CDEF, which cv2 reads, and
  so does the port;
- ``writer-<sub>-mc<M>-<range>-<depth>``: ``tools/av1_writer.py``'s
  lossless 4:2:0, 4:2:2 and 4:4:4 frames of random planes under every
  matrix libavif converts (``ops/avif.py:_MATRICES``), full and limited
  range, and two under chroma-derived coefficients the port refuses;
- ``c13-<sub>-<depth>-<range>-cp<P>-<w>x<h>``: the writer's lossless
  frames under YCgCo-Re (matrix 16), which cv2 reads at 10 bits and full
  range only, at 4:4:4, 4:2:2 and 4:2:0, odd sizes, colour primaries 1, 9
  and 12;
- ``box-colr-*``: a quality-95 frame under ICC, nclx and other ``colr``
  properties in turn, one or two of a type;
- ``smoke-*``: phase 22's labelled frame (``chip_smoke.draw_labelled``,
  seed 22, its background flattened) as cv2 writes it at quality 95 (BGR
  and gray) and 99 (10 and 12 bits, where libaom deblocks at 95), as the
  writer's lossless 4:2:0 BT.601 frame, and at quality 75 (CDEF);
  frames libaom deblocks and applies no CDEF to: BGR at quality 85, 10-bit
  BGR and 12-bit gray at quality 90; a 2048² BGR micrograph at quality 95,
  and at 85 (deblocked), for the decode time.

    python tools/make_torch_avif_lossy_fixtures.py

needs cv2; it is deterministic (the writer's 1024x768 frame takes ~20 s).
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
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_lossy_fixtures.npz"
HASHED_PIXELS = 64 * 64
MATRICES = (1, 2, 4, 5, 6, 7, 8, 9, 12, 15)  # ops/avif.py:_MATRICES
SMOKE_SEED = 22
# the entries whose frames cv2 wrote (their headers read by tools/av1_headers.py)
CV2_PREFIXES = ("q9", "size-", "txsel-", "plain-", "filter-", "smoke-bgr", "smoke-gray", "smoke-2048", "smoke-q75")
# the writer's frames cv2 reads that the port refuses -> the words of the refusal
WRITER_NAMED = {f"writer-420-mc12-primaries{cp}": f"chroma-derived matrix coefficients under colour primaries {cp}"
                for cp in (2, 4)}


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fx = _tool("make_torch_avif_fixtures")
aw = _tool("av1_writer")
hd = _tool("av1_headers")


def blurred(h: int, w: int, seed: int, channels: int = 3, depth: int = 8) -> np.ndarray:
    """Uniform noise blurred (sigma 3): the content on which libaom picks
    transform depths per block (TX_MODE_SELECT) -> [h,w] or [h,w,3]."""
    import cv2

    rng = np.random.default_rng(seed)
    g = cv2.GaussianBlur(rng.random((h, w, channels)).astype(np.float32) * 255, (0, 0), 3)
    v = np.clip(np.asarray(g).reshape(h, w, channels), 0, 255)
    if depth > 8:
        v = v * ((1 << depth) - 1) / 255
    v = v.round().astype(np.uint8 if depth == 8 else np.uint16)
    return v[..., 0] if channels == 1 else v


def cv2_lossy(img: np.ndarray, quality, depth: int = 8) -> bytes:
    import cv2

    params = [] if quality is None else [cv2.IMWRITE_AVIF_QUALITY, quality]
    if depth > 8:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", img, params)
    assert ok
    return buf.tobytes()


def with_payload(data: bytes, payload: bytes) -> bytes:
    """A cv2 file with its AV1 payload replaced (the box writer's form of
    cv2's one-item file)."""
    _, av1c, colr = fx.payload_of(data)
    f = hd.fields(payload)
    channels = 1 if f["mono"] else 3
    return fx.avif([fx.image_item(payload, av1c, f["width"], f["height"], f["depth"], channels, colr)])


def applies_cdef(data: bytes) -> bool:
    """Whether a cv2 file's frame applies CDEF (a strength other than 0)."""
    return any(any(s) for s in hd.fields(fx.payload_of(data)[0])["cdef_strengths"])


def deblocks(data: bytes) -> bool:
    """Whether a cv2 file's frame deblocks and applies no CDEF."""
    f = hd.fields(fx.payload_of(data)[0])
    return any(f["loop_filter"]) and not any(any(s) for s in f["cdef_strengths"])


def writer_frame(sub, mc: int, full: bool, depth: int, h: int, w: int, seed: int, primaries: int = 1) -> bytes:
    """The writer's lossless frame of random planes at subsampling ``sub``
    under matrix ``mc`` (``primaries`` in its colr box), every intra mode
    drawn."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1 << depth, (h, w))
    ch, cw = (h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]
    u, v = rng.integers(0, 1 << depth, (ch, cw)), rng.integers(0, 1 << depth, (ch, cw))
    payload = aw.encode([y, u, v], depth, subsampling=sub, matrix=mc, full_range=full, seed=seed)
    return fx.avif([fx.image_item(payload, aw.av1c(depth, False, sub), w, h, depth, 3,
                                  fx.colr_nclx(primaries, 13, mc, int(full)))])


def smoke_frame():
    """Phase 22's labelled frame: (the drawing with its background
    flattened, its label instances)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    gray, instances = chip_smoke.draw_labelled(np.random.default_rng(SMOKE_SEED))
    return chip_smoke.avif_flatten(gray), instances


def smoke_bgr(flat: np.ndarray) -> np.ndarray:
    """The flattened drawing with a little colour (B, G, R apart)."""
    g = flat.astype(np.int16)
    return np.stack([g, np.clip(g + 12, 0, 255), np.clip(g - 9, 0, 255)], -1).astype(np.uint8)


def cases() -> dict:
    out = {}
    # cv2's files at quality 92-99: 8, 10 and 12 bits, BGR and gray
    for q in range(92, 100):
        for depth in (8, 10, 12):
            out[f"q{q}-bgr{depth}-53x37"] = cv2_lossy(blurred(37, 53, q * 3 + depth, 3, depth), q, depth)
            out[f"q{q}-gray{depth}-41x29"] = cv2_lossy(blurred(29, 41, q * 5 + depth, 1, depth), q, depth)
    # sizes
    for h, w, ch in ((1, 1, 3), (1, 1, 1), (1, 9, 3), (9, 1, 3), (3, 5, 1), (7, 33, 3), (65, 65, 3), (33, 66, 1),
                     (512, 512, 3)):
        out[f"size-{'bgr' if ch == 3 else 'gray'}-{w}x{h}"] = cv2_lossy(blurred(h, w, h * 7 + w, ch), 95)
    # TX_MODE_SELECT without filters
    for h, w, ch in ((65, 77, 3), (129, 193, 1), (129, 193, 3)):
        for seed in range(1, 40):  # the first seed whose frame libaom writes so
            data = cv2_lossy(blurred(h, w, seed, ch), 95)
            f = hd.fields(fx.payload_of(data)[0])
            if f["tx_mode_select"] and not any(f["loop_filter"]):
                break
        assert f["tx_mode_select"] and not any(f["loop_filter"]), (h, w, ch)
        out[f"txsel-{'bgr' if ch == 3 else 'gray'}-{w}x{h}"] = data
    # the in-loop filters stripped, and kept
    for q, depth, ch, (h, w) in ((75, 8, 3, (45, 61)), (50, 8, 3, (45, 61)), (None, 8, 1, (50, 70)),
                                 (60, 10, 3, (40, 52)), (50, 12, 3, (40, 52)), (75, 8, 3, (129, 193))):
        data = cv2_lossy(blurred(h, w, 100 + (q or 0) + depth, ch, depth), q, depth)
        tag = f"q{q or 'default'}-{'bgr' if ch == 3 else 'gray'}{depth}-{w}x{h}"
        out[f"plain-{tag}"] = with_payload(data, hd.strip_filters(fx.payload_of(data)[0]))
        if q in (75, 50) and depth == 8 and h == 45:
            out[f"filter-{tag}"] = data
    data = cv2_lossy(blurred(45, 61, 150, 3), 50)  # CDEF kept, deblocking stripped
    out["filter-cdef-bgr8-61x45"] = with_payload(data, hd.strip_filters(fx.payload_of(data)[0], keep_cdef=True))
    out["filter-q95-bgr10-53x37"] = cv2_lossy(blurred(37, 53, 310, 3, 10), 95, 10)
    # the writer's lossless frames: every matrix libavif converts, both ranges, 4:2:0, 4:2:2 and 4:4:4
    k = 0
    for sub, tag in (((1, 1), "420"), ((1, 0), "422"), ((0, 0), "444")):
        for mc in MATRICES:
            for full in (True, False):
                depth = (8, 10, 12)[k % 3]
                h, w = (13, 17) if k % 2 else (10, 7)
                out[f"writer-{tag}-mc{mc}-{'full' if full else 'limited'}-{depth}"] = writer_frame(
                    sub, mc, full, depth, h, w, seed=k)
                k += 1
    # YCgCo-Re (C13): read at 10 bits and full range; cv2 returns None at 8 and 12 bits and at limited range
    for sub, tag in (((0, 0), "444"), ((1, 0), "422"), ((1, 1), "420")):
        for depth, full, cps, sizes in ((10, True, (1, 9, 12), ((13, 17), (6, 9))), (8, True, (1,), ((10, 7),)),
                                        (12, True, (9,), ((10, 7),)), (10, False, (12,), ((10, 7),)),
                                        (8, False, (1,), ((10, 7),))):
            for cp in cps:
                for h, w in sizes:
                    out[f"c13-{tag}-{depth}-{'full' if full else 'limited'}-cp{cp}-{w}x{h}"] = writer_frame(
                        sub, 16, full, depth, h, w, seed=h * 3 + depth + cp, primaries=cp)
    # chroma-derived coefficients (12) under primaries libavif derives them from in float: refused by name
    for cp in (2, 4):
        out[f"writer-420-mc12-primaries{cp}"] = writer_frame((1, 1), 12, True, 8, 12, 14, seed=200 + cp, primaries=cp)
    # colour properties as libavif takes them: one nclx and one ICC at most, other colour types ignored
    payload, av1c, colr = fx.payload_of(out["q95-bgr8-53x37"])
    ispe, pixi, config = (fx.ispe(53, 37), False), (fx.pixi(8, 3), False), (fx.box(b"av1C", av1c), True)
    nclx6, nclx1 = (fx.box(b"colr", colr), False), (fx.colr_nclx(1, 1, 1, 1), False)
    icc, prof = (fx.box(b"colr", b"rICC" + bytes(40)), False), (fx.box(b"colr", b"prof" + bytes(40)), False)
    other = (fx.box(b"colr", b"abcd" + bytes(8)), False)
    for tag, colours in (("icc-nclx", [icc, nclx1]), ("nclx-icc", [nclx1, icc]), ("icc-only", [icc]),
                         ("other-nclx", [other, nclx1]), ("nclx-twice", [nclx6, nclx1]), ("icc-prof", [icc, prof, nclx6])):
        out[f"box-colr-{tag}"] = fx.avif([dict(id=1, type=b"av01", data=payload, props=[ispe, pixi, config] + colours)])
    # phase 22
    flat, _ = smoke_frame()
    bgr = smoke_bgr(flat)
    out["smoke-bgr95"] = cv2_lossy(bgr, 95)
    out["smoke-gray95"] = cv2_lossy(flat, 95)
    out["smoke-bgr10-99"] = cv2_lossy(bgr.astype(np.uint16) << 2, 99, 10)
    out["smoke-bgr12-99"] = cv2_lossy(bgr.astype(np.uint16) << 4, 99, 12)
    h, w = flat.shape
    y = flat.astype(np.int64)
    c = np.full(((h + 1) // 2, (w + 1) // 2), 128)
    payload = aw.encode([y, c, c], 8, subsampling=(1, 1), matrix=6, full_range=True, modes=False)
    out["smoke-writer420"] = fx.avif([fx.image_item(payload, aw.av1c(8, False, (1, 1)), w, h, 8, 3,
                                                    fx.colr_nclx(1, 13, 6, 1))])
    out["smoke-q75"] = cv2_lossy(bgr, 75)
    p = fx.particles(2048, 0).astype(np.int16)
    particles = np.stack([p, np.clip(p + 10, 0, 255), np.clip(p - 8, 0, 255)], -1).astype(np.uint8)
    out["smoke-2048-q95"] = cv2_lossy(particles, 95)
    # deblocked, no CDEF
    out["smoke-bgr85"] = cv2_lossy(bgr, 85)
    out["smoke-bgr10-90"] = cv2_lossy(bgr.astype(np.uint16) << 2, 90, 10)
    out["smoke-gray12-90"] = cv2_lossy(flat.astype(np.uint16) << 4, 90, 12)
    out["smoke-2048-q85"] = cv2_lossy(particles, 85)
    for name in ("smoke-bgr85", "smoke-bgr10-90", "smoke-gray12-90", "smoke-2048-q85"):
        f = hd.fields(fx.payload_of(out[name])[0])
        assert any(f["loop_filter"]) and not any(any(c) for c in f["cdef_strengths"]), name
    return out


def main(out: str = str(DEFAULT_OUT)) -> str:
    import cv2

    arrays = {}
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for name, data in cases().items():
            Path(path).write_bytes(data)
            ref = cv2.imread(path, cv2.IMREAD_COLOR)
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            words = WRITER_NAMED.get(name)
            if words:
                arrays[f"{name}/named"] = np.frombuffer(words.encode(), np.uint8)
            elif name.startswith(CV2_PREFIXES) and applies_cdef(data):
                arrays[f"{name}/cdef"] = np.zeros(0, np.uint8)
            elif name.startswith(CV2_PREFIXES) and deblocks(data):
                arrays[f"{name}/deblocked"] = np.zeros(0, np.uint8)
            if ref is None:  # libavif converts YCgCo at full range only, YCgCo-Re at 10 bits too, and takes one
                # colr of each type
                assert ("-mc8-limited" in name or (name.startswith("c13-") and "-10-full-" not in name)
                        or name in ("box-colr-nclx-twice", "box-colr-icc-prof")), name
                arrays[f"{name}/none"] = np.zeros(0, np.uint8)
            elif name.startswith("smoke-") or ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)
            else:
                arrays[f"{name}/bgr"] = ref
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

"""Write ``tests/data/torch_avif_palette_fixtures.npz``: AVIF files whose AV1
frame allows screen content tools and not intra block copy, so that libaom
codes palettes in it, and what ``cv2.imread(path, cv2.IMREAD_COLOR)``
(OpenCV 5.0, libavif 1.4 and libaom 3.14) reads from each, for
``tests/test_torch_avif_palette.py`` and ``chip_smoke.py`` phase 22.

libaom's all-intra encoder, which cv2 calls, turns screen content tools
on for a frame of few distinct colours at speeds 0-8 (cv2's default, 9,
never), and intra block copy with them on some such frames at speeds 0-7.

Each entry ``<name>/file`` holds the file's bytes; ``<name>/bgr`` cv2's
BGR array (at most 40x40 pixels) or ``<name>/sha256`` the SHA-256 of its
bytes; ``<name>/fields`` (``fields_of``) the frame's PALETTE_FIELDS, read
off its headers by ``tools/av1_headers.py``; ``<name>/named``, for the
frame the port refused until it decoded intra block copy, the words of
that refusal. The entries:

- ``cv2-<content>-<form><depth>-s<S>-q<Q>``: cv2's 256x256 frames of a
  binary mask, flat blobs on a flat background and a six-level label
  image (gray, and through a colour map BGR) at 8, 10 and 12 bits, each
  the first (speed, quality) of a rotating schedule over speeds 0-8 and
  qualities 50-100 and the default whose frame takes palettes without
  intra block copy: one lossless (quality 100) and one lossy;
- ``cv2-random-<k>-*``: seeded random low-colour frames (16-299 px a
  side, 2-39 colours, gray or BGR, 8, 10 or 12 bits, quality 1-100 or the
  default, speed 0-8), those that add a form, a palette size of Y or UV,
  an in-loop filter, a speed, the colour cache or V's delta coding to the
  ones before them, until all are held;
- ``writer-*``: ``tools/av1_writer.py``'s palette frames in the forms
  cv2's frames do not reach (``WRITER_CASES``): 4:2:2 (cv2 writes none),
  4:4:4 lossy (cv2's 4:4:4 is lossless), 128x128 superblocks, two and four
  tiles, each palette size 2-8 in Y and UV in turn, and the colour cache
  taken at high odds;
- ``smoke-palette-bgr8``: phase 22's labelled frame
  (``chip_smoke.draw_labelled``, seed 22, its background flattened, a
  little colour added: ``make_torch_avif_lossy_fixtures.smoke_bgr``) as
  cv2 writes it at speed 8 (palettes, deblocked, CDEF), which joins phase
  22's dataset; ``refused-intrabc-smoke``: the same frame at speed 4,
  which takes intra block copy (once refused by name, now read; the intra
  block copy fixtures hold it as ``smoke-intrabc-bgr8``);
- ``smoke-2048-palette`` and ``smoke-2048-speed9``: the labelled frame
  tiled to 2048x2048, at speed 8 (palettes) and at cv2's default speed,
  for the decode time.

    python tools/make_torch_avif_palette_fixtures.py

needs cv2; it is deterministic (~2 minutes). It prints what cv2's frames
reach, counted by the port's decoder (``native.av1_decode``'s meta).
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
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_palette_fixtures.npz"
HASHED_PIXELS = 40 * 40
# the layout of ``<name>/fields``; speed is cv2's (-1 for the writer's)
PALETTE_FIELDS = ("screen_content", "intrabc", "depth", "mono", "ssx", "ssy", "lossless", "deblocked", "cdef",
                  "restoration", "sb128", "tiles", "width", "height", "speed")
# the words of the port's refusal of a frame that allows intra block copy, until it decoded the tool
INTRABC = "AV1 intra block copy"


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lossy = _tool("make_torch_avif_lossy_fixtures")
fx, aw, hd = lossy.fx, lossy.aw, lossy.hd
cv2_lossy = _tool("make_torch_avif_cdef_fixtures").cv2_lossy


def fields_of(data: bytes, speed: int = -1) -> np.ndarray:
    """A file's frame: its PALETTE_FIELDS."""
    f = hd.fields(fx.payload_of(data)[0])
    cols, rows = f["tiles_log2"]
    return np.array([f["screen_content"], f["intrabc"], f["depth"], f["mono"], *f["subsampling"],
                     int(f["base_q_idx"] == 0), int(any(f["loop_filter"])),
                     int(any(any(e) for e in f["cdef_strengths"])), int(any(f["lr_type"])), f["sb128"],
                     (1 << cols) * (1 << rows), f["width"], f["height"], speed], np.int16)


def palette_fields(data: bytes) -> dict:
    return dict(zip(PALETTE_FIELDS, (int(v) for v in fields_of(data))))


def takes_palettes(data: bytes) -> bool:
    """Whether the frame allows screen content tools and not intra block copy."""
    f = palette_fields(data)
    return bool(f["screen_content"] and not f["intrabc"])


# ---------------------------------------------------------------------------
# Content
# ---------------------------------------------------------------------------


def mask(h: int, w: int, seed: int) -> np.ndarray:
    """A binary mask (0 and 255): a few discs and boxes."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    for _ in range(6):
        cx, cy = (int(v) for v in rng.integers(0, (w, h)))
        if rng.random() < 0.5:
            cv2.circle(img, (cx, cy), int(rng.integers(8, max(9, min(h, w) // 4))), 255, -1)
        else:
            cv2.rectangle(img, (cx, cy), (cx + int(rng.integers(8, w // 3 + 9)), cy + int(rng.integers(8, h // 3 + 9))),
                          255, -1)
    return img


def blobs(h: int, w: int, seed: int) -> np.ndarray:
    """Flat blobs at 150-230 on a flat background of 80 (a flattened micrograph)."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.full((h, w), 80, np.uint8)
    for _ in range(14):
        axes = (int(rng.integers(4, 30)), int(rng.integers(4, 30)))
        cv2.ellipse(img, (int(rng.integers(0, w)), int(rng.integers(0, h))), axes, float(rng.uniform(0, 180)), 0, 360,
                    int(rng.integers(150, 231)), -1)
    return img


def labels(h: int, w: int, seed: int, levels: int = 6) -> np.ndarray:
    """A label image: overlapping boxes of ``levels`` levels, 40 apart."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    for _ in range(24):
        p0 = tuple(int(v) for v in rng.integers(0, (w, h)))
        p1 = tuple(int(v) for v in rng.integers(0, (w, h)))
        cv2.rectangle(img, p0, p1, int(rng.integers(0, levels)) * 40, -1)
    return img


def low_colour(h: int, w: int, colours: int, channels: int, depth: int, seed: int) -> np.ndarray:
    """Discs and boxes in ``colours`` random colours (at ``depth`` bits) over the first of them."""
    import cv2

    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << depth, (colours, channels))
    index = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(4, 40))):
        k = int(rng.integers(0, colours))
        cx, cy = (int(v) for v in rng.integers(0, (w, h)))
        if rng.random() < 0.5:
            cv2.circle(index, (cx, cy), int(rng.integers(2, max(3, min(h, w) // 3))), k, -1)
        else:
            cv2.rectangle(index, (cx, cy), (cx + int(rng.integers(2, w // 2 + 3)), cy + int(rng.integers(2, h // 2 + 3))),
                          k, -1)
    img = table[index].astype(np.uint8 if depth == 8 else np.uint16)
    return img[..., 0] if channels == 1 else img


def at_depth(img: np.ndarray, depth: int) -> np.ndarray:
    return img if depth == 8 else img.astype(np.uint16) << (depth - 8)


def colour(gray: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.applyColorMap(gray, cv2.COLORMAP_JET)


# ---------------------------------------------------------------------------
# The entries
# ---------------------------------------------------------------------------

CONTENTS = {"mask": lambda: mask(256, 256, 1), "blobs": lambda: blobs(256, 256, 2),
            "labels": lambda: labels(256, 256, 3), "labels-bgr": lambda: colour(labels(256, 256, 3))}
# (speed, quality) tried in turn, from a rotating start; quality 100 is lossless
LOSSY_SCHEDULE = [(s, q) for q in (None, 50, 75, 90) for s in (8, 6, 4, 2, 0, 7, 5, 3, 1)]
LOSSLESS_SCHEDULE = [(s, 100) for s in (8, 6, 4, 2, 0, 7, 5, 3, 1)]


def named_cases() -> dict:
    """cv2's 256x256 mask, blobs and label frames: {name: (file, speed)}."""
    out = {}
    for k, (content, make) in enumerate(CONTENTS.items()):
        img = make()
        form = "bgr" if img.ndim == 3 else "gray"
        for depth in (8, 10, 12):
            for schedule in (LOSSLESS_SCHEDULE, LOSSY_SCHEDULE):
                start = (3 * k + depth) % len(schedule)
                for speed, q in schedule[start:] + schedule[:start]:
                    data = cv2_lossy(at_depth(img, depth), q, depth, speed)
                    if takes_palettes(data):
                        out[f"cv2-{content}-{form}{depth}-s{speed}-q{q or 'default'}"] = (data, speed)
                        break
                else:
                    raise AssertionError(f"no palette frame of {content} at {depth} bits")
    return out


def features(data: bytes, speed: int) -> set:
    """What a palette frame reaches: its form, the palette sizes of Y and UV, the in-loop filters, its speed,
    the colour cache and V's delta coding (the last four counted by the port's decoder)."""
    sys.path.insert(0, str(ROOT))
    from deepemia_tpu_torch import native

    f = palette_fields(data)
    status, meta, _ = native.av1_decode(fx.payload_of(data)[0])
    assert status == 0, status
    out = {("form", f["depth"], f["mono"], f["lossless"]), ("speed", speed)}
    out |= {("y", n) for n in range(2, 9) if meta[11] >> n & 1} | {("uv", n) for n in range(2, 9) if meta[12] >> n & 1}
    out |= {k for k in ("deblocked", "cdef", "restoration") if f[k]}
    out |= {"cache"} if meta[13] else set()
    out |= {"v-delta"} if meta[14] else set()
    return out


def random_cases(n: int = 400, seed: int = 7) -> dict:
    """Seeded random low-colour frames that each add what the frames before them did not reach, until every
    feature of ``features`` is reached or ``n`` are tried: {name: (file, speed)}."""
    rng = np.random.default_rng(seed)
    want = ({("form", d, m, l) for d in (8, 10, 12) for m in (0, 1) for l in (0, 1)} | {("speed", s) for s in range(9)}
            | {("y", k) for k in range(2, 9)} | {("uv", k) for k in range(2, 9)}
            | {"deblocked", "cdef", "cache", "v-delta"})
    out, reached = {}, set()
    for i in range(n):
        h, w = (int(v) for v in rng.integers(16, 300, 2))
        colours, ch, depth = int(rng.integers(2, 40)), int(rng.choice([1, 3])), int(rng.choice([8, 10, 12]))
        q = None if rng.random() < 0.2 else 100 if rng.random() < 0.25 else int(rng.integers(1, 100))
        speed = int(rng.integers(0, 9))
        data = cv2_lossy(low_colour(h, w, colours, ch, depth, 1000 + i), q, depth, speed)
        if not takes_palettes(data):
            continue
        new = features(data, speed) - reached
        if new & want:
            reached |= new
            out[f"cv2-random-{i}-{'bgr' if ch == 3 else 'gray'}{depth}-{w}x{h}-s{speed}-q{q or 'default'}"] = (data,
                                                                                                          speed)
        if want <= reached:
            break
    missing = want - reached
    assert not missing, f"cv2's random frames reach no {sorted(missing, key=str)}"
    return out


# the writer's frames: (name, subsampling, depth, h, w, lossy, keywords); each lossy one at q-context 0 and deblocked
_LOSSY = {"q": 12, "levels": (6, 9, 4, 5), "sharpness": 1, "delta": None}
BLOCK_WEIGHTS = {6: [1.0, 0.2, 0.2, 0.6] + [0.2] * 6, 9: [1.0, 0.2, 0.2, 1.0] + [0.2] * 6,
        12: [0.5, 0.2, 0.2, 2.0] + [0.2] * 6, 15: [0.2, 0.2, 0.2, 3.0] + [0.1] * 4}
WRITER_CASES = (
    ("422-8-lossless", (1, 0), 8, 40, 46, None, {}),
    ("422-10-lossy", (1, 0), 10, 80, 96, _LOSSY, {}),
    ("422-12-lossless-sizes", (1, 0), 12, 48, 56, None, {"sizes": list(range(2, 9))}),
    ("444-8-lossy", (0, 0), 8, 64, 80, _LOSSY, {}),
    ("444-10-lossy-sizes", (0, 0), 10, 96, 96, _LOSSY, {"sizes": list(range(8, 1, -1))}),
    ("444-12-lossy-cache", (0, 0), 12, 70, 66, _LOSSY, {"cache": 0.9}),
    ("420-8-sb128-tiles4", (1, 1), 8, 150, 260, _LOSSY, {"sb128": True, "tiles": ("uniform", 1, 1)}),
    ("444-10-sb128-tiles2", (0, 0), 10, 140, 150, _LOSSY, {"sb128": True, "tiles": ("uniform", 1, 0)}),
    ("420-12-lossless-sizes-cache", (1, 1), 12, 48, 60, None, {"sizes": [2, 8, 3, 7, 4, 6, 5], "cache": 0.9}),
    ("mono-10-lossy-sizes", (1, 1), 10, 60, 77, _LOSSY, {"mono": True, "sizes": list(range(2, 9))}),
)


def writer_frame(sub, depth: int, h: int, w: int, lossy_params, seed: int, mono: bool = False, sb128: bool = False,
                 tiles=("uniform", 0, 0), sizes=None, cache: float = 0.5) -> bytes:
    """The writer's palette frame of random planes (BT.709 matrix, full range; the planes give only the size where
    the frame is lossy), its blocks mostly 8x8 to 64x64."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1 << depth, (h, w))
    c = rng.integers(0, 1 << depth, (2, (h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]))
    palette = {"odds": 0.7, "cache": cache}
    if sizes:
        palette["sizes"] = sizes
    payload = aw.encode([y] if mono else [y, c[0], c[1]], depth, subsampling=sub, matrix=1, full_range=True,
                        seed=seed, sb128=sb128, tiles=tiles, lossy=lossy_params, weights=BLOCK_WEIGHTS, palette=palette)
    return fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                  fx.colr_nclx(1, 13, 1, 1))])


def smoke_cases() -> dict:
    """Phase 22's palette frame, its intra block copy twin and the 2048² pair: {name: (file, speed)}."""
    flat, _ = lossy.smoke_frame()
    bgr = lossy.smoke_bgr(flat)
    out = {"smoke-palette-bgr8": (cv2_lossy(bgr, None, 8, 8), 8), "refused-intrabc-smoke": (cv2_lossy(bgr, None, 8, 4), 4)}
    tiled = lossy.smoke_bgr(np.tile(flat, (3, 2))[:2048, :2048])
    out["smoke-2048-palette"] = (cv2_lossy(tiled, None, 8, 8), 8)
    out["smoke-2048-speed9"] = (cv2_lossy(tiled, None), 9)
    assert takes_palettes(out["smoke-palette-bgr8"][0]) and takes_palettes(out["smoke-2048-palette"][0])
    assert palette_fields(out["refused-intrabc-smoke"][0])["intrabc"]
    assert not palette_fields(out["smoke-2048-speed9"][0])["screen_content"]
    return out


def cases() -> dict:
    """-> {name: (file, speed)}."""
    out = {**named_cases(), **random_cases()}
    for k, (name, sub, depth, h, w, lossy_params, kw) in enumerate(WRITER_CASES):
        out[f"writer-{name}"] = (writer_frame(sub, depth, h, w, lossy_params, 2400 + k, **kw), -1)
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
            assert ref is not None, name
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/fields"] = fields_of(data, speed)
            if name.startswith("refused-"):
                arrays[f"{name}/named"] = np.frombuffer(INTRABC.encode(), np.uint8)
            if name.startswith(("smoke-", "refused-")) or ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = _sha(ref)
            else:
                arrays[f"{name}/bgr"] = ref
            if name.startswith("cv2-"):
                reached |= features(data, speed)
    print("cv2's frames reach:", sorted(reached, key=str))
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

"""Probe the port's AV1 palette mode against ``cv2.imread(path,
cv2.IMREAD_COLOR)`` beyond the committed fixtures, and print what was
found:

- ``random_frames``: seeded random low-colour cv2 frames (16-299 px a
  side, 2-39 colours, gray or BGR, 8, 10 or 12 bits, quality 1-100 or the
  default, speed 0-8), each read by the port and by cv2 and counted as
  exact, DIFFERS (another array) or REFUSED (where cv2 reads it), by
  whether the frame allows screen content tools and intra block copy;
- ``writer_frames``: ``tools/av1_writer.py``'s palette frames under
  random forms (every subsampling and depth, lossless or lossy, both
  superblock sizes, one to four tiles, random palette odds and cache
  odds).

    python tools/probe_avif_palette.py [n_random n_writer]

needs cv2; deterministic (~3 minutes at the defaults, 300 and 40).
"""

from __future__ import annotations

import collections
import importlib.util
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


pal_fx = _tool("make_torch_avif_palette_fixtures")
fx, aw = pal_fx.fx, pal_fx.aw


def _read(path: Path, data: bytes):
    """-> (cv2's array or None, the port's array, or the ValueError it raised)."""
    import cv2

    sys.path.insert(0, str(ROOT))
    from deepemia_tpu_torch.ops.image import read_image

    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    try:
        return ref, read_image(str(path))
    except ValueError as e:
        return ref, e


def outcome(path: Path, data: bytes) -> str:
    """A frame's outcome: "exact" where the port reads cv2's array,
    "REFUSED" where the port raises, else "DIFFERS"."""
    ref, got = _read(path, data)
    if ref is None:
        return "DIFFERS (cv2 None)"
    if isinstance(got, np.ndarray):
        return "exact" if np.array_equal(ref, got) else "DIFFERS"
    return "REFUSED"


def random_frames(path: Path, n: int = 300, seed: int = 2031) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        h, w = (int(v) for v in rng.integers(16, 300, 2))
        colours, ch, depth = int(rng.integers(2, 40)), int(rng.choice([1, 3])), int(rng.choice([8, 10, 12]))
        q = None if rng.random() < 0.2 else 100 if rng.random() < 0.25 else int(rng.integers(1, 100))
        speed = int(rng.integers(0, 9))
        data = pal_fx.cv2_lossy(pal_fx.low_colour(h, w, colours, ch, depth, 5000 + i), q, depth, speed)
        f = pal_fx.palette_fields(data)
        kind = ", intra block copy" if f["intrabc"] else ", palettes" if f["screen_content"] else ", no screen content"
        counts[outcome(path, data) + kind] += 1
    return counts


def writer_frames(path: Path, n: int = 40, seed: int = 2032) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        sub, mono = [((0, 0), False), ((1, 0), False), ((1, 1), False), ((1, 1), True)][i % 4]
        depth, sb128 = (8, 10, 12)[(i // 4) % 3], bool(rng.integers(0, 2))
        lossless = rng.random() < 0.4
        top = 70 if lossless else 200
        h, w = int(rng.integers(8, top)), int(rng.integers(8, top))
        sb = 128 if sb128 else 64
        tiles = ("uniform", int(w > sb and rng.integers(0, 2)), int(h > sb and rng.integers(0, 2)))
        lossy = None if lossless else {"q": int(rng.integers(1, 21)),
                                       "levels": tuple(int(v) for v in rng.integers(0, 20, 4)),
                                       "sharpness": int(rng.integers(0, 8)), "delta": None}
        palette = {"odds": float(rng.uniform(0.3, 1.0)), "cache": float(rng.uniform(0.0, 1.0)),
                   "v_near": float(rng.uniform(0.0, 1.0))}
        y = rng.integers(0, 1 << depth, (h, w))
        c = rng.integers(0, 1 << depth, (2, (h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]))
        payload = aw.encode([y] if mono else [y, c[0], c[1]], depth, subsampling=sub, matrix=1, seed=i, sb128=sb128,
                            tiles=tiles, lossy=lossy, weights=pal_fx.BLOCK_WEIGHTS, palette=palette)
        data = fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                      fx.colr_nclx(1, 13, 1, 1))])
        counts[outcome(path, data)] += 1
    return counts


def main(n_random: int = 300, n_writer: int = 40) -> None:
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "f.avif"
        print(f"random cv2 frames ({n_random}, seed 2031): {dict(sorted(random_frames(path, n_random).items()))}")
        print(f"writer frames ({n_writer}, seed 2032): {dict(sorted(writer_frames(path, n_writer).items()))}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

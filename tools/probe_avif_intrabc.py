"""Probe the port's AV1 intra block copy against ``cv2.imread(path,
cv2.IMREAD_COLOR)`` beyond the committed fixtures, and print what was
found:

- ``random_frames``: seeded random blocky low-colour cv2 frames (cells of
  1-8 pixels, some tiled with a period and touched up, or discs and boxes;
  24-299 px a side, 2-7 colours, gray or BGR, 8, 10 or 12 bits, quality
  30-100 or the default, speed 0-7), each read by the port and by cv2 and
  counted as exact, DIFFERS (another array) or REFUSED (where cv2 reads
  it), by whether the frame allows intra block copy (and then whether
  its DV stacks held a candidate and its chroma took half pixels) or
  screen content tools;
- ``writer_frames``: ``tools/av1_writer.py``'s frames with skipped blocks
  that copy under random forms (every subsampling and depth, lossless or
  lossy, both superblock sizes, one or two tile rows).

    python tools/probe_avif_intrabc.py [n_random n_writer]

needs cv2; deterministic (~6 minutes at the defaults, 300 and 12: the
writer's lossless frames are pure Python).
"""

from __future__ import annotations

import collections
import importlib.util
import sys
import tempfile
from pathlib import Path

import numpy as np


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ibc_fx = _tool("make_torch_avif_intrabc_fixtures")
palette_probe = _tool("probe_avif_palette")
pal_fx = ibc_fx.palette
fx, aw = pal_fx.fx, pal_fx.aw


def _kind(data: bytes) -> str:
    f = pal_fx.palette_fields(data)
    if not f["intrabc"]:
        return ", palettes" if f["screen_content"] else ", no screen content"
    c = ibc_fx.coded(data)
    return ", intra block copy" + (", DV stacks" if c["stacked"] else "") + \
        (", half-pixel chroma" if {"half-x", "half-y"} & c["paths"] else "")


def random_frames(path: Path, n: int = 300, seed: int = 2033) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        h, w = (int(v) for v in rng.integers(24, 300, 2))
        colours, ch, depth = int(rng.integers(2, 8)), int(rng.choice([1, 3])), int(rng.choice([8, 10, 12]))
        q = [None, 100, 90, 70, 50, 30][int(rng.integers(0, 6))]
        speed = int(rng.integers(0, 8))
        u = rng.random()
        img = ibc_fx.tiled(h, w, colours, ch, depth, rng) if u < 0.4 else \
            ibc_fx.cells(h, w, colours, ch, depth, rng, int(rng.integers(1, 9))) if u < 0.8 else \
            pal_fx.low_colour(h, w, colours, ch, depth, 7000 + i)
        data = pal_fx.cv2_lossy(img, q, depth, speed)
        out = palette_probe.outcome(path, data)
        counts[out + (_kind(data) if out == "exact" else "")] += 1
    return counts


def writer_frames(path: Path, n: int = 12, seed: int = 2034) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        sub, mono = [((0, 0), False), ((1, 0), False), ((1, 1), False), ((1, 1), True)][i % 4]
        depth, sb128 = (8, 10, 12)[(i // 4) % 3], bool(rng.integers(0, 2))
        lossless = i % 3 == 0
        h, w = (int(rng.integers(64, 100)), int(rng.integers(330, 400))) if lossless else \
            (int(rng.integers(64, 300)), int(rng.integers(330, 460)))
        tiles = ("uniform", 0, int(h > (128 if sb128 else 64) and rng.integers(0, 2)))
        lossy = None if lossless else {"q": int(rng.integers(1, 21))}
        y = rng.integers(0, 1 << depth, (h, w))
        c = rng.integers(0, 1 << depth, (2, (h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]))
        payload = aw.encode([y] if mono else [y, c[0], c[1]], depth, subsampling=sub, matrix=1, seed=i, sb128=sb128,
                            tiles=tiles, lossy=lossy, weights=ibc_fx._WEIGHTS,
                            palette={"odds": float(rng.uniform(0.0, 0.5))},
                            intrabc={"odds": float(rng.uniform(0.2, 0.8)), "shift": float(rng.uniform(0.0, 1.0))})
        data = fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                      fx.colr_nclx(1, 13, 1, 1))])
        counts[palette_probe.outcome(path, data)] += 1
    return counts


def main(n_random: int = 300, n_writer: int = 12) -> None:
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "f.avif"
        print(f"random cv2 frames ({n_random}, seed 2033): {dict(sorted(random_frames(path, n_random).items()))}")
        print(f"writer frames ({n_writer}, seed 2034): {dict(sorted(writer_frames(path, n_writer).items()))}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

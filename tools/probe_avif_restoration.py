"""Probe the port's AV1 loop restoration against ``cv2.imread(path,
cv2.IMREAD_COLOR)`` beyond the committed fixtures, and print what was
found:

- ``random_frames``: seeded random cv2 frames (size 1-299 a side, BGR or
  gray, 8 or 10 bits, quality 60-99, speed 0-4 (0-2 at 160x160 or less),
  of blurred noise or plain noise), each read by the port and by cv2,
  counted by whether the frame applies restoration and which frame types
  (Wiener, self-guided, switchable) it takes;
- ``writer_frames``: ``tools/av1_writer.py``'s lossy frames under random
  restoration parameters (every subsampling and depth, a random frame
  type per plane, SWITCHABLE too, unit shifts 0-2, ``lr_uv_shift``, both
  superblock sizes, one to four tiles, now and then CDEF and Wiener taps
  at their ends).

    python tools/probe_avif_restoration.py [n_random n_writer]

needs cv2; deterministic (~2 minutes at the defaults, 300 and 60).
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


lr_fx = _tool("make_torch_avif_restoration_fixtures")
cdef_fx, lossy, fx, aw = lr_fx.cdef_fx, lr_fx.lossy, lr_fx.fx, lr_fx.aw
cdef_probe = _tool("probe_avif_cdef")
cdef_strengths, palette_probe = cdef_probe._strengths, cdef_probe.palette_probe
_TYPES = {1: "switchable", 2: "Wiener", 3: "self-guided"}


def _outcome(path: Path, data: bytes):
    """Whether the port reads the file to cv2's array (cv2 reads it)."""
    import cv2

    sys.path.insert(0, str(ROOT))
    from deepemia_tpu_torch.ops.image import read_image

    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    try:
        got = read_image(str(path))
    except ValueError:
        return False
    return ref is not None and np.array_equal(ref, got)


def random_frames(path: Path, n: int = 300, seed: int = 2029) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        depth, ch = int(rng.choice([8, 10])), int(rng.choice([1, 3]))
        speed = int(rng.integers(0, 5))
        top = 160 if speed <= 2 else 300
        h, w = int(rng.integers(1, top)), int(rng.integers(1, top))
        q = int(rng.integers(60, 100))
        img = lossy.blurred(h, w, i, ch, depth) if rng.random() < 0.6 else cdef_fx.noise(h, w, i, ch, depth)
        data = cdef_fx.cv2_lossy(img, q, depth, speed)
        screen = palette_probe.pal_fx.palette_fields(data)
        if screen["intrabc"]:  # no restoration parameters
            counts[palette_probe.outcome(path, data) + ", intra block copy"] += 1
            continue
        f = lr_fx.lr_fields(data)
        types = sorted({_TYPES[t] for t in (f["y"], f["u"], f["v"]) if t > 0})
        kind = ", restoration: " + "+".join(types) if types else ", no restoration"
        kind += ", palettes" if screen["screen_content"] else ""
        counts[("exact" if _outcome(path, data) else "DIFFERS") + kind] += 1
    return counts


def writer_frames(path: Path, n: int = 60, seed: int = 2030) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        sub, mono = [((0, 0), False), ((1, 0), False), ((1, 1), False), ((1, 1), True)][i % 4]
        depth, sb128 = (8, 10, 12)[(i // 4) % 3], bool(rng.integers(0, 2))
        h, w = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        types = tuple(int(t) for t in rng.integers(0, 4, 1 if mono else 3))
        if not any(types):
            types = (int(rng.integers(1, 4)),) + types[1:]
        lr = {"types": types, "unit_shift": int(rng.integers(1 if sb128 else 0, 3)),
              "extreme": bool(rng.random() < 0.3)}
        if sub == (1, 1) and not mono and any(types[1:]):
            lr["uv_shift"] = int(rng.integers(0, 2))
        params = {"q": int(rng.integers(1, 21)), "levels": tuple(int(v) for v in rng.integers(0, 20, 4)),
                  "sharpness": int(rng.integers(0, 8)), "delta": None, "restoration": lr}
        if rng.random() < 0.3:
            params["cdef"] = {"damping": int(rng.integers(3, 7)), "bits": 0, "strengths": cdef_strengths(rng, 1, mono)}
        sb = 128 if sb128 else 64
        tiles = ("uniform", int(w > sb and rng.integers(0, 2)), int(h > sb and rng.integers(0, 2)))
        y = np.zeros((h, w), np.int64)
        c = np.zeros(((h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]), np.int64)
        payload = aw.encode([y] if mono else [y, c, c], depth, subsampling=sub, matrix=1, seed=i, sb128=sb128,
                            tiles=tiles, lossy=params)
        data = fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                      fx.colr_nclx(1, 13, 1, 1))])
        counts["exact" if _outcome(path, data) else "DIFFERS"] += 1
    return counts


def main(n_random: int = 300, n_writer: int = 60) -> None:
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "f.avif"
        print(f"random cv2 frames ({n_random}, seed 2029): {dict(sorted(random_frames(path, n_random).items()))}")
        print(f"writer frames ({n_writer}, seed 2030): {dict(sorted(writer_frames(path, n_writer).items()))}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

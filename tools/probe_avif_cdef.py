"""Probe the port's AV1 CDEF against ``cv2.imread(path, cv2.IMREAD_COLOR)``
beyond the committed fixtures, and print what was found:

- ``random_frames``: seeded random cv2 frames (size 1-299 a side, BGR or
  gray, 8/10/12 bits, quality 1-83 or cv2's default, speed 3-10, of
  blurred noise or plain noise), one in three with its CDEF damping and
  strengths rewritten at random (``av1_headers.rewrite_cdef``), each read
  by the port and by cv2; frames libaom writes with loop restoration
  (speeds 3 and 4), which the port applies after CDEF, are counted as
  such;
- ``writer_frames``: ``tools/av1_writer.py``'s lossy frames under random
  CDEF parameters (every subsampling and depth, ``cdef_bits`` 0-3, both
  superblock sizes, 64x64s whose blocks all skip, 4x4 blocks that code
  skip 0 and no coefficient).

    python tools/probe_avif_cdef.py [n_random] [n_writer]

needs cv2; deterministic (~15 s at the defaults, 300 and 60).
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


cdef_fx = _tool("make_torch_avif_cdef_fixtures")
lossy, fx, hd, aw = cdef_fx.lossy, cdef_fx.fx, cdef_fx.hd, cdef_fx.aw
palette_probe = _tool("probe_avif_palette")


def _outcome(path: Path, data: bytes):
    """(cv2's array or None, the port's array or its exception)."""
    import cv2

    sys.path.insert(0, str(ROOT))
    from deepemia_tpu_torch.ops.image import read_image

    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    try:
        return ref, read_image(str(path))
    except ValueError as e:
        return ref, e


def _strengths(rng, n: int, mono: bool) -> list:
    return [[int(rng.integers(0, 16)), int(rng.integers(0, 4)), int(rng.integers(0, 16)),
             int(rng.integers(0, 4))][: 2 if mono else 4] for _ in range(n)]


def random_frames(path: Path, n: int = 300, seed: int = 2027) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        depth, ch = int(rng.choice([8, 10, 12])), int(rng.choice([1, 3]))
        h, w = int(rng.integers(1, 300)), int(rng.integers(1, 300))
        q = None if rng.random() < 0.2 else int(rng.integers(1, 84))
        speed = int(rng.integers(3, 11))
        img = lossy.blurred(h, w, i, ch, depth) if rng.random() < 0.7 else cdef_fx.noise(h, w, i, ch, depth)
        data = cdef_fx.cv2_lossy(img, q, depth, speed)
        try:
            f = hd.fields(fx.payload_of(data)[0])
        except ValueError as e:  # a header the tool does not read
            counts[str(e)] += 1
            continue
        if f["intrabc"]:  # no CDEF parameters
            counts[palette_probe.outcome(path, data) + ", intra block copy"] += 1
            continue
        rewrite = "cdef_strengths" in f and f["cdef_strengths"] and rng.random() < 1 / 3
        if rewrite:
            data = lossy.with_payload(data, hd.rewrite_cdef(
                fx.payload_of(data)[0], damping=int(rng.integers(3, 7)),
                strengths=_strengths(rng, 1 << f["cdef_bits"], f["mono"])))
            f = hd.fields(fx.payload_of(data)[0])
        ref, got = _outcome(path, data)
        same = ref is not None and isinstance(got, np.ndarray) and np.array_equal(ref, got)
        cdef = any(any(e) for e in f["cdef_strengths"])
        counts[("exact" if same else "DIFFERS") + (", rewritten" if rewrite else "") +
               (", CDEF" if cdef else ", no CDEF") + (", restoration" if any(f["lr_type"]) else "") +
               (", palettes" if f["screen_content"] else "")] += 1
    return counts


def writer_frames(path: Path, n: int = 60, seed: int = 2028) -> collections.Counter:
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        sub, mono = [((0, 0), False), ((1, 0), False), ((1, 1), False), ((1, 1), True)][i % 4]
        depth, bits, sb128 = (8, 10, 12)[(i // 4) % 3], int(rng.integers(0, 4)), bool(rng.integers(0, 2))
        h, w = int(rng.integers(1, 150)), int(rng.integers(1, 150))
        cdef = {"damping": int(rng.integers(3, 7)), "bits": bits, "strengths": _strengths(rng, 1 << bits, mono)}
        y = np.zeros((h, w), np.int64)
        c = np.zeros(((h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0]), np.int64)
        params = {"q": int(rng.integers(1, 21)), "levels": tuple(int(v) for v in rng.integers(0, 20, 4)),
                 "sharpness": int(rng.integers(0, 8)), "delta": None, "cdef": cdef, "skip64": [(0, 1), (1, 0)],
                 "empty": 0.2}
        payload = aw.encode([y] if mono else [y, c, c], depth, subsampling=sub, matrix=1, seed=i, sb128=sb128,
                            lossy=params)
        data = fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                      fx.colr_nclx(1, 13, 1, 1))])
        ref, got = _outcome(path, data)
        same = ref is not None and isinstance(got, np.ndarray) and np.array_equal(ref, got)
        counts["exact" if same else "DIFFERS"] += 1
    return counts


def main(n_random: int = 300, n_writer: int = 60) -> None:
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "f.avif"
        print(f"random cv2 frames ({n_random}, seed 2027): {dict(sorted(random_frames(path, n_random).items()))}")
        print(f"writer frames ({n_writer}, seed 2028): {dict(sorted(writer_frames(path, n_writer).items()))}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

"""Probe the port's AV1 deblocking and YCgCo-Re conversion against
``cv2.imread(path, cv2.IMREAD_COLOR)`` beyond the committed fixtures, and
print what was found:

- ``qualities``: cv2's 256x256 BGR frames at quality 80-99, 8, 10 and 12
  bits: each frame's loop filter level, whether it applies CDEF, and
  whether the port reads it bit for bit (frames with CDEF are not read);
- ``random_frames``: seeded random frames (size 1-299 a side, BGR or
  gray, 8/10/12 bits, quality 40-99, now and then an encoder speed),
  their CDEF strengths rewritten to 0, each read by the port and by cv2
  (frames libaom writes with loop restoration, which the port applies
  too, are counted as such);
- ``ycgco_re``: the writer's YCgCo-Re (matrix 16) frames at every
  subsampling, 8/10/12 bits, both ranges, primaries 1, 9 and 12 and three
  sizes: how many cv2 reads, and whether the port gives cv2's array or,
  where cv2 returns None, ``RefusedImageError``.

    python tools/probe_avif_deblock.py

needs cv2; deterministic (~3 minutes).
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


lossy = _tool("make_torch_avif_lossy_fixtures")
fx, hd = lossy.fx, lossy.hd


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


def _same(ref, got) -> bool:
    return ref is not None and isinstance(got, np.ndarray) and np.array_equal(ref, got)


def qualities(path: Path) -> None:
    for depth in (8, 10, 12):
        row = []
        for q in range(80, 100):
            data = lossy.cv2_lossy(lossy.blurred(256, 256, 7, 3, depth), q, depth)
            f = hd.fields(fx.payload_of(data)[0])
            if any(any(c) for c in f["cdef_strengths"]):
                row.append(f"{q}:{f['loop_filter'][0]}/CDEF")
                continue
            row.append(f"{q}:{f['loop_filter'][0]}/{'exact' if _same(*_outcome(path, data)) else 'DIFFERS'}")
        print(f"qualities, {depth} bits (quality:level/outcome): {' '.join(row)}")


def random_frames(path: Path, n: int = 300, seed: int = 2026) -> None:
    import cv2

    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    for i in range(n):
        depth, ch = int(rng.choice([8, 10, 12])), int(rng.choice([1, 3]))
        h, w, q = int(rng.integers(1, 300)), int(rng.integers(1, 300)), int(rng.integers(40, 100))
        speed = int(rng.integers(0, 11)) if rng.random() < 0.3 else None
        params = [cv2.IMWRITE_AVIF_QUALITY, q] + ([cv2.IMWRITE_AVIF_DEPTH, depth] if depth > 8 else [])
        params += [] if speed is None else [cv2.IMWRITE_AVIF_SPEED, speed]
        ok, buf = cv2.imencode(".avif", lossy.blurred(h, w, i, ch, depth), params)
        data = buf.tobytes()
        try:
            f = hd.fields(fx.payload_of(data)[0])
        except ValueError as e:  # a header the tool does not read
            counts[str(e)] += 1
            continue
        if any(any(c) for c in f["cdef_strengths"]):
            data = lossy.with_payload(data, hd.strip_filters(fx.payload_of(data)[0], keep_loop_filter=True))
        same = _same(*_outcome(path, data))
        counts[("exact" if same else "differs") + (", deblocked" if any(f["loop_filter"]) else "")
               + (", restoration" if any(f["lr_type"]) else "")] += 1
    print(f"random frames ({n}, seed {seed}): {dict(sorted(counts.items()))}")


def ycgco_re(path: Path) -> None:
    counts = collections.Counter()
    for sub in ((0, 0), (1, 1), (1, 0)):
        for depth in (8, 10, 12):
            for full in (True, False):
                for cp in (1, 9, 12):
                    for h, w in ((10, 7), (13, 17), (6, 9)):
                        data = lossy.writer_frame(sub, 16, full, depth, h, w, seed=h * 3 + depth + cp, primaries=cp)
                        ref, got = _outcome(path, data)
                        if ref is None:
                            counts["cv2 None, port " + type(got).__name__] += 1
                        else:
                            counts["read, " + ("exact" if _same(ref, got) else "differs")] += 1
    print(f"YCgCo-Re frames: {dict(sorted(counts.items()))}")


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "f.avif"
        qualities(path)
        random_frames(path)
        ycgco_re(path)


if __name__ == "__main__":
    main()

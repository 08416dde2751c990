"""Probe the port's AV1 delta loop filter levels against
``cv2.imread(path, cv2.IMREAD_COLOR)`` beyond the committed fixtures, and
print what was found: ``tools/av1_writer.py``'s lossy frames drawn at
random over bit depth (8, 10, 12), subsampling (4:4:4, 4:2:2, 4:2:0,
monochrome), delta_lf_multi, delta_lf_res, the range and sign of the
deltas, the frame's levels (each 0 now and then), sharpness,
loop_filter_delta_update (the INTRA_FRAME ref delta, or deltas off),
superblock size, tiles, CDEF, loop restoration and reduced_tx_set, each
read by the port and by cv2 and counted as exact, DIFFERS (another array)
or REFUSED (where cv2 reads it), with the decoder's delta LF paths
(``make_torch_avif_delta_lf_fixtures.PATHS``) the exact frames took.

    python tools/probe_avif_delta_lf.py [n_writer]

needs cv2; deterministic (~1 minute at the default, 200).
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


dlf_fx = _tool("make_torch_avif_delta_lf_fixtures")
palette_probe = _tool("probe_avif_palette")


def draw(rng, i: int):
    """The ``i``-th random frame -> (its file, what it was drawn with)."""
    form = list(dlf_fx.SUBSAMPLINGS)[i % 4]
    depth, sb128 = (8, 10, 12)[(i // 4) % 3], bool(rng.integers(0, 2))
    h, w = int(rng.integers(8, 200)), int(rng.integers(8, 200))
    sb = 128 if sb128 else 64
    tiles = ("uniform", int(w > sb and rng.integers(0, 2)), int(h > sb and rng.integers(0, 2)))
    levels = [int(v) if rng.random() < 0.8 else 0 for v in rng.integers(0, 64, 4)]
    dlf = {"multi": int(rng.integers(0, 2)), "res": int(rng.integers(0, 4)), "odds": float(rng.uniform(0.2, 1.0)),
           "range": int(rng.choice([2, 6, 20, 60])), "sign": int(rng.choice([-1, 0, 0, 1]))}
    kw = {"levels": tuple(levels), "sharpness": int(rng.integers(0, 8)),
          "delta": None if rng.random() < 0.3 else int(rng.integers(-20, 21)), "sb128": sb128, "tiles": tiles,
          "reduced_tx_set": bool(rng.random() < 0.2)}
    if rng.random() < 0.3:
        n = 2 if form == "mono" else 4
        kw["cdef"] = {"damping": int(rng.integers(3, 7)), "bits": 0,
                      "strengths": [[int(rng.integers(0, 16)), int(rng.integers(0, 4))] * (n // 2)]}
    if rng.random() < 0.3:
        kw["restoration"] = {"types": tuple(int(v) for v in rng.integers(0, 4, 1 if form == "mono" else 3)),
                             "unit_shift": 1 if sb128 else int(rng.integers(0, 3))}
    return dlf_fx.writer_frame(form, depth, h, w, 3000 + i, dlf, **kw), (form, depth, dlf, kw)


def writer_frames(path: Path, n: int = 200, seed: int = 2035):
    rng = np.random.default_rng(seed)
    counts, paths = collections.Counter(), collections.Counter()
    for i in range(n):
        data, drawn = draw(rng, i)
        out = palette_probe.outcome(path, data)
        counts[out] += 1
        if out == "exact":
            paths.update(dlf_fx.coded(data)["paths"])
        else:
            print(f"frame {i}: {out}: {drawn}", flush=True)
    return counts, paths


def main(n_writer: int = 200) -> None:
    with tempfile.TemporaryDirectory() as d:
        counts, paths = writer_frames(Path(d) / "f.avif", n_writer)
        print(f"writer frames ({n_writer}, seed 2035): {dict(sorted(counts.items()))}; the exact ones' delta LF paths: "
              f"{dict(sorted(paths.items()))}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

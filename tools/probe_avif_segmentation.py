"""Probe the port's AV1 segmentation against ``cv2.imread(path,
cv2.IMREAD_COLOR)`` beyond the committed fixtures, and print what was
found: ``tools/av1_writer.py``'s frames drawn at random over bit depth (8,
10, 12), subsampling (4:4:4, 4:2:2, 4:2:0, monochrome), lossy or
lossless, the segments and their features (ALT_Q taking some segments to
a quantizer of 0, ALT_LF per plane and direction, values past
Segmentation_Feature_Max, REF_FRAME, SKIP and GLOBALMV now and then), how
often a block repeats its predicted id, the frame's loop filter levels
(each 0 now and then), delta q, delta LF, quantizer matrices, DC and
chroma delta q, superblock size, tiles, CDEF, loop restoration, palettes
and intra block copy; each read by the port and by cv2 and counted as
exact, DIFFERS (another array) or REFUSED (where cv2 reads it), with the
decoder's segmentation paths
(``make_torch_avif_segmentation_fixtures.PATHS``) the exact frames took.

    python tools/probe_avif_segmentation.py [n_writer]

needs cv2; deterministic (~2 minutes at the default, 200).
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


seg_fx = _tool("make_torch_avif_segmentation_fixtures")
palette_probe = _tool("probe_avif_palette")


def features(rng, q: int, lossy: bool) -> dict:
    """1 to 8 segments' features at random: ALT_Q (to 0 a third of the time; never above 0 in a lossless frame),
    ALT_LF per plane and direction (one past the maximum now and then), and REF_FRAME, SKIP or GLOBALMV now and
    then."""
    out = {}
    for s in range(int(rng.integers(1, 9))):
        f = {}
        if rng.random() < 0.6:
            f[0] = -q - int(rng.integers(0, 8)) if rng.random() < 0.35 else int(rng.integers(-q, 80 if lossy else 1))
            if not lossy:
                f[0] = min(f[0], 0)
        for j in range(1, 5):
            if rng.random() < 0.3:
                f[j] = int(rng.choice([-64, 63])) if rng.random() < 0.1 else int(rng.integers(-40, 41))
        if rng.random() < 0.08:
            f[5] = int(rng.integers(0, 8))
        if rng.random() < 0.05:
            f[6] = 0
        if rng.random() < 0.05:
            f[7] = 0
        if f or rng.random() < 0.5:
            out[s] = f
    return out


def draw(rng, i: int):
    """The ``i``-th random frame -> (its file, what it was drawn with)."""
    form = list(seg_fx.SUBSAMPLINGS)[i % 4]
    depth, sb128 = (8, 10, 12)[(i // 4) % 3], bool(rng.integers(0, 2))
    lossy = rng.random() < 0.75
    h, w = (int(rng.integers(8, 200)), int(rng.integers(8, 200))) if lossy else \
        (int(rng.integers(8, 90)), int(rng.integers(8, 90)))
    sb = 128 if sb128 else 64
    tiles = ("uniform", int(w > sb and rng.integers(0, 2)), int(h > sb and rng.integers(0, 2)))
    q = int(rng.integers(1, 21)) if lossy else 0
    seg = {"features": features(rng, q, lossy), "repeat": float(rng.uniform(0.0, 0.9))}
    kw = {"sb128": sb128, "tiles": tiles, "lossy": lossy}
    extra = rng.random()
    if extra < 0.15:
        kw["palette"] = {"odds": 0.4}
    elif extra < 0.25:
        kw.update(palette={"odds": 0.3}, intrabc={"odds": 0.3})
    if lossy:
        levels = [int(v) if rng.random() < 0.8 else 0 for v in rng.integers(0, 64, 4)]
        kw.update(q=q, levels=tuple(levels), sharpness=int(rng.integers(0, 8)),
                  delta=None if rng.random() < 0.3 else int(rng.integers(-20, 21)))
        if rng.random() < 0.25:
            kw["delta_q"] = {"odds": float(rng.uniform(0.2, 1.0)), "range": int(rng.integers(1, 20)),
                             "res": int(rng.integers(0, 4))}
        if rng.random() < 0.15:
            kw["qm"] = (int(rng.integers(0, 15)), int(rng.integers(0, 15)))
        if rng.random() < 0.1:
            kw["dq"] = tuple(int(v) for v in rng.integers(-8, 9, 3))
        if "intrabc" not in kw:
            if rng.random() < 0.15:
                kw["delta_lf"] = {"multi": int(rng.integers(0, 2)), "res": int(rng.integers(0, 4)), "range": 8}
            if rng.random() < 0.25:
                n = 2 if form == "mono" else 4
                kw["cdef"] = {"damping": int(rng.integers(3, 7)), "bits": 0,
                              "strengths": [[int(rng.integers(0, 16)), int(rng.integers(0, 4))] * (n // 2)]}
            if rng.random() < 0.25:
                kw["restoration"] = {"types": tuple(int(v) for v in rng.integers(0, 4, 1 if form == "mono" else 3)),
                                     "unit_shift": 1 if sb128 else int(rng.integers(0, 3))}
    data = seg_fx.writer_frame(form, depth, h, w, 4000 + i, seg, **kw)
    return data, (form, depth, seg, kw)


def writer_frames(path: Path, n: int = 200, seed: int = 2036):
    rng = np.random.default_rng(seed)
    counts, paths = collections.Counter(), collections.Counter()
    for i in range(n):
        data, drawn = draw(rng, i)
        out = palette_probe.outcome(path, data)
        counts[out] += 1
        if out == "exact":
            paths.update(seg_fx.coded(data)["paths"])
        else:
            print(f"frame {i}: {out}: {drawn}", flush=True)
    return counts, paths


def main(n_writer: int = 200) -> None:
    with tempfile.TemporaryDirectory() as d:
        counts, paths = writer_frames(Path(d) / "f.avif", n_writer)
        print(f"writer frames ({n_writer}, seed 2036): {dict(sorted(counts.items()))}; the exact ones' segmentation "
              f"paths: {dict(sorted(paths.items()))}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

"""Write ``tests/data/torch_avif_segmentation_fixtures.npz``: AVIF files
whose AV1 frame codes segmentation (``segmentation_enabled``), and what
``cv2.imread(path, cv2.IMREAD_COLOR)`` (OpenCV 5.0, libavif 1.4 and libaom
3.14) reads from each, for ``tests/test_torch_avif_segmentation.py`` and
``chip_smoke.py`` phase 22.

libaom's encoder writes segmentation only in its adaptive quantisation
modes (``--aq-mode``), which cv2 does not set, so every frame here is
``tools/av1_writer.py``'s: lossless frames (every segment lossless) and
lossy ones whose segments move the quantizer (some to 0: lossless blocks
among lossy ones), the deblocking level of each plane and direction, or
force skip; each block's segment id drawn at random and coded against its
spatial prediction. Each entry ``<name>/file`` holds the file's bytes;
``<name>/bgr`` cv2's BGR array (at most 40x40 pixels) or ``<name>/sha256``
the SHA-256 of its bytes, or ``<name>/none`` where cv2 returns None;
``<name>/fields`` (``fields_of``) the frame's FIELDS, read off its headers
by ``tools/av1_headers.py``. The entries:

- ``form-<subsampling>-<depth>-*``: every subsampling (4:4:4, 4:2:2,
  4:2:0, monochrome) at 8, 10 and 12 bits, lossy (a lossless segment and
  loop filter levels per segment among others) and lossless, both
  superblock sizes;
- ``lossless-segment-*``, ``qm-*``, ``qindex0-dq-*``: a lossless segment
  in a lossy frame (WHT 4x4, TX_4X4, no transform type, the lossless CFL
  rule, filtered at its segment's level), with quantizer matrices (level
  15 for it), and a segment whose quantizer is 0 under a DC delta q (not
  lossless, no transform type read);
- ``altq-delta-q-*``: ALT_Q under delta q (the dequantizer from
  CurrentQIndex plus ALT_Q, the transform type gate from base_q_idx plus
  ALT_Q), one with a lossless segment;
- ``altlf-*``, ``raise0-*``, ``lower0-*``, ``uv0-*``: ALT_LF per plane and
  direction, a frame level of 0 that a segment raises, levels a segment
  takes to 0, a chroma level of 0 that a segment cannot raise;
- ``clamp-*``: feature values one past Segmentation_Feature_Max;
- ``preskip-*``: SEG_LVL_SKIP (skip without a symbol), REF_FRAME and
  GLOBALMV, which move the id before skip;
- ``last-active-*``, ``no-features-*``: LastActiveSegId 0, 2 and 7, and
  segmentation on with no feature;
- ``sb128-*``, ``tiles-*``, ``sb128-tiles-*``: 128x128 superblocks and
  tiles (the prediction stops at tile edges);
- ``coded-lossless-*``: a lossy base_q_idx whose segments are all lossless
  (CodedLossless: no filter parameters, no tx_mode);
- ``cdef-*``, ``lr-*``, ``delta-lf-*``, ``palette-*``, ``intrabc-*``:
  segmentation with CDEF, loop restoration, delta LF, palettes and intra
  block copy;
- ``corrupt-*``: an id coded past LastActiveSegId, which libaom fails on;
- ``records-<i>``: four 128x96 frames (two monochrome) for the loader,
  evaluator and size heuristic tests;
- ``timing-1024-segmentation`` and ``timing-1024-no-segmentation``: a
  1024x1024 4:2:0 lossy frame with ALT_Q and ALT_LF segments and its twin
  written from the same seed with segmentation off, phase 22's decode times;
- ``smoke-writer-seg``: phase 22's labelled frame, flattened, 4:2:0
  lossless with eight segments, all lossless; a training frame of its
  dataset.

    python tools/make_torch_avif_segmentation_fixtures.py

needs cv2; it is deterministic (~2 minutes).
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
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_avif_segmentation_fixtures.npz"
HASHED_PIXELS = 40 * 40
# the layout of ``<name>/fields``
FIELDS = ("depth", "mono", "ssx", "ssy", "sb128", "tile_cols", "tile_rows", "base_q_idx", "segmentation",
          "feature_mask", "last_active", "preskip", "lossless_segments", "coded_lossless", "delta_q_present",
          "delta_lf_present", "using_qmatrix", "dq_nonzero", "level_y_v", "level_y_h", "level_u", "level_v", "cdef",
          "restoration", "screen_content", "intrabc", "width", "height")
# meta[21]'s bits (av1.cpp: Decoder::kSeg*), in order
PATHS = ("preskip", "skip", "predicted", "tile-edge", "lossless-block", "delta-q", "lf-raised")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lossy_fx = _tool("make_torch_avif_lossy_fixtures")
fx, aw, hd = lossy_fx.fx, lossy_fx.aw, lossy_fx.hd


def fields_of(data: bytes) -> np.ndarray:
    """A file's frame: its FIELDS."""
    f = hd.fields(fx.payload_of(data)[0])
    feats = f["seg_features"]
    mask = 0
    for s in feats:
        for j in s:
            mask |= 1 << j
    qindex = [min(255, max(0, f["base_q_idx"] + s.get(0, 0))) for s in feats]
    dq = f["delta_q_y_dc"] != 0 or f["delta_q_uv"] != (0, 0)
    lossless = [q == 0 and not dq for q in qindex]
    levels = tuple(f["loop_filter"]) + tuple(f.get("loop_filter_uv", (0, 0)))
    return np.array([f["depth"], f["mono"], *f["subsampling"], f["sb128"], 1 << f["tiles_log2"][0],
                     1 << f["tiles_log2"][1], f["base_q_idx"], f["segmentation"], mask,
                     max([k for k, s in enumerate(feats) if s], default=0), int(any(j >= 5 for s in feats for j in s)),
                     sum(lossless), int(all(lossless)), f["delta_q_present"], f["delta_lf_present"],
                     f["using_qmatrix"], int(dq), *levels, int(bool(f["cdef_strengths"])), int(any(f["lr_type"])),
                     f["screen_content"], f["intrabc"], f["width"], f["height"]], np.int16)


def frame_fields(data: bytes) -> dict:
    return dict(zip(FIELDS, (int(v) for v in fields_of(data))))


def coded(data: bytes) -> dict:
    """What the port's decoder read in the frame: the segment ids its blocks took, and the paths its segmentation
    took (PATHS); None where it fails on the stream."""
    sys.path.insert(0, str(ROOT))
    from deepemia_tpu_torch import native

    status, meta, _ = native.av1_decode(fx.payload_of(data)[0])
    if status:
        return None
    return {"ids": {k for k in range(8) if meta[20] >> k & 1},
            "paths": {p for k, p in enumerate(PATHS) if meta[21] >> k & 1}}


SUBSAMPLINGS = {"444": ((0, 0), False), "422": ((1, 0), False), "420": ((1, 1), False), "mono": ((1, 1), True)}
LOSSY = {"q": 18, "levels": (6, 9, 4, 5), "sharpness": 1, "delta": 1}
# the partitions: split down to 4x4 blocks more often than the writer's default, for more blocks, each with its
# segment id (in a lossy frame only a 4x4 block draws one: a larger one skips, and takes the prediction)
SPLITTY = {aw.B8X8: [1.0, 0.3, 0.3, 3.0], 6: [0.5, 0.3, 0.3, 5.0] + [0.3] * 6, 9: [0.3, 0.3, 0.3, 6.0] + [0.3] * 6,
           aw.B64X64: [0.05, 0.05, 0.05, 10.0] + [0.05] * 6, aw.B128X128: [0.05, 0.05, 0.05, 10.0] + [0.05] * 4}


def writer_frame(form: str, depth: int, h: int, w: int, seed: int, segmentation, lossy=True, sb128: bool = False,
                 tiles=("uniform", 0, 0), palette=None, intrabc=None, **lossy_params) -> bytes:
    """The writer's frame in ``form`` (a SUBSAMPLINGS key; BT.709 matrix, full range) with ``segmentation``
    (``encode``'s): lossy at q 18 under the loop filter parameters given (levels (6, 9, 4, 5), sharpness 1 and the
    INTRA_FRAME ref delta 1 by default), or with ``lossy`` False, lossless planes of noise; SPLITTY's partitions."""
    sub, mono = SUBSAMPLINGS[form]
    csize = ((h + sub[1]) >> sub[1], (w + sub[0]) >> sub[0])
    if lossy:
        planes = [np.zeros((h, w), np.int64)] + [np.zeros(csize, np.int64)] * (0 if mono else 2)
        params = {**LOSSY, **lossy_params}
    else:  # noise of 33 levels about mid-grey, spaced as 8-bit levels
        rng = np.random.default_rng(seed)
        planes = [(1 << (depth - 1)) + (rng.integers(-16, 17, shape) << (depth - 8))
                  for shape in [(h, w)] + [csize] * (0 if mono else 2)]
        params = None
    payload = aw.encode(planes, depth, subsampling=sub, matrix=1, full_range=True, seed=seed, sb128=sb128,
                        tiles=tiles, lossy=params, palette=palette, intrabc=intrabc, segmentation=segmentation,
                        weights=SPLITTY)
    return fx.avif([fx.image_item(payload, aw.av1c(depth, mono, sub), w, h, depth, 1 if mono else 3,
                                  fx.colr_nclx(1, 13, 1, 1))])


# features by segment (SEG_LVL_*: 0 ALT_Q, 1-4 ALT_LF_Y_V, _Y_H, _U, _V, 5 REF_FRAME, 6 SKIP, 7 GLOBALMV)
MIXED = {0: {0: 30, 1: 5}, 1: {0: -18}, 2: {2: -9, 3: 20}, 3: {4: 40, 1: -30}, 4: {0: -10, 2: 12}}
LOSSLESS = {0: {1: 5}, 1: {0: -18}, 2: {2: -9, 3: 20}, 3: {}, 4: {0: -3, 4: 7}}


def form_cases() -> dict:
    """Every subsampling at 8, 10 and 12 bits, lossy then lossless, a third with 128x128 superblocks."""
    out = {}
    k = 0
    for form in SUBSAMPLINGS:
        for depth in (8, 10, 12):
            for lossy in (True, False):
                sb128 = k % 3 == 2
                h, w = (72, 136) if sb128 else ((45, 61) if k % 2 else (64, 96))
                seg = {"features": MIXED if lossy else LOSSLESS}
                out[f"form-{form}-{depth}-{'lossy' if lossy else 'lossless'}-{w}x{h}"] = writer_frame(
                    form, depth, h, w, 2700 + k, seg, lossy=lossy, sb128=sb128, sharpness=k % 8)
                k += 1
    return out


_CDEF = {"damping": 4, "bits": 1, "strengths": [[6, 1, 3, 1], [9, 2, 5, 0]]}
_LR = {"types": (1, 2, 3), "unit_shift": 0}
_ALL_LOSSLESS = {s: {0: -18 - s, 1 + s % 4: 3 * s} for s in range(8)}
# (name, form, depth, h, w, segmentation, keywords: writer_frame's, and "seed" where 2800 + the row's index would
# draw a frame of a few large blocks)
SPECIAL = (
    ("lossless-segment-420-8", "420", 8, 64, 96, {"features": {1: {0: -18}, 2: {0: 6}}, "odds": [1, 3, 1]}, {}),
    ("lossless-segment-422-12", "422", 12, 48, 80, {"features": {0: {0: -18}, 1: {0: 40}}}, {}),
    ("qm-lossless-segment-444-10", "444", 10, 64, 96, {"features": {1: {0: -18}, 2: {0: 60}}}, {"qm": (4, 7)}),
    ("qindex0-dq-444-8", "444", 8, 64, 96, {"features": {1: {0: -18}, 2: {0: 9}}}, {"dq": (3, -2, 4)}),
    ("altq-delta-q-420-8", "420", 8, 64, 96, {"features": MIXED}, {"delta_q": {"odds": 0.8, "range": 8, "res": 1}}),
    ("altq-delta-q-mono-12", "mono", 12, 64, 96, {"features": {1: {0: 50}, 2: {0: -7}}},
     {"delta_q": {"odds": 0.9, "range": 12}}),
    ("altq-delta-q-lossless-segment-444-10", "444", 10, 64, 96, {"features": {1: {0: -18}, 2: {0: 25}}},
     {"delta_q": {"odds": 0.9, "range": 10, "res": 2}}),
    ("altlf-y-v-420-8", "420", 8, 64, 96, {"features": {1: {1: 25}, 2: {1: -6}}}, {}),
    ("altlf-y-h-444-10", "444", 10, 64, 96, {"features": {1: {2: 30}, 3: {2: -9}}}, {}),
    ("altlf-u-422-8", "422", 8, 64, 96, {"features": {1: {3: 33}, 2: {3: -4}}}, {}),
    ("altlf-v-420-12", "420", 12, 64, 96, {"features": {0: {4: 21}, 2: {4: -5}}}, {}),
    ("raise0-y-v-420-8", "420", 8, 64, 96, {"features": {1: {1: 20, 2: 5}}}, {"levels": (0, 9, 4, 5)}),
    ("raise0-y-h-mono-10", "mono", 10, 64, 96, {"features": {1: {2: 14}}}, {"levels": (7, 0, 0, 0), "seed": 3012}),
    ("raise0-y-v-no-ref-delta-444-8", "444", 8, 64, 96, {"features": {2: {1: 24}}},
     {"levels": (0, 9, 4, 5), "delta": None}),
    ("lower0-420-10", "420", 10, 64, 96, {"features": {1: {1: -63, 2: -63, 3: -63, 4: -63}}},
     {"levels": (12, 9, 4, 5), "delta": None}),
    ("uv0-raise-u-420-8", "420", 8, 64, 96, {"features": {1: {3: 30, 4: 30}}}, {"levels": (6, 9, 0, 0)}),
    ("clamp-444-8", "444", 8, 64, 96, {"features": {0: {0: -256}, 1: {1: -64, 2: 63}, 2: {0: 255}, 3: {5: 7}}},
     {}),
    ("preskip-skip-lossy-420-8", "420", 8, 64, 96, {"features": {0: {6: 0}, 2: {0: -18}, 3: {0: 5}}}, {}),
    ("preskip-skip-lossless-444-8", "444", 8, 40, 56, {"features": {0: {6: 0}, 2: {0: -3}, 3: {5: 2}}},
     {"lossy": False}),
    ("preskip-ref-frame-422-10", "422", 10, 64, 96, {"features": {1: {5: 3}, 2: {0: -18}}}, {}),
    ("preskip-globalmv-mono-8", "mono", 8, 64, 96, {"features": {1: {7: 0}, 2: {0: 4}}}, {}),
    ("last-active-0-420-8", "420", 8, 64, 96, {"features": {0: {0: 20, 2: 7}}}, {}),
    ("last-active-2-444-8", "444", 8, 64, 96, {"features": {2: {0: -18}}}, {}),
    ("last-active-7-420-10", "420", 10, 64, 96, {"features": {s: {0: 4 * s - 18, 1 + s % 4: s} for s in range(8)}},
     {}),
    ("no-features-422-8", "422", 8, 64, 96, {"features": {}}, {}),
    ("sb128-420-8", "420", 8, 136, 264, {"features": MIXED}, {"sb128": True}),
    ("tiles-444-8", "444", 8, 140, 140, {"features": MIXED, "repeat": 0.7}, {"tiles": ("uniform", 1, 1)}),
    ("sb128-tiles-420-10", "420", 10, 264, 264, {"features": MIXED, "repeat": 0.7},
     {"sb128": True, "tiles": ("uniform", 1, 1)}),
    ("coded-lossless-420-8", "420", 8, 64, 96, {"features": _ALL_LOSSLESS}, {"cdef": _CDEF, "restoration": _LR}),
    ("cdef-420-10", "420", 10, 64, 96, {"features": MIXED}, {"cdef": _CDEF}),
    ("lr-444-8", "444", 8, 64, 96, {"features": MIXED}, {"restoration": _LR}),
    ("cdef-lr-420-8", "420", 8, 64, 96, {"features": MIXED}, {"cdef": _CDEF, "restoration": _LR}),
    ("delta-lf-420-8", "420", 8, 64, 96, {"features": MIXED}, {"delta_lf": {"multi": 1, "res": 1, "range": 8}}),
    ("palette-lossless-444-8", "444", 8, 48, 64, {"features": LOSSLESS}, {"lossy": False, "palette": {"odds": 0.5}}),
    ("palette-lossy-420-10", "420", 10, 64, 96, {"features": MIXED}, {"palette": {"odds": 0.5}}),
    ("intrabc-lossless-444-8", "444", 8, 64, 96, {"features": LOSSLESS},
     {"lossy": False, "palette": {"odds": 0.3}, "intrabc": {"odds": 0.3}}),
    ("intrabc-lossy-420-8", "420", 8, 64, 96, {"features": MIXED},
     {"palette": {"odds": 0.3}, "intrabc": {"odds": 0.3}}),
    ("intrabc-preskip-skip-420-8", "420", 8, 64, 96, {"features": {0: {6: 0}, 2: {0: -18}, 3: {0: 5}}},
     {"palette": {"odds": 0.3}, "intrabc": {"odds": 0.3}}),
    ("corrupt-420-8", "420", 8, 64, 96, {"features": {1: {0: -5}, 2: {}}, "corrupt": True}, {}),
)


def special_cases() -> dict:
    out = {}
    for k, (name, form, depth, h, w, seg, kw) in enumerate(SPECIAL):
        kw = dict(kw)
        out[name] = writer_frame(form, depth, h, w, kw.pop("seed", 2800 + k), seg, **kw)
    return out


RECORDS_HW = (96, 128)  # tests/test_torch_datasets.make_dataset's size


def record_cases() -> dict:
    """Four records' images: 4:2:0 BGR and monochrome in turn, mixed segments."""
    return {f"records-{i}": writer_frame("mono" if i % 2 else "420", 8, *RECORDS_HW, 2900 + i, {"features": MIXED})
            for i in range(4)}


TIMING_SEGMENTS = {0: {1: 6, 2: 6}, 1: {0: 20, 3: 10}, 2: {0: -8, 4: -4}, 3: {0: 40, 1: 12, 2: 12}}


def timing_cases() -> dict:
    """Phase 22's pair: a 1024x1024 4:2:0 lossy frame with ALT_Q and ALT_LF segments, and its twin written from the
    same seed with segmentation off."""
    return {"timing-1024-segmentation": writer_frame("420", 8, 1024, 1024, 2950, {"features": TIMING_SEGMENTS}),
            "timing-1024-no-segmentation": writer_frame("420", 8, 1024, 1024, 2950, None)}


# phase 22's frame: eight segments, all lossless (ALT_Q at or below 0 under base_q_idx 0), loop filter features
# (unused: a lossless frame is not filtered) and REF_FRAME on the last, which reads each id before skip
SMOKE_SEGMENTS = {s: {0: -16 * s, 1 + s % 4: 5 * s} for s in range(7)} | {7: {0: -40, 5: 1}}


def smoke_cases() -> dict:
    """Phase 22's dataset frame: the labelled frame (``chip_smoke.draw_labelled``, seed 22), flattened, as the
    writer's lossless 4:2:0 8-bit frame with neutral chroma (BT.601 matrix, full range), eight lossless segments."""
    flat, _ = lossy_fx.smoke_frame()
    h, w = flat.shape
    c = np.full(((h + 1) // 2, (w + 1) // 2), 128)
    payload = aw.encode([flat.astype(np.int64), c, c], 8, subsampling=(1, 1), matrix=6, full_range=True, modes=False,
                        seed=22, segmentation={"features": SMOKE_SEGMENTS})
    return {"smoke-writer-seg": fx.avif([fx.image_item(payload, aw.av1c(8, False, (1, 1)), w, h, 8, 3,
                                                       fx.colr_nclx(1, 13, 6, 1))])}


def cases() -> dict:
    return {**form_cases(), **special_cases(), **record_cases(), **timing_cases(), **smoke_cases()}


def _sha(ref) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(ref.tobytes()).hexdigest().encode(), np.uint8)


def main(out: str = str(DEFAULT_OUT)) -> str:
    import cv2

    arrays, reached = {}, set()
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f.avif")
        for name, data in cases().items():
            Path(path).write_bytes(data)
            try:
                ref = cv2.imread(path, cv2.IMREAD_COLOR)
            except cv2.error:
                ref = None
            assert (ref is None) == name.startswith("corrupt-"), name
            arrays[f"{name}/file"] = np.frombuffer(data, np.uint8)
            arrays[f"{name}/fields"] = fields_of(data)
            if ref is None:
                arrays[f"{name}/none"] = np.zeros(0, np.uint8)
                continue
            if name.startswith("smoke-") or ref.shape[0] * ref.shape[1] > HASHED_PIXELS:
                arrays[f"{name}/sha256"] = _sha(ref)
            else:
                arrays[f"{name}/bgr"] = ref
            got = coded(data)
            if got:
                reached |= got["paths"]
    assert reached == set(PATHS), reached
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    Path(out).write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    print(main())

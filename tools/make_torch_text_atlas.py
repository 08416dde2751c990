"""Write the text atlas of the PyTorch port's overlays.

The JAX package labels its overlays with ``cv2.putText(...,
FONT_HERSHEY_SIMPLEX, scale, color, 1, LINE_AA)`` at the font scales 0.45
(scale-bar debug), 0.5 (instance IDs) and 0.55 (class legend)
(``deepemia_tpu/inference/viz.py``). The port has no OpenCV, so it pastes
glyphs from a committed file: for each scale, each printable ASCII
character and each Latin-1 one ('µ' of a scale-bar reading, accented class
names), the anti-aliased coverage that ``cv2.putText`` draws in 255 on
0, and the whole pixels its pen advances past the character. OpenCV 5
starts every glyph on a whole pixel (a glyph after others is drawn exactly
as alone, shifted), so one coverage per glyph and scale is enough; the
advances are read from where ``putText`` draws the next glyph.

Needs OpenCV.

    python tools/make_torch_text_atlas.py   # writes deepemia_tpu_torch/inference/text_atlas.npz
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "deepemia_tpu_torch", "inference", "text_atlas.npz")
SCALES = (0.45, 0.5, 0.55)
CHARS = "".join(chr(c) for c in [*range(32, 127), *range(0xA0, 0x100)])
# the render canvas: the pen starts at (_PEN, _BASE)
_PEN, _BASE, _W, _H = 20, 45, 240, 64


def _draw(text: str, scale: float) -> np.ndarray:
    import cv2

    img = np.zeros((_H, _W), np.uint8)
    cv2.putText(img, text, (_PEN, _BASE), cv2.FONT_HERSHEY_SIMPLEX, scale, 255, 1, cv2.LINE_AA)
    return img


def advance(ch: str, scale: float) -> int:
    """Whole pixels the pen moves past ``ch``: the shift that lays "H" drawn
    alone over the "H" of ``ch`` + "H" (with ``ch``'s own pixels taken out)."""
    h = _draw("H", scale).astype(np.int32)
    rest = _draw(ch + "H", scale).astype(np.int32) - _draw(ch, scale)
    errs = [np.abs(rest - np.roll(h, s, axis=1)).sum() for s in range(64)]
    return int(np.argmin(errs))


def build() -> dict:
    glyphs = [np.stack([_draw(c, s) for c in CHARS]) for s in SCALES]
    ys, xs = np.nonzero(np.stack([g.max(axis=0) for g in glyphs]).max(axis=0))
    if ys.min() == 0 or xs.min() == 0 or ys.max() == _H - 1 or xs.max() == _W - 1:
        raise RuntimeError("a glyph reaches the edge of the render canvas")
    window = (slice(ys.min(), ys.max() + 1), slice(xs.min(), xs.max() + 1))
    arrays = {
        "chars": np.asarray([ord(c) for c in CHARS], np.int32),
        "scales": np.asarray(SCALES, np.float64),
        # the coverage's top-left corner relative to the pen on the baseline
        "origin": np.asarray([ys.min() - _BASE, xs.min() - _PEN], np.int32),
    }
    for i, scale in enumerate(SCALES):
        arrays[f"coverage_{i}"] = np.ascontiguousarray(glyphs[i][(slice(None),) + window])
        arrays[f"advance_{i}"] = np.asarray([advance(c, scale) for c in CHARS], np.int32)
    return arrays


def main(out: str = DEFAULT_OUT) -> None:
    arrays = build()
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {len(SCALES)} scales x {len(CHARS)} characters, {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()

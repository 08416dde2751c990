"""Write the glyph atlas of the PyTorch port's scale-bar reader.

The JAX package's reader renders its glyph templates at run time with
OpenCV's Hershey fonts and PIL's DejaVu faces
(``deepemia_tpu/inference/scalebar.py:_glyph_templates``). The port uses
neither library, so it reads the same templates from a committed file:
``_glyph_templates(h, 0.0)`` for every height ``h`` in the range, in the
reader's order (for each glyph: Hershey simplex, Hershey duplex, DejaVu
Sans, DejaVu Serif).

Needs OpenCV, PIL and the DejaVu fonts under /usr/share/fonts/truetype/dejavu.

    python tools/make_torch_glyph_atlas.py    # heights MIN_HEIGHT..MAX_HEIGHT

The reader takes its height range from the file (``scalebar.atlas_heights``).
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "deepemia_tpu_torch", "inference", "glyph_atlas.npz")
MIN_HEIGHT, MAX_HEIGHT = 8, 128
TEMPLATES_PER_HEIGHT = 60  # 15 glyphs x 4 faces


def build(heights) -> dict:
    """The atlas arrays: ``heights`` [H]; per template its glyph index into
    GLYPHS (``glyphs``), its [rows, cols] (``shapes``) and its start in
    ``pixels`` (``offsets``, one more than templates), all heights in order."""
    sys.path.insert(0, ROOT)
    from deepemia_tpu.inference.scalebar import GLYPHS, _glyph_templates

    glyphs, shapes, chunks = [], [], []
    for h in heights:
        templates = _glyph_templates(int(h), 0.0)
        if len(templates) != TEMPLATES_PER_HEIGHT:
            raise RuntimeError(
                f"height {h}: {len(templates)} templates, expected {TEMPLATES_PER_HEIGHT} "
                "(are PIL and the DejaVu fonts installed?)"
            )
        for ch, t in templates:
            glyphs.append(GLYPHS.index(ch))
            shapes.append(t.shape)
            chunks.append(np.ascontiguousarray(t, np.uint8).ravel())
    offsets = np.concatenate([[0], np.cumsum([c.size for c in chunks])])
    return {
        "glyph_set": np.frombuffer(GLYPHS.encode("utf-8"), np.uint8),
        "heights": np.asarray(list(heights), np.int32),
        "glyphs": np.asarray(glyphs, np.uint8),
        "shapes": np.asarray(shapes, np.int32),
        "offsets": offsets.astype(np.int64),
        "pixels": np.concatenate(chunks),
    }


def main(out: str = DEFAULT_OUT) -> str:
    arrays = build(range(MIN_HEIGHT, MAX_HEIGHT + 1))
    np.savez_compressed(out, **arrays)
    print(f"{out}: heights {MIN_HEIGHT}..{MAX_HEIGHT}, {len(arrays['glyphs'])} templates, "
          f"{os.path.getsize(out)} bytes")
    return out


if __name__ == "__main__":
    main()

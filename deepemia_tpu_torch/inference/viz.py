"""Overlay rendering and the class legend, in numpy (the PNG artefacts of
``--visualize``).

The port of the JAX package's ``inference/viz.py``, which draws with
OpenCV. Each OpenCV call is modelled here:

  * ``cv2.addWeighted(layer, 0.4, image, 0.6, 0)`` on uint8: float32
    products and sum, rounded half to even (equal to OpenCV on every pair
    of 8-bit values);
  * ``cv2.rectangle``, filled or 1 px, and ``cv2.line`` 2 px wide with the
    8-connected rasteriser, for the axis-aligned lines the scale-bar reader
    reports: exact;
  * ``cv2.putText(..., FONT_HERSHEY_SIMPLEX, scale, color, 1, LINE_AA)``:
    each glyph's anti-aliased coverage is pasted from a committed atlas
    (``text_atlas.npz``, written by ``tools/make_torch_text_atlas.py``) at
    the whole-pixel pen positions OpenCV 5 gives each glyph, and blended as
    OpenCV blends an anti-aliased stroke. OpenCV blends each stroke of a
    glyph in turn and the atlas holds their composite, so inside a text box
    a pixel where strokes cross may differ from OpenCV's by a few levels
    (the tolerance is stated in ``tests/test_torch_viz.py``); outside the
    text boxes the overlay is exact. The atlas holds printable ASCII and
    Latin-1 ('µ' of a scale-bar reading, accented class names); any other
    character is drawn as a '?' for each byte of its UTF-8 form, as
    OpenCV's Hershey fonts draw it.

``save_png`` writes an 8-bit PNG with ``zlib`` at level 1, OpenCV's
default PNG compression (filter 0 on every row).
"""

from __future__ import annotations

import functools
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

# class colours, BGR
CLASS_COLORS = [
    (0, 255, 0),
    (255, 0, 0),
    (0, 0, 255),
    (255, 255, 0),
    (255, 0, 255),
    (0, 255, 255),
    (128, 0, 128),
    (255, 165, 0),
]

ATLAS_PATH = Path(__file__).resolve().parent / "text_atlas.npz"


@functools.lru_cache(maxsize=1)
def _atlas() -> dict:
    with np.load(ATLAS_PATH) as z:
        a = {k: z[k] for k in z.files}
    a["index"] = {int(c): i for i, c in enumerate(a["chars"])}
    return a


def _font(scale: float):
    """(coverage [G, h, w] uint8, advance [G] whole pixels, origin (y, x)
    of the coverage relative to the pen on the baseline), G glyphs."""
    a = _atlas()
    hits = np.nonzero(np.isclose(a["scales"], scale))[0]
    if hits.size == 0:
        raise ValueError(f"no text atlas at font scale {scale} (have {a['scales'].tolist()})")
    i = int(hits[0])
    return a[f"coverage_{i}"], a[f"advance_{i}"], a["origin"]


def _glyphs(text: str) -> List[int]:
    """The atlas rows that draw ``text``: one per character the atlas holds
    (printable ASCII and Latin-1), and a '?' for each byte of the UTF-8 form
    of any other character, as OpenCV's Hershey fonts draw every byte
    outside printable ASCII."""
    index = _atlas()["index"]
    out = []
    for c in text:
        k = index.get(ord(c))
        out.extend([k] if k is not None else [index[ord("?")]] * len(c.encode("utf-8")))
    return out


def _blend(region: np.ndarray, alpha: np.ndarray, color) -> None:
    """One anti-aliased stroke over ``region`` [h,w,3] uint8, in place:
    v += ((c - v)·a + 127) >> 8, OpenCV's per-pixel blend, with the stroke's
    alpha a recovered from its coverage drawn in 255 on 0."""
    a = alpha.astype(np.int32)
    a = a + (a >= 128)
    v = region.astype(np.int32)
    c = np.asarray(color, np.int32)[None, None, :]
    region[...] = (v + (((c - v) * a[..., None] + 127) >> 8)).astype(np.uint8)


def put_text(image: np.ndarray, text: str, org, scale: float, color) -> None:
    """Draw ``text`` with its baseline's left end at ``org`` (x, y), in
    place, as ``cv2.putText(image, text, org, FONT_HERSHEY_SIMPLEX, scale,
    color, 1, LINE_AA)`` draws it (see the module's docstring for how
    closely): each glyph starts on a whole pixel, as in OpenCV 5."""
    cov, adv, (oy, ox) = _font(scale)
    h, w = image.shape[:2]
    gh, gw = cov.shape[1:]
    x = int(org[0])
    for k in _glyphs(text):
        y0, x0 = int(org[1]) + int(oy), x + int(ox)
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + gh, h), min(x0 + gw, w)
        if ys < ye and xs < xe:
            _blend(image[ys:ye, xs:xe], cov[k, ys - y0 : ye - y0, xs - x0 : xe - x0], color)
        x += int(adv[k])


def text_box(text: str, org, scale: float) -> tuple:
    """(x0, y0, x1, y1), end exclusive: the pixels ``put_text`` may touch."""
    cov, adv, (oy, ox) = _font(scale)
    glyphs = _glyphs(text)
    width = sum(int(adv[k]) for k in glyphs[:-1]) + cov.shape[2] if glyphs else 0
    x0, y0 = int(org[0]) + int(ox), int(org[1]) + int(oy)
    return x0, y0, x0 + width, y0 + cov.shape[1]


def _fill(image: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """Fill the pixels [x0..x1] x [y0..y1] (inclusive), clipped."""
    h, w = image.shape[:2]
    xa, xb = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    ya, yb = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if xa <= xb and ya <= yb:
        image[ya : yb + 1, xa : xb + 1] = color


def rectangle(image: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """``cv2.rectangle`` with thickness 1 (the outline) or -1 (filled)."""
    (x0, y0), (x1, y1) = p0, p1
    if thickness < 0:
        _fill(image, x0, y0, x1, y1, color)
        return
    if thickness != 1:
        raise ValueError("rectangle: thickness 1 or -1 only")
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x0, y1), (x1, y1)), ((x0, y0), (x0, y1))):
        _fill(image, a[0], a[1], b[0], b[1], color)


def thick_line(image: np.ndarray, p0, p1, color) -> None:
    """``cv2.line(image, p0, p1, color, 2)`` for an axis-aligned line: the
    band one pixel either side of it, with the round caps at both ends."""
    (x0, y0), (x1, y1) = p0, p1
    if x0 != x1 and y0 != y1:
        raise ValueError("thick_line: axis-aligned lines only (the scale-bar reader reports no other)")
    if y0 == y1:
        _fill(image, x0, y0 - 1, x1, y1 + 1, color)
    else:
        _fill(image, x0 - 1, y0, x1 + 1, y1, color)
    for cx, cy in ((x0, y0), (x1, y1)):  # radius-1 caps
        _fill(image, cx - 1, cy, cx + 1, cy, color)
        _fill(image, cx, cy - 1, cx, cy + 1, color)


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, 0)`` on uint8."""
    out = a.astype(np.float32) * np.float32(alpha) + b.astype(np.float32) * np.float32(beta)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def render_overlay(
    image: np.ndarray,
    masks: Sequence[np.ndarray],
    classes: Sequence[int],
    scores: Optional[Sequence[float]] = None,
    alpha: float = 0.4,
    draw_ids: bool = True,
    origins: Optional[Sequence] = None,
) -> np.ndarray:
    """Alpha-blend instance masks over the image with per-class colours and
    instance-ID labels at each mask's centroid. With ``origins`` (x, y per
    mask), ``masks`` are crops placed there (false outside them)."""
    out = image.copy()
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, axis=2)
    layer = out.copy()
    origins = [(0, 0)] * len(masks) if origins is None else origins
    placed = [(np.asarray(m, bool), (int(o[0]), int(o[1]))) for m, o in zip(masks, origins)]
    for (mask, (x0, y0)), cls in zip(placed, classes):
        h, w = mask.shape
        layer[y0 : y0 + h, x0 : x0 + w][mask] = CLASS_COLORS[int(cls) % len(CLASS_COLORS)]
    out = add_weighted(layer, alpha, out, 1.0 - alpha)
    if draw_ids:
        for i, (mask, (x0, y0)) in enumerate(placed, 1):
            ys, xs = np.nonzero(mask)
            if ys.size == 0:
                continue
            # the mean of whole coordinates: the integer sums are exact
            cx, cy = (int(xs.sum()) + x0 * xs.size) / xs.size, (int(ys.sum()) + y0 * ys.size) / ys.size
            put_text(out, str(i), (int(cx), int(cy)), 0.5, (255, 255, 255))
    return out


def draw_scalebar_debug(image: np.ndarray, debug: dict, psum: str) -> None:
    """Draw the scale-bar ROI box, the detected line and its reading, in
    place (``--draw-scalebar``)."""
    if debug.get("roi"):
        x0, y0, x1, y1 = debug["roi"]
        rectangle(image, (x0, y0), (x1, y1), (0, 200, 255), 1)
    if debug.get("line"):
        lx0, ly0, lx1, ly1 = debug["line"]
        thick_line(image, (lx0, ly0), (lx1, ly1), (0, 0, 255))
        put_text(image, f"scale: {psum} ({debug.get('text', '')!r})", (lx0, max(ly0 - 6, 12)), 0.45, (0, 0, 255))


def render_legend(class_names: List[str], cell_h: int = 30) -> np.ndarray:
    """The legend image: each class's colour swatch and "index: name"."""
    width = 260
    img = np.full((cell_h * max(len(class_names), 1), width, 3), 255, np.uint8)
    for i, name in enumerate(class_names):
        y0 = i * cell_h
        rectangle(img, (8, y0 + 6), (38, y0 + cell_h - 6), CLASS_COLORS[i % len(CLASS_COLORS)], -1)
        put_text(img, f"{i}: {name}", (48, y0 + cell_h - 10), 0.55, (0, 0, 0))
    return img


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(image: np.ndarray) -> bytes:
    """[H,W,3] BGR or [H,W] gray uint8 -> the bytes of an 8-bit PNG (RGB or
    gray, filter 0 on every row, zlib level 1)."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 3:
        if img.shape[2] != 3:
            raise ValueError(f"save_png: {img.shape[2]} channels (BGR or gray only)")
        img, ctype = np.ascontiguousarray(img[..., ::-1]), 2
    else:
        ctype = 0
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
        + _png_chunk(b"IEND", b"")
    )


def save_png(path, image: np.ndarray) -> None:
    """Write ``image`` (BGR or gray uint8) to ``path`` as PNG."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(image))

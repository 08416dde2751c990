"""Scale-bar detection: ROI crop -> run-length line scoring -> digit OCR,
on the host (the JAX package's ``inference/scalebar.py`` without OpenCV).

Every OpenCV call of the JAX package's reader is replaced by its bit-exact
counterpart in :mod:`deepemia_tpu_torch.ops.cv`, so both readers see the
same pixels, scores and tie-breaks. Glyph templates come from the committed
atlas ``glyph_atlas.npz`` (written by ``tools/make_torch_glyph_atlas.py``
from the JAX package's renderer), loaded once per process: heights
:func:`atlas_heights`; a request outside them takes the nearest end's
templates, which ``_read_glyph`` resizes to each patch anyway. Tilted
atlases are rotated here, cached exactly as the JAX package caches them.

The contract is the JAX package's: ``detect_scale_bar`` returns
``(psum, um_pix[, debug])`` and ``("0", 1.0)`` when no bar or label is
found, or when reading fails.
"""

from __future__ import annotations

import logging
import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepemia_tpu_torch.ops import cv

log = logging.getLogger("deepemia_tpu_torch.scalebar")

GLYPHS = "0123456789.umnµ"
_TEMPLATE_CACHE: Dict[Tuple[int, float], List[Tuple[str, np.ndarray]]] = {}

_ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "glyph_atlas.npz")
_ATLAS: Optional[Dict[int, List[Tuple[str, np.ndarray]]]] = None
# (templates, glyphs, [T, ph*pw] resized mean-centred templates, [T] their
# sums of squares) per (patch shape, templates): a label's glyphs share a
# height, so the reader matches the same templates against few patch
# shapes. The least recently used entries go once the rows pass
# _RESIZED_BUDGET bytes.
_RESIZED: "OrderedDict[tuple, tuple]" = OrderedDict()
_RESIZED_BUDGET = 32 << 20
_resized_bytes = 0


def get_scalebar_roi(config: dict, dataset_name: Optional[str], shape) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1) ROI from per-dataset or default factors (reference
    get_scalebar_roi_for_dataset, scalebar_ocr.py:29-69)."""
    rois = config.get("scale_bar_rois", {})
    roi = rois.get(dataset_name) or rois.get("default") or {}
    h, w = shape[:2]
    x0 = int(w * roi.get("x_start_factor", 0.7))
    y0 = int(h * roi.get("y_start_factor", 0.05))
    x1 = min(w, x0 + int(w * roi.get("width_factor", 1.0)))
    y1 = min(h, y0 + int(h * roi.get("height_factor", 0.05)))
    return x0, y0, x1, y1


def scale_line_candidates(
    gray: np.ndarray,
    intensity: float = 100,
    merge_gap: int = 15,
    min_line_length: int = 30,
    edge_margin_factor: float = 0.1,
) -> List[dict]:
    """All near-horizontal bright runs in the ROI, with per-run statistics.

    Each candidate dict has ``row``, ``x_start``, ``length`` (px) and
    ``intensity`` (brightest per-row mean gray level along the run within
    the 3-row band — the analog of the reference's mean-intensity-along-line
    check with a 2-px-thick line mask, scalebar_ocr.py:246-249; a per-band
    mean would under-score bars thinner than the band). Gap-tolerant run detection: a column
    belongs to a run if any pixel in a 3-row band is bright; gaps up to
    ``merge_gap`` columns are bridged (the reference achieves the same via
    Hough + merge_collinear_segments with the same ``merge_gap``).
    """
    h, w = gray.shape
    margin = int(w * edge_margin_factor)
    grayf = gray.astype(np.float32)
    bright = grayf >= intensity
    # 3-row vertical tolerance (scale bars are a few px thick / antialiased)
    band = np.zeros_like(bright)
    band[1:-1] = bright[:-2] | bright[1:-1] | bright[2:]
    if h >= 1:
        band[0] = bright[0]
        band[-1] = bright[-1]

    out: List[dict] = []
    for row in range(h):
        cols = band[row]
        if margin > 0:
            cols = cols.copy()
            cols[:margin] = False
            cols[w - margin :] = False
        idx = np.flatnonzero(cols)
        if idx.size < 2:
            continue
        # split where the gap exceeds merge_gap
        splits = np.flatnonzero(np.diff(idx) > merge_gap)
        starts = np.concatenate([[0], splits + 1])
        ends = np.concatenate([splits, [idx.size - 1]])
        lengths = idx[ends] - idx[starts] + 1
        r0, r1 = max(0, row - 1), min(h, row + 2)
        for s, e, ln in zip(starts, ends, lengths):
            if ln < min_line_length:
                continue
            x0 = int(idx[s])
            seg = grayf[r0:r1, x0 : x0 + int(ln)]
            # intensity = the BRIGHTEST row's mean within the band: a
            # 1-px-thick bar (230 on ~20 background) averaged over all 3
            # band rows scores (230+2*20)/3 ~= 90 and would fail the
            # default threshold 100 even though the bar is plainly bright;
            # the reference's 2-px line mask passes it. Per-row means keep
            # dim texture streaks (<threshold in every row) rejected.
            out.append(
                {
                    "row": row,
                    "x_start": x0,
                    "length": int(ln),
                    "intensity": (
                        float(seg.mean(axis=1).max()) if seg.size else 0.0
                    ),
                }
            )
    return out


def _group_angle_deg(g: dict) -> float:
    """Signed tilt of a merged run group (degrees, y-down screen coords)."""
    members = g["members"]
    if len(members) >= 3:
        xs = np.array(
            [m["x_start"] + m["length"] / 2.0 for m in members], np.float64
        )
        rows = np.array([m["row"] for m in members], np.float64)
        if float(np.ptp(xs)) >= 1.0:
            slope = float(np.polyfit(xs, rows, 1)[0])
            return float(np.degrees(np.arctan(slope)))
    dx = max(g["x1"] - g["x0"], 1)
    return float(np.degrees(np.arctan2(g["row_end"] - g["row_start"], dx)))


def merge_collinear_candidates(
    cands: List[dict], merge_gap: int = 15, row_tol: int = 3
) -> List[dict]:
    """Merge per-row runs into (possibly slightly rotated) line segments —
    the analog of the reference's merge_collinear_segments
    (scalebar_ocr.py:376-463, gap + y-tolerance chaining).

    A bar rotated a few degrees leaves the 3-row detection band every
    ``~3/tan(angle)`` columns, so it appears as a chain of shorter runs on
    consecutive rows; chaining them (x-gap <= ``merge_gap``, row step <=
    ``row_tol`` from the chain's right end) recovers the full bar, with
    ``length`` = hypot(x-extent, row-extent) — the bar's true length, which
    is what the um/px calibration divides by. Groups whose row extent is
    NOT line-like (> max(4, 0.15 * x-extent), i.e. steeper than ~8.5°) are
    returned unmerged: text rows chain the same way but are tall.
    """
    ordered = sorted(cands, key=lambda c: (c["x_start"], c["row"]))
    groups: List[dict] = []
    for c in ordered:
        cx0 = c["x_start"]
        cx1 = c["x_start"] + c["length"]
        for g in groups:
            if (
                cx0 <= g["x1"] + merge_gap
                and cx1 >= g["x0"] - merge_gap
                and abs(c["row"] - g["row_end"]) <= row_tol
            ):
                if cx0 < g["x0"]:
                    g["x0"] = cx0
                    g["row_start"] = c["row"]
                if cx1 > g["x1"]:
                    g["x1"] = cx1
                    g["row_end"] = c["row"]
                g["row_min"] = min(g["row_min"], c["row"])
                g["row_max"] = max(g["row_max"], c["row"])
                g["intensity"] = max(g["intensity"], c["intensity"])
                g["members"].append(c)
                break
        else:
            groups.append(
                {
                    "x0": cx0,
                    "x1": cx1,
                    "row_min": c["row"],
                    "row_max": c["row"],
                    "row_start": c["row"],
                    "row_end": c["row"],
                    "intensity": c["intensity"],
                    "members": [c],
                }
            )
    out: List[dict] = []
    for g in groups:
        dx = g["x1"] - g["x0"]
        dy = g["row_max"] - g["row_min"]
        if len(g["members"]) > 1 and dy > max(4, 0.15 * dx):
            out.extend(g["members"])  # not line-like: keep runs separate
            continue
        out.append(
            {
                "row": int(round((g["row_min"] + g["row_max"]) / 2.0)),
                "x_start": g["x0"],
                "length": int(round(float(np.hypot(dx, dy)))),
                "intensity": g["intensity"],
                # signed tilt (screen coords, y down) — drives the deskewed
                # re-read in detect_scale_bar. Least-squares slope over the
                # member runs' midpoints: the endpoint rows alone
                # underestimate the tilt by up to the 3-row band height
                # (±1.5 row over a short end run), which at 4° leaves a
                # ~2° residual after deskew — enough to still misread '5'
                # as '6'.
                "angle_deg": _group_angle_deg(g),
            }
        )
    return out


def find_scale_line(
    gray: np.ndarray,
    intensity: float = 100,
    merge_gap: int = 15,
    min_line_length: int = 30,
    edge_margin_factor: float = 0.1,
) -> Optional[Tuple[int, int, int]]:
    """Longest near-horizontal bright run (no text-proximity scoring).

    Returns (row, x_start, length_px) or None. ``detect_scale_bar`` uses
    :func:`scale_line_candidates` with proximity/intensity filters instead;
    this remains as the unconditional longest-run primitive.
    """
    cands = scale_line_candidates(
        gray, intensity, merge_gap, min_line_length, edge_margin_factor
    )
    if not cands:
        return None
    best = max(cands, key=lambda c: c["length"])
    return best["row"], best["x_start"], best["length"]


def _crop_glyph(canvas: np.ndarray) -> Optional[np.ndarray]:
    ys, xs = np.nonzero(canvas > 40)
    if ys.size == 0:
        return None
    return canvas[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]


def _atlas() -> Dict[int, List[Tuple[str, np.ndarray]]]:
    """Height -> [(glyph, template)] of the committed atlas, in the JAX
    package's template order; read once per process."""
    global _ATLAS
    if _ATLAS is None:
        with np.load(_ATLAS_PATH) as z:
            glyph_set = bytes(z["glyph_set"]).decode("utf-8")
            heights, glyphs, shapes = z["heights"], z["glyphs"], z["shapes"]
            offsets, pixels = z["offsets"], z["pixels"]
        per = len(glyphs) // len(heights)
        atlas = {}
        for i, h in enumerate(heights):
            atlas[int(h)] = [
                (glyph_set[glyphs[j]], pixels[offsets[j] : offsets[j + 1]].reshape(shapes[j]))
                for j in range(i * per, (i + 1) * per)
            ]
        _ATLAS = atlas
    return _ATLAS


def atlas_heights() -> Tuple[int, int]:
    """The lowest and highest glyph height the committed atlas holds."""
    heights = _atlas()
    return min(heights), max(heights)


def _rotate_template(t: np.ndarray, angle_deg: float) -> Optional[np.ndarray]:
    pad = max(2, int(0.3 * max(t.shape)))
    c = np.pad(t, pad)
    m = cv.rotation_matrix2d((c.shape[1] / 2.0, c.shape[0] / 2.0), angle_deg, 1.0)
    return _crop_glyph(cv.warp_affine_linear(c, m, (c.shape[1], c.shape[0])))


def _glyph_templates(height: int, angle_deg: float = 0.0) -> List[Tuple[str, np.ndarray]]:
    """Multi-font glyph atlas at a given pixel height (Hershey simplex and
    duplex, DejaVu Sans and Serif), from the committed atlas; heights
    outside :func:`atlas_heights` take the nearest end's templates.

    ``angle_deg`` (counterclockwise positive) rotates the atlas: when the
    scale bar, and with it the label, is tilted, matching the original
    glyphs against equally tilted templates beats deskewing the image. The
    cache key rounds the angle to 0.1 degree while the rotation uses the
    angle as given, as the JAX package does.
    """
    key = (height, round(float(angle_deg), 1))
    if key in _TEMPLATE_CACHE:
        return _TEMPLATE_CACHE[key]
    lo, hi = atlas_heights()
    out = list(_atlas()[min(max(height, lo), hi)])
    if abs(angle_deg) > 1e-6:
        out = [(ch, rt) for ch, t in out for rt in (_rotate_template(t, angle_deg),) if rt is not None]
    _TEMPLATE_CACHE[key] = out
    return out


def _resized_templates(templates, ph: int, pw: int):
    """(glyphs, [T, ph*pw] float32 templates resized to ph x pw with
    INTER_AREA and mean-centred, [T] their sums of squares), each row as
    the JAX package computes it for one template."""
    global _resized_bytes
    # the entry holds the templates, so their ids stay their own
    key = (ph, pw, *(id(t) for _, t in templates))
    hit = _RESIZED.get(key)
    if hit is not None:
        _RESIZED.move_to_end(key)
        return hit[1:]
    rows, sums = [], []
    for _, t in templates:
        b = cv.resize_area(t, pw, ph).astype(np.float32)
        b -= b.mean()
        rows.append(b.ravel())
        sums.append((b * b).sum())
    entry = (templates, [ch for ch, _ in templates], np.stack(rows), np.asarray(sums, np.float32))
    _RESIZED[key] = entry
    _resized_bytes += entry[2].nbytes
    while _resized_bytes > _RESIZED_BUDGET and len(_RESIZED) > 1:
        _resized_bytes -= _RESIZED.popitem(last=False)[1][2].nbytes
    return entry[1:]


def _read_glyph(patch: np.ndarray, templates) -> Tuple[str, float]:
    """The best-correlated glyph and its score; the first of equal scores
    wins. The correlations of all templates are one product."""
    ph, pw = patch.shape
    glyphs, b, bb = _resized_templates(templates, ph, pw)
    a = patch.astype(np.float32)
    a -= a.mean()
    aa = (a * a).sum()
    denom = np.sqrt(aa * bb)
    # each row summed in numpy's pairwise order, as (a * b).sum() of one
    # template is; a BLAS product would change the scores' last bits
    num = (b * a.ravel()).sum(axis=1)
    live = denom > 0
    scores = np.full(len(glyphs), -1.0)
    scores[live] = num[live] / denom[live]
    best_ch, best_score = "", -1.0
    for ch, score in zip(glyphs, scores.tolist()):
        if score > best_score:
            best_ch, best_score = ch, score
    return best_ch, best_score


def roi_polarity_inverted(gray: np.ndarray) -> bool:
    """True when the ROI is bright-background (dark bar/label): the
    above-Otsu fraction then exceeds half. The reference's Canny+Hough line
    detector was polarity-insensitive; the run scan flips the ROI instead."""
    t, _ = cv.otsu_threshold(gray)
    return float((gray > t).mean()) > 0.5


def _split_wide(thr, x, y, w, h):
    """Split a merged multi-glyph blob (w > 1.6h — blur/antialiasing can
    bridge adjacent glyphs) at deep valleys of the vertical ink profile."""
    patch = thr[y : y + h, x : x + w]
    ink = (patch > 0).sum(axis=0).astype(np.float32)
    med = max(float(np.median(ink[ink > 0])) if (ink > 0).any() else 1.0, 1.0)
    deep = ink < 0.25 * med
    # valley centers: runs of deep columns away from the borders
    pieces = []
    start = 0
    i = 0
    while i < w:
        if deep[i] and 0 < i < w - 1:
            j = i
            while j < w and deep[j]:
                j += 1
            cut = (i + j) // 2
            if cut - start >= 3:
                pieces.append((x + start, y, cut - start, h))
            start = cut
            i = j
        else:
            i += 1
    if w - start >= 3:
        pieces.append((x + start, y, w - start, h))
    return pieces if len(pieces) > 1 else [(x, y, w, h)]


def read_scale_text(gray: np.ndarray):
    """Segment connected components into glyphs (left to right) and classify
    each against the multi-font atlas.

    Returns ``(text, center, bbox, tokens)``: ``center`` is the (x, y)
    centroid and ``bbox`` the (x0, y0, x1, y1) extent of the accepted glyph
    boxes in ROI pixel coordinates (both None when no glyph was
    recognized); ``tokens`` is a list of ``(token_string, (cx, cy))`` for
    each whitespace-separated token — the analog of the reference's
    per-box EasyOCR results used for line↔text proximity scoring and
    value↔line association (scalebar_ocr.py:186-189,241-244)."""
    text, center, bbox, tokens, _score, _n = _read_scale_text_scored(gray)
    return text, center, bbox, tokens


def _read_scale_text_scored(gray: np.ndarray, template_angle: float = 0.0):
    """``read_scale_text`` plus the mean accepted-glyph NCC score — the
    read-quality signal ``detect_scale_bar`` uses to pick between its
    raw and denoised reading hypotheses. ``template_angle`` matches a
    tilted label against an equally tilted glyph atlas."""
    # 2x cubic upscale before binarization: reconnects thin serif strokes
    # that noise/JPEG/blur would otherwise fragment into bare stems
    gray = cv.resize_cubic_x2(gray)
    thr = cv.otsu_threshold(gray)[1]
    if thr.mean() > 127:  # dark text on bright: invert
        thr = 255 - thr
    n, stats = cv.connected_components_with_stats(thr)
    h_roi = gray.shape[0]
    comps = []
    for i in range(1, n):
        x, y, w, h, area = stats[i]
        if h < 3 or area < 6 or h > 0.95 * h_roi:
            continue
        if w > 4 * h:  # the scale bar itself
            continue
        comps.append((x, y, w, h))
    if not comps:
        return "", None, None, [], -1.0, 0
    heights = [c[3] for c in comps if c[3] >= 5]
    med_h = int(np.median(heights)) if heights else 8
    bottoms = [y + h for _, y, _, h in comps if h >= 5]
    med_bottom = float(np.median(bottoms)) if bottoms else float(med_h)
    # drop glyph FRAGMENTS: a small blob whose x-center lies under a tall
    # component is a piece JPEG/noise broke off that glyph (a '5' losing
    # its lower-left corner), not a decimal dot — a real '.' sits BETWEEN
    # glyphs ("500" would otherwise read "5.00", a 100x value error)
    tall = [c for c in comps if c[3] >= 0.7 * med_h]

    def _is_fragment(c):
        x, y, w, h = c
        if h >= 0.5 * med_h or w >= 0.5 * med_h:
            return False
        cx = x + w / 2.0
        return any(
            tx <= cx <= tx + tw for tx, _ty, tw, _th in tall if (tx, _ty, tw, _th) != c
        )

    comps = [c for c in comps if not _is_fragment(c)]
    if not comps:
        return "", None, None, [], -1.0, 0
    templates = _glyph_templates(max(med_h, 8), template_angle)

    def _classify(box):
        bx, by, bw, bh = box
        patch = thr[by : by + bh, bx : bx + bw]
        is_small = bh < 0.5 * med_h
        ch, score = _read_glyph(
            patch,
            # a dot is the only glyph much shorter than the line height;
            # conversely full-height components must not classify as '.'
            [(c, t) for c, t in templates if (c == ".") == is_small],
        )
        if is_small and score < 0.6:
            # a solid (near-constant) dot defeats NCC — zero variance on
            # either side makes every correlation undefined. Bitmap-font
            # dots are solid squares (tests/test_scalebar_foreign.py);
            # classify small, filled, baseline-anchored blobs as '.'.
            fill = float((patch > 0).mean())
            low = by + bh >= med_bottom - 0.35 * med_h
            if fill > 0.55 and low and 0.4 <= bw / max(bh, 1) <= 2.5:
                ch, score = ".", 0.7
        return box, ch, score

    def _best_segmentation(x, y, w, h):
        """Read a wide blob as the best-scoring contiguous grouping of its
        valley pieces.

        A wide blob may be a naturally wide glyph (bold 'm'), a merged
        glyph pair ('nm' bridged by JPEG artifacts), or both — and the
        valley split alone over-cuts double-stemmed glyphs (bold 'n' has a
        baseline gap between its stems, reading as '11'). Enumerate every
        contiguous grouping of the pieces and keep the one whose glyphs
        score highest on average (measured on the foreign-renderer corpus,
        tests/test_scalebar_foreign.py: serif-bold 'nm' -> '11m' without
        this)."""
        # split trigger 1.35h: a merged '00' at small font sizes is only
        # ~1.55h wide, while natural wide glyphs ('m' ~1.4h) are protected
        # by the enumeration below keeping the unsplit grouping as a
        # candidate
        pieces = (
            _split_wide(thr, x, y, w, h) if w > 1.35 * h else [(x, y, w, h)]
        )
        k = len(pieces)
        if k == 1:
            whole = _classify(pieces[0])
            if w > 1.35 * h:
                # no ink valley found, but the blob is still glyph-pair
                # wide: heavy antialiasing at small font sizes bridges a
                # '00' with enough ink that no column dips low. Try an
                # equal-width split into round(w/h) near-square glyphs and
                # keep it only when its glyphs clearly outscore the
                # whole-blob reading.
                n_eq = max(2, int(round(w / float(h))))
                bounds = [x + int(round(i * w / n_eq)) for i in range(n_eq + 1)]
                eq = [
                    _classify(
                        (bounds[i], y, bounds[i + 1] - bounds[i], h)
                    )
                    for i in range(n_eq)
                ]
                eq_mean = float(np.mean([sc for _, _, sc in eq]))
                if eq_mean > whole[2] + 0.1:
                    return eq
            return [whole]
        if k > 7:  # pathological blob; avoid 2^k enumeration
            return [_classify(b) for b in pieces]
        spans = {}
        for i in range(k):
            for j in range(i + 1, k + 1):
                bx = pieces[i][0]
                bw = pieces[j - 1][0] + pieces[j - 1][2] - bx
                # no single glyph is much wider than 2.6x the line height
                if bw <= 2.6 * h or (i, j) == (0, k):
                    spans[(i, j)] = _classify((bx, y, bw, h))
        best = None
        for mask in range(1 << (k - 1)):
            cuts = (
                [0]
                + [i + 1 for i in range(k - 1) if mask >> i & 1]
                + [k]
            )
            segs = list(zip(cuts[:-1], cuts[1:]))
            if any(s not in spans for s in segs):
                continue
            rr = [spans[s] for s in segs]
            mean = float(np.mean([sc for _, _, sc in rr]))
            if best is None or mean > best[0]:
                best = (mean, rr)
        return best[1]

    comps.sort(key=lambda c: c[0])
    reads = []
    for box in comps:
        reads.extend(_best_segmentation(*box))

    chars = []
    accepted = []
    accepted_scores = []
    prev_end = None
    for (x, y, w, h), ch, score in reads:
        if score > 0.35:
            # word spacing: a gap much wider than glyph spacing separates
            # the value from the unit — keeps a misread unit stroke from
            # being absorbed into the number ("200 nm" -> "2001n")
            if prev_end is not None and x - prev_end > 0.45 * med_h:
                chars.append(" ")
            chars.append(ch)
            accepted.append((x, y, w, h))
            accepted_scores.append(float(score))
            prev_end = x + w
    text = "".join(chars)
    if not accepted:
        return text, None, None, [], -1.0, 0
    # whitespace-separated tokens with their glyph-box centers (ROI pixels;
    # glyph coordinates are on the 2x-upscaled image, so halve back) — the
    # analog of EasyOCR's per-box results, needed to associate the VALUE
    # with the chosen line when the ROI holds several text fields (SEM
    # info strips: "15.0kV  x5,000  2 um  WD 8.1mm")
    tokens: List[Tuple[str, Tuple[float, float]]] = []
    tok_chars: List[str] = []
    tok_boxes: List[Tuple[int, int, int, int]] = []
    gi = 0

    def _flush():
        if tok_chars:
            tcx = float(np.mean([x + w / 2.0 for x, y, w, h in tok_boxes])) / 2.0
            tcy = float(np.mean([y + h / 2.0 for x, y, w, h in tok_boxes])) / 2.0
            tokens.append(("".join(tok_chars), (tcx, tcy)))
            tok_chars.clear()
            tok_boxes.clear()

    for ch in chars:
        if ch == " ":
            _flush()
            continue
        tok_chars.append(ch)
        tok_boxes.append(accepted[gi])
        gi += 1
    _flush()
    cx = float(np.mean([x + w / 2.0 for x, y, w, h in accepted])) / 2.0
    cy = float(np.mean([y + h / 2.0 for x, y, w, h in accepted])) / 2.0
    bx0 = min(x for x, y, w, h in accepted) / 2.0
    by0 = min(y for x, y, w, h in accepted) / 2.0
    bx1 = max(x + w for x, y, w, h in accepted) / 2.0
    by1 = max(y + h for x, y, w, h in accepted) / 2.0
    mean_score = float(np.mean(accepted_scores))
    return text, (cx, cy), (bx0, by0, bx1, by1), tokens, mean_score, len(accepted)


def _unit_factor(rest: str) -> Tuple[float, int]:
    """(to-micrometre factor, strength) from the text after a number.

    Priority u/µ > n > mm: a unit token may contain misread strokes, and a
    'u' (or 'µ') present anywhere marks micrometres unambiguously.
    Millimetres require BOTH 'm' glyphs: a bare residual 'm' most often
    means the 'u' of 'um' (or 'n' of 'nm') was dropped by noise — treating
    it as mm would silently scale every measurement by 10^3 (ADVICE r2).
    Strength: 2 = explicit length unit, 1 = bare residual 'm', 0 = none."""
    if "u" in rest or "µ" in rest:
        return 1.0, 2
    if "n" in rest:
        return 1e-3, 2  # nm -> um
    if rest.count("m") >= 2:
        return 1e3, 2  # mm -> um
    if "m" in rest:
        return 1.0, 1  # dropped-glyph residual; read as um
    return 1.0, 0


def parse_scale_value(text: str) -> Optional[Tuple[float, str]]:
    """First numeric token + unit from recognized text (reference takes the
    first numeric token, scalebar_ocr.py:169-189). Returns (value_um, raw)."""
    full = _parse_scale_value_full(text)
    return None if full is None else full[:2]


def _parse_scale_value_full(text: str) -> Optional[Tuple[float, str, int]]:
    """``parse_scale_value`` plus the unit strength (0/1/2)."""
    m = re.search(r"(\d+(?:\.\d+)?)", text)
    if not m:
        return None
    value = float(m.group(1))
    factor, strength = _unit_factor(text[m.end() :])
    return value * factor, m.group(1), strength


def parse_scale_tokens(
    tokens: List[Tuple[str, Tuple[float, float]]],
    line_center: Optional[Tuple[float, float]],
) -> Optional[Tuple[float, str]]:
    """Value+unit chosen among per-token OCR results: the pair with an
    explicit length unit nearest the chosen line wins.

    A multi-field annotation strip ("15.0kV  x5,000  2 um  WD 8.1mm")
    defeats first-numeric-token parsing; the reference avoids this because
    EasyOCR returns per-box text it associates with the line
    (scalebar_ocr.py:241-249). Candidates are (number token, unit text)
    pairs — the unit may trail in the same token ("8.1mm") or be the next
    all-letter token ("2" + "um"). Ranked by unit strength (explicit
    length unit > residual 'm' > none), then by distance to
    ``line_center``. Returns (value_um, raw) or None."""
    full = _parse_scale_tokens_full(tokens, line_center)
    return None if full is None else full[:2]


def _parse_scale_tokens_full(
    tokens: List[Tuple[str, Tuple[float, float]]],
    line_center: Optional[Tuple[float, float]],
) -> Optional[Tuple[float, str, int]]:
    """``parse_scale_tokens`` plus the winning candidate's unit strength."""
    # re-glue decimals the spacing heuristic split apart: wide-advance
    # (bitmap/monospaced) fonts put glyph gaps near the word-space width,
    # so "1.5" tokenizes as ["1", ".", "5"] (tests/test_scalebar_foreign.py)
    merged: List[Tuple[str, Tuple[float, float]]] = []
    for tok, center in tokens:
        if merged:
            pt, pc = merged[-1]
            glue = (
                re.fullmatch(r"\d+", pt) and re.fullmatch(r"\.\d*", tok)
            ) or (pt.endswith(".") and re.match(r"\d", tok))
            if glue:
                merged[-1] = (
                    pt + tok,
                    ((pc[0] + center[0]) / 2.0, (pc[1] + center[1]) / 2.0),
                )
                continue
        merged.append((tok, center))
    tokens = merged
    cands = []
    for i, (tok, center) in enumerate(tokens):
        # a value token STARTS with a digit ("8.1mm", "500"); a number
        # embedded after letters is a misread glyph stroke ("u1n" = noisy
        # serif 'm'), and magnification fields ("x5,000") are excluded too
        m = re.match(r"(\d+(?:\.\d+)?)", tok)
        if not m:
            continue
        value = float(m.group(1))
        if value <= 0:
            continue
        rest = tok[m.end() :]
        cx, cy = center
        if not re.search(r"[a-zµ]", rest, re.IGNORECASE) and i + 1 < len(
            tokens
        ):
            # unit in the NEXT token ("2" + "um") — it must start with a
            # letter (misread strokes may add digits inside: "u1n")
            nxt, ncenter = tokens[i + 1]
            if not re.match(r"\d", nxt):
                rest = nxt
                cx = (cx + ncenter[0]) / 2.0
                cy = (cy + ncenter[1]) / 2.0
        factor, strength = _unit_factor(rest)
        dist = (
            float(np.hypot(cx - line_center[0], cy - line_center[1]))
            if line_center is not None
            else 0.0
        )
        # unit-bearing candidates compete on proximity to the line (several
        # annotated fields may carry length units); unit-LESS ones keep the
        # value-precedes-unit reading order — a later unit-less token is
        # usually the misread unit itself ("2 um" -> "2", "1171"), and
        # glyph-box distance would prefer the garbage.
        # Rank: explicit unit (2) > plain number (0) > residual 'm' (1) — a
        # digit-bearing token ending in a bare 'm' ("11m") is most often the
        # unit itself with misread strokes ('u'->'11' under JPEG artifacts);
        # letting it beat a clean number token would read "500 um" as 11.
        rank = {2: 0, 0: 1, 1: 2}[strength]
        if strength > 0 and re.search(r"\d", rest):
            # digits INSIDE the unit text ("11n1" = blurred 'um') mark the
            # "value" as misread unit strokes too — demote below everything
            # so a clean number token elsewhere wins ("500 11n1" must read
            # 500, not 11 nm); a lone candidate still parses.
            rank = 3
        tiebreak = dist if strength > 0 else float(i)
        cands.append((rank, tiebreak, value * factor, m.group(1), strength))
    if not cands:
        return None
    cands.sort()
    _, _, value_um, raw, strength = cands[0]
    return value_um, raw, strength


def detect_scale_bar(
    image: np.ndarray,
    config: dict,
    dataset_name: Optional[str] = None,
    return_debug: bool = False,
):
    """(psum, um_pix[, debug]): scale value string and micrometres-per-pixel.

    Same contract and fallback as reference detect_scale_bar
    (scalebar_ocr.py:72-374): returns ("0", 1.0) when no bar/label is found.
    With ``return_debug`` a third dict carries the ROI box and detected line
    in image coordinates (for --draw-scalebar overlays,
    reference scalebar_ocr.py's debug drawing).
    """
    debug = {"roi": None, "line": None, "text": ""}

    def _ret(psum, um_pix):
        return (psum, um_pix, debug) if return_debug else (psum, um_pix)

    try:
        x0, y0, x1, y1 = get_scalebar_roi(config, dataset_name, image.shape)
        debug["roi"] = (x0, y0, x1, y1)
        # grey values are per pixel: converting the ROI alone is exact
        roi = image[y0:y1, x0:x1]
        roi = cv.bgr_to_gray(roi) if roi.ndim == 3 else roi
        if roi.size == 0:
            return _ret("0", 1.0)
        if roi_polarity_inverted(roi):
            roi = 255 - roi  # dark-bar-on-bright annotation style
        thr = config.get("scalebar_thresholds", {})
        intensity_thr = thr.get("intensity", 100)
        merge_gap = int(thr.get("merge_gap", 15))
        min_line_length = int(thr.get("min_line_length", 30))
        # Line selection mirrors the reference's criteria chain
        # (scalebar_ocr.py:303-309): the chosen line must be bright along its
        # length (mean intensity > threshold), near the recognized text
        # (center distance < `proximity`) but not inside the label's own
        # glyph box, and is the longest that qualifies. Border artifacts /
        # annotation underlines far from the label lose to these filters
        # even when longer than the bar.
        proximity = float(thr.get("proximity", 100))
        emf = float(thr.get("edge_margin_factor", 0.1))

        def _line_candidates(roi_img, transposed):
            # sub-runs of a slightly rotated bar are shorter than the bar:
            # detect at a reduced floor, then chain collinear runs back
            # into full segments and apply the configured floor to the
            # MERGED length
            merged = merge_collinear_candidates(
                scale_line_candidates(
                    np.ascontiguousarray(roi_img.T) if transposed else roi_img,
                    intensity=intensity_thr,
                    merge_gap=merge_gap,
                    min_line_length=max(8, min_line_length // 3),
                    edge_margin_factor=emf,
                ),
                merge_gap=merge_gap,
            )
            return [c for c in merged if c["length"] >= min_line_length]

        def _cand_geometry(c, vertical):
            """(center_xy, extent_box) of a candidate in ROI coordinates."""
            if vertical:
                cx = float(c["row"])
                cy = c["x_start"] + c["length"] / 2.0
                box = (c["row"], c["x_start"], c["row"],
                       c["x_start"] + c["length"])
            else:
                cx = c["x_start"] + c["length"] / 2.0
                cy = float(c["row"])
                box = (c["x_start"], c["row"],
                       c["x_start"] + c["length"], c["row"])
            return (cx, cy), box

        def _select_line(roi_img, cand_list, vertical, tbox, text_center):
            # structural lines: a run spanning the whole usable ROI extent
            # is an info-strip separator / panel border, not a scale bar
            # (SEM info bars place a full-width rule directly above the
            # annotation text, inside any proximity radius). Demote such
            # runs: they can only be chosen when no non-spanning candidate
            # qualifies (a dataset ROI drawn tightly around the bar itself
            # stays detectable).
            span = roi_img.shape[1 - int(vertical)]
            margin_px = int(span * emf)

            def _spans_roi(c):
                return (
                    c["x_start"] <= margin_px + 1
                    and c["x_start"] + c["length"] >= span - margin_px - 2
                )

            for allow_spanning in (False, True):
                for c in sorted(cand_list, key=lambda c: -c["length"]):
                    if c["intensity"] <= intensity_thr:
                        continue
                    if _spans_roi(c) and not allow_spanning:
                        continue
                    (ccx, ccy), ext = _cand_geometry(c, vertical)
                    if tbox is not None:
                        # run lies within the text block (glyph strokes
                        # bridged into a pseudo-line): skip — the bar sits
                        # outside the label box
                        bx0, by0, bx1, by1 = tbox
                        if (
                            by0 - 2 <= ext[1]
                            and ext[3] <= by1 + 2
                            and ext[0] >= bx0 - 2
                            and ext[2] <= bx1 + 2
                        ):
                            continue
                    if text_center is not None:
                        dist = float(
                            np.hypot(
                                ccx - text_center[0], ccy - text_center[1]
                            )
                        )
                        if dist >= proximity:
                            continue
                    return c, vertical
            return None

        cands = _line_candidates(roi, transposed=False)
        # vertical-bar fallback candidates (some annotation styles run the
        # scale bar vertically beside horizontal text; the reference's
        # ±10°-horizontal Hough filter could not see these): the same scan
        # on the transposed ROI, used only when no horizontal line
        # qualifies
        cands_v = _line_candidates(roi, transposed=True)

        def _evaluate(template_angle):
            """All (level, score, line, parsed, text) reading hypotheses
            for one glyph-atlas tilt.

            Two reading hypotheses per tilt: the raw ROI and a
            3x3-Gaussian-denoised one. Denoising reconnects glyphs
            fragmented by sensor noise and suppresses JPEG ringing blobs,
            but blurs fine serif-bold strokes into ambiguity; neither wins
            everywhere (measured on tests/test_scalebar_foreign.py). Level
            2 = token parse with an explicit length unit, 1 = any other
            successful parse, 0 = no line/value."""
            hyps = []
            for g in (roi, cv.gaussian_blur3(roi)):
                text, text_center, tbox, text_tokens, score, n_glyphs = (
                    _read_scale_text_scored(g, template_angle)
                )
                line = _select_line(roi, cands, False, tbox, text_center)
                if line is None and cands_v:
                    line = _select_line(roi, cands_v, True, tbox, text_center)
                line_center = (
                    _cand_geometry(*line)[0] if line is not None else None
                )
                strength = 0
                parsed = _parse_scale_tokens_full(text_tokens, line_center)
                if parsed is None:
                    parsed = _parse_scale_value_full(text)
                if parsed is not None:
                    value_um, raw, strength = parsed
                    parsed = (value_um, raw)
                if line is None or parsed is None:
                    level = 0
                elif strength == 2:
                    level = 2
                else:
                    level = 1
                hyps.append((level, score, line, parsed, text, n_glyphs))
            return hyps

        hyps = _evaluate(0.0)
        top = max(hyps, key=lambda h: (h[0], h[1]))
        line = top[2]
        if (
            line is not None
            and not line[1]
            and abs(line[0].get("angle_deg", 0.0)) >= 1.2
        ):
            # a tilted bar tilts the label with it, and rotated glyphs
            # misclassify against an upright atlas ('5' at 4° reads as
            # '6'): add hypotheses that match the ORIGINAL crisp glyphs
            # against an equally tilted atlas. The measured line angle is
            # y-down (row over x); the template rotation convention is
            # counterclockwise positive, so the atlas tilt is its negation.
            hyps.extend(_evaluate(-line[0]["angle_deg"]))
        # Arbitrate by value consensus: among the hypotheses at the highest
        # parse level, group by the parsed value and keep the group with
        # the highest summed (glyph score x glyph count) — single-hypothesis
        # score ranking is brittle when a misread is one NCC hair above a
        # correct read ('500' tilted 4° vs '600' blurred), and the glyph
        # count penalizes reads that silently DROPPED glyphs (a double-blur
        # '500 um' collapsing to '5 um' scores high on its 3 surviving
        # glyphs); both measured on the corpora in
        # tests/test_scalebar_{corpus,foreign}.py.
        max_level = max(h[0] for h in hyps)
        if max_level == 0:
            top = max(hyps, key=lambda h: h[1])
            debug["text"] = top[4]
            log.debug(
                "Scale bar not detected (line=%s, text=%r) — fallback",
                top[2], top[4],
            )
            return _ret("0", 1.0)
        pool = [h for h in hyps if h[0] == max_level]
        weights: Dict[Tuple[str, float], float] = {}
        for h in pool:
            key = (h[3][1], round(h[3][0], 9))
            weights[key] = weights.get(key, 0.0) + h[1] * h[5]
        best_key = max(weights, key=lambda k: weights[k])
        best = max(
            (h for h in pool if (h[3][1], round(h[3][0], 9)) == best_key),
            key=lambda h: h[1],
        )
        _level, _score, line, parsed, text, _n = best
        debug["text"] = text
        c, vertical = line
        row, xs, length = c["row"], c["x_start"], c["length"]
        if vertical:
            p0, p1 = (row, xs), (row, xs + length)
        else:
            p0, p1 = (xs, row), (xs + length, row)
        debug["line"] = (
            int(round(x0 + p0[0])), int(round(y0 + p0[1])),
            int(round(x0 + p1[0])), int(round(y0 + p1[1])),
        )
        value_um, raw = parsed
        um_pix = value_um / float(length)
        return _ret(raw, um_pix)
    except Exception as e:  # noqa: BLE001 - detection must never kill a run
        log.warning("Scale bar detection failed: %s — fallback", e)
        return _ret("0", 1.0)

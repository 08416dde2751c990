"""The port's scale-bar reader against the JAX package's on every image the
two scale-bar corpora build, on the distractor and info-strip renders, and
on labels taller than the port's glyph atlas: ``psum`` equal, ``um_pix``
equal to 1e-9 relative, the ``debug`` dict equal (fallbacks included).
Also the parsers on strings and ``read_scale_text`` on the corpora's ROIs."""

import cv2
import numpy as np
import pytest

import test_scalebar_corpus as corpus
import test_scalebar_foreign as foreign
from deepemia_tpu.inference import scalebar as ref_sb
from deepemia_tpu_torch.inference import scalebar as sb


@pytest.fixture(autouse=True)
def _fresh_template_caches():
    """Both readers' atlas caches start empty: a cached tilted atlas
    (keyed by the angle rounded to 0.1 degree) depends on which image
    filled it first."""
    ref_sb._TEMPLATE_CACHE.clear()
    sb._TEMPLATE_CACHE.clear()
    yield
    ref_sb._TEMPLATE_CACHE.clear()
    sb._TEMPLATE_CACHE.clear()


def _same_reading(img, cfg, dataset=None):
    ref = ref_sb.detect_scale_bar(img, cfg, dataset, return_debug=True)
    got = sb.detect_scale_bar(img, cfg, dataset, return_debug=True)
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= 1e-9 * abs(ref[1])
    assert got[2] == ref[2]
    return got


def _corpus_images():
    for font, label, value_um, deg, kw in corpus._corpus():
        yield f"{font}/{label}/{deg}", corpus._render(label, font, **kw), corpus.CFG, value_um


def _foreign_images():
    for source, label, value_um, img in foreign._corpus():
        yield f"{source}/{label}", img, foreign.CFG, value_um


@pytest.mark.parametrize("part", range(3))
def test_detect_matches_on_the_corpus(part):
    images = list(_corpus_images())[part::3]
    read = 0
    for name, img, cfg, value_um in images:
        psum, um_pix, _ = _same_reading(img, cfg)
        read += psum != "0" and abs(um_pix - value_um / corpus.BAR_LEN) <= 0.02 * value_um / corpus.BAR_LEN
    assert read >= 0.9 * len(images)


@pytest.mark.parametrize("part", range(3))
def test_detect_matches_on_the_foreign_corpus(part):
    """Tilted labels take the rotated atlas (the port's own warp)."""
    for name, img, cfg, _ in list(_foreign_images())[part::3]:
        _same_reading(img, cfg)


def test_detect_matches_on_distractors_and_info_strips():
    labels = [label for label, _ in corpus.LABELS]
    for label in labels:
        for kind in ("underline", "border", "second_bar", "texture"):
            _same_reading(corpus._render_distractor(label, kind), corpus.DISTRACTOR_CFG)
        _same_reading(corpus._render_info_strip(label), corpus.DISTRACTOR_CFG)


def test_fallbacks_match():
    """No label, no bar, an empty ROI, and a reading that raises."""
    plain = np.full((128, 128, 3), 30, np.uint8)
    assert _same_reading(plain, corpus.DISTRACTOR_CFG)[:2] == ("0", 1.0)
    far = np.full((corpus.ROI_H, corpus.ROI_W), 20, np.uint8)
    cv2.putText(far, "2 um", (140, 30), cv2.FONT_HERSHEY_SIMPLEX, 20 / 22.0, 230, 2, cv2.LINE_AA)
    cv2.rectangle(far, (430, 100), (779, 102), 230, -1)
    assert _same_reading(cv2.cvtColor(far, cv2.COLOR_GRAY2BGR), corpus.DISTRACTOR_CFG)[:2] == ("0", 1.0)
    empty_roi = {"scale_bar_rois": {"default": {"x_start_factor": 1.0, "width_factor": 0.0}}}
    assert _same_reading(plain, empty_roi)[:2] == ("0", 1.0)
    bad = {"scale_bar_rois": corpus.CFG["scale_bar_rois"], "scalebar_thresholds": {"merge_gap": "wide"}}
    assert _same_reading(plain, bad) == ("0", 1.0, {"roi": (0, 0, 128, 128), "line": None, "text": ""})


def test_dataset_roi_and_gray_input():
    img = corpus._render("2 um", "hershey_simplex")
    cfg = {
        "scale_bar_rois": {"default": {"x_start_factor": 0.9}, "ds": {"x_start_factor": 0.0, "y_start_factor": 0.0,
                                                                      "width_factor": 1.0, "height_factor": 1.0}},
        "scalebar_thresholds": corpus.CFG["scalebar_thresholds"],
    }
    assert _same_reading(img, cfg, "ds")[0] == "2"
    assert _same_reading(img[..., 0].copy(), cfg, "ds")[0] == "2"


def _tall_label(label, font, px):
    """A label whose glyphs stand taller (after the reader's 2x upscale)
    than the atlas's top height, with a 400-px bar under it."""
    img = np.full((int(px * 2.2) + 40, int(px * 4.5) + 260), 20, np.uint8)
    if font == "hershey":
        cv2.putText(img, label, (150, 10 + px), cv2.FONT_HERSHEY_SIMPLEX, px / 22.0, 230, max(1, px // 11), cv2.LINE_AA)
    else:
        from PIL import Image, ImageDraw, ImageFont

        pil = Image.fromarray(img)
        ImageDraw.Draw(pil).text((150, 10), label, fill=230, font=ImageFont.truetype(corpus.TTF_FONTS[font], px))
        img = np.array(pil)
    y = int(px * 1.5) + 20
    cv2.rectangle(img, (150, y), (549, y + 5), 230, -1)
    return cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)


@pytest.mark.parametrize("font", ["hershey", "dejavu_sans", "dejavu_serif"])
def test_labels_above_the_atlas_read_as_the_reference(font):
    cfg = {**corpus.CFG, "scalebar_thresholds": {**corpus.CFG["scalebar_thresholds"], "proximity": 400}}
    top = sb.atlas_heights()[1]
    for label, value_um in (("500 um", 500.0), ("2 um", 2.0), ("1.5 um", 1.5), ("200 nm", 0.2)):
        for px in (70, 90):
            psum, um_pix, debug = _same_reading(_tall_label(label, font, px), cfg)
            assert psum != "0" and abs(um_pix * 400 - value_um) <= 0.02 * value_um, (label, px, debug)
    assert max(h for h, _ in sb._TEMPLATE_CACHE) > top


def test_parsers_match():
    texts = ["500um", "500 µm", "200nm", "2mm", "1.5 um", "no digits here", "2 m", "2 ?m", "11m", "u1n 500",
             "15.0kV x5,000 2 um WD 8.1mm", "", ".5 um", "0 nm", "3.25.1 um"]
    for t in texts:
        assert sb.parse_scale_value(t) == ref_sb.parse_scale_value(t)
        assert sb._parse_scale_value_full(t) == ref_sb._parse_scale_value_full(t)
        assert sb._unit_factor(t) == ref_sb._unit_factor(t)
    token_sets = [
        [("500", (10.0, 5.0)), ("um", (30.0, 5.0))],
        [("15.0kV", (5.0, 5.0)), ("x5,000", (40.0, 5.0)), ("2", (80.0, 5.0)), ("um", (95.0, 5.0)), ("WD", (120.0, 5.0)), ("8.1mm", (140.0, 5.0))],
        [("1", (0.0, 0.0)), (".", (4.0, 0.0)), ("5", (8.0, 0.0)), ("um", (20.0, 0.0))],
        [("1.", (0.0, 0.0)), ("5", (8.0, 0.0)), ("nm", (20.0, 0.0))],
        [("500", (0.0, 0.0)), ("11n1", (20.0, 0.0))],
        [("11m", (0.0, 0.0))],
        [],
    ]
    for tokens in token_sets:
        for center in (None, (90.0, 10.0), (0.0, 0.0)):
            assert sb.parse_scale_tokens(tokens, center) == ref_sb.parse_scale_tokens(tokens, center)
            assert sb._parse_scale_tokens_full(tokens, center) == ref_sb._parse_scale_tokens_full(tokens, center)


def test_read_scale_text_and_lines_match_on_rois():
    rois = [cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) for _, img, _, _ in list(_corpus_images())[::7]]
    rois += [cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) for _, img, _, _ in list(_foreign_images())[::9]]
    rois.append(np.zeros((40, 200), np.uint8))
    for roi in rois:
        assert sb.read_scale_text(roi) == ref_sb.read_scale_text(roi)
        assert sb._read_scale_text_scored(roi, 3.0) == ref_sb._read_scale_text_scored(roi, 3.0)
        assert sb.roi_polarity_inverted(roi) == ref_sb.roi_polarity_inverted(roi)
        cands = sb.scale_line_candidates(roi, edge_margin_factor=0.05)
        assert cands == ref_sb.scale_line_candidates(roi, edge_margin_factor=0.05)
        assert sb.merge_collinear_candidates(cands) == ref_sb.merge_collinear_candidates(cands)
        assert sb.find_scale_line(roi) == ref_sb.find_scale_line(roi)
        assert sb.get_scalebar_roi(corpus.CFG, None, roi.shape) == ref_sb.get_scalebar_roi(corpus.CFG, None, roi.shape)


@pytest.mark.parametrize("budget", [None, 1])
def test_read_glyph_equals_the_reference(monkeypatch, budget):
    """The batched correlation picks the JAX package's glyph with its score
    bit for bit, on a first read and on a cached one; a budget below one
    entry keeps only the newest entry."""
    if budget is not None:
        monkeypatch.setattr(sb, "_RESIZED_BUDGET", budget)
    rng = np.random.default_rng(7)
    shapes = [(1, 5), (7, 1), (17, 9), (40, 23), (90, 61)]
    for height, angle in ((12, 0.0), (40, 0.0), (128, 0.0), (24, 3.3)):
        templates = sb._glyph_templates(height, angle)
        for small in (False, True):
            subset = [(c, t) for c, t in templates if (c == ".") == small]
            for shape in shapes:
                patch = np.where(rng.random(shape) < 0.4, 255, 0).astype(np.uint8)
                for _ in range(2):
                    assert sb._read_glyph(patch, subset) == ref_sb._read_glyph(patch, subset)
            blank = np.zeros((20, 11), np.uint8)
            assert sb._read_glyph(blank, subset) == ref_sb._read_glyph(blank, subset) == ("", -1.0)
    assert sb._resized_bytes == sum(e[2].nbytes for e in sb._RESIZED.values())
    if budget is not None:
        assert len(sb._RESIZED) == 1

"""Port parity of the overlays: ``render_overlay`` (with and without
instance IDs), ``draw_scalebar_debug`` and ``render_legend`` against the JAX
package's (OpenCV's drawing), on seeded images and masks.

Outside the text boxes every pixel must be equal. Inside them (the pixels
``viz.text_box`` gives for each label) a pixel may differ by TEXT_TOL
levels: OpenCV blends each anti-aliased stroke of a glyph in turn, with
rounding, and the port blends the glyph's composite coverage from the
atlas once, so a pixel where strokes cross can land one level apart.
The atlas holds printable ASCII and Latin-1; any other character is drawn
as a '?' for each byte of its UTF-8 form, as OpenCV's Hershey fonts draw
it, so where OpenCV draws such a character with a glyph of its own only
the label's box and that glyph's may differ. ``save_png`` must round-trip
through ``cv2.imread``, and the committed text atlas must equal a fresh
render by its tool."""

import importlib.util
from pathlib import Path

import cv2
import numpy as np
import pytest

from deepemia_tpu.inference import viz as jax_viz
from deepemia_tpu_torch.inference import viz
from deepemia_tpu_torch.ops.image import read_image

ROOT = Path(__file__).resolve().parents[1]
TEXT_TOL = 1


def _masks(rng, hw, n):
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(-5, h + 5), rng.uniform(-5, w + 5)
        ry, rx = rng.uniform(2, 25, 2)
        out.append(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
    out.append(np.zeros(hw, bool))  # an empty mask draws nothing and takes no label
    return out


def _text_region(hw, labels):
    region = np.zeros(hw, bool)
    for text, org, scale in labels:
        x0, y0, x1, y1 = viz.text_box(text, org, scale)
        region[max(y0, 0) : max(y1, 0), max(x0, 0) : max(x1, 0)] = True
    return region


def _assert_close(got, ref, region):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got[~region], ref[~region])
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert int(diff[region].max(initial=0)) <= TEXT_TOL


def _id_labels(masks):
    labels = []
    for i, m in enumerate(masks, 1):
        ys, xs = np.nonzero(m)
        if ys.size:
            labels.append((str(i), (int(xs.mean()), int(ys.mean())), 0.5))
    return labels


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("draw_ids", [False, True])
def test_render_overlay_matches_jax(seed, draw_ids):
    rng = np.random.default_rng(seed)
    hw = (90, 130)
    image = (rng.random(hw + (3,)) * 255).astype(np.uint8)
    masks = _masks(rng, hw, 14)
    classes = rng.integers(0, 10, len(masks)).tolist()
    ref = jax_viz.render_overlay(image, masks, classes, draw_ids=draw_ids)
    got = viz.render_overlay(image, masks, classes, draw_ids=draw_ids)
    region = _text_region(hw, _id_labels(masks) if draw_ids else [])
    _assert_close(got, ref, region)
    if not draw_ids:
        np.testing.assert_array_equal(got, ref)


def test_render_overlay_of_a_gray_image_matches_jax():
    rng = np.random.default_rng(9)
    image = (rng.random((40, 50)) * 255).astype(np.uint8)
    masks = _masks(rng, (40, 50), 3)
    ref = jax_viz.render_overlay(image, masks, [0, 1, 2, 3], draw_ids=True)
    got = viz.render_overlay(image, masks, [0, 1, 2, 3], draw_ids=True)
    _assert_close(got, ref, _text_region((40, 50), _id_labels(masks)))


@pytest.mark.parametrize("debug", [
    {"roi": (60, 5, 158, 40), "line": (80, 30, 140, 30), "text": "2 um"},
    {"roi": (60, 5, 158, 40), "line": (80, 30, 140, 30), "text": "500 µm"},
    {"roi": (0, 0, 159, 99), "line": (150, 10, 150, 70), "text": "500 nm"},
    {"roi": (10, 10, 50, 30), "line": (2, 3, 40, 3), "text": ""},  # the label clamps to row 12
    {"roi": (-5, -5, 170, 120), "line": None, "text": ""},
    {"roi": None, "line": None, "text": ""},
])
def test_draw_scalebar_debug_matches_jax(debug):
    rng = np.random.default_rng(3)
    image = (rng.random((100, 160, 3)) * 255).astype(np.uint8)
    ref, got = image.copy(), image.copy()
    jax_viz.draw_scalebar_debug(ref, debug, "2")
    viz.draw_scalebar_debug(got, debug, "2")
    labels = []
    if debug["line"]:
        lx0, ly0 = debug["line"][:2]
        labels.append((f"scale: 2 ({debug['text']!r})", (lx0, max(ly0 - 6, 12)), 0.45))
    _assert_close(got, ref, _text_region(image.shape[:2], labels))


@pytest.mark.parametrize("names", [
    ["particle", "pore"], ["a"], [], [f"class {i} ~!{{}}" for i in range(10)], ["partícula", "µ-pore", "naïve Ø"],
])
def test_render_legend_matches_jax(names):
    ref = jax_viz.render_legend(names)
    got = viz.render_legend(names)
    labels = [(f"{i}: {n}", (48, i * 30 + 20), 0.55) for i, n in enumerate(names)]
    _assert_close(got, ref, _text_region(ref.shape[:2], labels))


def test_render_legend_outside_the_atlas():
    """A class name with characters the atlas lacks draws, and differs from
    OpenCV's legend only inside its label's box and OpenCV's text box."""
    names = ["pore", "孔 Ω", "grain"]
    ref = jax_viz.render_legend(names)
    got = viz.render_legend(names)
    labels = [(f"{i}: {n}", (48, i * 30 + 20), 0.55) for i, n in enumerate(names)]
    region = _text_region(ref.shape[:2], labels)
    (w, h), base = cv2.getTextSize(labels[1][0], cv2.FONT_HERSHEY_SIMPLEX, 0.55, 1)
    region[50 - h - 2 : 50 + base + 2, 46 : 48 + w + 2] = True
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[~region], ref[~region])


def test_text_outside_the_atlas_draws_a_mark_per_byte():
    img = np.zeros((30, 120, 3), np.uint8)
    for text, marks in (("2 中m", "2 ???m"), ("Ω\t", "???"), ("a\x7f", "a?")):
        got, ref = img.copy(), img.copy()
        viz.put_text(got, text, (5, 20), 0.5, (255, 255, 255))
        viz.put_text(ref, marks, (5, 20), 0.5, (255, 255, 255))
        np.testing.assert_array_equal(got, ref, err_msg=text)
        assert viz.text_box(text, (5, 20), 0.5) == viz.text_box(marks, (5, 20), 0.5)


def test_text_matches_cv2_on_random_strings():
    """Every printable ASCII and Latin-1 character ('µ' of a scale-bar
    reading among them), at the three scales, on random backgrounds, partly
    off the image."""
    rng = np.random.default_rng(5)
    chars = "".join(chr(c) for c in [*range(32, 127), *range(0xA0, 0x100)])
    for scale, color in ((0.45, (0, 0, 255)), (0.5, (255, 255, 255)), (0.55, (0, 0, 0))):
        for k in range(0, len(chars), 12):
            img = (rng.random((40, 180, 3)) * 255).astype(np.uint8)
            org = (int(rng.integers(-8, 20)), int(rng.integers(5, 38)))
            text = chars[k : k + 12]
            ref, got = img.copy(), img.copy()
            cv2.putText(ref, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, 1, cv2.LINE_AA)
            viz.put_text(got, text, org, scale, color)
            _assert_close(got, ref, _text_region(img.shape[:2], [(text, org, scale)]))


def test_add_weighted_matches_cv2_on_every_pair():
    a = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 256, axis=1)
    b = np.ascontiguousarray(a.T)
    a3, b3 = np.stack([a] * 3, -1), np.stack([b] * 3, -1)
    np.testing.assert_array_equal(viz.add_weighted(a3, 0.4, b3, 0.6), cv2.addWeighted(a3, 0.4, b3, 0.6, 0))


def test_save_png_round_trips(tmp_path):
    rng = np.random.default_rng(2)
    for shape in ((33, 47, 3), (20, 9), (1, 1, 3)):
        img = (rng.random(shape) * 255).astype(np.uint8)
        path = tmp_path / "sub" / "x.png"
        viz.save_png(path, img)
        ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(ref, img)
        bgr = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
        np.testing.assert_array_equal(read_image(str(path)), bgr)


def test_text_atlas_matches_a_fresh_render():
    spec = importlib.util.spec_from_file_location("make_torch_text_atlas", ROOT / "tools" / "make_torch_text_atlas.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.build()
    with np.load(viz.ATLAS_PATH) as z:
        committed = {k: z[k] for k in z.files}
    assert set(fresh) == set(committed)
    for k in fresh:
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)

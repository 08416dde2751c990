"""Port parity of ``ops/morphometrics.py``: every function against the JAX
package's on one [H,W] mask, on the CPU in float32. Counts, boundaries,
extents, the rectangle, the Feret diameter, the perimeter and the contrast
percentiles must be equal; the moments, axes and eccentricity within 1e-5
relative (sums taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepemia_tpu.ops import morphometrics as jax_mm
from deepemia_tpu_torch.ops import morphometrics as pt_mm

torch.set_num_threads(2)

MOMENT_RTOL = 1e-5


def _masks():
    """Named [H,W] masks: shapes with holes, two components, a one-pixel
    mask, an empty one, a diagonal band, shapes on every image border."""
    h, w = 40, 52
    yy, xx = np.mgrid[0:h, 0:w]
    out = {}
    out["ellipse"] = (yy - 20) ** 2 / 150 + (xx - 22) ** 2 / 60 <= 1
    m = np.zeros((h, w), bool)
    m[5:30, 8:40] = True
    m[12:20, 15:25] = False
    out["hole"] = m
    m = np.zeros((h, w), bool)
    m[3:6, 3:40] = True
    m[28:39, 30:45] = True
    out["two"] = m
    m = np.zeros((h, w), bool)
    m[10, 10] = True
    out["pixel"] = m
    out["empty"] = np.zeros((h, w), bool)
    out["band"] = np.abs(xx - yy) < 3
    out["border"] = (xx < 6) | (yy > h - 4) | ((xx > w - 3) & (yy < 20))
    out["full"] = np.ones((h, w), bool)
    out["random"] = np.random.default_rng(0).random((h, w)) < 0.4
    return out


MASKS = _masks()
GRAY = (np.random.default_rng(1).random((40, 52, 3)) * 255).astype(np.float32)


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


def test_scan_directions_are_the_jax_packages():
    theta = jnp.arange(90, dtype=jnp.float32) * (jnp.pi / 2 / 90)
    c, s = pt_mm.scan_directions(90)
    np.testing.assert_array_equal(c, np.asarray(jnp.cos(theta)))
    np.testing.assert_array_equal(s, np.asarray(jnp.sin(theta)))


@pytest.mark.parametrize("name", sorted(MASKS))
def test_boundary_and_shift_match_jax(name):
    m = MASKS[name]
    np.testing.assert_array_equal(_np(pt_mm._boundary_4(torch.from_numpy(m))), np.asarray(jax_mm._boundary_4(jnp.asarray(m))))
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1), (-2, 3), (0, -1)):
        np.testing.assert_array_equal(_np(pt_mm._shift(torch.from_numpy(m), dy, dx)),
                                      np.asarray(jax_mm._shift(jnp.asarray(m), dy, dx)))


@pytest.mark.parametrize("name", sorted(MASKS))
def test_exact_measurements_match_jax(name):
    m = MASKS[name]
    t, j = torch.from_numpy(m), jnp.asarray(m)
    assert _np(pt_mm.digital_perimeter(t)) == np.asarray(jax_mm.digital_perimeter(j))
    for got, ref in zip(pt_mm.support_extents(t), jax_mm.support_extents(j)):
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    for got, ref in zip(pt_mm.min_area_rect_dims(t), jax_mm.min_area_rect_dims(j)):
        assert _np(got) == np.asarray(ref)
    assert _np(pt_mm.feret_diameter(t)) == np.asarray(jax_mm.feret_diameter(j))
    gray = jnp.asarray(GRAY[..., 1])
    for got, ref in zip(pt_mm.contrast_percentiles(t, torch.from_numpy(GRAY[..., 1])),
                        jax_mm.contrast_percentiles(j, gray)):
        assert _np(got) == np.asarray(ref)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_moments_match_jax(name):
    m = MASKS[name]
    got = pt_mm.moments_ellipse(torch.from_numpy(m))
    ref = jax_mm.moments_ellipse(jnp.asarray(m))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=MOMENT_RTOL, atol=1e-6)


EXACT = ("area", "pixel_count", "perimeter", "rect_w", "rect_h", "contrast_d10", "contrast_d50", "contrast_d90",
         "valid")


@pytest.mark.parametrize("name", sorted(MASKS))
@pytest.mark.parametrize("contrast", [False, True])
def test_measure_mask_matches_jax(name, contrast):
    m = MASKS[name]
    gray = GRAY[..., 2] if contrast else None
    got = pt_mm.measure_mask(torch.from_numpy(m), None if gray is None else torch.from_numpy(gray))
    ref = jax_mm.measure_mask(jnp.asarray(m), None if gray is None else jnp.asarray(gray))
    assert set(got) == set(ref)
    for k in ref:
        g, r = _np(got[k]), np.asarray(ref[k])
        if k in EXACT:
            assert g == r, (k, g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=MOMENT_RTOL, atol=1e-6, err_msg=k)


def test_crops_at_absolute_coordinates_equal_the_whole_image():
    """A mask measured in a crop that holds it with a false margin (or
    meets the image edge) gives the whole image's exact values."""
    for name in ("ellipse", "hole", "pixel", "border", "band"):
        m = MASKS[name]
        ys, xs = np.nonzero(m)
        y0, x0 = max(ys.min() - 1, 0), max(xs.min() - 1, 0)
        y1, x1 = min(ys.max() + 2, m.shape[0]), min(xs.max() + 2, m.shape[1])
        crop = torch.from_numpy(np.ascontiguousarray(m[y0:y1, x0:x1]))[None]
        origin = torch.tensor([[x0, y0]])
        got = pt_mm.measure_batch(crop, origin, m.shape, torch.from_numpy(GRAY[y0:y1, x0:x1, 0])[None])
        ref = pt_mm.measure_mask(torch.from_numpy(m), torch.from_numpy(GRAY[..., 0]))
        for k in ref:
            if k in EXACT:
                assert _np(got[k][0]) == _np(ref[k]), (name, k)
            else:
                np.testing.assert_allclose(_np(got[k][0]), _np(ref[k]), rtol=MOMENT_RTOL, atol=1e-6)

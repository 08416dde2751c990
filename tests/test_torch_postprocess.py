"""Port parity of the postprocess stage: the mask helpers (boxes, areas,
containment, erosion / dilation, hole filling, connected components), the
morphology postprocess, the fragment filter, the spatial constraints and
the compaction helpers, against the JAX package on the CPU in float32.
Masks and validity: equality; probabilities 1e-5 (f32 sums)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepemia_tpu.inference import constraints as jax_con
from deepemia_tpu.inference import detections as jax_det
from deepemia_tpu.inference import postprocess as jax_pp
from deepemia_tpu.ops import masks as jax_masks
from deepemia_tpu_torch.inference import constraints as pt_con
from deepemia_tpu_torch.inference import detections as pt_det
from deepemia_tpu_torch.inference import postprocess as pt_pp
from deepemia_tpu_torch.ops import masks as pt_masks
from tests.test_torch_engine import _assert_sets_match, _instances, _jax_set, _pt_set

torch.set_num_threads(2)


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    m = rng.random((6, 40, 37)) > 0.55
    m[0] = False
    m[1, 5:30, 5:30] = True
    m[1, 10:20, 10:20] = False  # a hole
    m[2] = False
    m[2, 2:12, 3:9] = True
    m[2, 20:35, 20:30] = True  # two components
    return m


@pytest.mark.parametrize("fn", ["mask_bboxes", "mask_areas"])
def test_box_and_area_match_jax(fn):
    m = _blobs()
    got = getattr(pt_masks, fn)(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jax_masks, fn)(jnp.asarray(m))))


def test_containment_matches_jax():
    m = _blobs()
    for stride in (1, 4):
        np.testing.assert_allclose(
            pt_masks.mask_containment_matrix(torch.from_numpy(m), torch.from_numpy(m[:3]), stride).numpy(),
            np.asarray(jax_masks.mask_containment_matrix(jnp.asarray(m), jnp.asarray(m[:3]), stride)),
            atol=1e-6,
        )


@pytest.mark.parametrize("radius", [1, 2])
def test_erode_dilate_match_jax(radius):
    m = _blobs()
    for fn in ("binary_dilate", "binary_erode"):
        got = getattr(pt_masks, fn)(torch.from_numpy(m), radius).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jax_masks, fn)(jnp.asarray(m), radius)))


def test_fill_holes_and_components_match_jax():
    m = _blobs()
    filled = pt_masks.fill_holes(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(filled, np.asarray(jax.vmap(jax_masks.fill_holes)(jnp.asarray(m))))
    assert filled[1, 10:20, 10:20].all()
    counts = pt_masks.num_components(torch.from_numpy(m)).numpy()
    assert counts[0] == 0 and counts[2] == 2
    for i, x in enumerate(m):
        jx = jnp.asarray(x)
        np.testing.assert_array_equal(
            pt_masks.connected_components(torch.from_numpy(x)).numpy(), np.asarray(jax_masks.connected_components(jx))
        )
        assert counts[i] == int(jax_masks.num_components(jx))
        np.testing.assert_array_equal(
            pt_masks.largest_component(torch.from_numpy(x)).numpy(), np.asarray(jax_masks.largest_component(jx))
        )


def test_compaction_helpers_match_jax():
    arrs = _instances(3, k=40)
    ref = jax_det.compact_instances(_jax_set(arrs))
    got = pt_det.compact_instances(_pt_set(arrs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    n = int(arrs[3].sum())
    assert got.valid[:n].all() and not got.valid[n:].any()
    for count, cap in ((0, 64), (5, 64), (9, 64), (33, 40), (100, 64)):
        assert pt_det.bucket_size(count, cap) == jax_det.bucket_size(count, cap)
    b = pt_det.bucket_size(n, 40)
    for g, r in zip(pt_det.slice_instances(got, b), jax_det.slice_instances(ref, b)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize(
    "small, min_small, min_large, window",
    [(None, None, None, 128), ({1}, None, None, 128), ({0}, 40.0, 300.0, 32)],
)
def test_morphology_postprocess_matches_jax(small, min_small, min_large, window):
    """Boxes of 4-60 px in a 160² image: native windows and, at window 32,
    shrink-to-fit ones; classes small and large; default and given size
    gates."""
    boxes, scores, classes, valid, probs = _instances(5, k=24, extent=100)
    probs = np.clip(probs * 1.6 - 0.2, 0, 1).astype(np.float32)
    arrs = (boxes, scores, classes, valid, probs)
    kw = dict(small_classes=small, min_size_small=min_small, min_size_large=min_large, window=window)
    ref = jax_pp.morphology_postprocess(_jax_set(arrs), (160, 160), **kw)
    got = pt_pp.morphology_postprocess(_pt_set(arrs), (160, 160), **kw)
    assert got.mask_probs.shape == (24, 56, 56)
    assert 0 < int(got.valid.sum()) < int(valid.sum())
    _assert_sets_match(got, ref)
    np.testing.assert_allclose(got.mask_probs.numpy(), np.asarray(ref.mask_probs), atol=1e-5)


def test_reject_fragmented_masks_matches_jax():
    boxes, scores, classes, valid, probs = _instances(6, k=16, extent=50)
    yy, xx = np.mgrid[0:28, 0:28]
    probs[::2] = np.exp(-((yy - 13.5) ** 2 + (xx - 13.5) ** 2) / 60.0)  # one blob each
    arrs = (boxes, scores, classes, valid, probs)
    ref = jax_pp.reject_fragmented_masks(_jax_set(arrs), (72, 64))
    got = pt_pp.reject_fragmented_masks(_pt_set(arrs), (72, 64), chunk=5)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0 < int(got.valid.sum()) < int(arrs[3].sum())


CONSTRAINTS = {
    "enabled": True,
    "containment_threshold": 0.6,
    "overlap_rules": {"class_0": {"allow_overlap": False, "max_iou_threshold": 0.2}, 1: {"max_iou_threshold": 0.95}},
    "containment_rules": {"class_1": "class_0"},
}


def test_spec_from_config_matches_jax():
    for cfg in (None, {"enabled": False}, CONSTRAINTS):
        ref = jax_con.spec_from_config(cfg, 3)
        got = pt_con.spec_from_config(cfg, 3)
        assert got.enabled == ref.enabled and got.containment_threshold == ref.containment_threshold
        np.testing.assert_array_equal(got.overlap_max_iou, ref.overlap_max_iou)
        np.testing.assert_array_equal(got.containment_parent, ref.containment_parent)


@pytest.mark.parametrize("cfg", [CONSTRAINTS, {"enabled": False}])
def test_spatial_constraints_match_jax(cfg):
    arrs = _instances(7, k=48, extent=90)
    ref = jax_con.apply_spatial_constraints(_jax_set(arrs), (128, 128), jax_con.spec_from_config(cfg, 2))
    got = pt_con.apply_spatial_constraints(_pt_set(arrs), (128, 128), pt_con.spec_from_config(cfg, 2))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    dropped = int(arrs[3].sum()) - int(got.valid.sum())
    assert (dropped > 0) == cfg["enabled"]

"""Port parity: mask ops, detection sets, the engine's merge steps, and the
whole tiled serving path against the JAX package (f32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepemia_tpu.inference import detections as jax_det
from deepemia_tpu.inference import engine as jax_engine
from deepemia_tpu.ops import masks as jax_masks
from deepemia_tpu_torch.inference import detections as pt_det
from deepemia_tpu_torch.inference import engine as pt_engine
from deepemia_tpu_torch.ops import masks as pt_masks
from tests.test_torch_heads import port_model, sane_geometry

torch.set_num_threads(2)


def _instances(seed, k=48, extent=120.0, res=28):
    rng = np.random.default_rng(seed)
    xy = rng.random((k, 2)) * extent
    boxes = np.concatenate([xy, xy + 4 + rng.random((k, 2)) * 40], 1).astype(np.float32)
    probs = rng.random((k, res, res)).astype(np.float32)
    probs[: k // 2] = np.repeat(probs[:1], k // 2, axis=0)  # shared shapes -> overlaps
    boxes[1:6] = boxes[0] + rng.random((5, 4)).astype(np.float32) * 3  # near-duplicates
    scores = np.round(rng.random(k), 2).astype(np.float32)  # some ties
    classes = rng.integers(0, 2, k).astype(np.int32)
    valid = rng.random(k) > 0.15
    return boxes, scores, classes, valid, probs


def _jax_set(arrs):
    return jax_det.InstanceSet(*(jnp.asarray(a) for a in arrs))


def _pt_set(arrs):
    return pt_det.InstanceSet(*(torch.from_numpy(np.asarray(a)) for a in arrs))


def _assert_sets_match(got, ref, box_atol=1e-5):
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.classes.numpy()[v], np.asarray(ref.classes)[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(ref.boxes)[v], atol=box_atol)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(ref.scores)[v], atol=1e-5)
    np.testing.assert_allclose(
        got.mask_probs.numpy()[v], np.asarray(ref.mask_probs)[v], atol=1e-4
    )


def test_mask_ops_match_jax():
    boxes, _, _, _, probs = _instances(0)
    boxes[7] = [-10.0, 50.0, 20.0, 50.00001]  # off-image, sub-pixel tall
    for h, w, thr in ((64, 80, 0.5), (30, 30, 0.3)):
        ref = jax_masks.paste_masks(jnp.asarray(probs), jnp.asarray(boxes) / 2, h, w, thr)
        got = pt_masks.paste_masks(torch.from_numpy(probs), torch.from_numpy(boxes) / 2, h, w, thr)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    masks = np.random.default_rng(1).random((12, 33, 41)) > 0.6
    for stride in (1, 4):
        np.testing.assert_array_equal(
            pt_masks.downsample_masks(torch.from_numpy(masks), stride).numpy(),
            np.asarray(jax_masks.downsample_masks(jnp.asarray(masks), stride)),
        )
        np.testing.assert_allclose(
            pt_masks.mask_iou_matrix(torch.from_numpy(masks), torch.from_numpy(masks[:5]), stride).numpy(),
            np.asarray(jax_masks.mask_iou_matrix(jnp.asarray(masks), jnp.asarray(masks[:5]), stride)),
            atol=1e-6,
        )
    np.testing.assert_array_equal(
        pt_masks.is_edge_mask(torch.from_numpy(boxes), 64, 0.1).numpy(),
        np.asarray(jax_masks.is_edge_mask(jnp.asarray(boxes), 64, 0.1)),
    )


def test_concat_and_thresholds_match_jax():
    a, b = _instances(2, k=40), _instances(3, k=30)
    ref = jax_det.concat_instances([_jax_set(a), _jax_set(b)], 64)
    got = pt_det.concat_instances([_pt_set(a), _pt_set(b)], 64)
    assert got.capacity == 64
    _assert_sets_match(got, ref)
    ref_small = jax_det.concat_instances([_jax_set(a), _jax_set(b)], 25)
    got_small = pt_det.concat_instances([_pt_set(a), _pt_set(b)], 25)
    _assert_sets_match(got_small, ref_small)

    cfg = {"class_specific_settings": {"class_1": {"confidence_threshold": 0.6, "min_size": 300}}}
    js = jax_engine.class_settings_from_config(cfg, 2, small_classes=[0])
    ps = pt_engine.class_settings_from_config(cfg, 2, small_classes=[0])
    for f_p, f_j in zip(ps, js):
        np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_j))
    for q in (0.85, 1.0):
        r = jax_engine.apply_class_thresholds(ref, js, jnp.float32(q))
        g = pt_engine.apply_class_thresholds(got, ps, torch.tensor(q))
        _assert_sets_match(g, r)


@pytest.mark.parametrize("class_aware", [True, False])
def test_dedup_by_mask_iou_matches_jax(class_aware):
    arrs = _instances(4, k=64)
    ref = jax_det.dedup_by_mask_iou(_jax_set(arrs), (128, 160), 0.4, stride=4, class_aware=class_aware)
    got = pt_det.dedup_by_mask_iou(_pt_set(arrs), (128, 160), 0.4, stride=4, class_aware=class_aware)
    assert 0 < got.valid.sum() < arrs[3].sum()
    _assert_sets_match(got, ref)


class _EngineStub:
    """The attributes ``_finish_batch`` reads."""

    def __init__(self, tiling_classes=None):
        self.edge_filter = True
        self.overlap_ratio = 0.1
        self.tiling_classes = tiling_classes


@pytest.mark.parametrize("tiling_classes", [None, (1,)])
def test_finish_batch_matches_jax(tiling_classes):
    sets = [_instances(10 + i, k=20, extent=120) for i in range(3)]
    stacked = [np.stack([s[f] for s in sets]) for f in range(5)]
    offs = np.array([[0, 0], [115, 0], [115, 115]], np.float32)
    ok = np.array([True, True, False])
    stub = _EngineStub(tiling_classes)
    ref = jax_engine.TileEngine._finish_batch(
        stub, _jax_set(stacked), jnp.asarray(offs), jnp.asarray(ok), 64, 2.0, 200, 200
    )
    got = pt_engine.TileEngine._finish_batch(
        stub, _pt_set(stacked), torch.from_numpy(offs), torch.from_numpy(ok), 64, 2.0, 200, 200
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), atol=1e-5)
    assert 0 < got.valid.sum() < ok.sum() * 20


def test_tile_engine_matches_jax(tiny_r50):
    """The whole slice: 128² image, 64 px tiles upscaled x2 (9 tiles) plus
    the native whole-image pass, merged, thresholded and deduplicated."""
    model, params = tiny_r50
    params = sane_geometry(params)
    rng = np.random.default_rng(5)
    img = (rng.random((128, 128, 3)) * 255).astype(np.uint8)
    kw = dict(tile_size=64, tile_batch=4, confidence_mode="auto")
    settings_cfg = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}}}
    ref_eng = jax_engine.TileEngine(model, params, **kw)
    ref, ref_q = ref_eng.infer(img, jax_engine.class_settings_from_config(settings_cfg, 2))
    eng = pt_engine.TileEngine(port_model(params), device="cpu", **kw)
    got, q = eng.infer(img, pt_engine.class_settings_from_config(settings_cfg, 2))
    np.testing.assert_allclose(float(q), float(ref_q), rtol=1e-5)
    assert got.capacity == ref.capacity
    assert int(np.asarray(ref.valid).sum()) > 0
    _assert_sets_match(got, ref, box_atol=1e-3)

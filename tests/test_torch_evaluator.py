"""Port parity: the numpy COCO evaluator (``deepemia_tpu_torch/train/
evaluator.py``) against the JAX package's on random detections, with and
without masks, empty images and classes without GT: every metric equal
(NaN where the JAX one is NaN)."""

import math

import numpy as np
import pytest

import deepemia_tpu.train.evaluator as jax_ev
import deepemia_tpu_torch.train.evaluator as port_ev


def _boxes(rng, n, size):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _masks(boxes, size):
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((len(boxes), size, size), bool)
    for m, b in zip(out, boxes):
        m[:] = (xx >= b[0]) & (xx < b[2]) & (yy >= b[1]) & (yy < b[3])
    return out


def random_images(seed, n_images=4, num_classes=3, size=160, with_masks=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        g = int(rng.integers(0, 8)) if i else 0  # the first image has no GT
        gt = _boxes(rng, g, size)
        # detections: jittered GT (some with another class) plus clutter
        jit = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
        pred = np.concatenate([jit, _boxes(rng, int(rng.integers(0, 6)), size)]).astype(np.float32)
        d = {
            "pred_boxes": pred,
            "pred_scores": np.round(rng.random(len(pred)), 2).astype(np.float32),  # ties included
            "pred_classes": rng.integers(0, num_classes, len(pred)).astype(np.int32),
            "gt_boxes": gt,
            "gt_classes": rng.integers(0, num_classes - 1, g).astype(np.int32),  # the last class has no GT
        }
        if with_masks:
            d["pred_masks"] = _masks(pred, size)
            d["gt_masks"] = _masks(gt, size)
        out.append(d)
    return out


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert (math.isnan(v) and math.isnan(got[k])) or got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_masks", [True, False])
def test_evaluate_predictions_matches_jax(seed, with_masks):
    images = random_images(seed, with_masks=with_masks)
    want = jax_ev.evaluate_predictions(images, 3)
    got = port_ev.evaluate_predictions(images, 3)
    _assert_metrics_equal(got, want)
    assert ("segm/AP" in got) == with_masks and np.isfinite(got["bbox/AP"])


def test_accumulator_without_areas_matches_jax():
    rng = np.random.default_rng(7)
    accs = [port_ev.APAccumulator(2), jax_ev.APAccumulator(2)]
    for _ in range(5):
        iou = rng.random((6, 4)).astype(np.float32)
        args = (rng.integers(0, 2, 6), rng.random(6), iou, rng.integers(0, 2, 4))
        for acc in accs:
            acc.add_image(*args)
    _assert_metrics_equal(accs[0].summarize(), accs[1].summarize())
    a, b = _boxes(rng, 5, 50), _boxes(rng, 3, 50)
    np.testing.assert_array_equal(port_ev.box_iou_np(a, b), jax_ev.box_iou_np(a, b))
    ma, mb = _masks(a, 50), _masks(b, 50)
    np.testing.assert_array_equal(port_ev.mask_iou_np(ma, mb), jax_ev.mask_iou_np(ma, mb))

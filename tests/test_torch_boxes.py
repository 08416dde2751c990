"""Port parity: box geometry, greedy NMS and anchors against the JAX package
(same numpy inputs through both; float32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepemia_tpu.models import anchors as jax_anchors
from deepemia_tpu.ops import boxes as jax_boxes
from deepemia_tpu_torch.models import anchors as pt_anchors
from deepemia_tpu_torch.ops import boxes as pt_boxes

torch.set_num_threads(2)


def _random_boxes(rng, n, extent=100.0, max_wh=40.0):
    xy = rng.random((n, 2)) * extent
    wh = rng.random((n, 2)) * max_wh
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_iou_deltas_clip_match_jax():
    rng = np.random.default_rng(0)
    a = _random_boxes(rng, 37)
    b = _random_boxes(rng, 23)
    b[3] = b[3, [0, 1, 0, 1]]  # degenerate (zero-area) box
    np.testing.assert_allclose(
        pt_boxes.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.box_iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5,
    )
    deltas = (rng.standard_normal((37, 4)) * 2.0).astype(np.float32)
    deltas[0, 2:] = 50.0  # beyond the log(1000/16) clamp
    for w in ((10.0, 10.0, 5.0, 5.0), (1.0, 1.0, 1.0, 1.0)):
        got = pt_boxes.apply_deltas(torch.from_numpy(a), torch.from_numpy(deltas), weights=w)
        ref = jax_boxes.apply_deltas(jnp.asarray(a), jnp.asarray(deltas), weights=w)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)
    wide = (rng.random((37, 4)) * 300 - 100).astype(np.float32)
    np.testing.assert_allclose(
        pt_boxes.clip_boxes(torch.from_numpy(wide), 90, 120).numpy(),
        np.asarray(jax_boxes.clip_boxes(jnp.asarray(wide), 90, 120)),
        atol=1e-5,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["scalar", "per_row", "invalid", "precomputed", "ties"])
def test_nms_mask_equals_jax(seed, case):
    rng = np.random.default_rng(seed)
    n = 300
    boxes = _random_boxes(rng, n, extent=120.0)
    scores = rng.random(n).astype(np.float32)
    valid = np.ones(n, bool)
    thr = 0.5
    iou = None
    if case == "per_row":
        thr = rng.uniform(0.2, 0.8, n).astype(np.float32)
    if case == "invalid":
        valid = rng.random(n) > 0.3
    if case == "ties":
        scores = np.round(scores * 5) / 5  # many equal scores
    if case == "precomputed":
        iou = (rng.random((n, n)) ** 4).astype(np.float32)
        iou = np.maximum(iou, iou.T)
    kw = dict(valid=valid, block_size=64)
    ref = jax_boxes.nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(thr),
        valid=jnp.asarray(valid), iou=None if iou is None else jnp.asarray(iou),
        block_size=64,
    )
    got = pt_boxes.nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.as_tensor(thr),
        valid=torch.from_numpy(valid),
        iou=None if iou is None else torch.from_numpy(iou),
        block_size=kw["block_size"],
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.numpy()[~valid].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_mask_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 200
    boxes = _random_boxes(rng, n, extent=80.0)
    scores = rng.random(n).astype(np.float32)
    classes = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    ref = jax_boxes.batched_nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.5,
        valid=jnp.asarray(valid),
    )
    got = pt_boxes.batched_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
        0.5, valid=torch.from_numpy(valid),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_nms_mask_batched_equals_per_set():
    """The batched form keeps exactly what one call per set keeps."""
    rng = np.random.default_rng(3)
    boxes = np.stack([_random_boxes(rng, 150) for _ in range(4)])
    scores = rng.random((4, 150)).astype(np.float32)
    valid = rng.random((4, 150)) > 0.1
    got = pt_boxes.nms_mask_batched(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.6,
        valid=torch.from_numpy(valid), block_size=32,
    )
    for i in range(4):
        ref = jax_boxes.nms_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.6,
            valid=jnp.asarray(valid[i]), block_size=32,
        )
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))


def test_box_transform_golden_weights_10_10_5_5():
    """The Box2BoxTransform golden of tests/test_kernels.py, on the port:
    decoding (2, 4, 0, 5·ln 1.4) onto [0,0,10,10] gives [2,2,12,16], and
    the width delta clamps at log(1000/16)."""
    src = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    golden = torch.tensor([[2.0, 4.0, 0.0, 5.0 * np.log(1.4)]], dtype=torch.float32)
    back = pt_boxes.apply_deltas(src, golden)
    np.testing.assert_allclose(back.numpy(), [[2.0, 2.0, 12.0, 16.0]], atol=1e-4)
    w = pt_boxes.apply_deltas(src, torch.tensor([[0.0, 0.0, 100.0, 0.0]]))[0]
    np.testing.assert_allclose(float(w[2] - w[0]), 10.0 * 1000.0 / 16.0, rtol=1e-5)


def test_nms_tiebreak_golden_torchvision():
    """The torchvision tie-break golden of tests/test_kernels.py: equal
    scores keep the lower index, IoU exactly at the threshold keeps both,
    padded rows are never kept."""
    boxes = torch.tensor(
        [
            [0.0, 0.0, 10.0, 10.0],
            [1.0, 1.0, 11.0, 11.0],
            [0.5, 0.5, 10.5, 10.5],
            [20.0, 20.0, 30.0, 30.0],
            [0.0, 0.0, 0.0, 0.0],
        ]
    )
    scores = torch.tensor([0.9, 0.9, 0.85, 0.8, 0.99])
    valid = torch.tensor([True, True, True, True, False])
    keep = pt_boxes.nms_mask(boxes, scores, 0.5, valid=valid)
    np.testing.assert_array_equal(keep.numpy(), [True, False, False, True, False])
    two = torch.tensor([[0.0, 0.0, 10.0, 10.0], [0.0, 5.0, 10.0, 15.0]])
    keep2 = pt_boxes.nms_mask(two, torch.tensor([0.9, 0.8]), 1.0 / 3.0)
    np.testing.assert_array_equal(keep2.numpy(), [True, True])


def test_anchors_equal_jax():
    shapes = {"p2": (16, 12), "p3": (8, 6), "p4": (4, 3), "p5": (2, 2), "p6": (1, 1)}
    ref = jax_anchors.all_anchors(shapes)
    got = pt_anchors.all_anchors(shapes, device="cpu")
    assert list(got) == list(ref)
    for lv in shapes:
        np.testing.assert_array_equal(got[lv].numpy(), np.asarray(ref[lv]))
    assert pt_anchors.STRIDES == jax_anchors.STRIDES
    assert pt_anchors.LEVELS == jax_anchors.LEVELS

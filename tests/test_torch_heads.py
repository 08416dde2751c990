"""Port parity: proposal selection, Fast R-CNN inference and the whole
``MaskRCNN`` forward against the JAX package (f32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepemia_tpu.models import anchors as jax_anchors
from deepemia_tpu.models.heads import fast_rcnn_inference as jax_frcnn
from deepemia_tpu.models.rpn import select_proposals as jax_select
from deepemia_tpu_torch.models import anchors as pt_anchors
from deepemia_tpu_torch.models.heads import fast_rcnn_inference as pt_frcnn
from deepemia_tpu_torch.models.mask_rcnn import build_model
from deepemia_tpu_torch.models.rpn import select_proposals as pt_select
from deepemia_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_proposals_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shapes = {"p2": (32, 32), "p3": (16, 16), "p4": (8, 8), "p5": (4, 4), "p6": (2, 2)}
    logits = {k: rng.standard_normal((h, w, 3)).astype(np.float32) for k, (h, w) in shapes.items()}
    regs = {k: (rng.standard_normal((h, w, 12)) * 0.3).astype(np.float32) for k, (h, w) in shapes.items()}
    kw = dict(pre_nms_topk=300, post_nms_topk=800, min_size=2.0)
    ref = jax_select(
        {k: jnp.asarray(v) for k, v in logits.items()},
        {k: jnp.asarray(v) for k, v in regs.items()},
        jax_anchors.all_anchors(shapes), (128, 128), **kw,
    )
    got = pt_select(
        {k: torch.from_numpy(v) for k, v in logits.items()},
        {k: torch.from_numpy(v) for k, v in regs.items()},
        pt_anchors.all_anchors(shapes, "cpu"), (128, 128), **kw,
    )
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert 50 < v.sum() < 800
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(ref.boxes)[v], atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(ref.scores)[v], atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_rcnn_inference_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, c = 200, 3
    xy = rng.random((n, 2)) * 100
    proposals = np.concatenate([xy, xy + 5 + rng.random((n, 2)) * 30], 1).astype(np.float32)
    scores = (rng.standard_normal((n, c + 1)) * 2).astype(np.float32)
    deltas = (rng.standard_normal((n, 4 * c)) * 0.5).astype(np.float32)
    pvalid = rng.random(n) > 0.2
    args = (scores, deltas, proposals, pvalid)
    ref = jax_frcnn(*(jnp.asarray(a) for a in args), (120, 128), 0.05, 0.5, 50)
    got = pt_frcnn(*(torch.from_numpy(a) for a in args), (120, 128), 0.05, 0.5, 50)
    v = np.asarray(ref[3])
    np.testing.assert_array_equal(got[3].numpy(), v)
    assert v.sum() == 50
    np.testing.assert_allclose(got[0].numpy()[v], np.asarray(ref[0])[v], atol=1e-4)
    np.testing.assert_allclose(got[1].numpy()[v], np.asarray(ref[1])[v], atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy()[v], np.asarray(ref[2])[v])


def sane_geometry(params):
    """Random-weight models decode degenerate boxes: zero the box-head
    regression, so detections keep their proposals' geometry, and shrink
    the RPN deltas (|d| ~ 4e2 at random weights, where a 2e-6 relative
    difference in the trunk's sums moves a corner by ~1e-2 px) to ~4, and
    the mask logits from |l| ~ 3e1 to ~3 for the same reason."""
    p = jax.tree_util.tree_map(np.array, jax.device_get(params))
    bp = p["params"]["roi_heads"]["box_predictor"]["bbox_pred"]
    bp["kernel"] = np.zeros_like(bp["kernel"])
    bp["bias"] = np.zeros_like(bp["bias"])
    p["params"]["rpn_head"]["anchor_deltas"]["kernel"] *= 1e-2
    p["params"]["roi_heads"]["mask_head"]["predictor"]["kernel"] *= 1e-1
    return p


def port_model(params):
    model = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    model.load_state_dict(params_from_jax(params, 50), strict=True)
    return model


def assert_detections_match(got, ref):
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.classes.numpy()[v], np.asarray(ref.classes)[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(ref.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(ref.scores)[v], atol=1e-5)
    np.testing.assert_allclose(
        got.mask_probs.numpy()[v], np.asarray(ref.mask_probs)[v], atol=1e-4
    )


def test_mask_rcnn_call_matches_jax(tiny_r50):
    model, params = tiny_r50
    params = sane_geometry(params)
    rng = np.random.default_rng(7)
    img = (rng.random((128, 128, 3)) * 255).astype(np.float32)
    ref = model.apply(params, jnp.asarray(img), score_threshold=0.05)
    with torch.no_grad():
        got = port_model(params)(torch.from_numpy(img), score_threshold=0.05)
    assert int(np.asarray(ref.valid).sum()) > 0
    assert_detections_match(got, ref)

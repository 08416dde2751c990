"""Port parity: the weight bridge, the trunk + FPN, and the image ops,
against the JAX package on the same weights and inputs (f32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepemia_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from deepemia_tpu.models.weights import export_detectron2_state_dict
from deepemia_tpu.ops import image as jax_image
from deepemia_tpu_torch.models.mask_rcnn import build_model
from deepemia_tpu_torch.models.weights import params_from_jax
from deepemia_tpu_torch.ops import image as pt_image

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_r50(tiny_r50):
    _, params = tiny_r50
    model = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), 50), strict=True)
    return model


def test_weight_bridge_matches_export(tiny_r50):
    _, params = tiny_r50
    ref = export_detectron2_state_dict(jax.device_get(params), 50)
    got = params_from_jax(jax.device_get(params), 50)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    assert set(model.state_dict()) == set(ref)
    model.load_state_dict(got, strict=True)


def test_features_match_jax(tiny_r50, port_r50):
    model, params = tiny_r50
    rng = np.random.default_rng(3)
    img = (rng.random((64, 64, 3)) * 255).astype(np.float32)
    ref = model.apply(params, jnp.asarray(img), method=JaxMaskRCNN.features)
    with torch.no_grad():
        got = port_r50.features(torch.from_numpy(img))
    assert list(got) == ["p2", "p3", "p4", "p5", "p6"]
    for lv in got:
        r = np.asarray(ref[lv])
        assert got[lv].shape == r.shape, lv
        # 1e-4 relative to the level's scale: with random weights the maps
        # reach |x| ~ 1e2, and ~60 conv layers sum in another order
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(
            got[lv].numpy(), r, rtol=1e-4, atol=1e-4 * scale, err_msg=lv
        )


@pytest.mark.parametrize("src, dst", [((48, 40), (96, 80)), ((96, 80), (40, 56)), ((64, 64), (64, 64))])
def test_resize_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src + dst))
    img = (rng.random((*src, 3)) * 255).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), (*dst, 3), "linear")
    got = pt_image.resize_image(torch.from_numpy(img), *dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    batch = pt_image.resize_image(torch.from_numpy(np.stack([img, img[::-1].copy()])), *dst)
    np.testing.assert_allclose(batch[0].numpy(), got.numpy(), atol=1e-5)


def test_normalize_and_quality_match_jax():
    rng = np.random.default_rng(4)
    for scale in (255, 60, 20):  # bright, dim (0.85 scale), dark (0.7 scale)
        img = (rng.random((40, 56, 3)) * scale).astype(np.uint8)
        q_ref = float(jax_image.image_quality_score(jnp.asarray(img)))
        q = pt_image.image_quality_score(torch.from_numpy(img))
        np.testing.assert_allclose(float(q), q_ref, rtol=1e-5)
        np.testing.assert_allclose(
            float(pt_image.adaptive_threshold_scale(q)),
            float(jax_image.adaptive_threshold_scale(jnp.float32(q_ref))),
        )
        np.testing.assert_allclose(
            pt_image.normalize_bgr(torch.from_numpy(img)).numpy(),
            np.asarray(jax_image.normalize_bgr(jnp.asarray(img))),
            atol=1e-5,
        )

"""Port parity of the R101-FPN network, the ensemble's first member: the
weight bridge and the trunk + FPN features against the JAX package on the
same weights and a 64² input, f32 on the CPU, and the R101 checkpoint's
depth read back by the port's loader."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepemia_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from deepemia_tpu.models.mask_rcnn import build_model as jax_build_model
from deepemia_tpu.models.mask_rcnn import init_params
from deepemia_tpu.models.weights import export_detectron2_state_dict
from deepemia_tpu_torch.data.models import load_model
from deepemia_tpu_torch.models.mask_rcnn import build_model
from deepemia_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_r101():
    model = jax_build_model("R101", num_classes=2, use_bf16=False)
    return model, jax.device_get(init_params(model, (64, 64), seed=3))


def test_r101_weight_bridge_and_features_match_jax(jax_r101):
    model, params = jax_r101
    sd = params_from_jax(params, 101)
    ref_sd = export_detectron2_state_dict(params, 101)
    assert set(sd) == set(ref_sd)
    port = build_model("R101", num_classes=2, use_bf16=False, device="cpu")
    assert len([k for k in port.state_dict() if k.startswith("backbone.bottom_up.res4.")]) > 23 * 9
    port.load_state_dict(sd, strict=True)
    img = (np.random.default_rng(3).random((64, 64, 3)) * 255).astype(np.float32)
    ref = model.apply(params, jnp.asarray(img), method=JaxMaskRCNN.features)
    with torch.no_grad():
        got = port.features(torch.from_numpy(img))
    assert list(got) == ["p2", "p3", "p4", "p5", "p6"]
    for lv in got:
        r = np.asarray(ref[lv])
        assert got[lv].shape == r.shape, lv
        # as tests/test_torch_trunk.py, relative to the level's scale: ~110
        # conv layers sum in another order
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(got[lv].numpy(), r, rtol=1e-4, atol=1e-4 * scale, err_msg=lv)


def test_r101_checkpoint_loads_as_r101(jax_r101, tmp_path):
    _, params = jax_r101
    path = tmp_path / "model_final_r101.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": export_detectron2_state_dict(params, 101), "__author__": "Detectron2 Model Zoo"}, f)
    model = load_model(str(path), num_classes=2, use_bf16=False, device="cpu")
    assert len(model.backbone.bottom_up.res4) == 23

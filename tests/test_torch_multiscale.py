"""Port parity of the multiscale merge, the iterative threshold walk, the
size heuristics, the default configuration and the checkpoint loaders,
against the JAX package on the CPU in float32. Detections as in
tests/test_torch_engine.py (boxes 1e-3 px, probabilities 1e-4); average
mask areas 1e-4 relative."""

import json
import pickle

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepemia_tpu.config.config import default_config as jax_default_config
from deepemia_tpu.inference import engine as jax_engine
from deepemia_tpu.inference import multiscale as jax_ms
from deepemia_tpu.models.weights import export_detectron2_state_dict
from deepemia_tpu_torch.config.config import deep_merge, default_config
from deepemia_tpu_torch.data.datasets import dataset_class_names, read_dataset_info
from deepemia_tpu_torch.data.models import get_trained_model_paths, load_model
from deepemia_tpu_torch.inference import engine as pt_engine
from deepemia_tpu_torch.inference import multiscale as pt_ms
from tests.test_torch_engine import _assert_sets_match, _instances, _jax_set, _pt_set
from tests.test_torch_heads import port_model, sane_geometry
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(4)


def test_default_config_matches_jax(tmp_home):
    assert default_config() == jax_default_config()
    assert default_config(tmp_home / "x") == jax_default_config(tmp_home / "x")
    base = default_config()
    merged = deep_merge(base, {"inference_settings": {"tile_settings": {"tile_size": 256}}, "new": [1]})
    assert merged["inference_settings"]["tile_settings"] == {**base["inference_settings"]["tile_settings"], "tile_size": 256}
    assert base["inference_settings"]["tile_settings"]["tile_size"] == 512 and merged["new"] == [1]


@pytest.fixture(scope="module")
def engines(tiny_r50):
    model, params = tiny_r50
    params = sane_geometry(params)
    kw = dict(use_tiling=False, confidence_mode="auto")
    return jax_engine.TileEngine(model, params, **kw), pt_engine.TileEngine(port_model(params), device="cpu", **kw)


def _image(seed=5, size=128):
    rng = np.random.default_rng(seed)
    img = (rng.random((size, size, 3)) * 120 + 60).astype(np.uint8)
    cv2.circle(img, (40, 50), 18, (230, 230, 230), -1)
    cv2.circle(img, (96, 90), 9, (20, 20, 20), -1)
    return img


def test_multiscale_matches_jax(engines):
    """Scales 0.7 and 1.5 of a 128² image (64² and 192² after the /64
    rounding), boxes mapped back and merged by the class-aware mask IoU."""
    jax_eng, pt_eng = engines
    img = _image()
    cfg = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}}}
    ref, ref_q = jax_ms.run_multiscale_inference(
        jax_eng, jnp.asarray(img), jax_engine.class_settings_from_config(cfg, 2), scales=(0.7, 1.5)
    )
    got, q = pt_ms.run_multiscale_inference(
        pt_eng, torch.from_numpy(img), pt_engine.class_settings_from_config(cfg, 2), scales=(0.7, 1.5)
    )
    np.testing.assert_allclose(float(q), float(ref_q), rtol=1e-5)
    assert got.capacity == ref.capacity and int(np.asarray(ref.valid).sum()) > 0
    _assert_sets_match(got, ref, box_atol=1e-3)


def test_resize_linear_matches_jax_image_resize():
    import jax

    img = _image(size=96)
    for hw in ((64, 64), (160, 128), (96, 96)):
        ref = np.asarray(jax.image.resize(jnp.asarray(img).astype(jnp.float32), hw + (3,), "linear", antialias=False))
        got = pt_ms.resize_linear(torch.from_numpy(img), *hw).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("base", [0.6, [0.5, 0.9], 0.1])
def test_iterative_threshold_matches_jax(base):
    arrs = _instances(8, k=64)
    kw = dict(floor_threshold=0.2, min_total_masks=5, min_relative_increase=0.3)
    ref, ref_d = jax_ms.iterative_threshold_inference(_jax_set(arrs), np.asarray(base), **kw)
    got, got_d = pt_ms.iterative_threshold_inference(_pt_set(arrs), np.asarray(base), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got_d == ref_d


def test_size_heuristics_match_jax(engines, tmp_path):
    jax_eng, pt_eng = engines
    paths = []
    for i in range(2):
        p = tmp_path / f"s{i}.png"
        cv2.imwrite(str(p), _image(seed=i))
        paths.append(str(p))
    (tmp_path / "bad.png").write_bytes(b"junk")
    paths.append(str(tmp_path / "bad.png"))
    cfg = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.2}}}
    ref = jax_ms.calculate_average_mask_sizes(jax_eng, paths, jax_engine.class_settings_from_config(cfg, 2), 0.05)
    got = pt_ms.calculate_average_mask_sizes(pt_eng, paths, pt_engine.class_settings_from_config(cfg, 2), 0.05)
    assert ref and set(got) == set(ref)
    for c in ref:
        assert abs(got[c] - ref[c]) <= 1e-4 * ref[c]
    for sizes in (got, {0: 900.0, 1: 5000.0, 2: 40.0}, {}):
        assert pt_ms.classes_needing_upscale(sizes) == jax_ms.classes_needing_upscale(sizes)
        assert pt_ms.determine_small_classes(sizes) == jax_ms.determine_small_classes(sizes)


def test_checkpoint_discovery_and_loading(tiny_r50, tmp_path):
    """The three checkpoint formats load the same weights; Detectron2's
    frozen batch-norm statistics fold into the affine norm."""
    _, params = tiny_r50
    sd = export_detectron2_state_dict(params, 50)
    (tmp_path / "info.json").write_text(json.dumps({"ds": ["i", "l", ["a", "b"]]}))
    info = read_dataset_info(str(tmp_path / "info.json"))
    assert dataset_class_names(info, "ds") == ["a", "b"]
    with pytest.raises(KeyError):
        dataset_class_names(info, "other")

    assert get_trained_model_paths(str(tmp_path), "ds") == {}
    r50 = tmp_path / "ds" / "rcnn_r50"
    r50.mkdir(parents=True)
    with open(r50 / "model_final_r50.pkl", "wb") as f:
        pickle.dump({"model": sd}, f, protocol=2)
    assert get_trained_model_paths(str(tmp_path), "ds") == {"R50": str(r50 / "model_final_r50.pkl")}
    ref = load_model(str(r50 / "model_final_r50.pkl"), 2, use_bf16=False, device="cpu").state_dict()
    assert set(ref) == set(port_model(params).state_dict())

    # a Detectron2 .pth: norms with running statistics and the pixel buffers
    rng = np.random.default_rng(0)
    d2 = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    norm = "backbone.bottom_up.res2.0.conv1.norm"
    mean, var = rng.random(64).astype(np.float32), (rng.random(64) + 0.5).astype(np.float32)
    scale = sd[f"{norm}.weight"] * np.sqrt(var + 1e-5)  # folds back to the affine weight
    d2[f"{norm}.weight"] = torch.from_numpy(scale)
    d2[f"{norm}.bias"] = torch.from_numpy(sd[f"{norm}.bias"] + mean * sd[f"{norm}.weight"])
    d2[f"{norm}.running_mean"], d2[f"{norm}.running_var"] = torch.from_numpy(mean), torch.from_numpy(var)
    d2["pixel_mean"] = torch.zeros(3, 1, 1)
    torch.save({"model": d2}, r50 / "model_final.pth")
    got = load_model(str(r50 / "model_final.pth"), 2, use_bf16=False, device="cpu").state_dict()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-6)

    # the port trainer's file wins over the others
    torch.save({"model": ref, "backbone": "R50", "num_classes": 2}, r50 / "model_final_r50.pt")
    assert get_trained_model_paths(str(tmp_path), "ds")["R50"].endswith("model_final_r50.pt")
    got = load_model(str(r50 / "model_final_r50.pt"), 2, use_bf16=True, device="cpu")
    assert next(got.parameters()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="3 classes, dataset expects|expects 3"):
        load_model(str(r50 / "model_final_r50.pt"), 3, device="cpu")

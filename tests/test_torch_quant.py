"""Port parity: int8 serving (``models/quant.py``, the plain version of the
int8 convolution K4) against the JAX package's ``models/quant.py`` on the
same inputs, on the CPU.

The JAX model runs its quantizers inside ``jit``, where XLA turns the
division by the constant 127 into a multiply by its float32 reciprocal
(eagerly it divides): the port follows the jitted functions, so these
tests compare against ``jax.jit`` of them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from deepemia_tpu.models import quant as jax_quant
from deepemia_tpu.models.mask_rcnn import MaskRCNN as JaxMaskRCNN
from deepemia_tpu.models.resnet import ResNet as JaxResNet
from deepemia_tpu_torch.kernels import int8_conv as k4
from deepemia_tpu_torch.models import quant
from deepemia_tpu_torch.models.mask_rcnn import build_model
from deepemia_tpu_torch.models.weights import params_from_jax
from deepemia_tpu_torch.ops.image import PIXEL_MEAN_BGR
from torch_tmp_weights import drop_weights  # noqa: F401 - autouse: removes the weights a test wrote

torch.set_num_threads(2)

# (N, H, W, Ci, Co, k, stride, padding): tests/test_quant.py's three conv
# shapes (3x3/1, 1x1/2, 7x7/2; indices 0, 4, 5), the stem's Ci = 3 with a
# 7x7 kernel, a 1x1/1 and a 3x3/2
CONV_SHAPES = [
    (2, 16, 16, 32, 64, 3, 1, 1),
    (2, 16, 16, 64, 32, 1, 1, 0),
    (2, 15, 15, 32, 64, 3, 2, 1),
    (2, 23, 19, 3, 64, 7, 2, 3),
    (2, 16, 16, 64, 128, 1, 2, 0),
    (2, 16, 16, 16, 32, 7, 2, 3),
]


def _jax_weight(w_oihw: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.transpose(w_oihw, (2, 3, 1, 0)))  # -> HWIO


def _weights(rng, co, ci, k):
    # per-channel ranges ~100x apart, as after BN folding
    return (rng.standard_normal((co, ci, k, k)) * np.exp(rng.uniform(-2.3, 2.3, (co, 1, 1, 1)))).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 32, 3, 3), (128, 256, 1, 1), (64, 3, 7, 7), (8, 4, 1, 1)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = _weights(rng, shape[0], shape[1], shape[2])
    w[-1] = 0.0  # an all-zero channel takes the 1e-12 floor
    q_ref, s_ref = jax.jit(jax_quant.quantize_weight)(_jax_weight(w))
    q, s = quant.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and q.shape == (shape[0], shape[2], shape[3], shape[1])
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(q.numpy(), np.transpose(np.asarray(q_ref), (3, 0, 1, 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_activation_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((5, 7, 9, 16)) * rng.uniform(0.01, 100, (5, 1, 1, 1))).astype(np.float32)
    x[2] = 0.0  # an all-zero image takes the 1e-12 floor
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q_ref, s_ref = jax.jit(jax_quant.quantize_activation)(jnp.asarray(x).astype(jdt))
    nchw = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    q, s = quant.quantize_activation(nchw)
    assert q.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref).reshape(-1))
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(q_ref))


def _int8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_int32_conv_matches_jax(shape):
    n, h, w, ci, co, k, stride, pad = shape
    rng = np.random.default_rng(n * h + ci + co + k)
    x, wq = _int8(rng, (n, h, w, ci)), _int8(rng, (co, k, k, ci))
    ref = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(np.transpose(wq, (1, 2, 3, 0))), (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = k4.int8_conv_acc_plain(xt, torch.from_numpy(wq), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def test_int32_conv_saturated_is_exact():
    """All ±127 at K = 4608 (3x3x512): |acc| reaches 127² x 4608, where a
    float32 sum would round; the plain version's float64 sum may not."""
    x = np.full((1, 3, 3, 512), 127, np.int8)
    x[..., 1::2] = -127
    wq = np.full((4, 3, 3, 512), 127, np.int8)
    wq[1, ..., 1::2] = -127
    wq[2] = -127
    wq[3, ..., 1::2] = -127
    wq[3, 0, 0, 0] = 126
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = k4.int8_conv_acc_plain(xt, torch.from_numpy(wq), 1, 0).reshape(-1).tolist()
    exact = [int(np.sum(x[0].astype(np.int64) * wq[c].astype(np.int64))) for c in range(4)]
    assert got == exact and max(map(abs, exact)) == 127 * 127 * 4608
    ref = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(np.transpose(wq, (1, 2, 3, 0))), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    assert np.asarray(ref).reshape(-1).tolist() == exact


@pytest.mark.parametrize("shape, bias", [(CONV_SHAPES[0], True), (CONV_SHAPES[2], False), (CONV_SHAPES[3], False),
                                         (CONV_SHAPES[4], True), ((1,) + CONV_SHAPES[3][1:], False),
                                         ((1,) + CONV_SHAPES[0][1:], False)])
def test_int8_conv2d_matches_jax_int8conv(shape, bias):
    """The module, float32 output, against the JAX ``Int8Conv``. Without a
    bias: equal, for batches of one image too, where XLA reassociates the
    scale product (``dequant_scale``). With one, XLA's CPU backend contracts ``acc * s + bias``
    into one fused multiply-add, where the port rounds the product first
    (as K4 does: kernel and plain version agree bit for bit); the two then
    differ by at most one rounding of the product and one of the result,
    which is the bound: 1 ulp of |acc * s| plus 1 ulp of the output."""
    n, h, w, ci, co, k, stride, pad = shape
    rng = np.random.default_rng(11 + ci)
    x = (rng.standard_normal((n, h, w, ci)) * 3).astype(np.float32)
    wt = _weights(rng, co, ci, k)
    b = rng.standard_normal(co).astype(np.float32) if bias else None
    conv = jax_quant.Int8Conv(co, (k, k), strides=(stride, stride), padding=[(pad, pad)] * 2, use_bias=bias)
    params = {"params": {"kernel": _jax_weight(wt), **({"bias": jnp.asarray(b)} if bias else {})}}
    ref = np.asarray(jax.jit(conv.apply)(params, jnp.asarray(x)))
    mod = quant.Int8Conv2d(torch.from_numpy(wt), None if b is None else torch.from_numpy(b), stride, pad)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = mod(xt).permute(0, 2, 3, 1).numpy()
    if b is None:
        np.testing.assert_array_equal(got, ref)
        return
    product = got - b  # within an ulp of acc * s
    bound = np.spacing(np.abs(product)) + np.spacing(np.abs(ref))
    assert np.all(np.abs(got - ref) <= bound)
    assert np.mean(got == ref) > 0.5


def test_int8_module_keeps_float32_scales_when_cast():
    rng = np.random.default_rng(2)
    mod = quant.Int8Conv2d(torch.from_numpy(_weights(rng, 8, 4, 3)), torch.ones(8), 1, 1)
    amax = mod.w_amax.clone()
    mod.to(torch.bfloat16)
    assert mod.w_amax.dtype == torch.float32 and mod.bias.dtype == torch.float32
    assert mod.weight_q.dtype == torch.int8
    assert torch.equal(mod.w_amax, amax)


@pytest.fixture(scope="module")
def port_params(tiny_r50):
    _, params = tiny_r50
    return params_from_jax(jax.device_get(params), 50)


@pytest.mark.parametrize("mode", ["trunk", "full"])
def test_quantized_features_match_jax(tiny_r50, port_params, mode):
    """The int8 backbone of ``tiny_r50`` at 64² (one image), float32,
    against ``model.clone(quant_backbone=mode)``. The trunk's stages are
    equal: every int8 conv is exact, the dequantization table is XLA's
    (``dequant_scale``), and ``tiny_r50``'s identity frozen norms make
    XLA's fused multiply-add and the port's two roundings agree. The float
    FPN of ``trunk`` sums in another order, so p2-p6 are held to 1e-5 of
    each level's largest magnitude, as the float features are
    (tests/test_torch_trunk.py, 1e-4); ``full``'s zero FPN biases leave its
    FPN exact too. The float backbone's res2 is ~1e-3 away, so the check
    sees the quantization."""
    model, params = tiny_r50
    rng = np.random.default_rng(3)
    img = (rng.random((64, 64, 3)) * 255).astype(np.float32)
    x = (img - np.asarray(PIXEL_MEAN_BGR, np.float32))[None]
    res_ref = jax.jit(lambda p, v: JaxResNet(depth=50, quant=True).apply({"params": p}, v))(
        params["params"]["backbone"], jnp.asarray(x))
    ref = jax.jit(
        lambda p, v: model.clone(quant_backbone=mode).apply(p, v, method=JaxMaskRCNN.features)
    )(params, jnp.asarray(img))
    port = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    port.load_state_dict(port_params, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        float_res2 = port.backbone.bottom_up.res2(port.backbone.bottom_up.stem(xt))
        port.quantize(mode)
        got_res = port.backbone.bottom_up(xt)
        got = port.features(torch.from_numpy(img))
    n_int8 = sum(isinstance(m, quant.Int8Conv2d) for m in port.modules())
    assert n_int8 == (53 if mode == "trunk" else 61)
    r2 = np.asarray(res_ref["res2"])
    assert np.abs(float_res2.permute(0, 2, 3, 1).numpy() - r2).max() > 1e-3 * np.abs(r2).max()
    for lv in ("res2", "res3", "res4", "res5"):
        np.testing.assert_array_equal(got_res[lv].permute(0, 2, 3, 1).numpy(), np.asarray(res_ref[lv]), err_msg=lv)
    for lv in ("p2", "p3", "p4", "p5", "p6"):
        r, g = np.asarray(ref[lv]), got[lv].numpy()
        assert g.shape == r.shape, lv
        if mode == "full":
            np.testing.assert_array_equal(g, r, err_msg=lv)
        else:
            np.testing.assert_allclose(g, r, atol=1e-5 * float(np.abs(r).max()), rtol=0, err_msg=lv)


def test_load_model_quantizes_from_float32(tmp_path, port_params):
    """bf16 serving quantizes the float32 checkpoint, as the JAX package
    does, not the model's bf16 copy of it."""
    from deepemia_tpu_torch.data.models import load_model

    path = tmp_path / "model_final_r50.pt"
    torch.save({"model": port_params}, path)
    model = load_model(str(path), 2, use_bf16=True, device="cpu", quant_backbone="trunk")
    assert model.quant_backbone == "trunk" and model.dtype == torch.bfloat16
    for name in quant.quantized_conv_names(build_model("R50", 2, False, device="cpu"), "trunk"):
        mod = model.get_submodule(name)
        q, s = quant.quantize_weight(port_params[f"{name}.weight"])
        assert torch.equal(mod.weight_q, q), name
        assert mod.w_amax.dtype == torch.float32 and torch.equal(mod.w_amax * quant._INV_127, s), name
    # and the float layers kept the checkpoint's values in bf16
    assert torch.equal(model.backbone.fpn_lateral2.weight,
                       port_params["backbone.fpn_lateral2.weight"].to(torch.bfloat16))
    full = load_model(str(path), 2, use_bf16=True, device="cpu", quant_backbone="full")
    assert torch.equal(full.backbone.fpn_output2.bias, port_params["backbone.fpn_output2.bias"])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 16, 8, 8), dtype=torch.int8)
    w = torch.zeros((32, 3, 3, 16), dtype=torch.int8)
    s = torch.ones((1, 32))
    with pytest.raises(ValueError, match="int8"):
        k4.int8_conv2d(x.float(), w, s, None, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="scale"):
        k4.int8_conv2d(x, w, s.double(), None, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="scale"):
        k4.int8_conv2d(x, w, s[:, :16], None, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="bias"):
        k4.int8_conv2d(x, w, s, torch.ones(31), 1, 1, torch.float32)
    with pytest.raises(ValueError, match=r"\[Co,kh,kw,Ci\]"):
        k4.int8_conv2d(x, w[..., :8].contiguous(), s, None, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="even"):
        k4.int8_conv2d(x, w[:31], s[:, :31], None, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="writes"):
        k4.int8_conv2d(x, w, s, None, 1, 1, torch.float16)
    with pytest.raises(ValueError, match="no kernel"):
        k4.launch(x, w, s, None, 1, 1, torch.float32)
    assert k4.int8_conv2d(x, w, s, None, 1, 1, torch.bfloat16).dtype == torch.bfloat16

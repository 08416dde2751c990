"""Port parity: the int8 trunk with the frozen norm and ReLU fused into the
int8 convolution's epilogue (K4) and the activation quantizer as its own
kernel (K5), on the CPU through their plain versions.

The fusion must not move a bit: the fused plain version equals the
separate torch ops (``FrozenBatchNorm``, ``F.relu``), the stem as a
space-to-depth conv of 16 channels adds only zero products, the scale
made from the maxima equals the table, a block's shared input is
quantized once, and the quantized trunk and FPN equal the unfused module
chain of the previous design, in float32 and in bf16 (where every
rounding of the norm shows), and still match the JAX package."""

import copy
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deepemia_tpu.models import quant as jax_quant
from deepemia_tpu.models.resnet import ResNet as JaxResNet
from deepemia_tpu_torch.kernels import int8_conv as k4
from deepemia_tpu_torch.kernels import int8_quant as k5
from deepemia_tpu_torch.models import quant, resnet
from deepemia_tpu_torch.models.mask_rcnn import build_model
from deepemia_tpu_torch.models.resnet import FrozenBatchNorm
from deepemia_tpu_torch.models.weights import params_from_jax
from deepemia_tpu_torch.ops.image import PIXEL_MEAN_BGR

torch.set_num_threads(2)

# (N, H, W, Ci, Co, k, stride, padding): 1x1, 3x3, the stem's 7x7/2 on 3
# channels, a 1x1/2, each at one image and at several
FUSED_SHAPES = [
    (1, 9, 11, 32, 64, 1, 1, 0),
    (3, 9, 11, 32, 64, 1, 1, 0),
    (1, 10, 9, 16, 48, 3, 1, 1),
    (2, 10, 9, 16, 48, 3, 1, 1),
    (1, 23, 19, 3, 64, 7, 2, 3),
    (3, 23, 19, 3, 64, 7, 2, 3),
    (2, 12, 12, 64, 128, 1, 2, 0),
]


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8))


def _conv_inputs(shape, seed):
    n, h, w, ci, co, k, stride, pad = shape
    rng = np.random.default_rng(seed)
    x_q = _int8(rng, (n, h, w, ci)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    w_q = _int8(rng, (co, k, k, ci))
    scale = torch.from_numpy((rng.random((n, co)) * 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    norm = FrozenBatchNorm(co)
    with torch.no_grad():  # per-channel scales and shifts of several magnitudes
        w = rng.standard_normal(co) * np.exp(rng.uniform(-3, 3, co))
        norm.weight.copy_(torch.from_numpy(w.astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(rng.standard_normal(co).astype(np.float32)))
    return x_q, w_q, scale, bias, norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("norm_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_epilogue_equals_separate_ops(shape, dtype, with_bias, norm_dtype):
    """The plain K4 with the norm and ReLU equals the plain K4, then
    ``FrozenBatchNorm`` and ``F.relu`` as separate ops, bit for bit; with
    the norm's parameters in float32 (cast to ``dtype`` first, as the
    module does) and already in bf16 (a model cast with ``model.to``)."""
    n, h, w, ci, co, k, stride, pad = shape
    x_q, w_q, scale, bias, norm = _conv_inputs(shape, sum(shape) + with_bias)
    norm = norm.to(norm_dtype)
    b = bias if with_bias else None
    with torch.no_grad():
        want = F.relu(norm(k4.int8_conv2d_plain(x_q, w_q, scale, b, stride, pad, dtype)))
        got = k4.int8_conv2d_plain(x_q, w_q, scale, b, stride, pad, dtype, norm_weight=norm.weight,
                                   norm_bias=norm.bias, relu=True)
        through_wrapper = k4.int8_conv2d(x_q, w_q, scale, b, stride, pad, dtype, norm_weight=norm.weight,
                                         norm_bias=norm.bias, relu=True)
        norm_only = k4.int8_conv2d(x_q, w_q, scale, b, stride, pad, dtype, norm_weight=norm.weight,
                                   norm_bias=norm.bias)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want) and torch.equal(through_wrapper, want)
    assert torch.equal(norm_only, norm(k4.int8_conv2d_plain(x_q, w_q, scale, b, stride, pad, dtype)))
    assert bool((want == 0).any()) and bool((want > 0).any())  # the ReLU and the norm both acted


@pytest.mark.parametrize("n", [1, 3])
def test_dequant_scale_from_maxima_equals_table(n):
    """The module hands K4 the maxima (``DequantScale``), whose epilogue
    makes the scale table; the plain version with them equals it with
    ``dequant_scale``'s table, in both of XLA's orders (one image and
    several)."""
    x_q, w_q, _, bias, norm = _conv_inputs((n, 8, 9, 16, 32, 3, 1, 1), n)
    rng = np.random.default_rng(n)
    a_amax = torch.from_numpy(rng.uniform(0.1, 50, n).astype(np.float32))
    w_amax = torch.from_numpy(rng.uniform(0.01, 2, 32).astype(np.float32))
    table = quant.dequant_scale(a_amax, w_amax)
    if n == 1:  # XLA folds the two constants: w * (a * (1/127)^2)
        assert torch.equal(table, w_amax[None] * (a_amax * quant._INV_127 * quant._INV_127)[:, None])
    got = k4.int8_conv2d(x_q, w_q, k4.DequantScale(a_amax, w_amax), bias, 1, 1, torch.bfloat16,
                         norm_weight=norm.weight, norm_bias=norm.bias, relu=True)
    want = k4.int8_conv2d_plain(x_q, w_q, table, bias, 1, 1, torch.bfloat16, norm_weight=norm.weight,
                                norm_bias=norm.bias, relu=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="maxima"):
        k4.int8_conv2d(x_q, w_q, k4.DequantScale(a_amax, w_amax[:16]), None, 1, 1, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(37, 41), (64, 64), (1, 2)])
def test_stem_as_space_to_depth_is_exact(dtype, hw):
    """The stem module runs its 7x7/2 conv on 3 channels as a 4x4 stride-1
    conv over 2x2 blocks of pixels (16 channels: 12 values, 4 zeros; K5's
    space-to-depth layout) with its output cropped to the 7x7/2's: equal to
    the direct conv on the unpadded input, odd sizes included."""
    rng = np.random.default_rng(sum(hw))
    x = torch.from_numpy((rng.standard_normal((2, 3) + hw) * 40).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    mod = quant.Int8Conv2d(torch.from_numpy(rng.standard_normal((64, 3, 7, 7)).astype(np.float32)), None, 2, 3)
    assert mod.space_to_depth and mod.weight_q.shape == (64, 7, 7, 3) and mod.weight_k.shape == (64, 4, 4, 16)
    w = mod.weight_k[..., :12].reshape(64, 4, 4, 4, 3)  # (r', s', 2 dy + dx, c) of tap (2 r' + dy - 1, 2 s' + dx - 1)
    for r in range(7):
        for s_ in range(7):
            tap = w[:, (r + 1) // 2, (s_ + 1) // 2, ((r + 1) % 2) * 2 + (s_ + 1) % 2]
            assert torch.equal(tap, mod.weight_q[:, r, s_])
    assert not bool(mod.weight_k[..., 12:].any())
    assert not bool(w[:, 0, :, 0:2].any()) and not bool(w[:, :, 0, 0::2].any())  # the zero first row and column
    q = mod.quantize(x)
    assert q.x_q.shape == (2, 16, (hw[0] + 1) // 2, (hw[1] + 1) // 2)
    x_q3, amax3 = quant._quantize_activation(x)
    assert torch.equal(q.x_q, k5.space_to_depth(x_q3)) and torch.equal(q.amax, amax3)
    want = k4.int8_conv2d_plain(x_q3, mod.weight_q, quant.dequant_scale(amax3, mod.w_amax), None, 2, 3, dtype)
    with torch.no_grad():
        got = mod(x)
    assert got.shape == want.shape and torch.equal(got, want)


def _port_model(tiny_r50, dtype, norm_seed=None):
    _, params = tiny_r50
    port = build_model("R50", num_classes=2, use_bf16=False, device="cpu")
    port.load_state_dict(params_from_jax(jax.device_get(params), 50), strict=True)
    if norm_seed is not None:  # tiny_r50's norms are identities: give them scales and shifts
        rng = np.random.default_rng(norm_seed)
        with torch.no_grad():
            for mod in port.modules():
                if isinstance(mod, FrozenBatchNorm):
                    c = mod.weight.shape[0]
                    mod.weight.copy_(torch.from_numpy(rng.uniform(0.3, 1.7, c).astype(np.float32)))
                    mod.bias.copy_(torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32)))
    return port


def _quantized(port, mode, dtype):
    weights = {k: v.clone() for k, v in port.state_dict().items()}
    model = copy.deepcopy(port)
    model.quantize(mode, weights)
    return model.to(dtype)


def _unfused_forward(self, x):
    """``Int8Conv2d.forward`` before the fusion: the torch-op quantizer,
    K4's plain version with the dequantize and bias only, then the
    module's norm and ``F.relu`` as separate ops."""
    x = x.x if isinstance(x, quant.QuantizedActivation) else x
    x_q, a_amax = quant._quantize_activation(x.contiguous(memory_format=torch.channels_last))
    y = k4.int8_conv2d_plain(x_q, self.weight_q, quant.dequant_scale(a_amax, self.w_amax), self.bias, self.stride,
                             self.padding, x.dtype)
    y = y if self.norm is None else self.norm(y)
    return F.relu(y) if self.relu else y


def _unfused_block(self, x):
    """``BottleneckBlock.forward`` before the fusions: the shortcut added
    and the block's ReLU applied as separate ops, no max handed on."""
    shortcut = x if self.shortcut is None else self.shortcut(x)
    return F.relu(self.conv3(self.conv2(self.conv1(x))) + shortcut)


def _unfused_chain(model):
    """A copy of the quantized ``model`` that runs as the previous design
    did: each int8 conv unfused, every ReLU and residual add a separate op
    and each conv's input quantized for that conv alone, its max taken
    from it."""
    ref = copy.deepcopy(model)
    for mod in ref.modules():
        if isinstance(mod, quant.Int8Conv2d):
            mod.forward = types.MethodType(_unfused_forward, mod)
            mod.quantize = lambda x: x  # the blocks hand the float input on
        elif isinstance(mod, resnet.BottleneckBlock):
            mod.forward = types.MethodType(_unfused_block, mod)
    return ref


def _image(seed, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((n, 64, 64, 3)) * 255).astype(np.float32))


@pytest.mark.parametrize("mode", ["trunk", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_model_equals_unfused_chain(tiny_r50, mode, dtype):
    """``tiny_r50`` with scaled and shifted frozen norms, quantized, two
    64² images: the fused trunk (res2-res5) and the features (p2-p6) equal
    the unfused module chain's bit for bit."""
    model = _quantized(_port_model(tiny_r50, dtype, norm_seed=5), mode, dtype)
    ref = _unfused_chain(model)
    img = _image(3, 2)
    with torch.no_grad():
        x = model.normalize(img.to(dtype))
        got_res, want_res = model.backbone.bottom_up(x), ref.backbone.bottom_up(x)
        got, want = model.features_batched(img), ref.features_batched(img)
    for lv in ("res2", "res3", "res4", "res5"):
        assert got_res[lv].dtype == dtype and torch.equal(got_res[lv], want_res[lv]), lv
    for lv in ("p2", "p3", "p4", "p5", "p6"):
        assert torch.equal(got[lv], want[lv]), lv
    assert float(got_res["res5"].float().abs().max()) > 0


def test_block_input_quantized_once(tiny_r50, monkeypatch):
    """One trunk forward quantizes 49 inputs for its 53 convs: each
    stage's first block quantizes its input once for ``conv1`` and
    ``shortcut`` (counted as calls of K5's plain version), with the same
    outputs as quantizing it for each."""
    model = _quantized(_port_model(tiny_r50, torch.float32, norm_seed=6), "trunk", torch.float32)
    calls = []
    real = quant._quantize_activation

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(quant, "_quantize_activation", counted)
    x = model.normalize(_image(4, 2))
    with torch.no_grad():
        got = model.backbone.bottom_up(x)
    assert len(calls) == 49
    def separate(self, x):  # the block quantizing its input for each conv that reads it
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + shortcut)  # conv1, conv2 apply their ReLUs

    monkeypatch.setattr(resnet.BottleneckBlock, "forward", separate)
    calls.clear()
    with torch.no_grad():
        each = model.backbone.bottom_up(x)
    assert len(calls) == 53
    for lv in got:
        assert torch.equal(got[lv], each[lv]), lv


def test_quantize_backbone_marks_relu():
    """``quantize_backbone`` marks exactly the stem's conv and every
    bottleneck's ``conv1`` and ``conv2`` as applying the ReLU that follows
    them; not ``conv3``, the shortcuts or the FPN's convs."""
    model = build_model("R50", num_classes=2, use_bf16=False, device="cpu", quant_backbone="full")
    marked = sorted(name for name, mod in model.named_modules() if isinstance(mod, quant.Int8Conv2d) and mod.relu)
    want = ["backbone.bottom_up.stem.conv1"] + [
        f"backbone.bottom_up.res{s}.{b}.conv{i}" for s, n in zip(range(2, 6), (3, 4, 6, 3)) for b in range(n)
        for i in (1, 2)
    ]
    assert marked == sorted(want) and len(marked) == 33
    unmarked = [name for name, mod in model.named_modules() if isinstance(mod, quant.Int8Conv2d) and not mod.relu]
    assert len(unmarked) == 61 - 33 and all(
        n.endswith((".conv3", ".shortcut")) or ".fpn_" in n for n in unmarked)


def test_fused_trunk_matches_jax_two_images(tiny_r50):
    """The fused int8 trunk of ``tiny_r50`` at two 64² images, float32,
    equals ``JaxResNet(quant=True)`` at res2-res5 (as
    ``tests/test_torch_quant.py`` holds one image: for a batch XLA keeps
    the written order of the dequantization table)."""
    _, params = tiny_r50
    img = _image(8, 2).numpy()
    x = img - np.asarray(PIXEL_MEAN_BGR, np.float32)
    ref = jax.jit(lambda p, v: JaxResNet(depth=50, quant=True).apply({"params": p}, v))(
        params["params"]["backbone"], jnp.asarray(x))
    model = _quantized(_port_model(tiny_r50, torch.float32), "trunk", torch.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model.backbone.bottom_up(xt)
    for lv in ("res2", "res3", "res4", "res5"):
        np.testing.assert_array_equal(got[lv].permute(0, 2, 3, 1).numpy(), np.asarray(ref[lv]), err_msg=lv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, s2d", [(16, False), (32, False), (3, True), (4, True)])
def test_quantizer_matches_plain_and_jax(dtype, c, s2d):
    """K5's wrapper on the CPU equals ``_quantize_activation`` (its plain
    version) and, through it, ``jax.jit(quantize_activation)``; in the
    stem's space-to-depth layout too, whose other channels are zeros."""
    rng = np.random.default_rng(c + 3)
    x = (rng.standard_normal((4, 6, 7, c)) * rng.uniform(0.01, 100, (4, 1, 1, 1))).astype(np.float32)
    x[1] = 0.0  # an all-zero image takes the 1e-12 floor
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q_ref, s_ref = jax.jit(jax_quant.quantize_activation)(jnp.asarray(x).astype(jdt))
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    q, amax = k5.int8_quantize(xt, s2d)
    q_plain, amax_plain = quant._quantize_activation(xt)
    assert q.dtype == torch.int8 and q.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(amax, amax_plain)
    if s2d:
        assert q.shape == (4, 16, 3, 4) and torch.equal(q, k5.space_to_depth(q_plain))
        assert torch.equal(q[:, :c, :, :], q_plain[:, :, 0::2, 0::2]) and not bool(q[:, 4 * c:].any())
    else:
        assert q.shape == (4, c, 6, 7) and torch.equal(q, q_plain)
    np.testing.assert_array_equal(q_plain.permute(0, 2, 3, 1).numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal((amax * quant._INV_127).numpy(), np.asarray(s_ref).reshape(-1))


def test_quantizer_refuses_what_its_kernel_does_not_take():
    x = torch.zeros((2, 16, 4, 4)).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k5.int8_quantize(x.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k5.int8_quantize(x.to(torch.int8))
    with pytest.raises(ValueError, match=r"\[N,C,H,W\]"):
        k5.int8_quantize(x[0])
    three = x[:, :3].contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        k5.int8_quantize(x.contiguous())
    with pytest.raises(ValueError, match="space-to-depth"):
        k5.int8_quantize(x, space_to_depth_blocks=True)
    with pytest.raises(ValueError, match="no kernel"):
        k5.launch(x)
    with pytest.raises(ValueError, match="no kernel"):
        k5.launch(three)
    assert k5.int8_quantize(three)[0].shape[1] == 3 and k5.int8_quantize(three, True)[0].shape[1] == 16


def test_conv_wrapper_refuses_half_a_norm():
    x_q, w_q, scale, bias, norm = _conv_inputs((1, 6, 6, 16, 32, 1, 1, 0), 0)
    with pytest.raises(ValueError, match="out_hw"):
        k4.int8_conv2d(x_q, w_q, scale, None, 1, 0, torch.float32, out_hw=(7, 6))
    with pytest.raises(ValueError, match="both"):
        k4.int8_conv2d(x_q, w_q, scale, None, 1, 0, torch.float32, norm_weight=norm.weight)
    with pytest.raises(ValueError, match="norm_weight and norm_bias"):
        k4.int8_conv2d(x_q, w_q, scale, None, 1, 0, torch.float32, norm_weight=norm.weight[:8],
                       norm_bias=norm.bias[:8])
    with pytest.raises(ValueError, match="no kernel"):
        k4.launch(x_q, w_q, scale, None, 1, 0, torch.float32, norm_weight=norm.weight, norm_bias=norm.bias)

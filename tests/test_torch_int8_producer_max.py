"""Port parity: the int8 trunk with the producer's max, on the CPU through
the plain versions.

K4's epilogue takes the per-image max of what it stores, and a
bottleneck's ``conv3`` adds the shortcut and applies the block's ReLU
there, so that K5 quantizes each map it produced in one pass. None of it
may move a bit: the plain K4 with a residual equals the separate
``F.relu(y + shortcut)``, its max equals the quantizer's max of its
output, and every map K4 produced reaches K5 with that max, which equals
the max K5's plain version takes from the map itself. Only the stem's
image and the max-pool output (and in ``full`` the FPN's top-down sums)
take K5's own max pass."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepemia_tpu_torch.kernels import int8_conv as k4
from deepemia_tpu_torch.kernels import int8_quant as k5
from deepemia_tpu_torch.models import quant
from deepemia_tpu_torch.models.resnet import ActivationMax
from test_torch_int8_fused import _conv_inputs, _image, _port_model, _quantized

torch.set_num_threads(2)

# (N, H, W) of a 1x1 conv3-like conv: Ho*Wo a multiple of 128, below 128 (a kernel tile spans three
# or more images), and the 253x259 tile, whose kernel tiles straddle two images
RESIDUAL_SHAPES = [(1, 8, 16), (3, 8, 16), (3, 9, 11), (1, 253, 259), (2, 253, 259)]


def _shortcut(rng, n, c, h, w, dtype):
    s = rng.standard_normal((n, h, w, c)) * rng.uniform(0.1, 3.0, (n, 1, 1, 1))
    return torch.from_numpy(s.astype(np.float32)).to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("shape", RESIDUAL_SHAPES)
def test_residual_epilogue_equals_separate_ops(shape, with_norm, dtype):
    """The plain K4 with a residual and the ReLU equals the conv, its norm,
    then ``F.relu(y + shortcut)`` as separate ops, bit for bit; its max
    equals ``_quantize_activation(out)[1]`` bit for bit."""
    n, h, w = shape
    x_q, w_q, scale, bias, norm = _conv_inputs((n, h, w, 32, 64, 1, 1, 0), n * h + w + with_norm)
    scale = scale * 30  # outputs of the shortcut's magnitude, so that both terms count
    shortcut = _shortcut(np.random.default_rng(h * w), n, 64, h, w, dtype)
    nw, nb = (norm.weight, norm.bias) if with_norm else (None, None)
    with torch.no_grad():
        y = k4.int8_conv2d_plain(x_q, w_q, scale, bias, 1, 0, dtype, norm_weight=nw, norm_bias=nb)
        want = F.relu(y + shortcut)
        got, amax = k4.int8_conv2d(x_q, w_q, scale, bias, 1, 0, dtype, norm_weight=nw, norm_bias=nb, relu=True,
                                   residual=shortcut, with_max=True)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    assert amax.dtype == torch.float32 and torch.equal(amax, quant._quantize_activation(want)[1])
    assert bool((want == 0).any()) and bool((want > 0).any())
    assert not torch.equal(want, F.relu(y))  # the shortcut counted


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", [(3, 10, 9, 16, 48, 3, 1, 1, True), (3, 8, 9, 32, 64, 1, 1, 0, False),
                                  (2, 23, 19, 3, 64, 7, 2, 3, True)])
def test_max_equals_the_quantizers(conv, dtype):
    """Without a residual (``conv1``, ``conv2``: the norm and the ReLU; a
    conv without its ReLU) the max K4 takes of its output equals the
    quantizer's, bit for bit; an all-zero image takes the 1e-12 floor."""
    *shape, relu = conv
    n, h, w, ci, co, k, stride, pad = shape
    x_q, w_q, scale, _, norm = _conv_inputs(tuple(shape), sum(shape))
    x_q[1:2] = 0  # with no bias and no norm, image 1's output is all zeros
    for nw, nb in ((norm.weight, norm.bias), (None, None)):
        with torch.no_grad():
            got, amax = k4.int8_conv2d(x_q, w_q, scale, None, stride, pad, dtype, norm_weight=nw, norm_bias=nb,
                                       relu=relu, with_max=True)
            want = k4.int8_conv2d_plain(x_q, w_q, scale, None, stride, pad, dtype, norm_weight=nw, norm_bias=nb,
                                        relu=relu)
        assert torch.equal(got, want) and torch.equal(amax, quant._quantize_activation(want)[1])
    assert float(amax[1]) == float(np.float32(1e-12))


class QuantizerSpy:
    """Records each call of K5's wrapper that the int8 modules make: the
    input's shape, whether it came with its producer's max, and that max
    against the one the plain version takes of the input."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.real = quant.int8_quantize
        monkeypatch.setattr(quant, "int8_quantize", self)

    def __call__(self, x, space_to_depth_blocks=False, amax=None):
        x_q, got = self.real(x, space_to_depth_blocks, amax)
        self.calls.append((tuple(x.shape), amax is not None))
        if amax is not None:
            assert torch.equal(amax, got), (tuple(x.shape), amax, got)  # the producer's max is x's own
        return x_q, got

    def launches(self):
        """The K5 launches these calls make on the card: one with the producer's max, two without."""
        return sum(1 if given else 2 for _, given in self.calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_hands_each_map_its_producer_max(tiny_r50, monkeypatch, dtype):
    """One int8 trunk forward of two 64² images quantizes 49 inputs: the
    stem's image and the max-pool output (res2.0's input) take K5's max
    pass, the 47 maps K4 produced come with their max, equal bit for bit to
    the max taken of the map: 51 K5 launches on the card."""
    model = _quantized(_port_model(tiny_r50, dtype, norm_seed=8), "trunk", dtype)
    spy = QuantizerSpy(monkeypatch)
    with torch.no_grad():
        feats = model.backbone.bottom_up(model.normalize(_image(9, 2).to(dtype)))
    assert all(isinstance(v, torch.Tensor) and v.dtype == dtype for v in feats.values())
    two_pass = [shape for shape, given in spy.calls if not given]
    assert len(spy.calls) == 49 and two_pass == [(2, 3, 64, 64), (2, 64, 16, 16)]
    assert spy.launches() == 51


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_fpn_takes_the_stage_maxima(tiny_r50, monkeypatch, dtype):
    """``full``: the FPN's laterals quantize the stage outputs with the
    maxima the trunk's last conv3s took (4 one-pass inputs); its output
    convs read the top-down sums, which take the max pass (4 two-pass):
    57 inputs, 63 K5 launches a forward. ``trunk`` hands the bf16 FPN the
    maps alone."""
    spy = QuantizerSpy(monkeypatch)
    img = _image(10, 2)
    calls = {}
    for mode in ("full", "trunk"):
        model = _quantized(_port_model(tiny_r50, dtype, norm_seed=9), mode, dtype)
        spy.calls.clear()
        with torch.no_grad():
            feats = model.features_batched(img)
        assert all(bool(torch.isfinite(v.float()).all()) for v in feats.values())
        calls[mode] = (list(spy.calls), spy.launches())
    assert len(calls["full"][0]) == 57 and calls["full"][1] == 63
    assert len(calls["trunk"][0]) == 49 and calls["trunk"][1] == 51
    fpn = calls["full"][0][49:]  # lateral5 .. lateral2, then output2 .. output5
    assert [shape for shape, given in fpn if given] == [(2, 2048, 2, 2), (2, 1024, 4, 4), (2, 512, 8, 8),
                                                        (2, 256, 16, 16)]
    assert [given for _, given in fpn] == [True] * 4 + [False] * 4


def test_block_output_carries_its_max(tiny_r50):
    """A quantized block returns its output with the max its ``conv3``
    took; the float block returns the map alone, as before."""
    float_model = _port_model(tiny_r50, torch.float32)
    model = _quantized(float_model, "trunk", torch.float32)
    trunk = model.backbone.bottom_up
    x = model.normalize(_image(11, 2))
    with torch.no_grad():
        stem = trunk.stem(x)
        out = trunk.res2[0](stem)
        plain = float_model.backbone.bottom_up.res2[0](float_model.backbone.bottom_up.stem(x))
        again = trunk(x, with_max=True)["res2"]
    assert isinstance(out, ActivationMax) and torch.equal(out.amax, quant._quantize_activation(out.x)[1])
    assert isinstance(plain, torch.Tensor)
    assert isinstance(again, ActivationMax) and torch.equal(again.amax, quant._quantize_activation(again.x)[1])


def test_one_pass_plain_version_takes_the_max_from_x():
    """On the CPU the wrapper takes the plain version, which takes the max
    from x whatever max it is handed (the card's one pass returns the
    producer's): holding the kernel to it holds the producer's max to x."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.standard_normal((2, 4, 5, 32)) * 7).astype(np.float32)).permute(0, 3, 1, 2)
    q, amax = k5.int8_quantize(x, amax=torch.full((2,), 1e3))
    q_ref, amax_ref = quant._quantize_activation(x)
    assert torch.equal(q, q_ref) and torch.equal(amax, amax_ref)
    with pytest.raises(ValueError, match="no kernel"):
        k5.launch(x, amax=amax_ref)


def test_wrappers_refuse_a_wrong_residual_or_max():
    """K4 refuses a residual of another shape, dtype or layout than its
    output's; K5 a producer's max of another shape or dtype than [N]
    float32."""
    x_q, w_q, scale, _, _ = _conv_inputs((2, 6, 6, 16, 32, 1, 1, 0), 1)
    good = torch.zeros((2, 32, 6, 6)).contiguous(memory_format=torch.channels_last)
    assert k4.int8_conv2d(x_q, w_q, scale, None, 1, 0, torch.float32, relu=True, residual=good).shape == good.shape
    for bad, what in ((good[:, :16], "residual"), (good[:1], "residual"), (good.bfloat16(), "residual"),
                      (good.contiguous(), "channels_last")):
        with pytest.raises(ValueError, match=what):
            k4.int8_conv2d(x_q, w_q, scale, None, 1, 0, torch.float32, relu=True, residual=bad)
    with pytest.raises(ValueError, match="residual"):  # the stride-2 output is 3x3
        k4.int8_conv2d(x_q, w_q, scale[:, :32], None, 2, 0, torch.float32, residual=good)
    x = good.clone()
    for bad in (torch.ones(3), torch.ones(2, dtype=torch.float64), torch.ones(2, 1)):
        with pytest.raises(ValueError, match="producer's max"):
            k5.int8_quantize(x, amax=bad)

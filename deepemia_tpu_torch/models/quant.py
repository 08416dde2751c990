"""Int8 serving of the backbone (``--quantized trunk|full``): the port of
``deepemia_tpu/models/quant.py``.

  * weights: symmetric int8 per output channel, from the float32 weight:
    ``w_scale[co] = max(amax|W[co]|, 1e-12) / 127``,
    ``clip(round(W / w_scale), -127, 127)`` (round half to even);
  * activations: the same, per image (per tile), computed on the device
    for every conv input (``kernels/int8_quant.py``, K5 on the card; the
    input of a stage's first block is quantized once for its ``conv1`` and
    its ``shortcut``);
  * the convolution sums int8 products in int32 (``kernels/int8_conv.py``,
    K4 on the card) and dequantizes ``acc * (a_scale * w_scale) + bias`` in
    float32 before the cast to the compute dtype; the frozen-BN affine
    and the ReLU that follow in the trunk (``ConvNorm.relu``), and a
    block's ``relu(conv3 + shortcut)``, run in K4's epilogue, rounded as
    the separate ops round;
  * the per-image max of a conv output that another int8 conv reads (each
    bottleneck's ``conv1``, ``conv2`` and block output) is taken in that
    epilogue too and carried beside the map (``ActivationMax``), so K5
    reads the map once; the stem's image, the max-pool output and the
    FPN's top-down sums take K5's own max pass.

The ``a_scale * w_scale`` table is the one XLA computes for the JAX
package (:func:`dequant_scale`): with one image in the batch its algebraic
simplifier folds the two reciprocals of 127 into one constant and computes
``w_amax * (a_amax * (1/127)²)``, the written order otherwise.

The JAX package runs these functions inside ``jit``, where XLA turns the
division by the constant 127 into a multiply by its float32 reciprocal;
the port multiplies by ``float32(1/127)`` so that its scales are the same
bits as the JAX model's. XLA's CPU backend also contracts a multiply
feeding an add (the bias, the frozen-BN affine) into one fused
multiply-add, which the port does not (the card's bf16 serving path has no
such fusion to match): that moves a float32 result by an ulp, which in an
int8 network can flip a level at the next quantizer; the parity tests
state their tolerances with that reason.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepemia_tpu_torch.kernels.int8_conv import INV_127 as _INV_127
from deepemia_tpu_torch.kernels.int8_conv import DequantScale, conv_out_hw, int8_conv2d
from deepemia_tpu_torch.kernels.int8_quant import image_amax, int8_quantize
from deepemia_tpu_torch.models.resnet import ActivationMax, ConvNorm

QUANT_MODES = ("none", "trunk", "full")


def _floor(amax: torch.Tensor) -> torch.Tensor:
    return amax.float().clamp_min(1e-12)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 [Co,Ci,kh,kw] -> (int8 [Co,kh,kw,Ci], float32 per-channel
    scale [Co])."""
    q, amax = _quantize_weight(w)
    return q, amax * _INV_127


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    w = w.float()
    amax = _floor(w.abs().amax(dim=(1, 2, 3)))
    q = torch.round(w / (amax * _INV_127).view(-1, 1, 1, 1)).clamp_(-127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous(), amax


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N,C,H,W] (any float dtype and memory format) -> (int8 of the same
    shape and memory format, float32 per-image scale [N])."""
    q, amax = _quantize_activation(x)
    return q, amax * _INV_127


def _quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8, the floored per-image max |x|): the plain version of K5
    (``kernels/int8_quant.py``). The max is :func:`image_amax`'s; the
    division promotes to float32 as it reads, which divides the exact
    float32 value of each element, as ``x.float() / scale`` does, without
    a float32 copy of ``x``."""
    amax = image_amax(x)
    q = torch.div(x, (amax * _INV_127).view(-1, *([1] * (x.ndim - 1))))
    return q.round_().clamp_(-127, 127).to(torch.int8), amax


def dequant_scale(a_amax: torch.Tensor, w_amax: torch.Tensor) -> torch.Tensor:
    """The [N,Co] float32 table of ``a_scale[n] * w_scale[co]`` from the
    floored maxima, in XLA's order (:class:`DequantScale`)."""
    return DequantScale(a_amax, w_amax).table()


def takes_space_to_depth(ci: int, k: int, stride: int, padding: int) -> bool:
    """Whether a conv runs as a space-to-depth conv (the stem: 7x7/2,
    padding 3, 3 channels): stride 2, an odd square kernel and padding, and
    4 Ci <= 16, so that a 2x2 block of pixels fits one 16-byte pixel."""
    return stride == 2 and k % 2 == 1 and padding % 2 == 1 and 4 * ci <= 16


def space_to_depth_weights(w_q: torch.Tensor) -> torch.Tensor:
    """int8 [Co,k,k,Ci] of a stride-2 conv (k odd) -> [Co,(k+1)/2,(k+1)/2,16]:
    the same conv over :func:`kernels.int8_quant.space_to_depth`'s layout,
    stride 1, padding (padding + 1) / 2 at the top and left. The kernel gets
    a zero first row and column (tap r of the conv is tap r + 1 = 2 r' + dy
    of the 2x2 blocks), so every product is one of the original conv's or
    zero, and the int32 sums are equal."""
    co, k, _, ci = w_q.shape
    w8 = F.pad(w_q, (0, 0, 1, 0, 1, 0))  # [Co, k+1, k+1, Ci]
    kb = (k + 1) // 2
    t = w8.reshape(co, kb, 2, kb, 2, ci).permute(0, 1, 3, 2, 4, 5).reshape(co, kb, kb, 4 * ci)
    return F.pad(t, (0, 16 - 4 * ci)).contiguous()


class QuantizedActivation(NamedTuple):
    """A conv input and its int8 copy, made once for the convs that read
    it: ``x_q`` ``channels_last`` in the layout K4 reads (x's own, or the
    stem's 2x2 blocks of pixels) and ``amax`` [N], the floored per-image
    max |x|."""

    x: torch.Tensor
    x_q: torch.Tensor
    amax: torch.Tensor


class Int8Conv2d(nn.Module):
    """A quantized conv: int8 weights ``weight_q`` [Co,kh,kw,Ci] (K-major,
    as NHWC reads them), their float32 per-channel maxima ``w_amax`` [Co]
    (the scale is ``w_amax / 127``) and optional float32 ``bias`` [Co],
    then the replaced conv's ``norm`` if it had one and a ReLU if
    ``relu`` (copied from the :class:`ConvNorm` it replaces), both applied
    by K4. K4 reads input channels in multiples of 16: the stem (3
    channels, 7x7/2) runs as a 4x4 stride-1 conv over 2x2 blocks of pixels
    of 16 channels (:func:`space_to_depth_weights`, ``weight_k``, made once
    here). Its float buffers stay float32 when the model is cast
    (``model.to(bf16)``); the output is in the input's dtype."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: int, padding: int,
                 norm: Optional[nn.Module] = None, relu: bool = False):
        super().__init__()
        q, amax = _quantize_weight(weight)
        self.register_buffer("weight_q", q)
        self.register_buffer("w_amax", amax)  # w_scale = w_amax * float32(1/127)
        self.register_buffer("bias", None if bias is None else bias.detach().float().clone())
        self.stride = stride
        self.padding = padding
        self.space_to_depth = takes_space_to_depth(q.shape[3], q.shape[1], stride, padding)
        # the weights of the space-to-depth conv: exact, zero products only
        self.register_buffer("weight_s2d", space_to_depth_weights(q) if self.space_to_depth else None,
                             persistent=False)
        self.norm = norm
        self.relu = relu

    @property
    def weight_k(self) -> torch.Tensor:
        """The weights K4 reads."""
        return self.weight_q if self.weight_s2d is None else self.weight_s2d

    def _apply(self, fn, recurse=True):
        keep = {n: b for n, b in self._buffers.items() if b is not None and b.is_floating_point()}
        super()._apply(fn, recurse)
        for n, b in keep.items():  # follow the device, not the dtype
            self._buffers[n] = b.to(fn(b.new_empty(0)).device)
        return self

    def quantize(self, x) -> QuantizedActivation:
        """``x`` in int8 as this conv reads it (K5 on the card, in one pass
        where ``x`` is an :class:`ActivationMax`, whose max its producer
        took); K4 reads NHWC, a no-op for the trunk's ``channels_last``
        maps."""
        x, amax = x if isinstance(x, ActivationMax) else (x, None)
        x_q, amax = int8_quantize(x.contiguous(memory_format=torch.channels_last), self.space_to_depth, amax)
        return QuantizedActivation(x, x_q, amax)

    def forward(self, x, residual: Optional[torch.Tensor] = None, with_max: bool = False):
        """``x``: a float tensor, its :class:`ActivationMax`, or its
        :class:`QuantizedActivation` from :meth:`quantize` (of this conv or
        one that reads the same layout). With ``residual`` (a bottleneck's
        shortcut, ``channels_last`` in the output's dtype) the output is
        ``relu(conv + residual)``, the block's. With ``with_max`` it
        returns the :class:`ActivationMax` of the output, its max taken by
        K4."""
        q = x if isinstance(x, QuantizedActivation) else self.quantize(x)
        scale = DequantScale(q.amax, self.w_amax)  # made in K4's epilogue
        norm = (None, None) if self.norm is None else (self.norm.weight, self.norm.bias)
        stride, padding, out_hw = self.stride, self.padding, None
        if self.space_to_depth:
            k = self.weight_q.shape[1]
            stride, padding = 1, (self.padding + 1) // 2
            out_hw = conv_out_hw(q.x.shape[2], q.x.shape[3], (k, k), self.stride, self.padding)
        out = int8_conv2d(q.x_q, self.weight_k, scale, self.bias, stride, padding, q.x.dtype, norm_weight=norm[0],
                          norm_bias=norm[1], relu=self.relu or residual is not None, out_hw=out_hw,
                          residual=residual, with_max=with_max)
        return ActivationMax(*out) if with_max else out


def quantized_conv_names(model: nn.Module, mode: str):
    """The names (in ``model``) of the convs ``mode`` quantizes: every conv
    of the ResNet trunk, stem included, for ``trunk`` and ``full``, and the
    FPN's laterals and outputs for ``full`` only (as
    ``deepemia_tpu/models/mask_rcnn.py:52-59``)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant_backbone must be one of {QUANT_MODES}, got {mode!r}")
    names = []
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Conv2d):
            continue
        in_trunk = ".bottom_up." in f".{name}."
        in_fpn = ".fpn_lateral" in f".{name}" or ".fpn_output" in f".{name}"
        if (mode in ("trunk", "full") and in_trunk) or (mode == "full" and in_fpn):
            names.append(name)
    return names


def quantize_backbone(model: nn.Module, mode: str,
                      weights: Optional[Dict[str, torch.Tensor]] = None) -> nn.Module:
    """Replaces the convs of ``mode`` (``none``, ``trunk`` or ``full``) by
    :class:`Int8Conv2d`, in place, and returns ``model``. A
    :class:`ConvNorm` hands on its norm and its ReLU (the stem's and each
    bottleneck's ``conv1`` and ``conv2``). Each is quantized
    from ``weights[name + ".weight"]`` (and its ``.bias``) where given,
    else from the conv's own weight: a bf16 model must be handed its
    float32 checkpoint, since the JAX package quantizes the float32
    parameter."""
    for name in quantized_conv_names(model, mode):
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        conv = getattr(parent, attr)
        if conv.groups != 1 or conv.dilation != (1, 1) or conv.stride[0] != conv.stride[1] \
                or conv.padding[0] != conv.padding[1]:
            raise ValueError(f"{name}: only square, undilated, ungrouped convs quantize")
        w = weights[f"{name}.weight"] if weights is not None else conv.weight
        b = None
        if conv.bias is not None:
            b = weights[f"{name}.bias"] if weights is not None else conv.bias
        norm, relu = (conv.norm, conv.relu) if isinstance(conv, ConvNorm) else (None, False)
        q = Int8Conv2d(w.detach().to(torch.float32).cpu(), None if b is None else b.cpu(), conv.stride[0],
                       conv.padding[0], norm, relu=relu)
        setattr(parent, attr, q.to(conv.weight.device))
    return model

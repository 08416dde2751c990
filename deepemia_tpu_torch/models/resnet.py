"""ResNet-50/101 trunk with frozen batch norm, Detectron2 parameter names.

The downsampling stride sits on each stage's first 1x1 conv (STRIDE_IN_1X1,
the Detectron2 / MSRA convention): converted checkpoints are only right with
the stride there, and the kernel shapes would not reveal a mismatch.
Callers run the trunk on NCHW tensors in ``torch.channels_last`` memory
format, so every feature map is NHWC in memory.

A :class:`ConvNorm` applies the ReLU that follows it where it is built
with ``relu``, and a block's ``conv3`` the block's ``relu(y + shortcut)``
where it is handed the shortcut. Int8 serving (``models/quant.py``) swaps
each for a module that applies its norm, the shortcut and the ReLU in the
int8 conv's epilogue and whose ``quantize`` makes the int8 copy of an
input: a block hands its input to ``conv1`` and ``shortcut`` as
``conv1.quantize`` made it, quantized once (a float conv's ``quantize``
returns the input itself). There ``conv1``, ``conv2`` and ``conv3`` also
return their output's per-image max (``with_max``: an
:class:`ActivationMax`, which a float conv does not make), so that the
conv that reads the output quantizes it in one pass; a block's output,
and with ``with_max`` the trunk's levels, are then
:class:`ActivationMax`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class ActivationMax(NamedTuple):
    """A feature map of int8 serving beside its floored per-image max
    |x| [N] (float32), taken by the conv that produced it, for the conv
    that quantizes it next."""

    x: torch.Tensor
    amax: torch.Tensor


def feature_map(x) -> torch.Tensor:
    """The map of ``x``: a tensor, or an :class:`ActivationMax`."""
    return x.x if isinstance(x, ActivationMax) else x


class FrozenBatchNorm(nn.Module):
    """Per-channel affine y = x * weight + bias (batch norm with its
    statistics folded in), in the dtype of ``x``: float32 master weights
    under bf16 compute keep the trunk in bf16, as Flax's ``dtype`` does."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(num_features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return x * w + self.bias.to(x.dtype).view(1, -1, 1, 1)


class ConvNorm(nn.Conv2d):
    """Bias-free conv followed by its ``norm`` (Detectron2's Conv2d with a
    norm attached) and, with ``relu``, a ReLU; given a ``residual``, the
    bottleneck's ``relu(y + residual)`` instead. ``with_max`` is int8
    serving's request for the output's max: a float conv returns the
    output alone."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0, relu: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.norm = FrozenBatchNorm(cout)
        self.relu = relu

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """The input as this conv reads it: ``x`` itself."""
        return x

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None, with_max: bool = False) -> torch.Tensor:
        y = self.norm(super().forward(x))
        if residual is not None:
            return F.relu(y + residual)
        return F.relu(y) if self.relu else y


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with an optional projection shortcut."""

    def __init__(self, cin: int, cout: int, bottleneck: int, stride: int = 1):
        super().__init__()
        self.shortcut = (
            ConvNorm(cin, cout, 1, stride=stride)
            if cin != cout or stride != 1
            else None
        )
        self.conv1 = ConvNorm(cin, bottleneck, 1, stride=stride, relu=True)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, padding=1, relu=True)
        self.conv3 = ConvNorm(bottleneck, cout, 1)

    def forward(self, x):
        """``x``: the block's input, in int8 serving the previous block's
        :class:`ActivationMax` where it has one."""
        x_in = self.conv1.quantize(x)  # int8 serving: one int8 copy for conv1 and shortcut
        shortcut = feature_map(x) if self.shortcut is None else self.shortcut(x_in)
        y = self.conv2(self.conv1(x_in, with_max=True), with_max=True)
        return self.conv3(y, residual=shortcut, with_max=True)  # relu(conv3(y) + shortcut)


class Stem(nn.Module):
    """7x7/2 conv + frozen BN + ReLU + 3x3/2 max-pool (pad 1)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvNorm(3, 64, 7, stride=2, padding=3, relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)


class ResNet(nn.Module):
    """ResNet-{50,101} returning {res2..res5} (strides 4/8/16/32)."""

    def __init__(self, depth: int = 50):
        super().__init__()
        self.stem = Stem()
        cin = 64
        channels = (256, 512, 1024, 2048)
        bottlenecks = (64, 128, 256, 512)
        for stage_idx, (n_blocks, cout, bn) in enumerate(
            zip(STAGE_BLOCKS[depth], channels, bottlenecks)
        ):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage_idx > 0 and b == 0 else 1
                blocks.append(BottleneckBlock(cin, cout, bn, stride))
                cin = cout
            self.add_module(f"res{stage_idx + 2}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, with_max: bool = False) -> Dict[str, torch.Tensor]:
        """With ``with_max``, int8 serving's levels keep their maxima
        (:class:`ActivationMax`), for an int8 FPN."""
        x = self.stem(x)
        feats = {}
        for name in ("res2", "res3", "res4", "res5"):
            x = getattr(self, name)(x)
            feats[name] = x if with_max else feature_map(x)
        return feats

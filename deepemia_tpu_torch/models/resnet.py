"""ResNet-50/101 trunk with frozen batch norm, Detectron2 parameter names.

The downsampling stride sits on each stage's first 1x1 conv (STRIDE_IN_1X1,
the Detectron2 / MSRA convention): converted checkpoints are only right with
the stride there, and the kernel shapes would not reveal a mismatch.
Callers run the trunk on NCHW tensors in ``torch.channels_last`` memory
format, so every feature map is NHWC in memory.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class FrozenBatchNorm(nn.Module):
    """Per-channel affine y = x * weight + bias (batch norm with its
    statistics folded in)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(num_features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class ConvNorm(nn.Conv2d):
    """Bias-free conv followed by its ``norm`` (Detectron2's Conv2d with a
    norm attached)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.norm = FrozenBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with an optional projection shortcut."""

    def __init__(self, cin: int, cout: int, bottleneck: int, stride: int = 1):
        super().__init__()
        self.shortcut = (
            ConvNorm(cin, cout, 1, stride=stride)
            if cin != cout or stride != 1
            else None
        )
        self.conv1 = ConvNorm(cin, bottleneck, 1, stride=stride)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, padding=1)
        self.conv3 = ConvNorm(bottleneck, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        return F.relu(y + shortcut)


class Stem(nn.Module):
    """7x7/2 conv + frozen BN + ReLU + 3x3/2 max-pool (pad 1)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvNorm(3, 64, 7, stride=2, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)


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

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        feats = {}
        for name in ("res2", "res3", "res4", "res5"):
            x = getattr(self, name)(x)
            feats[name] = x
        return feats

"""Feature Pyramid Network over the ResNet trunk (Detectron2's ``backbone``:
``bottom_up`` trunk + ``fpn_lateral*`` / ``fpn_output*`` convs).

1x1 laterals on res2..res5, a nearest-neighbour x2 top-down path, 3x3
output convs -> p2..p5, and p6 as the stride-2 subsample of p5 (the
RPN-only level).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepemia_tpu_torch.models.resnet import ResNet

_IN_CHANNELS = {2: 256, 3: 512, 4: 1024, 5: 2048}


class FPNBackbone(nn.Module):
    """[B,3,H,W] normalised pixels -> {p2..p6: [B,C,h,w]}."""

    def __init__(self, depth: int = 50, out_channels: int = 256):
        super().__init__()
        self.bottom_up = ResNet(depth)
        for lvl, cin in _IN_CHANNELS.items():
            self.add_module(f"fpn_lateral{lvl}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(
                f"fpn_output{lvl}", nn.Conv2d(out_channels, out_channels, 3, padding=1)
            )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        # int8 serving's int8 laterals (``full``) take the levels with the maxima the trunk took
        feats = self.bottom_up(x, with_max=not isinstance(self.fpn_lateral2, nn.Conv2d))
        td = getattr(self, "fpn_lateral5")(feats["res5"])
        tops = {5: td}
        for lvl in (4, 3, 2):
            lateral = getattr(self, f"fpn_lateral{lvl}")(feats[f"res{lvl}"])
            td = lateral + F.interpolate(td, scale_factor=2, mode="nearest")
            tops[lvl] = td
        out = {f"p{lvl}": getattr(self, f"fpn_output{lvl}")(tops[lvl]) for lvl in (2, 3, 4, 5)}
        out["p6"] = out["p5"][:, :, ::2, ::2]
        return out

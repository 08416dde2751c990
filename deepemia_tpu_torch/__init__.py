"""PyTorch / CUDA port of deepEMIA: tiled Mask R-CNN serving, the
inference pipeline and training.

The package mirrors the JAX package's module layout (``config/``,
``data/``, ``models/``, ``ops/``, ``kernels/``, ``native/``,
``inference/``, ``train/``, ``tools/``, ``utils/``) so every module has one
counterpart. It imports ``torch``, ``numpy`` and ``scipy`` only. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from deepemia_tpu_torch.version import VERSION_INFO, __version__  # noqa: F401


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` names
    another. Raises when CUDA is asked for (explicitly or by default) and
    absent — never a silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev

"""Wrapper of the windowed-sum kernel (``csrc/window_sum.cu``, K3).

K3 replaces the Pallas kernel ``consume`` of the JAX package's
``tools/bench_decouple.py``: the float32 sum of the window
``feat[0:8, 0:16, :]`` of a row-major [H,W,C] feature map, as a [1,1]
float32 tensor. A CPU tensor takes the plain version
(:func:`window_sum_plain`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from deepemia_tpu_torch.kernels import _build
from deepemia_tpu_torch.kernels.roi_align import LaunchCounter

WINDOW = (8, 16)  # rows, columns
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

counter = LaunchCounter()  # K3, window_sum on CUDA tensors


def window_sum_plain(feat: torch.Tensor) -> torch.Tensor:
    """[H,W,C] -> [1,1] float32 sum of the [8,16,C] window."""
    rows, cols = WINDOW
    return feat[:rows, :cols].float().sum().reshape(1, 1)


def _library():
    fn = _build.load("window_sum").window_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    return fn


def window_sum(feat: torch.Tensor) -> torch.Tensor:
    """[H,W,C] float32 or bfloat16 -> [1,1] float32 sum of the window
    ``feat[0:8, 0:16, :]``. On the card the kernel reads a row-major
    operand: a view of another layout (a transpose) is copied first."""
    if feat.device.type == "cpu":
        return window_sum_plain(feat)
    if feat.device.type != "cuda":
        raise ValueError(f"window_sum: no kernel for device {feat.device}")
    rows, cols = WINDOW
    if feat.ndim != 3 or feat.dtype not in _DTYPE_CODE:
        raise ValueError(f"window_sum takes [H,W,C] float32 or bfloat16, got {tuple(feat.shape)} {feat.dtype}")
    h, w, c = feat.shape
    if h < rows or w < cols:
        raise ValueError(f"window_sum: feature map {h}x{w} is smaller than the {rows}x{cols} window")
    feat = feat.contiguous()
    out = torch.empty((1, 1), dtype=torch.float32, device=feat.device)
    status = _library()(
        feat.data_ptr(), h, w, c, rows, cols, _DTYPE_CODE[feat.dtype], out.data_ptr(),
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"window_sum launch failed: CUDA error {status}")
    counter.launches += 1
    return out

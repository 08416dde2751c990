"""Wrapper of the CUDA RoIAlign forward (``csrc/roi_align_fwd.cu``).

The kernel replaces the JAX package's Pallas ``roi_align_pallas``; its
plain counterpart is ``models/roi_align.py:multilevel_roi_align``. The
wrapper checks what the kernel takes, allocates the output, launches on
PyTorch's current stream and raises on a nonzero launch status. It never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from deepemia_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = "roi_align_fwd"


class LaunchCounter:
    """Counts kernel launches (one per wrapper call that reaches the
    kernel)."""

    def __init__(self):
        self.launches = 0


counter = LaunchCounter()


def _library():
    lib = _build.load(_LIB)
    fn = lib.roi_align_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 8
        + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7
        + [ctypes.c_void_p]
    )
    return fn


def _require_cuda(tensors: Sequence[torch.Tensor]) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"roi_align_cuda takes CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"roi_align_cuda: tensors on {t.device} and {dev}")


def _check(feats, boxes, levels, batch_idx, valid, out_dtype) -> None:
    if len(feats) != 4:
        raise ValueError(f"roi_align_cuda takes the 4 levels p2..p5, got {len(feats)}")
    dtype = feats[0].dtype
    if dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(
            f"roi_align_cuda: features {dtype} / output {out_dtype} must be float32 or bfloat16"
        )
    b, _, _, c = feats[0].shape
    if c % 2:
        raise ValueError(f"roi_align_cuda: channel count {c} must be even")
    for f in feats:
        if f.ndim != 4 or f.shape[0] != b or f.shape[3] != c or f.dtype != dtype:
            raise ValueError(
                f"roi_align_cuda: each level must be [B,H,W,C] = [{b},H,W,{c}] "
                f"{dtype}, got {tuple(f.shape)} {f.dtype}"
            )
        if not f.is_contiguous():
            raise ValueError(
                "roi_align_cuda: features must be NHWC-contiguous; permute a "
                "channels_last [B,C,H,W] tensor with .permute(0, 2, 3, 1)"
            )
        if f.data_ptr() % (2 * f.element_size()):
            raise ValueError("roi_align_cuda: feature rows must be 2-element aligned")
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or boxes.dtype != torch.float32 or not boxes.is_contiguous():
        raise ValueError("roi_align_cuda: boxes must be contiguous [N,4] float32")
    for name, t in (("levels", levels), ("batch_idx", batch_idx)):
        if t.shape != (n,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"roi_align_cuda: {name} must be contiguous [N] int32")
    if valid is not None and (valid.shape != (n,) or valid.dtype != torch.bool):
        raise ValueError("roi_align_cuda: valid must be [N] bool")


def roi_align_cuda(
    feats: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    batch_idx: torch.Tensor,
    valid: torch.Tensor | None,
    output_size: int = 7,
    sampling_ratio: int = 2,
    adaptive_ratio: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """RoIAlign forward on the card.

    feats: p2..p5 as NHWC-contiguous [B,H,W,C] float32 or bfloat16;
    boxes [N,4] float32 image coordinates; levels [N] int32 (0 = p2);
    batch_idx [N] int32; valid [N] bool or None -> [N,out,out,C] in
    ``out_dtype``. Sums run in float32.
    """
    _require_cuda([*feats, boxes, levels, batch_idx] + ([] if valid is None else [valid]))
    _check(feats, boxes, levels, batch_idx, valid, out_dtype)
    fn = _library()
    n, c = boxes.shape[0], feats[0].shape[3]
    out = torch.empty((n, output_size, output_size, c), dtype=out_dtype, device=boxes.device)
    valid_u8 = None if valid is None else valid.contiguous().view(torch.uint8)
    shapes = [d for f in feats for d in (f.shape[1], f.shape[2])]
    status = fn(
        *[f.data_ptr() for f in feats],
        *shapes,
        boxes.data_ptr(),
        levels.data_ptr(),
        batch_idx.data_ptr(),
        None if valid_u8 is None else valid_u8.data_ptr(),
        out.data_ptr(),
        n,
        c,
        output_size,
        sampling_ratio,
        int(adaptive_ratio),
        _DTYPE_CODE[feats[0].dtype],
        _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(boxes.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"roi_align_fwd launch failed: CUDA error {status}")
    if n:
        counter.launches += 1
    return out

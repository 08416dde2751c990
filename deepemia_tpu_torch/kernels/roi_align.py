"""Wrappers of the CUDA RoIAlign kernels: the forward
(``csrc/roi_align_fwd.cu``, K1) and its adjoint (``csrc/roi_align_bwd.cu``,
K2).

K1 replaces the JAX package's Pallas ``roi_align_pallas``, K2 its
``roi_align_backward_pallas``; their plain counterparts are
``models/roi_align.py:multilevel_roi_align`` and
``multilevel_roi_align_backward``. Each wrapper checks what its kernel
takes, allocates the outputs, launches on PyTorch's current stream of the
operands' device with that device current (``torch.cuda.device``: a thread
may hold another GPU current), raises on a nonzero launch status and counts
the launch. Neither falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence

import torch

from deepemia_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 64  # samples per axis the kernels' tap tables hold (roi_align_geom.cuh)
_LIB = "roi_align_fwd"
_BWD_LIB = "roi_align_bwd"


class LaunchCounter:
    """Counts kernel launches (one per wrapper call that reaches the
    kernel). Tile shards and ensemble members launch from several threads,
    so a launch adds under a lock."""

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.launches += n


counter = LaunchCounter()  # K1, roi_align_cuda
bwd_counter = LaunchCounter()  # K2, roi_align_backward_cuda


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
        raise ValueError(f"RoIAlign kernels take CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"RoIAlign kernels: tensors on {t.device} and {dev}")


def _check(feats, boxes, levels, batch_idx, valid, out_dtype, samples_per_axis) -> None:
    if len(feats) != 4:
        raise ValueError(f"roi_align_cuda takes the 4 levels p2..p5, got {len(feats)}")
    dtype = feats[0].dtype
    if dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(
            f"roi_align_cuda: features {dtype} / output {out_dtype} must be float32 or bfloat16"
        )
    b, _, _, c = feats[0].shape
    _check_layout("roi_align_cuda", c, samples_per_axis)
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
        if f.data_ptr() % 16:
            raise ValueError("roi_align_cuda: feature levels must be 16-byte aligned")
    _check_rois("roi_align_cuda", boxes, levels, batch_idx)
    n = boxes.shape[0]
    if valid is not None and (valid.shape != (n,) or valid.dtype != torch.bool):
        raise ValueError("roi_align_cuda: valid must be [N] bool")


def _check_layout(fn: str, c: int, samples_per_axis: int) -> None:
    """What the kernels' layout takes: a lane owns 8 channels (one 16-byte
    bf16 load), and the tap tables hold at most MAX_TAPS samples per
    axis."""
    if c % 8:
        raise ValueError(f"{fn}: channel count {c} must be a multiple of 8")
    if not 1 <= samples_per_axis <= MAX_TAPS:
        raise ValueError(
            f"{fn}: output_size * sampling_ratio = {samples_per_axis} must be in [1, {MAX_TAPS}]"
        )


def _check_rois(fn: str, boxes, levels, batch_idx) -> None:
    n = boxes.shape[0]
    if boxes.shape != (n, 4) or boxes.dtype != torch.float32 or not boxes.is_contiguous():
        raise ValueError(f"{fn}: boxes must be contiguous [N,4] float32")
    for name, t in (("levels", levels), ("batch_idx", batch_idx)):
        if t.shape != (n,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous [N] int32")


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
    _check(feats, boxes, levels, batch_idx, valid, out_dtype, output_size * sampling_ratio)
    fn = _library()
    n, c = boxes.shape[0], feats[0].shape[3]
    out = torch.empty((n, output_size, output_size, c), dtype=out_dtype, device=boxes.device)
    valid_u8 = None if valid is None else valid.contiguous().view(torch.uint8)
    shapes = [d for f in feats for d in (f.shape[1], f.shape[2])]
    with torch.cuda.device(boxes.get_device()):
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
        counter.add()
    return out


def _bwd_library():
    lib = _build.load(_BWD_LIB)
    fn = lib.roi_align_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    return fn


def roi_align_backward_cuda(
    g: torch.Tensor,
    boxes: torch.Tensor,
    levels: torch.Tensor,
    batch_idx: torch.Tensor,
    level_shapes: Sequence[Sequence[int]],
    sampling_ratio: int = 2,
    adaptive_ratio: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """RoIAlign backward on the card: the adjoint of :func:`roi_align_cuda`
    for the same boxes, levels and image indices.

    g: the pooled cotangent, contiguous [N,out,out,C] float32 or bfloat16;
    level_shapes: (B,H,W) of p2..p5 -> the feature cotangents of p2..p5,
    NHWC-contiguous [B,H,W,C] in ``out_dtype`` (float32 or bfloat16): the
    gradient of the NHWC levels the forward read. Sums run in float32
    accumulators that the kernel's entry zeroes.
    """
    _require_cuda([g, boxes, levels, batch_idx])
    fn = "roi_align_backward_cuda"
    if g.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: cotangent {g.dtype} / output {out_dtype} must be float32 or bfloat16")
    n = boxes.shape[0]
    if g.ndim != 4 or g.shape[0] != n or g.shape[1] != g.shape[2] or not g.is_contiguous():
        raise ValueError(f"{fn}: g must be contiguous [N,out,out,C], got {tuple(g.shape)}")
    out_size, c = g.shape[1], g.shape[3]
    _check_layout(fn, c, out_size * sampling_ratio)
    if g.data_ptr() % 16:
        raise ValueError(f"{fn}: g must be 16-byte aligned")
    if len(level_shapes) != 4 or len({sh[0] for sh in level_shapes}) != 1:
        raise ValueError(f"{fn}: level_shapes must be (B,H,W) of the 4 levels p2..p5")
    _check_rois(fn, boxes, levels, batch_idx)
    lib = _bwd_library()
    sizes = [int(b * h * w * c) for b, h, w in level_shapes]
    acc = torch.empty(sum(sizes), dtype=torch.float32, device=g.device)
    out = acc if out_dtype == torch.float32 else torch.empty(sum(sizes), dtype=out_dtype, device=g.device)
    with torch.cuda.device(g.get_device()):
        status = lib(
            g.data_ptr(),
            boxes.data_ptr(),
            levels.data_ptr(),
            batch_idx.data_ptr(),
            acc.data_ptr(),
            out.data_ptr(),
            int(level_shapes[0][0]),
            *[int(d) for sh in level_shapes for d in sh[1:3]],
            n,
            c,
            out_size,
            sampling_ratio,
            int(adaptive_ratio),
            _DTYPE_CODE[g.dtype],
            _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"roi_align_bwd launch failed: CUDA error {status}")
    if n:
        bwd_counter.add()
    grads, start = [], 0
    for size, (b, h, w) in zip(sizes, level_shapes):
        grads.append(out[start : start + size].view(int(b), int(h), int(w), c))
        start += size
    return grads

"""RoIAlign (aligned=True): level assignment, the plain PyTorch forward and
backward, the autograd function over both, and the dispatch that sends CUDA
tensors to the hand-written kernels (``kernels/roi_align.py``).

Semantics (those of the JAX package's ``multilevel_roi_align`` and of its
fast-gradient custom VJP):

  * each box is pooled from one FPN level, floor(4 + log2(sqrt(area)/224))
    clamped to p2..p5;
  * aligned half-pixel offsets: level coordinates are ``box/stride - 0.5``;
  * a ``sampling_ratio``² sub-grid of bilinear samples per output bin,
    averaged. With ``adaptive_ratio`` an axis whose box extent is at most
    ``output_size`` cells collapses its sub-samples onto the bin centre,
    which reproduces the adaptive ceil(roi/out) sample count exactly for
    grids of 1 or 2 (every box on p2..p4; wider p5 boxes keep the 2x2 grid);
  * samples outside [-1, size] weigh zero, corner indices are clamped;
  * rows with ``valid`` False return zeros and get no gradient;
  * the gradient reaches the features only: box coordinates get none
    (proposals are detached in training, as Detectron2 does).

Features come as {level: [H,W,C]} for one image, or {level: [B,H,W,C]}
with a per-RoI ``batch_idx`` for a batch of images (one call covers a whole
tile batch or training batch).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deepemia_tpu_torch.models.anchors import STRIDES

POOLED_LEVELS = ("p2", "p3", "p4", "p5")
# RoIs pooled per step of the plain versions: bounds their gathered
# [chunk·P²·4, C] intermediate (~800 MB at 14x14, C=256, f32)
_CHUNK = 256


def assign_fpn_levels(
    boxes: torch.Tensor, min_level: int = 2, max_level: int = 5
) -> torch.Tensor:
    """[N,4] -> [N] int32 FPN level per box (canonical level 4 at 224 px)."""
    w = (boxes[:, 2] - boxes[:, 0]).clamp(min=0.0)
    h = (boxes[:, 3] - boxes[:, 1]).clamp(min=0.0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(4.0 + torch.log2(scale.clamp(min=1e-6) / 224.0))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def _unit_grid(p: int, device) -> torch.Tensor:
    """(k + 0.5) / p for k < p, float32. Divided in numpy: on CUDA, torch
    divides by a scalar as a multiply by its reciprocal, one rounding off
    the kernels' (and XLA's constant-folded) true division."""
    k = np.arange(p, dtype=np.float32)
    return torch.from_numpy((k + np.float32(0.5)) / np.float32(p)).to(device)


def sample_grid(
    boxes: torch.Tensor,
    lvl: torch.Tensor,
    output_size: int,
    sampling_ratio: int,
    adaptive_ratio: bool,
):
    """Sample coordinates (sx, sy) [N,P] in cells of each box's level
    (``lvl`` 0-based into p2..p5). The CUDA kernels evaluate the same
    expressions in the same order, without fused multiply-adds
    (``kernels/csrc/roi_align_geom.cuh``)."""
    p = output_size * sampling_ratio
    stride = torch.tensor(
        [STRIDES[nm] for nm in POOLED_LEVELS], dtype=torch.float32, device=boxes.device
    )[lvl.long()]
    scale = 1.0 / stride
    x0 = boxes[:, 0] * scale - 0.5
    y0 = boxes[:, 1] * scale - 0.5
    bw = (boxes[:, 2] - boxes[:, 0]) * scale
    bh = (boxes[:, 3] - boxes[:, 1]) * scale
    grid = _unit_grid(p, boxes.device)
    if adaptive_ratio:
        k = np.arange(p, dtype=np.float32)
        grid1 = (np.floor(k / np.float32(sampling_ratio)) + np.float32(0.5)) / np.float32(output_size)
        grid1 = torch.from_numpy(grid1).to(boxes.device)
        gx = torch.where((bw <= output_size)[:, None], grid1[None], grid[None])
        gy = torch.where((bh <= output_size)[:, None], grid1[None], grid[None])
    else:
        gx = gy = grid[None]
    return x0[:, None] + gx * bw[:, None], y0[:, None] + gy * bh[:, None]


def _axis_taps(s: torch.Tensor, size: torch.Tensor):
    """Bilinear taps along one axis: samples s [n,P] on an axis of ``size``
    [n,1] cells -> (low corner, high corner, fraction, in range), corners
    clamped to the axis."""
    i0 = torch.floor(s)
    frac = s - i0
    i0 = i0.long()
    lo = torch.minimum(i0.clamp(min=0), size - 1)
    hi = torch.minimum((i0 + 1).clamp(min=0), size - 1)
    ok = (s >= -1.0) & (s <= size.float())
    return lo, hi, frac, ok


def _taps(base, lh, lw, sx, sy):
    """Flat row indices [n,P,P,4] into the flattened pyramid and bilinear
    weights [n,P,P,4] (zero outside [-1, size]) of every sample's 4
    corners, in the order (y0x0, y0x1, y1x0, y1x1). Coincident clamped
    corners keep both weights."""
    xlo, xhi, fx, vx = _axis_taps(sx, lw[:, None])
    ylo, yhi, fy, vy = _axis_taps(sy, lh[:, None])

    def idx(yy, xx):  # [n,P],[n,P] -> [n,P,P]
        return base[:, None, None] + yy[:, :, None] * lw[:, None, None] + xx[:, None, :]

    idx4 = torch.stack([idx(ylo, xlo), idx(ylo, xhi), idx(yhi, xlo), idx(yhi, xhi)], dim=-1)
    wy0, wx0 = 1.0 - fy, 1.0 - fx
    w4 = torch.stack(
        [
            wy0[:, :, None] * wx0[:, None, :],
            wy0[:, :, None] * fx[:, None, :],
            fy[:, :, None] * wx0[:, None, :],
            fy[:, :, None] * fx[:, None, :],
        ],
        dim=-1,
    ) * (vy[:, :, None] & vx[:, None, :])[..., None]
    return idx4, w4


class _Layout:
    """Per-RoI geometry over a flattened [sum_l B·H_l·W_l, C] pyramid: the
    assigned level's offset of the RoI's image (``base``), the level's
    height and width, and the sample coordinates."""

    def __init__(self, level_shapes, boxes, batch_idx, output_size, sampling_ratio, adaptive_ratio):
        dev = boxes.device
        sizes = [int(np.prod(sh[:3])) for sh in level_shapes]
        self.offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.total = sum(sizes)
        heights = torch.tensor([sh[1] for sh in level_shapes], device=dev)
        widths = torch.tensor([sh[2] for sh in level_shapes], device=dev)
        lvl = (assign_fpn_levels(boxes) - 2).long()
        self.sx, self.sy = sample_grid(boxes, lvl, output_size, sampling_ratio, adaptive_ratio)
        self.lh, self.lw = heights[lvl], widths[lvl]
        offsets = torch.tensor(self.offsets, device=dev)
        self.base = offsets[lvl] + batch_idx.long() * self.lh * self.lw

    def taps(self, a: int, b: int):
        return _taps(self.base[a:b], self.lh[a:b], self.lw[a:b], self.sx[a:b], self.sy[a:b])


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sums run in float32, or float64 for float64 inputs (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _pool_rows(flat, idx4, w4, output_size, s, acc):
    """Bilinear samples of one chunk of RoIs, averaged per bin: -> [n,
    out, out, C] in ``acc``."""
    n = idx4.shape[0]
    c = flat.shape[1]
    shape6 = (n, output_size, s, output_size, s, 4)
    idx6 = idx4.reshape(shape6).permute(0, 1, 3, 2, 4, 5).reshape(-1)
    w6 = w4.reshape(shape6).permute(0, 1, 3, 2, 4, 5)
    w6 = w6.reshape(n * output_size * output_size, s * s * 4, 1)
    rows = flat[idx6].to(acc).reshape(n * output_size * output_size, s * s * 4, c)
    pooled = (rows * w6).sum(dim=1) / (s * s)
    return pooled.reshape(n, output_size, output_size, c)


def _batched(features: Dict[str, torch.Tensor], boxes, batch_idx):
    feats = [features[nm] for nm in POOLED_LEVELS]
    if batch_idx is None:
        feats = [f[None] for f in feats]
        batch_idx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
    return feats, batch_idx


def multilevel_roi_align(
    features: Dict[str, torch.Tensor],
    boxes: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    adaptive_ratio: bool = False,
    valid: torch.Tensor | None = None,
    batch_idx: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The plain PyTorch RoIAlign: features {p2..p5: [H,W,C]} (or
    [B,H,W,C] with ``batch_idx`` [N]), boxes [N,4] -> [N,out,out,C].

    Sums run in float32; the result is cast to ``out_dtype`` (default: the
    feature dtype)."""
    feats, batch_idx = _batched(features, boxes, batch_idx)
    out_dtype = feats[0].dtype if out_dtype is None else out_dtype
    acc = _acc_dtype(feats[0].dtype)
    n = boxes.shape[0]
    c = feats[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in feats], dim=0)
    geo = _Layout([f.shape for f in feats], boxes.float(), batch_idx, output_size,
                  sampling_ratio, adaptive_ratio)
    out = torch.empty((n, output_size, output_size, c), dtype=acc, device=boxes.device)
    for a in range(0, n, _CHUNK):
        b = min(a + _CHUNK, n)
        idx4, w4 = geo.taps(a, b)
        out[a:b] = _pool_rows(flat, idx4, w4, output_size, sampling_ratio, acc)
    if valid is not None:
        out = torch.where(valid[:, None, None, None], out, 0.0)
    return out.to(out_dtype)


def multilevel_roi_align_backward(
    g: torch.Tensor,
    boxes: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int, int]],
    batch_idx: torch.Tensor | None = None,
    sampling_ratio: int = 2,
    adaptive_ratio: bool = False,
    out_dtype: torch.dtype | None = None,
) -> List[torch.Tensor]:
    """The plain adjoint of :func:`multilevel_roi_align` (the plain
    version of kernel K2): the pooled cotangent g [N,out,out,C] and boxes
    [N,4] -> the feature cotangents of p2..p5, [B,H,W,C] each
    (``level_shapes`` gives (B,H,W) per level; B = 1 without
    ``batch_idx``).

    Every sample adds its 4 clamped-corner weights × g/s² into float32
    accumulators (``index_add_``; coincident corners add both weights),
    on the forward's sample grid, at the unbumped level. Results are cast
    to ``out_dtype`` (default: g's dtype)."""
    n, out_size = g.shape[0], g.shape[1]
    c = g.shape[-1]
    s = sampling_ratio
    p = out_size * s
    out_dtype = g.dtype if out_dtype is None else out_dtype
    acc = _acc_dtype(out_dtype)
    if batch_idx is None:
        batch_idx = torch.zeros(n, dtype=torch.int32, device=boxes.device)
    geo = _Layout(level_shapes, boxes.float(), batch_idx, out_size, s, adaptive_ratio)
    flat = torch.zeros((geo.total, c), dtype=acc, device=g.device)
    for a in range(0, n, _CHUNK):
        b = min(a + _CHUNK, n)
        idx4, w4 = geo.taps(a, b)
        m = b - a
        share = g[a:b].to(acc) / (s * s)  # every sub-sample of a bin gets g/s²
        share = share[:, :, None, :, None, :].expand(m, out_size, s, out_size, s, c)
        contrib = w4[..., None] * share.reshape(m, p, p, 1, c)  # [m,P,P,4,C]
        flat.index_add_(0, idx4.reshape(-1), contrib.reshape(-1, c))
    return [
        flat[o : o + sh[0] * sh[1] * sh[2]].reshape(*sh, c).to(out_dtype)
        for o, sh in zip(geo.offsets, level_shapes)
    ]


class RoIAlignFunction(torch.autograd.Function):
    """Multilevel RoIAlign with its adjoint: kernels K1 / K2 for CUDA
    tensors, the plain versions for CPU tensors.

    ``apply(boxes, batch_idx, valid, output_size, sampling_ratio,
    adaptive_ratio, out_dtype, p2, p3, p4, p5)`` with levels [B,H,W,C]
    (NHWC-contiguous on CUDA), ``batch_idx`` [N] int32 and ``valid`` [N]
    bool or None -> [N,out,out,C] in ``out_dtype`` (None: the feature
    dtype), sums in float32; rows with ``valid`` False are zeros and read
    nothing. The backward zeroes the cotangent of those rows, returns
    feature cotangents in the feature dtype and no gradient for the boxes
    (the JAX package's ``_mra_fast_grad``)."""

    @staticmethod
    def forward(ctx, boxes, batch_idx, valid, output_size, sampling_ratio, adaptive_ratio, out_dtype, *feats):
        dev = boxes.device
        boxes = boxes.float().contiguous()
        batch_idx = batch_idx.to(torch.int32).contiguous()
        levels = (assign_fpn_levels(boxes) - 2).contiguous()
        out_dtype = feats[0].dtype if out_dtype is None else out_dtype
        ctx.save_for_backward(boxes, batch_idx, levels, valid)
        ctx.config = (sampling_ratio, adaptive_ratio, [tuple(f.shape[:3]) for f in feats], feats[0].dtype)
        if dev.type == "cuda":
            from deepemia_tpu_torch.kernels.roi_align import roi_align_cuda

            return roi_align_cuda(
                list(feats), boxes, levels, batch_idx, valid,
                output_size=output_size, sampling_ratio=sampling_ratio,
                adaptive_ratio=adaptive_ratio, out_dtype=out_dtype,
            )
        if dev.type == "cpu":
            return multilevel_roi_align(
                dict(zip(POOLED_LEVELS, feats)), boxes, output_size, sampling_ratio,
                adaptive_ratio=adaptive_ratio, valid=valid, batch_idx=batch_idx, out_dtype=out_dtype,
            )
        raise ValueError(f"RoIAlignFunction: no RoIAlign for device {dev}")

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        boxes, batch_idx, levels, valid = ctx.saved_tensors
        sampling_ratio, adaptive_ratio, shapes, dtype = ctx.config
        if valid is not None:
            g = torch.where(valid[:, None, None, None], g, 0.0)
        if g.device.type == "cuda":
            from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda

            grads = roi_align_backward_cuda(
                g.contiguous(), boxes, levels, batch_idx, shapes,
                sampling_ratio=sampling_ratio, adaptive_ratio=adaptive_ratio, out_dtype=dtype,
            )
        else:
            grads = multilevel_roi_align_backward(
                g, boxes, shapes, batch_idx, sampling_ratio, adaptive_ratio, out_dtype=dtype
            )
        return (None,) * 7 + tuple(grads)


def roi_align_dispatch(
    features: Dict[str, torch.Tensor],
    boxes: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    adaptive_ratio: bool = False,
    valid: torch.Tensor | None = None,
    batch_idx: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Multilevel RoIAlign through :class:`RoIAlignFunction`: the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors, an error
    for anything else. Serving (with ``valid``), the pipeline and training
    take this one route; it is differentiable in the features."""
    feats, batch_idx = _batched(features, boxes, batch_idx)
    return RoIAlignFunction.apply(
        boxes, batch_idx, valid, output_size, sampling_ratio, adaptive_ratio, out_dtype, *feats
    )


def roi_align_level(
    features: torch.Tensor,
    boxes: torch.Tensor,
    stride: int,
    output_size: int = 7,
    sampling_ratio: int = 2,
    batch_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """RoIAlign from a single feature map (plain PyTorch; the training loss
    crops GT masks with it at stride 1, 28x28, C = 1).

    features [H,W,C] (or [B,H,W,C] with ``batch_idx`` [N]), boxes [N,4]
    XYXY in image coordinates -> [N,out,out,C] float32. Features of any
    dtype are gathered and then cast (bool masks need no float copy). The
    arithmetic is the JAX package's ``roi_align_level`` step for step, so a
    ``>= 0.5`` threshold on a 0/1 mask gives the same labels."""
    if batch_idx is None:
        features = features[None]
        batch_idx = torch.zeros(boxes.shape[0], dtype=torch.long, device=boxes.device)
    _, h, w, c = features.shape
    n = boxes.shape[0]
    s = sampling_ratio
    p = output_size * s
    boxes = boxes.float()
    scale = 1.0 / stride
    x0 = boxes[:, 0] * scale - 0.5
    y0 = boxes[:, 1] * scale - 0.5
    bw = (boxes[:, 2] * scale - 0.5) - x0
    bh = (boxes[:, 3] * scale - 0.5) - y0
    grid = _unit_grid(p, boxes.device)
    sx = x0[:, None] + grid[None, :] * bw[:, None]
    sy = y0[:, None] + grid[None, :] * bh[:, None]

    size_w = torch.full((1, 1), w, device=boxes.device)
    size_h = torch.full((1, 1), h, device=boxes.device)
    xlo, xhi, fx, vx = _axis_taps(sx, size_w)
    ylo, yhi, fy, vy = _axis_taps(sy, size_h)
    flat = features.reshape(-1, c)
    base = batch_idx.long() * (h * w)

    def corner(yy, xx):  # -> [n,P,P,C] float32
        rows = base[:, None, None] + yy[:, :, None] * w + xx[:, None, :]
        return flat[rows].float()

    wx0 = (1.0 - fx)[:, None, :, None]
    wx1 = fx[:, None, :, None]
    wy0 = (1.0 - fy)[:, :, None, None]
    wy1 = fy[:, :, None, None]
    out = (corner(ylo, xlo) * wx0 + corner(ylo, xhi) * wx1) * wy0 + (
        corner(yhi, xlo) * wx0 + corner(yhi, xhi) * wx1
    ) * wy1
    out = out * (vy[:, :, None] & vx[:, None, :])[..., None]
    return out.reshape(n, output_size, s, output_size, s, c).mean(dim=(2, 4))

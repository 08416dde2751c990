"""Multilevel RoIAlign (aligned=True): level assignment, the plain PyTorch
version, and the dispatch that sends CUDA tensors to the hand-written
kernel (``kernels/roi_align.py``).

Semantics (those of the JAX package's ``multilevel_roi_align``):

  * each box is pooled from one FPN level, floor(4 + log2(sqrt(area)/224))
    clamped to p2..p5;
  * aligned half-pixel offsets: level coordinates are ``box/stride - 0.5``;
  * a ``sampling_ratio``² sub-grid of bilinear samples per output bin,
    averaged. With ``adaptive_ratio`` an axis whose box extent is at most
    ``output_size`` cells collapses its sub-samples onto the bin centre,
    which reproduces the adaptive ceil(roi/out) sample count exactly for
    grids of 1 or 2 (every box on p2..p4; wider p5 boxes keep the 2x2 grid);
  * samples outside [-1, size] weigh zero, corner indices are clamped;
  * rows with ``valid`` False return zeros.

Features come as {level: [H,W,C]} for one image, or {level: [B,H,W,C]}
with a per-RoI ``batch_idx`` for a batch of images (one call covers a whole
tile batch).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from deepemia_tpu_torch.models.anchors import STRIDES

POOLED_LEVELS = ("p2", "p3", "p4", "p5")
# RoIs pooled per step of the plain version: bounds its gathered
# [chunk·P²·4, C] intermediate (~200 MB at 14x14, C=256, f32)
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


def sample_grid(
    boxes: torch.Tensor,
    lvl: torch.Tensor,
    output_size: int,
    sampling_ratio: int,
    adaptive_ratio: bool,
):
    """Sample coordinates (sx, sy) [N,P] in cells of each box's level
    (``lvl`` 0-based into p2..p5). The CUDA kernel evaluates the same
    expressions in the same order, without fused multiply-adds."""
    p = output_size * sampling_ratio
    stride = torch.tensor(
        [STRIDES[nm] for nm in POOLED_LEVELS], dtype=torch.float32, device=boxes.device
    )[lvl.long()]
    scale = 1.0 / stride
    x0 = boxes[:, 0] * scale - 0.5
    y0 = boxes[:, 1] * scale - 0.5
    bw = (boxes[:, 2] - boxes[:, 0]) * scale
    bh = (boxes[:, 3] - boxes[:, 1]) * scale
    # the grids are divided in numpy: on CUDA, torch divides by a scalar
    # as a multiply by its reciprocal, one rounding off the kernel's
    k = np.arange(p, dtype=np.float32)
    grid = torch.from_numpy((k + np.float32(0.5)) / np.float32(p)).to(boxes.device)
    if adaptive_ratio:
        grid1 = (np.floor(k / np.float32(sampling_ratio)) + np.float32(0.5)) / np.float32(output_size)
        grid1 = torch.from_numpy(grid1).to(boxes.device)
        gx = torch.where((bw <= output_size)[:, None], grid1[None], grid[None])
        gy = torch.where((bh <= output_size)[:, None], grid1[None], grid[None])
    else:
        gx = gy = grid[None]
    return x0[:, None] + gx * bw[:, None], y0[:, None] + gy * bh[:, None]


def _pool_rows(flat, base, lh, lw, sx, sy, output_size, s):
    """Bilinear samples of one chunk of RoIs from the flattened pyramid,
    averaged per bin: -> [n, out, out, C] float32."""
    n = sx.shape[0]
    xi0 = torch.floor(sx)
    yi0 = torch.floor(sy)
    fx = sx - xi0
    fy = sy - yi0
    xi0 = xi0.long()
    yi0 = yi0.long()
    lw_ = lw[:, None]
    lh_ = lh[:, None]
    xi0c = torch.minimum(xi0.clamp(min=0), lw_ - 1)
    xi1c = torch.minimum((xi0 + 1).clamp(min=0), lw_ - 1)
    yi0c = torch.minimum(yi0.clamp(min=0), lh_ - 1)
    yi1c = torch.minimum((yi0 + 1).clamp(min=0), lh_ - 1)
    vx = (sx >= -1.0) & (sx <= lw_.float())
    vy = (sy >= -1.0) & (sy <= lh_.float())

    def idx(yy, xx):  # [n,P],[n,P] -> [n,P,P]
        return base[:, None, None] + yy[:, :, None] * lw[:, None, None] + xx[:, None, :]

    idx4 = torch.stack(
        [idx(yi0c, xi0c), idx(yi0c, xi1c), idx(yi1c, xi0c), idx(yi1c, xi1c)], dim=-1
    )  # [n,P,P,4]
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
    c = flat.shape[1]
    shape6 = (n, output_size, s, output_size, s, 4)
    idx6 = idx4.reshape(shape6).permute(0, 1, 3, 2, 4, 5).reshape(-1)
    w6 = w4.reshape(shape6).permute(0, 1, 3, 2, 4, 5)
    w6 = w6.reshape(n * output_size * output_size, s * s * 4, 1)
    rows = flat[idx6].float().reshape(n * output_size * output_size, s * s * 4, c)
    pooled = (rows * w6).sum(dim=1) / (s * s)
    return pooled.reshape(n, output_size, output_size, c)


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
    feats = [features[nm] for nm in POOLED_LEVELS]
    if batch_idx is None:
        feats = [f[None] for f in feats]
        batch_idx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
    out_dtype = feats[0].dtype if out_dtype is None else out_dtype
    n = boxes.shape[0]
    s = sampling_ratio
    c = feats[0].shape[-1]
    dev = boxes.device

    flat = torch.cat([f.reshape(-1, c) for f in feats], dim=0)
    bsz = feats[0].shape[0]
    heights = torch.tensor([f.shape[1] for f in feats], device=dev)
    widths = torch.tensor([f.shape[2] for f in feats], device=dev)
    sizes = heights * widths * bsz
    offsets = torch.cumsum(sizes, 0) - sizes

    boxes = boxes.float()
    lvl = (assign_fpn_levels(boxes) - 2).long()
    sx, sy = sample_grid(boxes, lvl, output_size, s, adaptive_ratio)
    lh, lw = heights[lvl], widths[lvl]
    base = offsets[lvl] + batch_idx.long() * lh * lw

    out = torch.empty((n, output_size, output_size, c), dtype=torch.float32, device=dev)
    for a in range(0, n, _CHUNK):
        b = min(a + _CHUNK, n)
        out[a:b] = _pool_rows(
            flat, base[a:b], lh[a:b], lw[a:b], sx[a:b], sy[a:b], output_size, s
        )
    if valid is not None:
        out = torch.where(valid[:, None, None, None], out, 0.0)
    return out.to(out_dtype)


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
    """Multilevel RoIAlign: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, an error for anything else."""
    if boxes.device.type == "cuda":
        from deepemia_tpu_torch.kernels.roi_align import roi_align_cuda

        feats = [features[nm] for nm in POOLED_LEVELS]
        n = boxes.shape[0]
        if batch_idx is None:
            feats = [f[None] for f in feats]
            batch_idx = torch.zeros(n, dtype=torch.int32, device=boxes.device)
        boxes = boxes.float().contiguous()
        return roi_align_cuda(
            feats,
            boxes,
            assign_fpn_levels(boxes) - 2,
            batch_idx.to(torch.int32).contiguous(),
            valid,
            output_size=output_size,
            sampling_ratio=sampling_ratio,
            adaptive_ratio=adaptive_ratio,
            out_dtype=feats[0].dtype if out_dtype is None else out_dtype,
        )
    if boxes.device.type == "cpu":
        return multilevel_roi_align(
            features,
            boxes,
            output_size=output_size,
            sampling_ratio=sampling_ratio,
            adaptive_ratio=adaptive_ratio,
            valid=valid,
            batch_idx=batch_idx,
            out_dtype=out_dtype,
        )
    raise ValueError(f"roi_align_dispatch: no RoIAlign for device {boxes.device}")

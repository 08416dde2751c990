"""Run-length encoding of binary masks: column-major (Fortran order),
1-indexed (start, length) pairs.

The host half (numpy) encodes and decodes single masks (a whole-image
mask, or a mask's crop at its origin). The device half
produces fixed-capacity run tensors, so that only integers leave the card:
``rle_encode_batch`` for full-image masks, ``rle_encode_windowed`` for
instances pasted into a window at their box corner (O(K·S²) instead of
O(K·H·W)).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deepemia_tpu_torch.ops.masks import paste_masks


def rle_encode(mask: np.ndarray) -> List[int]:
    """Encode a binary mask into [start1, len1, start2, len2, ...]:
    column-major scan, 1-indexed starts."""
    mask = np.asarray(mask)
    return rle_encode_crop(mask, (0, 0), mask.shape[0])


def rle_encode_crop(crop: np.ndarray, origin, height: int) -> List[int]:
    """:func:`rle_encode` of a mask of ``height`` rows that is false outside
    ``crop`` [h,w], whose top-left pixel is ``origin`` (x, y): O(h·w). A run
    that ends on the image's last row and one that starts on the next
    column's first row are one run, as in the whole image."""
    crop = np.asarray(crop, bool)
    x0, y0 = int(origin[0]), int(origin[1])
    cols = np.zeros((crop.shape[1], crop.shape[0] + 2), np.int8)
    cols[:, 1:-1] = crop.T
    d = np.diff(cols, axis=1)
    sc, sr = np.nonzero(d == 1)  # column-major order
    _, er = np.nonzero(d == -1)
    if sc.size == 0:
        return []
    starts = (x0 + sc).astype(np.int64) * height + y0 + sr
    lengths = (er - sr).astype(np.int64)
    first = np.concatenate([[True], starts[1:] != starts[:-1] + lengths[:-1]])
    at = np.flatnonzero(first)
    out = np.empty(2 * at.size, np.int64)
    out[0::2] = starts[at] + 1
    out[1::2] = np.add.reduceat(lengths, at)
    return out.tolist()


def rle_decode(rle: Sequence[int], shape) -> np.ndarray:
    """Inverse of :func:`rle_encode`: a bool mask of ``shape``."""
    h, w = shape
    flat = np.zeros(h * w, dtype=bool)
    rle = list(rle)
    for start, length in zip(rle[0::2], rle[1::2]):
        flat[start - 1 : start - 1 + length] = True
    return flat.reshape(w, h).T


def rle_to_string(rle: Sequence[int]) -> str:
    """Space-separated string form used in the results CSV."""
    return " ".join(str(int(v)) for v in rle)


def _nth_marker_positions(is_start: torch.Tensor, is_end: torch.Tensor, k: int):
    """Positions of the first ``k`` True entries of each row of ``is_start``
    / ``is_end`` ([N,M] bool), ascending, and each row's start count
    (clamped to k). The running count is monotone and steps up exactly at a
    marker, so the j-th marker is the first index where it reaches j: one
    binary search per row over the cumulative sum. Rows with fewer than k
    markers pad with M."""
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=is_start.device)
    targets = targets.expand(is_start.shape[0], k).contiguous()
    cs = torch.cumsum(is_start, dim=1, dtype=torch.int32)
    ce = torch.cumsum(is_end, dim=1, dtype=torch.int32)
    st = torch.searchsorted(cs, targets, side="left").to(torch.int32)
    en = torch.searchsorted(ce, targets, side="left").to(torch.int32)
    return st, en, cs[:, -1].clamp(max=k)


def _runs(cols: torch.Tensor):
    """[N,A,B] 0/1 rows scanned row after row -> (is_start, is_end) [N,A*B]:
    a run starts at a 1 after a 0 and ends at a 1 before a 0, both within a
    row of B."""
    padded = F.pad(cols.to(torch.int8), (1, 1))
    d = padded[..., 1:] - padded[..., :-1]
    n = cols.shape[0]
    return (d[..., :-1] == 1).reshape(n, -1), (d[..., 1:] == -1).reshape(n, -1)


def _padded(starts: torch.Tensor, lengths: torch.Tensor, k: int, max_runs: int):
    if k < max_runs:
        starts = F.pad(starts, (0, max_runs - k))
        lengths = F.pad(lengths, (0, max_runs - k))
    return starts, lengths


def rle_encode_batch(masks: torch.Tensor, max_runs: int = 2048):
    """Masks [N,H,W] bool -> (starts, lengths) [N,max_runs] int32, n_runs
    [N] int32; starts 1-indexed column-major, zeros past ``n_runs``. A mask
    with more runs than ``max_runs`` reports ``n_runs = max_runs``."""
    n, h, w = masks.shape
    flat = masks.transpose(1, 2).reshape(n, 1, h * w)
    is_start, is_end = _runs(flat)
    k = min(max_runs, h * w)
    st, en, n_runs = _nth_marker_positions(is_start, is_end, k)
    ok = torch.arange(k, dtype=torch.int32, device=masks.device)[None, :] < n_runs[:, None]
    starts = torch.where(ok, st + 1, 0).to(torch.int32)
    lengths = torch.where(ok, en - st + 1, 0).to(torch.int32)
    return (*_padded(starts, lengths, k, max_runs), n_runs.to(torch.int32))


def rle_encode_windowed(
    probs: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    image_hw,
    max_runs: int = 2048,
    threshold: float = 0.5,
    window: int = 512,
):
    """Device RLE from per-instance windows: each instance's RoI
    probabilities paste into an S×S window at its box corner (2 px margin,
    clamped inside the image), and the window's runs map to global
    column-major coordinates, (x0 + wc)·H + (y0 + wr) + 1. A window column
    is shorter than an image column, so no run crosses into the next
    column. Instances whose box side exceeds S-4 report ``n_runs =
    max_runs``: the caller re-encodes them at full resolution.

    probs [K,P,P], boxes [K,4], valid [K] -> (starts, lengths) [K,max_runs]
    int32, n_runs [K] int32."""
    h, w = int(image_hw[0]), int(image_hw[1])
    s = int(min(window, h, w))
    k_cap = min(max_runs, s * s // 2 + 1)
    x0 = (torch.floor(boxes[:, 0]).to(torch.int32) - 2).clamp(0, w - s)
    y0 = (torch.floor(boxes[:, 1]).to(torch.int32) - 2).clamp(0, h - s)
    off = torch.stack([x0, y0, x0, y0], dim=1).float()
    fits = ((boxes[:, 2] - boxes[:, 0]) <= s - 4.0) & ((boxes[:, 3] - boxes[:, 1]) <= s - 4.0)
    mw = paste_masks(probs, boxes - off, s, s, threshold) & (valid & fits)[:, None, None]
    is_start, is_end = _runs(mw.transpose(1, 2))  # window columns as rows
    ws, we, nr = _nth_marker_positions(is_start, is_end, k_cap)
    ok = torch.arange(k_cap, dtype=torch.int32, device=probs.device)[None, :] < nr[:, None]
    g_start = (x0[:, None] + ws // s) * h + (y0[:, None] + ws % s)
    g_end = (x0[:, None] + we // s) * h + (y0[:, None] + we % s)
    starts = torch.where(ok, g_start + 1, 0).to(torch.int32)
    lengths = torch.where(ok, g_end - g_start + 1, 0).to(torch.int32)
    nr = torch.where(valid & ~fits, max_runs, nr).to(torch.int32)
    return (*_padded(starts, lengths, k_cap, max_runs), nr)

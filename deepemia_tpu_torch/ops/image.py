"""Image ops: pixel normalisation, the quality score behind adaptive
confidence, and the bilinear resize of the tile upscale."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Detectron2 R50/R101 zoo models take BGR input with these pixel stats.
PIXEL_MEAN_BGR = (103.53, 116.28, 123.675)
PIXEL_STD_BGR = (1.0, 1.0, 1.0)


def to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """[H,W,3] BGR -> [H,W] float32 luma (cv2 BGR2GRAY weights)."""
    img = image.float()
    if img.ndim == 2:
        return img
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def image_quality_score(image: torch.Tensor) -> torch.Tensor:
    """Quality in [0,1] = 0.4·brightness + 0.6·contrast, with the
    population standard deviation."""
    gray = to_grayscale(image)
    brightness = gray.mean() / 255.0
    contrast = gray.std(correction=0) / 128.0
    return (0.4 * brightness + 0.6 * contrast).clamp(0.0, 1.0)


def adaptive_threshold_scale(quality: torch.Tensor) -> torch.Tensor:
    """Confidence multiplier from image quality: <0.3 → 0.7, <0.5 → 0.85,
    else 1.0."""
    one = torch.ones_like(quality)
    return torch.where(
        quality < 0.3, 0.7 * one, torch.where(quality < 0.5, 0.85 * one, one)
    )


def resize_image(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of [H,W,C] or [N,H,W,C] to (height, width), float32.

    Half-pixel centres with edge renormalisation, and an antialiasing
    (triangle) filter on downscale — the semantics of
    ``jax.image.resize(..., "linear")``."""
    x = image.float()
    single = x.ndim == 3
    if single:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    down = height < h or width < w
    y = F.interpolate(
        x.permute(0, 3, 1, 2),
        size=(height, width),
        mode="bilinear",
        align_corners=False,
        antialias=down,
    ).permute(0, 2, 3, 1)
    return y[0] if single else y


def normalize_bgr(image: torch.Tensor) -> torch.Tensor:
    """Subtract the Detectron2 BGR pixel means."""
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32, device=image.device)
    std = torch.tensor(PIXEL_STD_BGR, dtype=torch.float32, device=image.device)
    return (image.float() - mean) / std

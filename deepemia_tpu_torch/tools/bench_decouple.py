"""Micro-benchmark of the windowed-sum kernel (K3) behind a conv chain.

    python -m deepemia_tpu_torch.tools.bench_decouple

One 3x3 conv 3->C, then four 3x3 convs C->C on a size² image (bf16,
``channels_last``, seeded weights) produce an [H,W,C] feature map that the
windowed-sum kernel consumes. Six variants put a different op between the
two: none (``no_consumer`` sums the map alone), ``direct``, a float32
conversion, a matrix product with the identity, a flip and a transpose.
Each variant accumulates 8 conv chains per call; after 2 warm-up calls, 8
timed calls give milliseconds per conv chain, printed beside the card's
name and power limit.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from deepemia_tpu_torch import resolve_device
from deepemia_tpu_torch.kernels.window_sum import window_sum


def _card(dev: torch.device) -> str:
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def variants(eye: torch.Tensor) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """Consumer variants of a feature map [H,W,C] -> f32 scalar."""

    def total(f):
        return f.sum().float()

    return {
        "no_consumer": total,
        "direct": lambda f: window_sum(f)[0, 0] + total(f),
        "f32_convert": lambda f: window_sum(f.float())[0, 0] + total(f),
        "identity_dot": lambda f: window_sum(torch.matmul(f, eye))[0, 0] + total(f),
        "flip": lambda f: window_sum(torch.flip(f, dims=(0,)))[0, 0] + total(f),
        "transpose": lambda f: window_sum(f.transpose(0, 1))[0, 0] + total(f),
    }


def conv_chain(dev: torch.device, size: int = 256, channels: int = 256, dtype: torch.dtype = torch.bfloat16):
    """The benchmark's seeded input and conv chain: (image [size,size,3],
    convs: image -> feature map [size,size,C], NHWC in memory, identity
    matrix [C,C])."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((size, size, 3)).astype(np.float32)).to(dev, dtype)
    k1 = torch.from_numpy(rng.standard_normal((3, 3, 3, channels)) * 0.1).float()
    k2 = torch.from_numpy(rng.standard_normal((3, 3, channels, channels)) * 0.06).float()
    # HWIO -> OIHW
    w1 = k1.permute(3, 2, 0, 1).to(dev, dtype).contiguous(memory_format=torch.channels_last)
    w2 = k2.permute(3, 2, 0, 1).to(dev, dtype).contiguous(memory_format=torch.channels_last)

    def convs(img):
        y = img.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
        y = F.conv2d(y, w1, padding=1)
        for _ in range(4):
            y = F.conv2d(y, w2, padding=1)
        return y[0].permute(1, 2, 0)

    return x, convs, torch.eye(channels, dtype=dtype, device=dev)


def main(
    device=None,
    size: int = 256,
    channels: int = 256,
    dtype: torch.dtype = torch.bfloat16,
    warmup: int = 2,
    reps: int = 8,
    steps: int = 8,
) -> Dict[str, Dict[str, float]]:
    """Run every variant; returns {variant: {"ms": per conv chain, "value":
    the last call's accumulated sum}}."""
    dev = resolve_device(device)
    x, convs, eye = conv_chain(dev, size, channels, dtype)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    card = _card(dev)
    results = {}
    with torch.inference_mode():
        for name, post in variants(eye).items():

            def prog():
                acc = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(steps):
                    acc = acc + post(convs(x + torch.tensor(float(i), dtype=dtype, device=dev)))
                return acc

            for _ in range(warmup):
                prog()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                value = float(prog())  # reads the result back, as the timed loop must
            ms = (time.perf_counter() - t0) / max(reps, 1) / steps * 1e3
            results[name] = {"ms": ms, "value": value}
            print(f"{name:14s} {ms:7.3f} ms per conv-chain ({card})", flush=True)
    return results


if __name__ == "__main__":
    main()

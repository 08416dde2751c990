"""Ablations of the first RoIAlign kernel design beside the package's
kernels K1 and K2, at the shapes of the serving and training paths.

    python -m deepemia_tpu_torch.tools.roi_align_ablation

Builds ``kernels/csrc/roi_align_ablation.cu`` (the first design, one block
per RoI and output row, with the modes its source note lists) and times,
on synthetic RoIs made from a seed:

  * serving, one 16-tile batch of 1024² inputs (p2..p5 [16,256..32,256]
    bf16): box stage 16,000 RoIs (about half invalid) at 7x7, mask stage
    1,600 RoIs at 14x14; the package kernel also with every valid RoI
    moved onto one 56 px box (a footprint that stays in L2) and onto one
    2 px box (one that stays in L1);
  * training, 2 x 512² (p2..p5 [2,128..16,256]): box stage 1,024 RoIs at
    7x7 and mask stage 256 at 14x14, bf16 cotangent, float32
    accumulators.

Every time is the median of CUDA-event times, each after a write that
evicts the L2 cache. Each line is one JSON object; the first names the
card and its power limit.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import numpy as np
import torch

from deepemia_tpu_torch.kernels import _build
from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda, roi_align_cuda
from deepemia_tpu_torch.models.roi_align import assign_fpn_levels

FWD_MODES = {0: "first design", 1: "loads removed", 2: "geometry hoisted", 3: "one block per RoI"}
BWD_MODES = {0: "first design", 1: "atomics removed", 2: "float2 atomics"}


def _time_ms(fn, reps: int = 15) -> float:
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rois(images: int, per_image: int, image_px: float, frac_valid: float, rng: np.random.Generator):
    """Boxes [N,4] (log-uniform sides 8-512 px, centres over the image),
    valid [N], batch_idx [N] on the card."""
    n = images * per_image
    ctr = rng.uniform(0.0, image_px, (n, 2))
    wh = np.exp(rng.uniform(math.log(8.0), math.log(512.0), (n, 2)))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    valid = rng.random(n) < frac_valid
    boxes[~valid] = 0.0
    bidx = np.repeat(np.arange(images, dtype=np.int32), per_image)
    return (torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda(), torch.from_numpy(bidx).cuda())


def main() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("roi_align_ablation times kernels on the card: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    lib = _build.load("roi_align_ablation")
    fwd, bwd = lib.ablate_fwd, lib.ablate_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p] * 2
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    records = [{"card": card}]
    print(json.dumps(records[0]), flush=True)

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    # serving: one 16-tile batch, bf16 in and out
    feats = [torch.randn(16, s, s, 256, device="cuda").to(torch.bfloat16) for s in (256, 128, 64, 32)]
    shapes = [d for f in feats for d in f.shape[1:3]]
    scale = max(float(f.float().abs().max()) for f in feats)
    for stage, per_image, out, frac in (("serving box", 1000, 7, 0.5), ("serving mask", 100, 14, 1.0)):
        boxes, valid, bidx = rois(16, per_image, 1024.0, frac, rng)
        levels = (assign_fpn_levels(boxes) - 2).contiguous()
        n = boxes.shape[0]
        res = torch.empty(n, out, out, 256, dtype=torch.bfloat16, device="cuda")
        vu8 = valid.view(torch.uint8)
        ref = roi_align_cuda(feats, boxes, levels, bidx, valid, out, 2, True, torch.bfloat16)
        rec = {"stage": stage, "n": n, "valid": int(valid.sum()), "out": out,
               "package_kernel_ms": _time_ms(lambda: roi_align_cuda(feats, boxes, levels, bidx, valid, out, 2,
                                                                     True, torch.bfloat16))}
        for mode, name in FWD_MODES.items():
            def run(mode=mode):
                st = fwd(mode, *[f.data_ptr() for f in feats], *shapes, boxes.data_ptr(), levels.data_ptr(),
                         bidx.data_ptr(), vu8.data_ptr(), res.data_ptr(), n, 256, out, 2, 1, stream)
                if st:
                    raise RuntimeError(f"ablate_fwd mode {mode}: CUDA error {st}")
            run()
            torch.cuda.synchronize()
            if mode != 1:
                err = float((res.float() - ref.float()).abs().max())
                if not err <= 1e-2 * scale:  # about one bf16 step of the largest feature
                    raise AssertionError(f"ablate_fwd mode {mode} disagrees with the package kernel: {err}")
            rec[f"mode {mode} ({name}) ms"] = _time_ms(run)
        # the package kernel with every valid RoI moved onto one box per
        # image: its footprint stays in L2 (56 px, dense) or in L1 (2 px)
        for name, box in (("one 56 px box", (500.0, 500.0, 556.0, 556.0)),
                          ("one 2 px box", (500.0, 500.0, 502.0, 502.0))):
            same = torch.where(valid[:, None], torch.tensor(box, device="cuda"), boxes).contiguous()
            same_lv = (assign_fpn_levels(same) - 2).contiguous()
            rec[f"package kernel, {name} per RoI ms"] = _time_ms(
                lambda: roi_align_cuda(feats, same, same_lv, bidx, valid, out, 2, True, torch.bfloat16))
        emit(rec)

    # training: 2 x 512², bf16 cotangent
    level_shapes = [(2, s, s) for s in (128, 64, 32, 16)]
    total = sum(b * h * w for b, h, w in level_shapes) * 256
    acc = torch.empty(total, dtype=torch.float32, device="cuda")
    for stage, per_image, out in (("training box", 512, 7), ("training mask", 128, 14)):
        boxes, _, bidx = rois(2, per_image, 512.0, 1.0, rng)
        levels = (assign_fpn_levels(boxes) - 2).contiguous()
        n = boxes.shape[0]
        g = torch.randn(n, out, out, 256, device="cuda").to(torch.bfloat16)
        sink = torch.empty(n * out * 128 * 2, dtype=torch.float32, device="cuda")
        ref = torch.cat([t.reshape(-1) for t in roi_align_backward_cuda(g, boxes, levels, bidx, level_shapes, 2,
                                                                         True, torch.float32)])
        rec = {"stage": stage, "n": n, "out": out,
               "package_kernel_ms": _time_ms(lambda: roi_align_backward_cuda(g, boxes, levels, bidx, level_shapes,
                                                                              2, True, torch.float32))}
        for mode, name in BWD_MODES.items():
            def run(mode=mode):
                st = bwd(mode, g.data_ptr(), boxes.data_ptr(), levels.data_ptr(), bidx.data_ptr(), acc.data_ptr(),
                         2, *[d for sh in level_shapes for d in sh[1:]], n, 256, out, 2, 1, sink.data_ptr(), stream)
                if st:
                    raise RuntimeError(f"ablate_bwd mode {mode}: CUDA error {st}")
            run()
            torch.cuda.synchronize()
            if mode != 1:
                err = float((acc - ref).abs().max())
                if not err <= 1e-5 * float(ref.abs().max()):
                    raise AssertionError(f"ablate_bwd mode {mode} disagrees with the package kernel: {err}")
            rec[f"mode {mode} ({name}) ms"] = _time_ms(run)
        emit(rec)
    return records


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``deepemia_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k3-times ROOT   # only K3's timings, see k3_times

Run from the root of a checkout on a machine with one NVIDIA H100 (the
CUDA toolkit's ``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``).
It builds the CUDA kernels from the sources in the checkout and then:

  1. prints the card's name and power limit, builds the kernels;
  2. holds the RoIAlign kernel against its plain PyTorch version at one
     1024² tile's shapes (box stage 1000 RoIs, about half invalid, 7x7;
     mask stage 100 RoIs, 14x14), in float32 and bfloat16, and times both;
     then on edge cases at 5x5 (the generic kernel instance), 7x7 and
     14x14 in both dtypes (``edge_rois``: elongated 700x4 px boxes, p5
     boxes of a 2048² whole-image pass wider than the output, boxes past
     the level edge and past [-1, size]; an all-invalid set; N = 0);
  3. serves three synthetic 2048² micrographs through ``TileEngine.infer``
     (Mask R-CNN R50-FPN, 2 classes, bf16, seeded random weights with the
     box regression zeroed, default engine settings: 512 px tiles, 0.1
     overlap, x2 upscale, 16-tile batches, native whole-image pass) and
     checks that every RoIAlign of that run went through the kernel;
  4. records the RoIAlign inputs of one real tile batch of that path and
     holds the kernel against the plain version on them (these are the
     timings in the kernel line), then times the stages of one tile batch;
  5. runs a small image through the engine in float32 on the card and on
     the CPU (the plain RoIAlign) and compares the detections;
  7. trains Mask R-CNN R50-FPN through ``train()`` (2 classes, 512² batches
     of 2 synthetic micrographs, bf16 compute over float32 master weights,
     Detectron2 capacities, seeded random init with zeroed residual norms):
     6 steps with a checkpoint every 3, then a second ``train()`` call to
     step 8 that resumes at 6; checks that every loss is finite, that the
     first step's update of every parameter matches torch's SGD on the CPU
     given the same weights and gradients, and that each step launched the
     RoIAlign forward (K1) and backward (K2) kernels exactly twice (box and
     mask stage); prints seconds per step and peak device memory;
  6. records the RoIAlign inputs and cotangents of one real training step
     (box stage 2x512 RoIs at 7x7, mask stage 2x128 at 14x14, C = 256) and
     holds K2 against its plain version on them, and on a seeded unit-scale
     cotangent, each in bf16 and float32; checks the adjoint identity
     <K1(F), G> = sum_l <F_l, K2(G)_l> on the card, and times K2, its plain
     version and K1 at these shapes; then K2 against its plain version and
     the adjoint identity on phase 2's edge cases, in both dtypes, N = 0,
     and an all-invalid set through ``RoIAlignFunction`` (zero rows, zero
     feature gradients);
  8. runs one float32 training step (128², same weights, batch and sampling
     draws) on the card and on the CPU (plain RoIAlign forward and backward)
     and compares the RPN outputs, the card's proposal selection given the
     CPU's RPN outputs, the losses and every parameter's gradient;
  9. serves three synthetic 2048² micrographs, written as uncompressed TIFF
     by this script with a 300x4 px scale bar and its label ("500 nm",
     "2 um" dark on bright, "1.5 um", glyphs pasted from the reader's atlas
     at 28 px) in the default scale-bar region, through ``run_inference``
     with no config when PyYAML is importable (the store's ``config.yaml``
     and a ``config/datasets/smoke.yaml`` that sets ``scale_bar_roi`` and
     one ``inference_overrides`` value, which must reach the pipeline), else
     through ``InferencePipeline`` under ``validate_config(default_config())``
     after checking that ``get_config`` names the file it cannot read
     (Mask R-CNN R50-FPN, 2 classes, bf16, the seeded phase-3
     weights saved as ``model_final_r50.pt``; the size heuristic, 512 px
     tiles with the x2 upscale the heuristic keeps or drops, multiscale at
     0.7/1.0/1.5/2.0, morphology postprocess, device RLE, native host
     measurements) to both CSVs; checks that every image was processed,
     that the reader read every drawn bar (the value exactly, micrometres
     per pixel within 2 % of value / 300),
     that the RLE rows are the valid instances and decode inside the image,
     that every measurement row belongs to one of them, and that every
     multilevel RoIAlign of the run launched the K1 kernel; holds K1
     against the plain RoIAlign on the first call of every pyramid shape
     and stage of that run (tile batches and whole-image passes of every
     scale) and times it there per launch; prints seconds per image and
     the pipeline's stage seconds;
     then runs one 256² image through the pipeline in float32 on the card
     and on the CPU and compares the two CSVs, and once more on the card
     with every RoIAlign box moved by 0.25 px, which the comparison must
     reject;
 11. the ensemble: phase 9's images and R50 checkpoint beside a seeded
     Mask R-CNN R101-FPN checkpoint (bf16, published widths), through
     ``InferencePipeline`` under the default configuration (ensemble on,
     small classes only; members R101 then R50, one after the other);
     checks that both members ran on every image, that every multilevel
     RoIAlign with RoIs launched K1 in both members, and that every bar was
     read; holds K1 against the plain RoIAlign at the R101 member's first
     shape of each stage; prints seconds per image, R101's trunk + FPN
     seconds per 16-tile batch of 1024² inputs, and the merged instance
     counts. ``python3 -c "import chip_smoke; chip_smoke.ensemble_only()"``
     runs phases 1 and 11 alone;
 10. holds the windowed-sum kernel (K3) against its plain version on the
     conv-chain output of its micro-benchmark and on edge cases
     (``window_sum_edge_cases``: the map exactly the window, C in {1, 3,
     8, 257}, a row pitch off 16 bytes, a base one element off, a
     transposed view, magnitudes 1e4 beside 1e-3), in bf16 and float32,
     printing the plan instance that ran; checks 20 launches bitwise
     equal; times K3, ``torch.sum`` and the empty kernel in turns, per call
     with CUDA events, on the host per call, and per launch on the device
     with ``torch.profiler``, and the plain version; runs the
     micro-benchmark's six variants
     (``deepemia_tpu_torch.tools.bench_decouple``) with K3's launch count
     reset before and read after.

Phase 7 runs before phase 6, whose inputs come from a training step, and
phase 11 before phase 10. K1's ``launches`` in the kernel line is the sum
of phases 3, 9 and 11, each counted from zero over its own run.
Float32 comparisons run with TF32 off for both cuDNN convolutions and
matrix products (``torch.backends.*.allow_tf32 = False``), set below.
Any failure ends the run with a nonzero exit and no result line. The last
lines of standard output are the kernel JSON line, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# kernel vs plain, relative to the largest magnitude the result can hold
# (K1: the largest feature, which bounds every bilinear average; K2: the
# largest entry of the plain result), with no absolute floor, so that a
# kernel writing zeros fails however small the values: float32 output
# differs by sums taken in another order (for K2, atomics in a varying
# order), bfloat16 output by at most one rounding step (2^-7 relative) of
# the bf16 result
F32_TOL = 1e-5
BF16_TOL = 1e-2
# |<K1(F),G> - sum_l <F_l,K2(G)_l>| over sum |F_l * K2(G)_l|, sums in f64:
# the pair shares one sample grid, so only f32 rounding separates them
ADJOINT_TOL = 1e-5
# card vs CPU training step (float32, TF32 off): RPN outputs to RPN_RTOL
# of each level's largest entry; losses to 1e-4 relative;
# each parameter's gradient to GRAD_TOL of its largest entry and the
# median tensor to GRAD_TOL_MEDIAN. Random weights put the class logits at
# ~1e2 (a class loss of ~29), so cuDNN's and the CPU's float32 sums differ
# by ~1e-4 of a tensor's largest gradient entry
RPN_RTOL = 1e-4
# proposal boxes the card selects from the CPU's RPN outputs vs the CPU's
PROPOSAL_TOL_PX = 1e-3
LOSS_RTOL = 1e-4
GRAD_TOL = 5e-3
GRAD_TOL_MEDIAN = 5e-4
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
PIPELINE_DIR = os.path.join(ROOT, "build", "chip_smoke_pipeline")
# K3 vs plain: both sum the window in float32, in other orders; relative to
# the sum of |x| over the window
K3_TOL = 1e-5
# card vs CPU pipeline (float32, TF32 off): the share of instances on each
# device with a partner on the other at mask IoU >= PIPE_MIN_IOU, and of
# measurement rows with a partner whose numbers all agree to 1e-3 relative.
# Random weights make the pipeline chaotic at rounding scale, so the two
# devices' CSVs are not identical; the limits sit between the sound
# readings and those of a planted fault (every RoIAlign box on the card
# moved by PIPE_FAULT_PX), which the phase replays on every run and must
# reject. The readings are in PERF.md (Findings)
PIPE_MIN_IOU = 0.95
PIPE_MATCH_SHARE = 0.95
PIPE_ROW_SHARE = 0.9
PIPE_FAULT_PX = 0.25
# the scale bars drawn into phase 9's and 11's micrographs: (label, value in
# micrometres, dark on bright), a BAR_LEN x 4 px bar, glyphs GLYPH_PX tall;
# the read value must be exact and um/px within BAR_RTOL of value / BAR_LEN
BARS = (("500 nm", 0.5, False), ("2 um", 2.0, True), ("1.5 um", 1.5, False))
BAR_LEN = 300
GLYPH_PX = 28
BAR_RTOL = 0.02
# the dataset YAML's scale-bar region (it contains the default region, where
# the bars are drawn) and its one inference override
SMOKE_ROI = {"x_start_factor": 0.68, "y_start_factor": 0.04, "width_factor": 1.0, "height_factor": 0.07}
SMOKE_OVERRIDE = {"postprocessing": {"size_heuristic_sample": 3}}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def time_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, each after a
    256 MB write that evicts the 50 MB L2 (the serving path reads its
    pyramid cold)."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def roi_work(feats, boxes, valid, batch_idx, out_size, out_dtype):
    """Bytes and float ops this RoIAlign call needs: every feature row its
    valid samples touch read once, the RoI tables read once, the output
    written once; 2 ops per corner weight and channel."""
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, sample_grid

    lvl = (assign_fpn_levels(boxes) - 2).long()
    sx, sy = sample_grid(boxes, lvl, out_size, 2, True)
    hs = torch.tensor([f.shape[1] for f in feats], device=boxes.device)
    ws = torch.tensor([f.shape[2] for f in feats], device=boxes.device)
    sizes = hs * ws * feats[0].shape[0]
    base = (torch.cumsum(sizes, 0) - sizes)[lvl] + batch_idx.long() * hs[lvl] * ws[lvl]
    h, w = hs[lvl][:, None], ws[lvl][:, None]

    def corners(s, size):
        i0 = torch.floor(s).long()
        ok = (s >= -1.0) & (s <= size.float())
        lo = torch.minimum(i0.clamp(min=0), size - 1)
        hi = torch.minimum((i0 + 1).clamp(min=0), size - 1)
        return torch.stack([lo, hi], -1), ok

    yc, vy = corners(sy, h)  # [N,P,2]
    xc, vx = corners(sx, w)
    keys = base[:, None, None, None, None] + yc[:, :, :, None, None] * w[:, :, None, None, None] + xc[:, None, None, :, :]
    ok = (vy[:, :, None, None, None] & vx[:, None, None, :, None]) & valid[:, None, None, None, None]
    ok = ok.expand_as(keys)
    c = feats[0].shape[3]
    rows = int(torch.unique(keys[ok]).numel())
    samples = int((vy[:, :, None] & vx[:, None, :] & valid[:, None, None]).sum())
    n = boxes.shape[0]
    out_bytes = n * out_size * out_size * c * torch.empty((), dtype=out_dtype).element_size()
    in_bytes = rows * c * feats[0].element_size() + n * (16 + 4 + 4 + 1)
    flops = samples * 4 * c * 2
    bound_s = max((in_bytes + out_bytes) / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    by = "bytes" if (in_bytes + out_bytes) / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations"
    return bound_s * 1e3, by


def compare_roi_align(tag, feats, boxes, valid, batch_idx, out_size, dtype, reps=25, adaptive=True, timed=True):
    """Kernel vs plain on the same inputs; returns the record of one row
    (with ``timed=False`` only its error, and nothing is timed)."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_cuda
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, multilevel_roi_align

    levels = (assign_fpn_levels(boxes) - 2).contiguous()
    bidx = batch_idx.to(torch.int32).contiguous()

    def kernel():
        return roi_align_cuda(feats, boxes, levels, bidx, valid, output_size=out_size,
                              sampling_ratio=2, adaptive_ratio=adaptive, out_dtype=dtype)

    def plain():
        fd = dict(zip(("p2", "p3", "p4", "p5"), feats))
        return multilevel_roi_align(fd, boxes, out_size, 2, adaptive_ratio=adaptive, valid=valid,
                                    batch_idx=bidx, out_dtype=dtype)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = float((got.float() - ref.float()).abs().max())
    scale = max(float(f.float().abs().max()) for f in feats)
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * scale
    zeros = bool((got[~valid] == 0).all())
    line = (f"roi_align {tag}: N={boxes.shape[0]} valid={int(valid.sum())} out={out_size} "
            f"{str(dtype).split('.')[-1]} max_abs_err={err:.3g} tol={tol:.3g} invalid_rows_zero={zeros}")
    if not (err <= tol and zeros and math.isfinite(err)):
        raise AssertionError(f"{line}: kernel disagrees with plain")
    if not timed:
        print(line, flush=True)
        return dict(err=err)
    k_ms = time_ms(kernel, reps)
    p_ms = time_ms(plain, max(3, reps // 5))
    bound_ms, by = roi_work(feats, boxes, valid, bidx, out_size, dtype)
    print(f"{line} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
          f"share_of_bound={bound_ms / k_ms:.3f}", flush=True)
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by)


def synthetic_rois(n, image, frac_valid, gen):
    ctr = torch.rand(n, 2, generator=gen) * image * 1.1 - 0.05 * image
    wh = torch.exp(torch.empty(n, 2).uniform_(math.log(4), math.log(700), generator=gen))
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], 1)
    valid = torch.rand(n, generator=gen) < frac_valid
    boxes[~valid] = 0.0
    return boxes.cuda().contiguous(), valid.cuda()


def edge_rois():
    """RoIs on the pyramid of a 2048² whole-image pass (p2..p5 of 512..64
    cells) that stress the kernels' tap tables and footprints: elongated
    700x4 and 4x700 px boxes (p2, 175 x 1 cells), p5 boxes of 19-64 cells
    (wider than 7 and 14), boxes past the image edge and past [-1, size]
    (two of them wholly outside, whose samples all weigh zero). Every fifth
    row is invalid for K1."""
    rows = []
    for y in (10.0, 1000.0, 2040.0):
        rows += [[100.0, y, 800.0, y + 4.0], [y / 2, 300.0, y / 2 + 4.0, 1000.0]]
    rows += [[0.0, 0.0, 2048.0, 2048.0], [100.0, 200.0, 1900.0, 1300.0], [300.0, 300.0, 1000.0, 1000.0],
             [1024.0, 0.0, 2048.0, 600.0]]
    rows += [[-300.0, 100.0, 200.0, 400.0], [1900.0, -250.0, 2300.0, 150.0], [-40.0, -40.0, 60.0, 60.0],
             [2000.0, 2000.0, 2100.0, 2100.0], [-500.0, -500.0, -100.0, -100.0], [2200.0, 100.0, 2600.0, 500.0]]
    boxes = torch.tensor(rows, dtype=torch.float32, device="cuda")
    valid = torch.ones(len(rows), dtype=torch.bool, device="cuda")
    valid[::5] = False
    return boxes, valid


# output sizes of the edge cases: 7 and 14 take the kernels' unrolled
# instances, 5 their generic one
EDGE_OUTS = (5, 7, 14)


def edge_pyramid(dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(1, s, s, 256, device="cuda", generator=gen).to(dtype) for s in (512, 256, 128, 64)]


def phase_kernel_vs_plain():
    from deepemia_tpu_torch.kernels.roi_align import counter, roi_align_cuda

    gen = torch.Generator().manual_seed(1)
    shapes = [256, 128, 64, 32]  # p2..p5 of one 1024² model input
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats = [torch.randn(1, s, s, 256, generator=gen).to("cuda", dtype) for s in shapes]
        for n, out, frac in ((1000, 7, 0.5), (100, 14, 1.0)):
            boxes, valid = synthetic_rois(n, 1024.0, frac, gen)
            bidx = torch.zeros(n, dtype=torch.int32, device="cuda")
            rows[(n, dtype)] = compare_roi_align(f"tile {n}x{out}", feats, boxes, valid, bidx, out, dtype)
    # edge cases: elongated, wide p5, past the edges, all invalid, N = 0
    boxes, valid = edge_rois()
    bidx = torch.zeros(boxes.shape[0], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        feats = edge_pyramid(dtype, seed=2)
        for out in EDGE_OUTS:
            for tag, v in (("edge cases", valid), ("edge cases, all invalid", torch.zeros_like(valid))):
                rows[(tag, out, dtype)] = compare_roi_align(f"{tag} {out}x{out}", feats, boxes, v, bidx, out,
                                                            dtype, timed=False)
            before = counter.launches
            got = roi_align_cuda(feats, boxes[:0], bidx[:0], bidx[:0], valid[:0], out, 2, True, dtype)
            torch.cuda.synchronize()
            assert got.shape == (0, out, out, 256) and counter.launches == before, "N = 0"
            print(f"roi_align edge cases N=0 {out}x{out} {str(dtype).split('.')[-1]}: empty result, "
                  f"nothing launched", flush=True)
    return rows


def synthetic_micrograph(size: int, seed: int) -> np.ndarray:
    """A grey micrograph: noisy background and ~300 dark round particles."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    yy, xx = torch.meshgrid(
        torch.arange(size, device="cuda", dtype=torch.float32),
        torch.arange(size, device="cuda", dtype=torch.float32),
        indexing="ij",
    )
    img = 170.0 + 12.0 * torch.randn(size, size, device="cuda", generator=gen)
    ctr = torch.rand(300, 2, device="cuda", generator=gen) * size
    rad = 6.0 + 40.0 * torch.rand(300, device="cuda", generator=gen)
    for (cy, cx), r in zip(ctr.tolist(), rad.tolist()):
        y0, y1 = max(int(cy - 3 * r), 0), min(int(cy + 3 * r) + 1, size)
        x0, x1 = max(int(cx - 3 * r), 0), min(int(cx + 3 * r) + 1, size)
        d2 = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2
        img[y0:y1, x0:x1] -= 90.0 * torch.exp(-d2 / (2 * (0.6 * r) ** 2))
    gray = img.clamp(0, 255).round().to(torch.uint8)
    return gray[..., None].expand(-1, -1, 3).contiguous().cpu().numpy()


def sane_geometry(model):
    """Random weights decode degenerate boxes. Zero the box regression and
    scale the RPN deltas (|d| ~ 4e2 at random weights, so most proposals
    clip to nothing) and the mask logits (|l| ~ 3e1) down to trained
    magnitudes, as the parity tests do (tests/test_torch_heads.py)."""
    with torch.no_grad():
        model.roi_heads.box_predictor.bbox_pred.weight.zero_()
        model.roi_heads.box_predictor.bbox_pred.bias.zero_()
        model.proposal_generator["rpn_head"].anchor_deltas.weight.mul_(1e-2)
        model.roi_heads.mask_head.predictor.weight.mul_(1e-1)


def check_instances(inst, capacity):
    assert inst.boxes.shape == (capacity, 4) and inst.mask_probs.shape == (capacity, 28, 28)
    for t in (inst.boxes, inst.scores, inst.mask_probs):
        assert bool(torch.isfinite(t).all()), "non-finite detections"
    v = inst.valid
    assert bool(((inst.mask_probs[v] >= 0) & (inst.mask_probs[v] <= 1)).all())
    assert bool((inst.boxes[v][:, 2:] >= inst.boxes[v][:, :2]).all())


def phase_slice(images):
    from deepemia_tpu_torch.inference.engine import TileEngine, class_settings_from_config
    from deepemia_tpu_torch.kernels.roi_align import counter
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
    sane_geometry(model)
    engine = TileEngine(model)
    settings = class_settings_from_config({}, 2, device="cuda")
    counter.launches = 0
    secs = []
    for i, img in enumerate(images):
        (inst, quality), dt = sync_time(lambda img=img: engine.infer(img, settings))
        check_instances(inst, engine.capacity)
        secs.append(dt)
        print(
            f"slice image {i}: {img.shape[0]}x{img.shape[1]} valid_detections={int(inst.valid.sum())} "
            f"quality={float(quality):.4f} seconds={dt:.4f}",
            flush=True,
        )
    launches = counter.launches
    n_tiles = 25
    expected = len(images) * 2 * (1 + math.ceil(n_tiles / engine.tile_batch))
    print(
        f"slice: roi_align launches={launches} (expected {expected}: box + mask stage for the "
        f"whole-image pass and each {engine.tile_batch}-tile batch) "
        f"seconds_per_image={secs} first_image_includes_warmup=True",
        flush=True,
    )
    assert launches > 0, "the main path launched no RoIAlign kernel"
    assert launches == expected, (launches, expected)
    return model, engine, launches


def capture_tile_batch(model, engine, image):
    """RoIAlign inputs of the first tile batch of ``image``, as the engine
    builds them (outside the counted run)."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.ops import tiles as tile_ops
    from deepemia_tpu_torch.ops.image import resize_image

    calls = []
    real = heads_mod.roi_align_dispatch

    def record(features, boxes, **kw):
        calls.append((features, boxes, kw))
        return real(features, boxes, **kw)

    img = torch.as_tensor(image).cuda()
    grid = tile_ops.compute_tile_grid(img.shape[0], img.shape[1], engine.tile_size, engine.overlap_ratio)
    tiles = tile_ops.extract_tiles(img, grid)[: engine.tile_batch].float()
    ts_up = int(round(engine.tile_size * engine.upscale_factor))
    heads_mod.roi_align_dispatch = record
    try:
        feats = model.features_batched(resize_image(tiles, ts_up, ts_up))
        model.detect_batched(feats, (ts_up, ts_up))
    finally:
        heads_mod.roi_align_dispatch = real
    assert len(calls) == 2
    return calls


def phase_captured(calls):
    """Kernel vs plain on the recorded inputs: in the path's output dtype
    (the timed rows) and with float32 output, which holds the f32 sums to
    F32_TOL."""
    rows = []
    for (features, boxes, kw), tag in zip(calls, ("box", "mask")):
        feats = [features[k] for k in ("p2", "p3", "p4", "p5")]
        args = (feats, boxes, kw["valid"], kw["batch_idx"], kw["output_size"])
        rows.append(compare_roi_align(f"captured {tag} stage", *args, kw["out_dtype"]))
        compare_roi_align(f"captured {tag} stage, f32 output", *args, torch.float32, reps=3)
    return rows


def phase_stage_times(model, engine, image):
    """Seconds of each stage of one 16-tile batch and of the image-level
    steps, each ended by a synchronize."""
    from deepemia_tpu_torch.inference.detections import concat_instances, dedup_by_mask_iou
    from deepemia_tpu_torch.inference.engine import apply_class_thresholds, class_settings_from_config
    from deepemia_tpu_torch.models import anchors as anchor_lib
    from deepemia_tpu_torch.models.heads import fast_rcnn_inference_batched
    from deepemia_tpu_torch.models.rpn import select_proposals_batched
    from deepemia_tpu_torch.ops import tiles as tile_ops
    from deepemia_tpu_torch.ops.image import resize_image

    st = {}
    img = torch.as_tensor(image).cuda()
    grid = tile_ops.compute_tile_grid(img.shape[0], img.shape[1], engine.tile_size, engine.overlap_ratio)
    tiles = tile_ops.extract_tiles(img, grid)[: engine.tile_batch].float()
    ts_up = int(round(engine.tile_size * engine.upscale_factor))
    hw = (ts_up, ts_up)
    rh = model.roi_heads
    for rep in range(2):  # the second pass is the one kept (the first warms up)
        ups, st["upscale"] = sync_time(lambda: resize_image(tiles, ts_up, ts_up))
        feats, st["trunk_fpn"] = sync_time(lambda: model.features_batched(ups))
        (logits, regs), st["rpn_head"] = sync_time(lambda: model.proposal_generator["rpn_head"](feats))
        anchors = anchor_lib.all_anchors({k: (v.shape[2], v.shape[3]) for k, v in feats.items()}, "cuda")
        props, st["select_proposals_nms"] = sync_time(
            lambda: select_proposals_batched(logits, regs, anchors, hw))
        nhwc = {k: feats[k].permute(0, 2, 3, 1) for k in ("p2", "p3", "p4", "p5")}
        pooled, st["roi_align_box"] = sync_time(lambda: rh._pool(nhwc, props.boxes, props.valid, 7))
        (sc, dl), st["box_head"] = sync_time(lambda: rh.box_predictor(rh.box_head(pooled)))
        b = props.boxes.shape[0]
        (boxes, scores, classes, valid), st["fast_rcnn_nms"] = sync_time(
            lambda: fast_rcnn_inference_batched(sc.reshape(b, -1, sc.shape[-1]), dl.reshape(b, -1, dl.shape[-1]),
                                                props.boxes, props.valid, hw, 0.05))
        pooled_m, st["roi_align_mask"] = sync_time(lambda: rh._pool(nhwc, boxes, valid, 14))
        _, st["mask_head"] = sync_time(lambda: rh.mask_head(pooled_m))
        full, st["whole_image_pass"] = sync_time(lambda: engine._forward(img))
        merged, st["merge_thresholds"] = sync_time(lambda: apply_class_thresholds(
            concat_instances([full], engine.capacity), class_settings_from_config({}, 2, device="cuda"),
            torch.ones((), device="cuda")))
        _, st["mask_iou_dedup_nms"] = sync_time(
            lambda: dedup_by_mask_iou(merged, tuple(img.shape[:2]), engine.dedup_iou, stride=8))
    print("stage seconds (one 16-tile batch of 1024² inputs; image-level steps on 2048²): "
          + json.dumps({k: round(v, 6) for k, v in st.items()}), flush=True)


def phase_small_reference():
    """A 128² image, 64 px tiles x2 (9 tiles) + whole-image pass, float32:
    the engine on the card (CUDA kernel) against the engine on the CPU
    (plain RoIAlign), same weights."""
    from deepemia_tpu_torch.inference.engine import TileEngine, class_settings_from_config
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    cpu_model = build_model("R50", num_classes=2, use_bf16=False, device="cpu", seed=3)
    sane_geometry(cpu_model)
    gpu_model = build_model("R50", num_classes=2, use_bf16=False, device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    img = (np.random.default_rng(5).random((128, 128, 3)) * 255).astype(np.uint8)
    kw = dict(tile_size=64, tile_batch=4)
    cfg = {"class_specific_settings": {"class_0": {"confidence_threshold": 0.3}}}
    ref, _ = TileEngine(cpu_model, device="cpu", **kw).infer(img, class_settings_from_config(cfg, 2))
    got, _ = TileEngine(gpu_model, device="cuda", **kw).infer(img, class_settings_from_config(cfg, 2, device="cuda"))
    got = [t.cpu() for t in got]
    rv, gv = ref.valid, got[3]
    print(f"small reference: valid cpu={int(rv.sum())} gpu={int(gv.sum())}", flush=True)
    assert int(rv.sum()) > 0 and bool((rv == gv).all()), "valid sets differ"
    db = float((got[0][rv] - ref.boxes[rv]).abs().max())
    ds = float((got[1][rv] - ref.scores[rv]).abs().max())
    dm = float((got[4][rv] - ref.mask_probs[rv]).abs().max())
    print(f"small reference: max |d box|={db:.3g} px |d score|={ds:.3g} |d mask|={dm:.3g}", flush=True)
    assert bool((got[2][rv] == ref.classes[rv]).all())
    assert db <= 1e-2 and ds <= 1e-4 and dm <= 1e-3, (db, ds, dm)


def synthetic_train_batches(n_batches, seed, size=512, gmax=64, ims=2):
    """Training batches in the loader's format: grey micrographs (noisy
    background, 10-40 bright disks and ellipses each), GT boxes as the
    masks' tight bounds, 2 classes, masks rasterized in numpy and
    bit-packed as the loader sends them."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        img = np.clip(rng.normal(90.0, 15.0, (ims, size, size)), 0, 255)
        boxes = np.zeros((ims, gmax, 4), np.float32)
        classes = np.zeros((ims, gmax), np.int32)
        valid = np.zeros((ims, gmax), bool)
        masks = np.zeros((ims, gmax, size, size), bool)
        for i in range(ims):
            for j in range(min(int(rng.integers(10, 41)), gmax)):
                cy, cx = rng.uniform(20, size - 20, 2)
                ry, rx = rng.uniform(6, 30, 2) if rng.random() < 0.5 else (rng.uniform(6, 30),) * 2
                th = rng.uniform(0, np.pi)
                r = int(max(ry, rx)) + 1
                y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, size)
                x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, size)
                yy, xx = np.mgrid[y0:y1, x0:x1]
                u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
                v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
                win = (u / rx) ** 2 + (v / ry) ** 2 <= 1.0
                if not win.any():
                    continue
                masks[i, j, y0:y1, x0:x1] = win
                img[i, y0:y1, x0:x1][win] = rng.uniform(160, 230)
                ys, xs = np.nonzero(win)
                boxes[i, j] = [x0 + xs.min(), y0 + ys.min(), x0 + xs.max() + 1, y0 + ys.max() + 1]
                classes[i, j] = int(rng.integers(0, 2))
                valid[i, j] = True
        image = np.repeat(img.round().astype(np.uint8)[..., None], 3, axis=-1)
        batches.append(dict(image=image, gt_boxes=boxes, gt_classes=classes, gt_valid=valid,
                            gt_masks=np.packbits(masks, axis=-1)))
    return batches


def check_first_update(model, opt, before, lr, cfg):
    """The card's first optimizer step against torch's SGD on the CPU,
    applied to the same weights and the same gradients: from scratch every
    parameter trains, at the schedule's rate at count 0 (Detectron2's
    warmup factor 1e-3 times the base rate), with momentum 0.9 and weight
    decay 1e-4. Each updated weight must match to 2 float32 steps of its
    magnitude, so a tensor the card left in place fails wherever the CPU
    moved it."""
    params = dict(model.named_parameters())
    n_opt = sum(len(group["params"]) for group in opt.param_groups)
    assert n_opt == len(params), f"the optimizer holds {n_opt} of {len(params)} parameter tensors"
    assert math.isclose(lr, cfg.base_lr * 1e-3, rel_tol=1e-9), (lr, cfg.base_lr)
    missing = [n for n, p in params.items() if p.grad is None]
    assert not missing, f"no gradient for {missing[:5]}"
    ref = {n: before[n].cpu().clone().requires_grad_() for n in params}
    for n, p in params.items():
        ref[n].grad = p.grad.detach().cpu()
    sgd = torch.optim.SGD(list(ref.values()), lr=lr, momentum=0.9, weight_decay=1e-4)
    sgd.step()
    moved_card = moved_ref = 0
    for n, p in params.items():
        got, want, p0 = p.detach().cpu(), ref[n].detach(), before[n].cpu()
        moved_card += not torch.equal(got, p0)
        moved_ref += not torch.equal(want, p0)
        excess = (got - want).abs() - 2.0**-22 * torch.maximum(p0.abs(), want.abs())
        assert float(excess.max()) <= 0.0, f"{n}: the card's update differs from SGD on the CPU"
    print(f"train step 1 update: lr={lr:.6g}, {n_opt} tensors in the optimizer, all with gradients; "
          f"moved on the card {moved_card}, by SGD on the CPU {moved_ref}; every weight within "
          f"2 float32 steps of the CPU's update", flush=True)
    assert moved_ref > 0, "SGD on the CPU moved no tensor"


def phase_train(batches):
    """``train()`` from scratch to step 6 (checkpoints at 3 and 6), then a
    second call to step 8 that resumes at 6. Every train_step is wrapped
    to time it and to count its kernel launches."""
    import shutil

    from deepemia_tpu_torch.kernels.roi_align import bwd_counter, counter
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import trainer as trainer_mod

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg = trainer_mod.TrainConfig(checkpoint_every=3, log_every=1)
    steps = []
    real = trainer_mod.train_step

    def timed(model, opt, *args):
        first = not steps
        if first:
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            lr = opt.param_groups[0]["lr"]
        k1, k2 = counter.launches, bwd_counter.launches
        metrics, dt = sync_time(lambda: real(model, opt, *args))
        steps.append(dict(metrics, seconds=dt, k1=counter.launches - k1, k2=bwd_counter.launches - k2))
        if first:
            check_first_update(model, opt, before, lr, cfg)
        return metrics

    torch.cuda.reset_peak_memory_stats()
    counter.launches = bwd_counter.launches = 0
    trainer_mod.train_step = timed
    try:
        trainer_mod.train(batches, 2, TRAIN_DIR, cfg, max_steps_override=6)
        first = sorted(os.listdir(os.path.join(TRAIN_DIR, "ckpts")))
        final, _ = trainer_mod.train(batches, 2, TRAIN_DIR, cfg, max_steps_override=8)
    finally:
        trainer_mod.train_step = real
    launches = {"roi_align_fwd": counter.launches, "roi_align_bwd": bwd_counter.launches}
    peak = torch.cuda.max_memory_allocated()
    second = sorted(os.listdir(os.path.join(TRAIN_DIR, "ckpts")))
    for i, st in enumerate(steps):
        print("train step {}: ".format(i + 1) + json.dumps({k: round(v, 6) for k, v in st.items()}), flush=True)
    assert first == ["step_00000003.pt", "step_00000006.pt"], first
    assert len(steps) == 8 and second == ["step_00000006.pt", "step_00000008.pt"], (len(steps), second)
    for st in steps:
        assert all(math.isfinite(st[k]) for k in ("rpn_cls", "rpn_loc", "cls", "box", "mask", "total")), st
        assert st["k1"] == 2 and st["k2"] == 2, st
    assert launches == {"roi_align_fwd": 16, "roi_align_bwd": 16}, launches

    start = build_train_model("R50", 2, device="cpu", seed=cfg.seed)
    trainer_mod.zero_residual_norms(start)
    after = torch.load(final, map_location="cpu")["model"]
    moved = sum(not torch.equal(v, after[k]) for k, v in start.state_dict().items())
    # at the schedule's warmup rates (~1e-7) an update of a small gradient
    # is below one float32 step of its weight, so not every tensor moves
    print(f"train: {moved} of {len(after)} parameter tensors moved in 8 steps", flush=True)
    assert moved > 0
    steady = float(np.median([st["seconds"] for st in steps[2:]]))
    print(
        f"train: steady seconds/step={steady:.6f} (median of steps 3-8; R50-FPN, 2 x 512², bf16) "
        f"first_step_seconds={steps[0]['seconds']:.4f} resumed_first_step_seconds={steps[6]['seconds']:.4f} "
        f"peak_memory_allocated_GB={peak / 1e9:.4f} launches={launches} (expected 2 + 2 per step)",
        flush=True,
    )
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return launches, steady


def capture_train_step(batch):
    """The RoIAlign inputs (features, boxes, image indices) and cotangents
    of one training step as ``train()`` runs it (outside the counted run)."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import trainer as trainer_mod

    cfg = trainer_mod.TrainConfig()
    model = build_train_model("R50", 2, device="cuda", seed=cfg.seed)
    trainer_mod.zero_residual_norms(model)
    opt, sched = trainer_mod.make_optimizer(model.parameters(), cfg.base_lr, 8, cfg.warmup_iters, cfg.gamma)
    calls = []
    real = heads_mod.roi_align_dispatch

    def record(features, boxes, **kw):
        out = real(features, boxes, **kw)
        call = dict(feats=[features[k].detach() for k in ("p2", "p3", "p4", "p5")], boxes=boxes.detach().float(),
                    bidx=kw["batch_idx"].to(torch.int32), out=kw["output_size"])
        out.register_hook(lambda g: call.__setitem__("g", g.detach().contiguous()))
        calls.append(call)
        return out

    heads_mod.roi_align_dispatch = record
    try:
        trainer_mod.train_step(model, opt, sched, batch, cfg, trainer_mod.step_generator(cfg.seed, 0, "cuda"))
    finally:
        heads_mod.roi_align_dispatch = real
    torch.cuda.synchronize()
    assert [c["out"] for c in calls] == [7, 14] and all("g" in c for c in calls)
    return calls


def bwd_work(g, boxes, shapes, out_dtype):
    """Bytes and float ops of the function one K2 call computes: the
    cotangent and the RoI tables read once, the feature cotangents written
    once in ``out_dtype`` (the zeros of untouched cells are part of that
    write); 2 ops per corner weight and channel of every valid sample.
    Also returns the milliseconds at the memory rate of this design's own
    extra traffic: its float32 accumulators zeroed and written, and for a
    bf16 result read back before the cast."""
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, sample_grid

    n, out, c = g.shape[0], g.shape[1], g.shape[3]
    lvl = (assign_fpn_levels(boxes) - 2).long()
    sx, sy = sample_grid(boxes, lvl, out, 2, True)
    hs = torch.tensor([sh[1] for sh in shapes], device=boxes.device)[lvl][:, None]
    ws = torch.tensor([sh[2] for sh in shapes], device=boxes.device)[lvl][:, None]
    vy = (sy >= -1.0) & (sy <= hs.float())
    vx = (sx >= -1.0) & (sx <= ws.float())
    samples = int((vy[:, :, None] & vx[:, None, :]).sum())
    total = sum(b * h * w for b, h, w in shapes) * c
    out_bytes = total * torch.empty((), dtype=out_dtype).element_size()
    nbytes = g.numel() * g.element_size() + n * (16 + 4 + 4) + out_bytes
    acc_bytes = 2 * 4 * total + (4 * total if out_dtype == torch.bfloat16 else 0)
    if out_dtype == torch.float32:
        acc_bytes -= out_bytes  # the accumulators are the result
    flops = samples * 4 * c * 2
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), acc_bytes / HBM_BYTES_PER_S * 1e3


def compare_backward(tag, g, boxes, levels, bidx, shapes, dtype):
    """K2 against its plain version on the same inputs, tolerance relative
    to the plain result's max |dF| with no floor -> (kernel, plain, err,
    line); raises where they disagree."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    from deepemia_tpu_torch.models.roi_align import multilevel_roi_align_backward

    def kernel():
        return roi_align_backward_cuda(g, boxes, levels, bidx, shapes, 2, True, dtype)

    def plain():
        return multilevel_roi_align_backward(g, boxes, shapes, bidx, 2, True, dtype)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
    peak = max(float(b.float().abs().max()) for b in ref)
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * peak
    line = (f"roi_align_bwd {tag}: N={boxes.shape[0]} out={g.shape[1]} {str(dtype).split('.')[-1]} "
            f"max_abs_err={err:.3g} tol={tol:.3g} (max |dF| {peak:.4g})")
    if not (peak > 0 and err <= tol and math.isfinite(err)):
        raise AssertionError(f"{line}: kernel disagrees with plain")
    return kernel, plain, err, line


def check_adjoint(tag, f32, boxes, levels, bidx, g32):
    """<K1(F),G> = sum_l <F_l, K2(G)_l> on the card, float32 kernels,
    float64 sums, to ADJOINT_TOL of sum |F_l * K2(G)_l|."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda, roi_align_cuda

    shapes = [tuple(f.shape[:3]) for f in f32]
    fwd = roi_align_cuda(f32, boxes, levels, bidx, None, g32.shape[1], 2, True, torch.float32)
    bwd = roi_align_backward_cuda(g32, boxes, levels, bidx, shapes, 2, True, torch.float32)
    lhs = float((fwd.double() * g32.double()).sum())
    rhs = sum(float((a.double() * b.double()).sum()) for a, b in zip(f32, bwd))
    mag = sum(float((a.double() * b.double()).abs().sum()) for a, b in zip(f32, bwd))
    rel = abs(lhs - rhs) / max(mag, 1e-30)
    print(f"adjoint {tag}: <K1(F),G>={lhs:.9g} sum<F,K2(G)>={rhs:.9g} rel={rel:.3g} tol={ADJOINT_TOL}", flush=True)
    assert rel <= ADJOINT_TOL, (tag, rel)


def phase_backward(calls):
    """K2 against its plain version on the captured inputs and on a seeded
    unit-scale cotangent (bf16, the path's dtype, and float32), the
    adjoint identity, and times."""
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels

    rows = []
    for call, tag in zip(calls, ("box", "mask")):
        boxes, bidx, out = call["boxes"], call["bidx"], call["out"]
        levels = (assign_fpn_levels(boxes) - 2).contiguous()
        shapes = [tuple(f.shape[:3]) for f in call["feats"]]
        # the step's own cotangent (timed), then a seeded unit-scale one on
        # the same RoIs, each in the path's dtype (bf16: the bf16 load and
        # the cast to bf16) and in float32
        gen = torch.Generator(device="cuda").manual_seed(3)
        g_unit = torch.randn(call["g"].shape, device="cuda", generator=gen)
        for source, g_src in (("captured", call["g"]), ("unit", g_unit)):
            for dtype in (torch.bfloat16, torch.float32):
                g = g_src.to(dtype)
                kernel, plain, err, line = compare_backward(f"train {tag} stage, {source} cotangent", g, boxes,
                                                            levels, bidx, shapes, dtype)
                if source == "unit":
                    print(line, flush=True)
                    rows[-1]["err"] = max(rows[-1]["err"], err)
                    continue
                k_ms = time_ms(kernel, 25 if dtype == torch.bfloat16 else 5)
                p_ms = time_ms(plain, 5 if dtype == torch.bfloat16 else 3)
                bound_ms, by, extra_ms = bwd_work(g, boxes, shapes, dtype)
                print(f"{line} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
                      f"share_of_bound={bound_ms / k_ms:.3f} accumulator_traffic_ms={extra_ms:.4f}", flush=True)
                if dtype == torch.bfloat16:
                    rows.append(dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by))

        check_adjoint(f"{tag} stage", [f.float().contiguous() for f in call["feats"]], boxes, levels, bidx,
                      call["g"].float())
        valid = torch.ones(boxes.shape[0], dtype=torch.bool, device="cuda")
        compare_roi_align(f"train {tag} stage (K1)", call["feats"], boxes, valid, bidx, out,
                          call["feats"][0].dtype, reps=25)
    return rows


def phase_backward_edges():
    """K2 against its plain version on the edge-case RoIs of phase 2 (all
    rows; K2 has no valid mask), a seeded unit cotangent, bf16 and float32,
    with the adjoint identity; N = 0 gives zeros; an all-invalid set
    through ``RoIAlignFunction`` on the card gives zero rows and zero
    feature gradients."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_backward_cuda
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, roi_align_dispatch

    gen = torch.Generator().manual_seed(4)
    boxes, valid = edge_rois()
    n = boxes.shape[0]
    levels = (assign_fpn_levels(boxes) - 2).contiguous()
    bidx = torch.zeros(n, dtype=torch.int32, device="cuda")
    f32 = edge_pyramid(torch.float32, seed=5)
    shapes = [tuple(f.shape[:3]) for f in f32]
    for out in EDGE_OUTS:
        g_unit = torch.randn(n, out, out, 256, generator=gen).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            print(compare_backward(f"edge cases {out}x{out}", g_unit.to(dtype), boxes, levels, bidx, shapes,
                                   dtype)[3], flush=True)
        check_adjoint(f"edge cases {out}x{out}", f32, boxes, levels, bidx, g_unit)
        empty = roi_align_backward_cuda(g_unit[:0], boxes[:0], levels[:0], bidx[:0], shapes, 2, True, torch.float32)
        assert all(int(t.count_nonzero()) == 0 for t in empty), "N = 0 must give zero gradients"
        feats = {k: f.clone().requires_grad_(True) for k, f in zip(("p2", "p3", "p4", "p5"), f32)}
        pooled = roi_align_dispatch(feats, boxes, out, adaptive_ratio=True, valid=torch.zeros_like(valid),
                                    batch_idx=bidx)
        (pooled * g_unit).sum().backward()
        zero = int(pooled.count_nonzero()) == 0 and all(int(f.grad.count_nonzero()) == 0 for f in feats.values())
        print(f"roi_align_bwd edge cases {out}x{out}: N=0 gives zeros; all-invalid set through RoIAlignFunction "
              f"gives zero rows and zero feature gradients: {zero}", flush=True)
        assert zero


def phase_train_reference():
    """One float32 training step at 128² on the card (K1, K2) and on the
    CPU (plain RoIAlign and adjoint): same weights, batch and draws, and
    the CPU's proposals handed to the card's loss. Objectness scores of
    random weights sit closer together than the two devices' rounding
    differences, so the top-k cuts and NMS may keep another proposal on
    each device; how many differ is printed. The card's selection is held
    to the CPU's on its own: the RPN outputs of the two devices must agree
    to RPN_RTOL, and the card, given the CPU's RPN outputs, must select the
    CPU's proposals (same validity, boxes within PROPOSAL_TOL_PX)."""
    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import losses as losses_mod
    from deepemia_tpu_torch.train import trainer as trainer_mod

    cfg = trainer_mod.TrainConfig(train_size=128, max_instances=16, use_bf16=False)
    batch = synthetic_train_batches(1, seed=11, size=128, gmax=16)[0]
    cpu = build_train_model("R50", 2, device="cpu", seed=3)
    sane_geometry(cpu)
    gpu = build_train_model("R50", 2, device="cuda", seed=3)
    gpu.load_state_dict(cpu.state_dict())
    n_anchors = sum(3 * (128 // st) ** 2 for st in (4, 8, 16, 32, 64))
    n_rois = 1000 + 16  # post-NMS proposals + the appended GT rows
    gen = torch.Generator().manual_seed(5)
    draws = [losses_mod.Draws(*(torch.rand(n, generator=gen) for n in (n_anchors, n_anchors, n_rois, n_rois)))
             for _ in range(2)]
    out, props, rpn = {}, {}, {}
    real = losses_mod.select_proposals_batched

    def select(logits, regs, anchors, hw, **kw):
        p = real(logits, regs, anchors, hw, **kw)
        dev = p.boxes.device.type
        props[dev] = p
        rpn[dev] = ({k: v.detach() for k, v in logits.items()}, {k: v.detach() for k, v in regs.items()},
                    anchors, hw, kw)
        return p if dev == "cpu" else type(p)(*(t.to(dev) for t in props["cpu"]))

    losses_mod.select_proposals_batched = select
    try:
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            images, gt = trainer_mod.batch_to_device(batch, dev, cfg)
            d = [losses_mod.Draws(*(t.to(dev) for t in dr)) for dr in draws]
            losses = losses_mod.maskrcnn_loss(model, images, gt, draws=d)
            losses["total"].backward()
            out[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    finally:
        losses_mod.select_proposals_batched = real
    pc, pg = props["cpu"], type(props["cuda"])(*(t.cpu() for t in props["cuda"]))
    both = pc.valid & pg.valid
    print(f"train reference proposals, each device's own: valid cpu={int(pc.valid.sum())} "
          f"gpu={int(pg.valid.sum())} rows differing in validity={int((pc.valid != pg.valid).sum())} "
          f"rows moved > {PROPOSAL_TOL_PX} px="
          f"{int(((pc.boxes - pg.boxes).abs().amax(-1) > PROPOSAL_TOL_PX)[both].sum())}", flush=True)
    (lc, rc, ac, hw, kw), (lg, rg) = rpn["cpu"], rpn["cuda"][:2]
    for name, c_maps, g_maps in (("objectness", lc, lg), ("deltas", rc, rg)):
        for lv in c_maps:
            gap = float((g_maps[lv].cpu() - c_maps[lv]).abs().max()) / float(c_maps[lv].abs().max())
            print(f"train reference rpn {name} {lv}: max |card - cpu| / max |cpu| = {gap:.3g} "
                  f"(tol {RPN_RTOL})", flush=True)
            assert gap <= RPN_RTOL, (name, lv, gap)
    on_card = real({k: v.cuda() for k, v in lc.items()}, {k: v.cuda() for k, v in rc.items()},
                   {k: v.cuda() for k, v in ac.items()}, hw, **kw)
    sv, sb = on_card.valid.cpu(), on_card.boxes.cpu()
    moved = float((sb - pc.boxes).abs().amax(-1)[pc.valid].max())
    print(f"train reference proposals, the card's selection from the CPU's RPN outputs: valid "
          f"{int(sv.sum())} (cpu {int(pc.valid.sum())}), rows differing in validity "
          f"{int((sv != pc.valid).sum())}, max |d box| {moved:.3g} px (tol {PROPOSAL_TOL_PX})", flush=True)
    assert bool((sv == pc.valid).all()) and moved <= PROPOSAL_TOL_PX, "the card selects other proposals"
    (ref, ref_g), (got, got_g) = out["cpu"], out["cuda"]
    print("train reference losses cpu: " + json.dumps(ref), flush=True)
    print("train reference losses gpu: " + json.dumps(got), flush=True)
    for k in ref:
        assert math.isfinite(got[k]) and abs(got[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), (k, got[k], ref[k])
    errs = {}
    for n, r in ref_g.items():
        scale = float(r.abs().max())
        errs[n] = float((got_g[n] - r).abs().max()) / scale if scale > 0 else float((got_g[n]).abs().max())
    worst = sorted(errs.items(), key=lambda kv: kv[1])[-3:]
    median = float(np.median(list(errs.values())))
    print(f"train reference gradients: {len(errs)} tensors, err / max |grad| median={median:.3g} "
          f"(tol {GRAD_TOL_MEDIAN}) worst={worst} (tol {GRAD_TOL})", flush=True)
    assert all(e <= GRAD_TOL for e in errs.values()) and median <= GRAD_TOL_MEDIAN, worst


def phase_train_profile(batch):
    """Device time of two steady training steps by kernel (torch.profiler,
    CUDA activity), and the device's busy share of their wall time. The
    profiler's host-side recording lengthens the wall time, so the busy
    share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from deepemia_tpu_torch.models.mask_rcnn import build_train_model
    from deepemia_tpu_torch.train import trainer as trainer_mod

    cfg = trainer_mod.TrainConfig()
    model = build_train_model("R50", 2, device="cuda", seed=cfg.seed)
    trainer_mod.zero_residual_norms(model)
    opt, sched = trainer_mod.make_optimizer(model.parameters(), cfg.base_lr, 8, cfg.warmup_iters, cfg.gamma)

    def step(i):
        trainer_mod.train_step(model, opt, sched, batch, cfg, trainer_mod.step_generator(cfg.seed, i, "cuda"))

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3, 5):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, sets): the host ops that
    # launched them, and annotated ranges, carry the same time again
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation]
    assert rows, "the profiler recorded no device time"
    busy_s = sum(t for _, t, _ in rows) / 1e6
    print(f"train profile: 2 steps wall={wall:.4f} s device_busy={busy_s:.4f} s "
          f"busy_share={busy_s / wall:.3f} (profiler on)", flush=True)
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"train profile: {t / 2e3:9.4f} ms/step  x{count // 2:<5d} {key[:110]}", flush=True)
    print(f"train profile: {len(rows)} device event kinds, {sum(c for _, _, c in rows) // 2} device events per step",
          flush=True)


def write_tiff(path: str, gray: np.ndarray) -> None:
    """A baseline uncompressed 8-bit gray TIFF: header, one strip, IFD."""
    import struct

    h, w = gray.shape
    data = np.ascontiguousarray(gray, np.uint8).tobytes()
    tags = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1), (262, 3, 1), (273, 4, 8),
            (277, 3, 1), (278, 4, h), (279, 4, len(data))]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", t, typ, 1) + (struct.pack("<HH", v, 0) if typ == 3 else struct.pack("<I", v))
        for t, typ, v in tags
    ) + struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", 8 + len(data)) + data + ifd)


def draw_scale_bar(gray: np.ndarray, label: str, dark_on_bright: bool) -> np.ndarray:
    """``gray`` with SMOKE_ROI (which holds the default scale-bar region: x
    from 0.7 of the width, rows 0.05..0.10 of the height) cleared to a flat
    background, a BAR_LEN x 4 px bar in the default region and ``label``
    centred above the bar, its glyphs (DejaVu Sans, GLYPH_PX tall) pasted
    from the reader's atlas on one baseline."""
    from deepemia_tpu_torch.inference.scalebar import _atlas

    h, w = gray.shape
    out = gray.copy()
    x0, y0 = int(w * 0.7), int(h * 0.05)
    bg, fg = (225, 25) if dark_on_bright else (30, 230)
    cx, cy = int(w * SMOKE_ROI["x_start_factor"]), int(h * SMOKE_ROI["y_start_factor"])
    out[cy : cy + int(h * SMOKE_ROI["height_factor"]), cx:] = bg
    sans = dict(_atlas()[GLYPH_PX][2::4])  # per glyph: simplex, duplex, sans, serif
    widths = [GLYPH_PX // 2 + 4 if ch == " " else sans[ch].shape[1] for ch in label]
    bar_x, bar_y = x0 + 130, y0 + GLYPH_PX + 24
    x = bar_x + (BAR_LEN - sum(widths) - 4 * (len(label) - 1)) // 2
    base = y0 + 10 + GLYPH_PX
    for ch, wd in zip(label, widths):
        if ch != " ":
            t = sans[ch].astype(np.float32) / 255.0
            region = out[base - t.shape[0] : base, x : x + wd].astype(np.float32)
            out[base - t.shape[0] : base, x : x + wd] = np.round(region + (fg - region) * t).astype(np.uint8)
        x += wd + 4
    out[bar_y : bar_y + 4, bar_x : bar_x + BAR_LEN] = fg
    return out


def pipeline_home(name: str, model, images, r101=None, bars=False):
    """A dataset home under ``PIPELINE_DIR/name``: the category file, the
    model's float32 state dict as ``model_final_r50.pt`` (and ``r101``'s as
    ``model_final_r101.pt``), the images as TIFF, with the BARS drawn when
    ``bars``. -> (default config of the home, split_dir, image folder,
    output folder)."""
    import shutil

    from deepemia_tpu_torch.config.config import default_config

    home = os.path.join(PIPELINE_DIR, name)
    shutil.rmtree(home, ignore_errors=True)
    cfg = default_config(home)
    folder = os.path.join(home, "INFERENCE")
    os.makedirs(folder)
    with open(cfg["paths"]["category_json"], "w") as f:
        json.dump({"smoke": [folder, folder, ["particle", "pore"]]}, f)
    for depth, net in (("R50", model), ("R101", r101)):
        if net is None:
            continue
        ckpt = os.path.join(cfg["paths"]["split_dir"], "smoke", f"rcnn_{depth.lower()}")
        os.makedirs(ckpt)
        sd = {k: v.detach().float().cpu() for k, v in net.state_dict().items()}
        torch.save({"model": sd, "backbone": depth, "num_classes": 2},
                   os.path.join(ckpt, f"model_final_{depth.lower()}.pt"))
    for i, img in enumerate(images):
        gray = img[..., 0]
        if bars:
            gray = draw_scale_bar(gray, BARS[i][0], BARS[i][2])
        write_tiff(os.path.join(folder, f"micrograph_{i}.tif"), gray)
    return cfg, cfg["paths"]["split_dir"], folder, os.path.join(home, "out")


def check_scale_bars(res, meas, names):
    """Every drawn bar read: the value exactly (in the reader's result and
    in the CSV's scale-bar column), um/px within BAR_RTOL of value / BAR_LEN."""
    for i, name in enumerate(names):
        label, value_um, _ = BARS[i]
        psum, um_pix = res["scale_bars"][name]
        expected = value_um / BAR_LEN
        print(f"scale bar {name}: drawn {label!r} -> read {psum!r}, um_pix {um_pix:.6g} "
              f"(expected {expected:.6g})", flush=True)
        assert psum == label.split()[0], (name, psum, label)
        assert abs(um_pix - expected) <= BAR_RTOL * expected, (name, um_pix, expected)
        assert {r[-2] for r in meas[1:] if r[-1] == name} == {psum}, name


def read_csv(path):
    import csv

    csv.field_size_limit(1 << 30)  # the RLE of a mask over most of a 2048² image
    with open(path) as f:
        return list(csv.reader(f))


def smoke_config(home: str):
    """The configuration branch of phase 9: with PyYAML, write the dataset
    YAML (SMOKE_ROI, SMOKE_OVERRIDE) and return None, so that the store
    reads ``<home>/config``; without it, check that ``get_config`` names the
    file it cannot read and return ``validate_config(default_config(home))``."""
    from deepemia_tpu_torch.config.config import default_config, get_config
    from deepemia_tpu_torch.config.schema import validate_config
    from deepemia_tpu_torch.utils.exceptions import ConfigurationError

    try:
        import yaml
    except ImportError:
        yaml = None
    print(f"config: PyYAML importable={yaml is not None}", flush=True)
    if yaml is not None:
        d = os.path.join(home, "config", "datasets")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "smoke.yaml"), "w") as f:
            yaml.safe_dump({"scale_bar_roi": SMOKE_ROI, "inference_overrides": SMOKE_OVERRIDE}, f)
        print("config: branch = run_inference('smoke', split_dir) with no config: the store's config.yaml "
              "and config/datasets/smoke.yaml", flush=True)
        return None
    try:
        get_config("smoke")
    except ConfigurationError as e:
        assert "config.yaml" in str(e) and "yaml" in str(e), e
        print(f"config: get_config('smoke') raised ConfigurationError: {e}", flush=True)
    else:
        raise AssertionError("get_config read a YAML file without PyYAML")
    print("config: branch = InferencePipeline under validate_config(default_config(home))", flush=True)
    return validate_config(default_config(home))


class ObservedPipelines:
    """Within the block, every ``InferencePipeline`` that
    ``run_inference`` builds is kept in ``.made``, with its ``_infer_one``
    wrapped by ``wrap``."""

    def __init__(self, wrap):
        import deepemia_tpu_torch.inference.pipeline as pipeline_mod

        self.mod, self.wrap, self.made = pipeline_mod, wrap, []

    def __enter__(self):
        base, made, wrap = self.mod.InferencePipeline, self.made, self.wrap

        class Observed(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._infer_one = wrap(self._infer_one)
                made.append(self)

        self.base, self.mod.InferencePipeline = base, Observed
        return self

    def __exit__(self, *exc):
        self.mod.InferencePipeline = self.base


class StageLog:
    """Within the block, every ``StageTimers`` that the pipeline makes also
    appends each stage's (name, seconds) to ``.calls``, in order."""

    def __enter__(self):
        import contextlib

        import deepemia_tpu_torch.inference.pipeline as pipeline_mod

        base, calls = pipeline_mod.StageTimers, []

        class Logged(base):
            @contextlib.contextmanager
            def time(self, name):
                before = self.totals[name]
                with super().time(name):
                    yield
                calls.append((name, self.totals[name] - before))

        self.mod, self.base, self.calls = pipeline_mod, base, calls
        pipeline_mod.StageTimers = Logged
        return self

    def __exit__(self, *exc):
        self.mod.StageTimers = self.base

    def steady(self):
        """Stage seconds of each image after the first: the calls from one
        ``decode`` to the next, without the run's closing RLE file write."""
        per_image = []
        for name, sec in self.calls[:-1]:
            if name == "decode":
                per_image.append({})
            if per_image:
                per_image[-1][name] = round(per_image[-1].get(name, 0.0) + sec, 4)
        return per_image[1:]


def phase_pipeline(model, images):
    """The pipeline on three 2048² micrographs at full width, default
    configuration, each with a drawn scale bar; every bar must be read,
    every multilevel RoIAlign must launch K1, and K1 must agree with the
    plain RoIAlign at every pyramid shape the run gave it."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline, run_inference
    from deepemia_tpu_torch.kernels.roi_align import counter
    from deepemia_tpu_torch.ops.rle import rle_decode

    _, split_dir, folder, out = pipeline_home("full", model, images, bars=True)
    home = os.path.join(PIPELINE_DIR, "full")
    counts, calls, shapes = {}, [], {}
    real_dispatch = heads_mod.roi_align_dispatch

    def wrap(real_infer):
        def infer(image, timers):
            inst, q = real_infer(image, timers)
            counts[len(counts)] = int(inst.valid.sum())
            return inst, q

        return infer

    def dispatch(features, boxes, **kw):
        # the first call of each pyramid shape and stage, held against the
        # plain version after the counted run
        calls.append(int(boxes.shape[0]))
        key = (tuple(features["p2"].shape), kw["output_size"])
        if boxes.shape[0] and key not in shapes:
            shapes[key] = ([features[k] for k in ("p2", "p3", "p4", "p5")], boxes.clone(),
                           {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
        return real_dispatch(features, boxes, **kw)

    saved_home = os.environ.get("DEEPEMIA_TPU_HOME")
    os.environ["DEEPEMIA_TPU_HOME"] = home
    try:
        cfg = smoke_config(home)
        with ObservedPipelines(wrap) as seen, StageLog() as stage_log:
            heads_mod.roi_align_dispatch = dispatch
            counter.launches = 0
            if cfg is None:
                res = run_inference("smoke", split_dir, image_folder=folder, output_dir=out)
            else:
                pipe = InferencePipeline("smoke", split_dir, out, cfg)
                pipe._infer_one = wrap(pipe._infer_one)
                res = pipe.run(folder, visualize=False)
            launches = counter.launches
    finally:
        heads_mod.roi_align_dispatch = real_dispatch
        if saved_home is None:
            os.environ.pop("DEEPEMIA_TPU_HOME", None)
        else:
            os.environ["DEEPEMIA_TPU_HOME"] = saved_home
    if cfg is None:
        (pipe,) = seen.made
        assert pipe.config["scale_bar_rois"]["smoke"] == SMOKE_ROI, pipe.config["scale_bar_rois"]
        assert pipe.size_heuristic_sample == SMOKE_OVERRIDE["postprocessing"]["size_heuristic_sample"]
        print(f"config: the dataset YAML reached the pipeline: scale_bar_rois.smoke={SMOKE_ROI}, "
              f"size_heuristic_sample={pipe.size_heuristic_sample}", flush=True)
    assert pipe.use_multiscale and pipe.postproc_enabled and not pipe.use_ensemble
    assert next(pipe.engine.model.parameters()).dtype == torch.bfloat16
    names = sorted(os.listdir(folder))
    assert res["processed"] == names and not res["failed"], res
    rle = read_csv(res["rle_csv"])[1:]
    meas = read_csv(res["measurements_csv"])
    assert meas[0][0] == "Instance_ID" and len(meas) > 1
    check_scale_bars(res, meas, names)
    h, w = images[0].shape[:2]
    for i, name in enumerate(names):
        rows = [r for r in rle if r[0] == name]
        assert len(rows) == counts[i] > 0, (name, len(rows), counts[i])
        for _, enc in rows:
            vals = [int(t) for t in enc.split()]
            starts, lengths = vals[0::2], vals[1::2]
            assert all(s >= 1 and s + n - 1 <= h * w for s, n in zip(starts, lengths)), name
            assert rle_decode(vals, (h, w)).sum() == sum(lengths), name
        ids = {int(r[0].rsplit("_", 1)[1]) for r in meas[1:] if r[-1] == name}
        assert ids and ids <= set(range(1, counts[i] + 1)), name
    rois = sum(1 for n in calls if n > 0)
    print(f"pipeline: images={len(names)} valid_instances={[counts[i] for i in range(len(names))]} "
          f"rle_rows={len(rle)} measurement_rows={len(meas) - 1} multilevel_roi_align_calls={len(calls)} "
          f"(with RoIs {rois}) roi_align_fwd launches={launches}", flush=True)
    assert launches > 0 and launches == rois, "a multilevel RoIAlign of the pipeline did not launch K1"
    errs, timed = [], []
    for ((b, hp, wp, _), out_size), (feats, boxes, kw) in sorted(shapes.items()):
        args = (feats, boxes, kw["valid"], kw["batch_idx"], out_size)
        tag = f"pipeline {b} x {4 * hp}x{4 * wp} input, {'box' if out_size == 7 else 'mask'} stage"
        # timed in the path's dtype (per-launch times), float32 output untimed
        for dtype in dict.fromkeys((kw["out_dtype"], torch.float32)):
            row = compare_roi_align(tag, *args, dtype, reps=10, adaptive=kw["adaptive_ratio"],
                                    timed=dtype == kw["out_dtype"])
            errs.append(row["err"])
            if "ms" in row:
                timed.append(row)
    print(f"pipeline: K1 at the {len(timed)} captured shapes, one launch each: kernel ms "
          f"{sum(r['ms'] for r in timed):.4f}, bound ms {sum(r['bound_ms'] for r in timed):.4f}", flush=True)
    print(f"pipeline: K1 held against the plain RoIAlign at {len(shapes)} pyramid shapes and stages", flush=True)
    shapes.clear()
    print(f"pipeline: size heuristic valid={pipe._heuristic_valid} small classes={sorted(pipe.small_classes)} "
          f"classes needing the upscale={sorted(pipe.upscale_classes)} -> tile upscale "
          f"{'x1 (native tiles)' if pipe._heuristic_valid and not pipe.upscale_classes else 'configured'}", flush=True)
    secs = res["seconds_per_image"]
    print(f"pipeline: seconds_per_image first={secs[0]:.4f} steady={secs[1:]} ({h}x{w}, bf16, default config; "
          f"size heuristic before the loop {res['stages']['size_heuristic']['total_s']:.4f} s)", flush=True)
    print("pipeline stage seconds: " + json.dumps(
        {k: {"total_s": round(v["total_s"], 6), "count": v["count"]} for k, v in res["stages"].items()}), flush=True)
    print(f"pipeline: steady stage seconds per image {json.dumps(stage_log.steady())}", flush=True)
    sb = res["stages"]["scalebar"]
    print(f"pipeline: scalebar stage seconds per image {sb['total_s'] / sb['count']:.4f} "
          f"(host, {sb['count']} images of {h}x{w}, the first loads the glyph atlas)", flush=True)
    scalebar_steady_seconds(folder, pipe)
    return launches, errs


def scalebar_steady_seconds(folder, pipe):
    """The reader's seconds per image on the run's decoded images, the
    atlas loaded and the run's template caches warm (second of two passes)."""
    from deepemia_tpu_torch.inference.scalebar import detect_scale_bar
    from deepemia_tpu_torch.ops.image import read_image

    imgs = [read_image(os.path.join(folder, n)) for n in sorted(os.listdir(folder))]
    for _ in range(2):
        secs = []
        for img in imgs:
            t0 = time.perf_counter()
            detect_scale_bar(img, pipe.config, pipe.dataset_name, return_debug=True)
            secs.append(time.perf_counter() - t0)
    print(f"pipeline: scalebar steady seconds per image {json.dumps([round(x, 4) for x in secs])} "
          f"(host, {imgs[0].shape[0]}x{imgs[0].shape[1]})", flush=True)


def phase_ensemble(model, images):
    """The default configuration's ensemble on phase 9's images: a seeded
    R101-FPN checkpoint beside the R50 one; both members must run on every
    image, every multilevel RoIAlign with RoIs must launch K1 in each
    member, and K1 must agree with the plain RoIAlign at the R101 member's
    first shape of each stage. -> (K1 launches of the run, errors)."""
    import deepemia_tpu_torch.models.heads as heads_mod
    from deepemia_tpu_torch.config.schema import validate_config
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline
    from deepemia_tpu_torch.kernels.roi_align import counter
    from deepemia_tpu_torch.models.mask_rcnn import build_model
    from deepemia_tpu_torch.ops import tiles as tile_ops
    from deepemia_tpu_torch.ops.image import resize_image

    r101 = build_model("R101", num_classes=2, use_bf16=True, device="cuda", seed=1)
    sane_geometry(r101)
    cfg, split_dir, folder, out = pipeline_home("ensemble", model, images, r101=r101, bars=True)
    cfg = validate_config(cfg)
    es = cfg["inference_settings"]["ensemble_settings"]
    assert es["enabled"] and es["small_classes_only"], es
    pipe = InferencePipeline("smoke", split_dir, out, cfg)
    assert pipe.use_ensemble and [n for n, _, _ in pipe.engines] == ["R101", "R50"], pipe.engines
    assert len(pipe.engines[0][1].model.backbone.bottom_up.res4) == 23
    assert all(next(e.model.parameters()).dtype == torch.bfloat16 for _, e, _ in pipe.engines)

    member = {"name": None}
    calls = {"R101": [], "R50": []}
    shapes = {}
    real_dispatch = heads_mod.roi_align_dispatch

    def tracked(name, infer):
        def run(*a, **kw):
            member["name"] = name
            try:
                return infer(*a, **kw)
            finally:
                member["name"] = None

        return run

    for name, engine, _ in pipe.engines:
        engine.infer = tracked(name, engine.infer)

    def dispatch(features, boxes, **kw):
        calls[member["name"]].append(int(boxes.shape[0]))
        key = kw["output_size"]
        if member["name"] == "R101" and boxes.shape[0] and key not in shapes:
            shapes[key] = ([features[k] for k in ("p2", "p3", "p4", "p5")], boxes.clone(),
                           {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
        return real_dispatch(features, boxes, **kw)

    counter.launches = 0
    heads_mod.roi_align_dispatch = dispatch
    try:
        with StageLog() as stage_log:
            res = pipe.run(folder, visualize=False)
    finally:
        heads_mod.roi_align_dispatch = real_dispatch
    launches = counter.launches
    names = sorted(os.listdir(folder))
    assert res["processed"] == names and not res["failed"], res
    assert res["members"] == {n: ["R101", "R50"] for n in names}, res["members"]
    meas = read_csv(res["measurements_csv"])
    rle = read_csv(res["rle_csv"])[1:]
    check_scale_bars(res, meas, names)
    with_rois = {m: sum(1 for n in c if n > 0) for m, c in calls.items()}
    print(f"ensemble: members {res['members'][names[0]]} on every image; multilevel_roi_align calls "
          f"{ {m: len(c) for m, c in calls.items()} } (with RoIs {with_rois}) roi_align_fwd launches={launches}",
          flush=True)
    assert min(with_rois.values()) > 0 and launches == sum(with_rois.values()), \
        "a multilevel RoIAlign of the ensemble did not launch K1"
    errs = []
    for out_size, (feats, boxes, kw) in sorted(shapes.items()):
        tag = f"ensemble R101 {tuple(feats[0].shape)} p2, {'box' if out_size == 7 else 'mask'} stage"
        for dtype in dict.fromkeys((kw["out_dtype"], torch.float32)):
            row = compare_roi_align(tag, feats, boxes, kw["valid"], kw["batch_idx"], out_size, dtype,
                                    adaptive=kw["adaptive_ratio"], timed=False)
            errs.append(row["err"])
    assert sorted(shapes) == [7, 14], sorted(shapes)
    per_image = {n: sum(1 for r in rle if r[0] == n) for n in names}
    secs = res["seconds_per_image"]
    print(f"ensemble: merged instances per image {per_image}; seconds_per_image first={secs[0]:.4f} "
          f"steady={[round(x, 4) for x in secs[1:]]} ({images[0].shape[0]}x{images[0].shape[1]}, bf16, "
          f"R101 + R50, default config)", flush=True)
    print("ensemble stage seconds: " + json.dumps(
        {k: {"total_s": round(v["total_s"], 6), "count": v["count"]} for k, v in res["stages"].items()}), flush=True)
    print(f"ensemble: steady stage seconds per image {json.dumps(stage_log.steady())}", flush=True)

    # R101's trunk + FPN on one 16-tile batch of 1024² inputs (512 px tiles, x2)
    engine = pipe.engines[0][1]
    img = torch.as_tensor(images[0]).cuda()
    grid = tile_ops.compute_tile_grid(img.shape[0], img.shape[1], engine.tile_size, engine.overlap_ratio)
    ts_up = int(round(engine.tile_size * engine.upscale_factor))
    ups = resize_image(tile_ops.extract_tiles(img, grid)[: engine.tile_batch].float(), ts_up, ts_up)
    r50 = pipe.engines[1][1].model
    times = {}
    for rep_i in range(3):  # the last pass is kept
        for tag, net in (("R101", engine.model), ("R50", r50)):
            _, times[tag] = sync_time(lambda net=net: net.features_batched(ups))
    print(f"ensemble: trunk + FPN seconds per {engine.tile_batch}-tile batch of {ts_up}² inputs, bf16: "
          f"R101 {times['R101']:.4f}, R50 {times['R50']:.4f}", flush=True)
    return launches, errs


def ensemble_only():
    """Phases 1 and 11 alone (phase 3's R50 weights rebuilt from their seed)."""
    from deepemia_tpu_torch.kernels import _build
    from deepemia_tpu_torch.models.mask_rcnn import build_model

    import shutil

    print(f"card: {card_line()}", flush=True)
    _build.build(["roi_align_fwd"])
    with torch.inference_mode():
        model = build_model("R50", num_classes=2, use_bf16=True, device="cuda", seed=0)
        sane_geometry(model)
        images = [synthetic_micrograph(2048, seed) for seed in range(3)]
        try:
            phase_ensemble(model, images)
        finally:
            shutil.rmtree(PIPELINE_DIR, ignore_errors=True)


def best_match_share(score):
    """[N,M] agreement scores in [0,1] -> the share of rows and of columns
    whose best partner scores 1 (both directions)."""
    if score.size == 0:
        return 0.0, 0.0
    return float((score.max(axis=1) >= 1).mean()), float((score.max(axis=0) >= 1).mean())


def pipeline_csvs(model, img, name, device):
    """Both CSVs' rows (headers dropped) of one image through the pipeline
    in float32."""
    from deepemia_tpu_torch.inference.pipeline import InferencePipeline

    cfg, split_dir, folder, out = pipeline_home(name, model, [img])
    pipe = InferencePipeline("smoke", split_dir, out, cfg, use_bf16=False, device=device)
    res = pipe.run(folder)
    assert not res["failed"], res
    return read_csv(res["rle_csv"])[1:], read_csv(res["measurements_csv"])[1:]


def csv_agreement(rle_g, meas_g, rle_c, meas_c, hw):
    """Instances matched by mask IoU >= PIPE_MIN_IOU and measurement rows
    matched by value (same class, every number to 1e-3 relative), each
    side's share with a partner on the other; identical RLE strings."""
    from deepemia_tpu_torch.ops.rle import rle_decode

    def masks(rows):
        return np.stack([rle_decode([int(t) for t in r[1].split()], hw).ravel() for r in rows]).astype(np.float32)

    mg, mc = masks(rle_g), masks(rle_c)
    inter = mg @ mc.T
    union = mg.sum(1)[:, None] + mc.sum(1)[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    inst_g, inst_c = best_match_share(iou >= PIPE_MIN_IOU)

    def numbers(rows):
        return np.array([[float(v) for v in r[3:15]] for r in rows]), np.array([r[2] for r in rows])

    (vg, cg), (vc, cc) = numbers(meas_g), numbers(meas_c)
    rel = np.abs(vg[:, None, :] - vc[None, :, :]) / np.maximum(np.abs(vc[None, :, :]), 1e-9)
    rows_g, rows_c = best_match_share((rel.max(axis=2) <= 1e-3) & (cg[:, None] == cc[None, :]))
    cpu_strings = {r[1] for r in rle_c}
    return dict(n_card=len(rle_g), n_cpu=len(rle_c), identical=sum(r[1] in cpu_strings for r in rle_g),
                inst=min(inst_g, inst_c), rows_card=len(meas_g), rows_cpu=len(meas_c), rows=min(rows_g, rows_c))


def phase_pipeline_reference(model):
    """One 256² image through the pipeline in float32 on the card and on
    the CPU (plain RoIAlign), same weights and default configuration.
    Borderline instances (a score, size gate or IoU within rounding of its
    threshold) may differ between the two devices and shift the rows after
    them, so instances are matched by mask IoU and measurement rows by
    value, not by position. Then the card again with a planted fault (every
    RoIAlign box moved by PIPE_FAULT_PX), which the limits must reject."""
    import deepemia_tpu_torch.models.heads as heads_mod

    img = synthetic_micrograph(256, seed=7)
    rle_c, meas_c = pipeline_csvs(model, img, "ref_cpu", "cpu")
    rle_g, meas_g = pipeline_csvs(model, img, "ref_cuda", "cuda")
    a = csv_agreement(rle_g, meas_g, rle_c, meas_c, (256, 256))
    print("pipeline reference 256² f32: " + json.dumps(a), flush=True)
    assert min(a["n_card"], a["n_cpu"], a["rows_card"], a["rows_cpu"]) > 0
    assert a["inst"] >= PIPE_MATCH_SHARE and a["rows"] >= PIPE_ROW_SHARE, a
    real = heads_mod.roi_align_dispatch
    heads_mod.roi_align_dispatch = lambda features, boxes, **kw: real(features, boxes + PIPE_FAULT_PX, **kw)
    try:
        rle_f, meas_f = pipeline_csvs(model, img, "ref_fault", "cuda")
    finally:
        heads_mod.roi_align_dispatch = real
    f = csv_agreement(rle_f, meas_f, rle_c, meas_c, (256, 256))
    print(f"pipeline reference 256² f32, card with RoIAlign boxes moved by {PIPE_FAULT_PX} px: " + json.dumps(f),
          flush=True)
    assert f["inst"] < PIPE_MATCH_SHARE or f["rows"] < PIPE_ROW_SHARE, "the limits pass a planted RoIAlign fault"


def check_window_sum(tag, f, got, expect_instance=None):
    """K3's [1,1] output ``got`` for ``f`` against the plain version within
    K3_TOL of sum |x| over the window; -> the absolute error. Prints the
    plan instance that ran."""
    from deepemia_tpu_torch.kernels import window_sum as ws

    torch.cuda.synchronize()
    plan = ws.plan_of(f.contiguous())
    ref = ws.window_sum_plain(f)
    scale = float(f[: ws.WINDOW[0], : ws.WINDOW[1]].float().abs().sum())
    err = float((got - ref).abs().max())
    tol = K3_TOL * scale
    line = (f"window_sum {tag} {tuple(f.shape)} {str(f.dtype).split('.')[-1]} "
            f"instance={ws.INSTANCE_NAMES[plan.instance]}: kernel={float(got):.6f} plain={float(ref):.6f} "
            f"max_abs_err={err:.3g} tol={tol:.3g} (sum |x| {scale:.6g})")
    print(line, flush=True)
    if not (scale > 0 and err <= tol and math.isfinite(err)):
        raise AssertionError(f"{line}: kernel disagrees with plain")
    if expect_instance is not None and plan.instance != expect_instance:
        raise AssertionError(f"{line}: expected instance {ws.INSTANCE_NAMES[expect_instance]}")
    return err


def window_sum_edge_cases(dtype, gen):
    """(name, operand, expected plan instance) for K3's edge cases: the
    map is exactly the window; C in {1, 3, 8, 257}; a row pitch W*C*esize
    that is not a multiple of 16; a contiguous view one element past a
    16-byte boundary; a transposed view (copied by the wrapper); values of
    ~1e4 beside ~1e-3."""
    from deepemia_tpu_torch.kernels.window_sum import SCALAR, VECTOR

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    mixed = torch.randn((20, 33, 64), generator=gen, device="cuda")
    mixed *= torch.where(torch.rand((20, 33, 64), generator=gen, device="cuda") < 0.5, 1e4, 1e-3)
    return [
        ("exact 8x16xC", randn(8, 16, 256), VECTOR),
        ("C=1", randn(20, 33, 1), SCALAR),
        ("C=3", randn(20, 33, 3), SCALAR),
        ("C=8", randn(20, 33, 8), VECTOR),
        ("C=257", randn(20, 33, 257), SCALAR),
        ("pitch % 16 != 0", randn(12, 21, 10), SCALAR),
        ("base + 1 element", randn(12 * 20 * 64 + 1)[1:].view(12, 20, 64), SCALAR),
        ("transposed view", randn(33, 20, 64).transpose(0, 1), VECTOR),
        ("mixed 1e4 / 1e-3", mixed.to(dtype), VECTOR),
    ]


def device_ms(fn, n=200, skip=frozenset()):
    """Device time per call of the kernels ``fn`` launches, from
    torch.profiler (CUDA activity) over ``n`` calls, each after the
    L2-evicting write of time_ms: for each device event kind but those in
    ``skip`` (the write's own), its mean self device time times its events
    per call (the profiler drops some records, up to 9 % seen, so counts
    are rounded); -> (ms per call, {event kind: count})."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation and e.key not in skip]
    return sum(t / c * max(1, round(c / n)) for _, t, c in rows) / 1e3, {k: c for k, _, c in rows}


def host_ms(fn, n=1000):
    """Median host time of one call of ``fn`` over ``n`` calls back to
    back (the wrapper and the launch; the device keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        fn()
        ts.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return float(np.median(ts)) / 1e6


def window_sum_times(timed):
    """Times each function of ``timed`` ({dtype: {name: fn}}) in turns,
    forward and back, within a dtype: per call with time_ms (three rounds:
    the per-call times show the host path wherever it outlasts the
    L2-evicting write, so they swing with the host's load), on the host
    with host_ms, and on the device with device_ms after every other
    timing; -> {dtype: {"<name>_ms", "<name>_host_ms", "<name>_device_ms"}},
    the medians over the turns."""
    rows = {}
    for dtype, fns in timed.items():
        name = str(dtype).split(".")[-1]
        order = list(fns) + list(fns)[::-1]
        ms, host = {k: [] for k in fns}, {k: [] for k in fns}
        for k in order * 3:
            ms[k].append(time_ms(fns[k], 50))
        for k in order:
            host[k].append(host_ms(fns[k]))
        rows[dtype] = row = {}
        for k in fns:
            row[f"{k}_ms"], row[f"{k}_host_ms"] = float(np.median(ms[k])), float(np.median(host[k]))
            print(f"window_sum {name} {k:8s}: per-call ms median {row[f'{k}_ms']:.6f} {ms[k]} "
                  f"host ms median {row[f'{k}_host_ms']:.6f} {host[k]}", flush=True)

    _, flush_kinds = device_ms(lambda: None, 20)
    skip = frozenset(flush_kinds)
    for dtype, fns in timed.items():
        dev, kinds = {k: [] for k in fns}, {}
        for k in list(fns) + list(fns)[::-1]:
            t, kinds[k] = device_ms(fns[k], 200, skip)
            dev[k].append(t)
            if k != "library":  # its own kernel only, at most once a call
                assert len(kinds[k]) == 1 and list(kinds[k].values())[0] <= 200, (k, kinds[k])
        for k in fns:
            rows[dtype][f"{k}_device_ms"] = float(np.median(dev[k]))
            print(f"window_sum {str(dtype).split('.')[-1]} {k:8s}: device ms median "
                  f"{rows[dtype][f'{k}_device_ms']:.6f} {dev[k]} events per call "
                  f"{json.dumps({n[:90]: c / 200 for n, c in kinds[k].items()})}", flush=True)
    return rows


def phase_window_sum():
    """K3 against its plain version on the micro-benchmark's conv-chain
    output and on edge cases, bf16 and float32; 20 launches bitwise equal;
    per-call, host and device times of K3, torch.sum and the empty kernel
    (window_sum_times); the six variants of the tool with the launch count
    reset before and read after."""
    from deepemia_tpu_torch.kernels import window_sum as ws
    from deepemia_tpu_torch.tools import bench_decouple

    x, convs, _ = bench_decouple.conv_chain(torch.device("cuda"))
    with torch.inference_mode():
        feat = convs(x)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, timed = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        f = feat.to(dtype)
        err = check_window_sum("benchmark", f, ws.window_sum(f), ws.VECTOR)
        for tag, e, instance in window_sum_edge_cases(dtype, gen):
            err = max(err, check_window_sum(tag, e, ws.window_sum(e), instance))
        outs = [ws.window_sum(f) for _ in range(20)]
        patterns = torch.cat(outs).view(torch.int32).unique().numel()
        print(f"window_sum {name}: 20 launches, {patterns} bit pattern(s)", flush=True)
        assert patterns == 1, "K3 differs between launches"

        win = f[: ws.WINDOW[0], : ws.WINDOW[1]]
        p_ms = time_ms(lambda: ws.window_sum_plain(f), 50)
        nbytes = win.numel() * win.element_size() + 4
        t_b, t_f = nbytes / HBM_BYTES_PER_S, win.numel() / F32_FLOPS_PER_S
        bound_ms, by = max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")
        rows[dtype] = dict(err=err, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by)
        print(f"window_sum {name}: plain_ms={p_ms:.5f} bound_ms={bound_ms:.3g} ({by}, {nbytes} bytes)",
              flush=True)
        timed[dtype] = {
            "kernel": lambda f=f: ws.window_sum(f),
            "library": lambda win=win: torch.sum(win, dtype=torch.float32),
            "empty": lambda f=f: ws.launch(f, "window_sum_empty"),
        }
    for dtype, times in window_sum_times(timed).items():
        rows[dtype].update(times)
    ws.counter.launches = 0
    variants = bench_decouple.main(device="cuda")
    launches = ws.counter.launches
    print("bench_decouple: " + json.dumps({k: round(v["ms"], 6) for k, v in variants.items()})
          + f" window_sum launches={launches}", flush=True)
    assert launches == 5 * 8 * (2 + 8), launches  # 5 consuming variants x 8 steps x 10 calls
    assert all(math.isfinite(v["value"]) for v in variants.values())
    return rows, launches


def k3_times(root):
    """``python3 chip_smoke.py --k3-times ROOT``: K3 and torch.sum timed by
    window_sum_times through ``window_sum`` of the package in the checkout
    at ROOT (which may be another commit's), at the benchmark's shape
    [256,256,256] of seeded normal values, bf16 and float32, after a check
    against the plain version; prints one JSON line. To compare two
    commits' K3 on one card, run it once for each in one call: parent,
    change, change, parent."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from deepemia_tpu_torch.kernels import window_sum as ws

    assert ws.__file__.startswith(root + os.sep), ws.__file__
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((256, 256, 256), generator=gen, device="cuda")
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        f = x.to(dtype)
        win = f[: ws.WINDOW[0], : ws.WINDOW[1]]
        err = float((ws.window_sum(f) - ws.window_sum_plain(f)).abs().max())
        assert err <= K3_TOL * float(win.float().abs().sum()), err
        timed[dtype] = {
            "kernel": lambda f=f: ws.window_sum(f),
            "library": lambda win=win: torch.sum(win, dtype=torch.float32),
        }
    rows = window_sum_times(timed)
    print(json.dumps({"root": root, **{str(d).split(".")[-1]: r for d, r in rows.items()}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--k3-times"]:  # before this checkout's package is imported
        print(f"card: {card_line()}", flush=True)
        k3_times(sys.argv[2])
        return 0
    from deepemia_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    sources = ["roi_align_fwd", "roi_align_bwd", "window_sum"]
    _, build_s = sync_time(lambda: _build.build(sources))
    print(f"build: {', '.join(nm + '.cu' for nm in sources)} in {build_s:.2f} s (in parallel)", flush=True)
    for nm in sources:
        for line in _build.build_logs.get(nm, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {nm}:", line.strip(), flush=True)

    with torch.inference_mode():
        tile_rows = phase_kernel_vs_plain()
        images = [synthetic_micrograph(2048, seed) for seed in range(3)]
        model, engine, launches = phase_slice(images)
        calls = capture_tile_batch(model, engine, images[0])
        captured = phase_captured(calls)
        phase_stage_times(model, engine, images[0])
        phase_small_reference()

    batches = synthetic_train_batches(4, seed=7)
    train_launches, _ = phase_train(batches)
    bwd_rows = phase_backward(capture_train_step(batches[0]))
    phase_backward_edges()
    phase_train_reference()
    phase_train_profile(batches[1])

    import shutil

    try:
        pipeline_launches, pipeline_errs = phase_pipeline(model, images)
        phase_pipeline_reference(model)
        with torch.inference_mode():
            ensemble_launches, ensemble_errs = phase_ensemble(model, images)
    finally:
        shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    k3_rows, k3_launches = phase_window_sum()

    errs = [r["err"] for r in list(tile_rows.values()) + captured] + pipeline_errs + ensemble_errs
    kernel = {
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/roi_align_fwd.cu",
        "replaces": "deepemia_tpu/kernels/roi_align_pallas.py:351",
        # phases 3 (tile engine), 9 (pipeline) and 11 (ensemble), each counted from zero
        "launches": launches + pipeline_launches + ensemble_launches,
        "max_abs_err": max(errs),
        # one 16-tile batch of the main path: its box-stage + mask-stage call
        "ms": sum(r["ms"] for r in captured),
        "plain_ms": sum(r["plain_ms"] for r in captured),
        "bound_ms": sum(r["bound_ms"] for r in captured),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in captured) else "operations",
        "library_ms": None,
    }
    backward = {
        "name": "roi_align_bwd",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/roi_align_bwd.cu",
        "replaces": "deepemia_tpu/kernels/roi_align_pallas.py:608",
        "launches": train_launches["roi_align_bwd"],
        "max_abs_err": max(r["err"] for r in bwd_rows),
        # one training step: its box-stage + mask-stage call, bf16
        "ms": sum(r["ms"] for r in bwd_rows),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows),
        "bound_ms": sum(r["bound_ms"] for r in bwd_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd_rows) else "operations",
        "library_ms": None,
    }
    k3, k3_f32 = k3_rows[torch.bfloat16], k3_rows[torch.float32]
    window = {
        "name": "window_sum",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/window_sum.cu",
        "replaces": "tools/bench_decouple.py:49",
        "launches": k3_launches,
        "max_abs_err": max(r["err"] for r in k3_rows.values()),
        # one call at the benchmark's shape: [256,256,256] bf16 -> the 8x16x256 window
        # (CUDA events around the call, median of six time_ms readings); *_device_ms:
        # the profiler's device time per launch; *_host_ms: host time per call;
        # *_f32: the same in float32; empty_*: the same launch of a kernel that does nothing
        "ms": k3["kernel_ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "device_ms": k3["kernel_device_ms"],
        "host_ms": k3["kernel_host_ms"],
        "library_device_ms": k3["library_device_ms"],
        "library_host_ms": k3["library_host_ms"],
        "empty_ms": k3["empty_ms"],
        "empty_device_ms": k3["empty_device_ms"],
        "ms_f32": k3_f32["kernel_ms"],
        "plain_ms_f32": k3_f32["plain_ms"],
        "bound_ms_f32": k3_f32["bound_ms"],
        "library_ms_f32": k3_f32["library_ms"],
        "device_ms_f32": k3_f32["kernel_device_ms"],
        "host_ms_f32": k3_f32["kernel_host_ms"],
        "library_device_ms_f32": k3_f32["library_device_ms"],
        "library_host_ms_f32": k3_f32["library_host_ms"],
    }
    print(f"roi_align_fwd launches: tile engine {launches}, pipeline {pipeline_launches}, "
          f"ensemble {ensemble_launches}", flush=True)
    print(f"total seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [kernel, backward, window]}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``deepemia_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (the
CUDA toolkit's ``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``).
It builds the CUDA kernels from the sources in the checkout and then:

  1. prints the card's name and power limit, builds the kernels;
  2. holds the RoIAlign kernel against its plain PyTorch version at one
     1024² tile's shapes (box stage 1000 RoIs, about half invalid, 7x7;
     mask stage 100 RoIs, 14x14), in float32 and bfloat16, and times both;
  3. serves three synthetic 2048² micrographs through ``TileEngine.infer``
     (Mask R-CNN R50-FPN, 2 classes, bf16, seeded random weights with the
     box regression zeroed, default engine settings: 512 px tiles, 0.1
     overlap, x2 upscale, 16-tile batches, native whole-image pass) and
     checks that every RoIAlign of that run went through the kernel;
  4. records the RoIAlign inputs of one real tile batch of that path and
     holds the kernel against the plain version on them (these are the
     timings in the kernel line), then times the stages of one tile batch;
  5. runs a small image through the engine in float32 on the card and on
     the CPU (the plain RoIAlign) and compares the detections.

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
# kernel vs plain, both relative to max(1, max |feature|): float32 output
# differs by sums taken in another order, bfloat16 output by at most one
# rounding step of the bf16 result
F32_TOL = 1e-5
BF16_TOL = 1e-2


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


def compare_roi_align(tag, feats, boxes, valid, batch_idx, out_size, dtype, reps=25):
    """Kernel vs plain on the same inputs; returns the record of one row."""
    from deepemia_tpu_torch.kernels.roi_align import roi_align_cuda
    from deepemia_tpu_torch.models.roi_align import assign_fpn_levels, multilevel_roi_align

    levels = (assign_fpn_levels(boxes) - 2).contiguous()
    bidx = batch_idx.to(torch.int32).contiguous()

    def kernel():
        return roi_align_cuda(feats, boxes, levels, bidx, valid, output_size=out_size,
                              sampling_ratio=2, adaptive_ratio=True, out_dtype=dtype)

    def plain():
        fd = dict(zip(("p2", "p3", "p4", "p5"), feats))
        return multilevel_roi_align(fd, boxes, out_size, 2, adaptive_ratio=True, valid=valid,
                                    batch_idx=bidx, out_dtype=dtype)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = float((got.float() - ref.float()).abs().max())
    scale = max(float(f.float().abs().max()) for f in feats)
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * max(scale, 1.0)
    zeros = bool((got[~valid] == 0).all())
    k_ms = time_ms(kernel, reps)
    p_ms = time_ms(plain, max(3, reps // 5))
    bound_ms, by = roi_work(feats, boxes, valid, bidx, out_size, dtype)
    print(
        f"roi_align {tag}: N={boxes.shape[0]} valid={int(valid.sum())} out={out_size} "
        f"{str(dtype).split('.')[-1]} max_abs_err={err:.3g} tol={tol:.3g} invalid_rows_zero={zeros} "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
        f"share_of_bound={bound_ms / k_ms:.3f}",
        flush=True,
    )
    if not (err <= tol and zeros and math.isfinite(err)):
        raise AssertionError(f"roi_align {tag}: kernel disagrees with plain ({err} > {tol})")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by)


def synthetic_rois(n, image, frac_valid, gen):
    ctr = torch.rand(n, 2, generator=gen) * image * 1.1 - 0.05 * image
    wh = torch.exp(torch.empty(n, 2).uniform_(math.log(4), math.log(700), generator=gen))
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], 1)
    valid = torch.rand(n, generator=gen) < frac_valid
    boxes[~valid] = 0.0
    return boxes.cuda().contiguous(), valid.cuda()


def phase_kernel_vs_plain():
    gen = torch.Generator().manual_seed(1)
    shapes = [256, 128, 64, 32]  # p2..p5 of one 1024² model input
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats = [torch.randn(1, s, s, 256, generator=gen).to("cuda", dtype) for s in shapes]
        for n, out, frac in ((1000, 7, 0.5), (100, 14, 1.0)):
            boxes, valid = synthetic_rois(n, 1024.0, frac, gen)
            bidx = torch.zeros(n, dtype=torch.int32, device="cuda")
            rows[(n, dtype)] = compare_roi_align(f"tile {n}x{out}", feats, boxes, valid, bidx, out, dtype)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from deepemia_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    _, build_s = sync_time(lambda: _build.build(["roi_align_fwd"]))
    print(f"build: roi_align_fwd.cu in {build_s:.2f} s", flush=True)
    for line in _build.build_logs.get("roi_align_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    with torch.inference_mode():
        tile_rows = phase_kernel_vs_plain()
        images = [synthetic_micrograph(2048, seed) for seed in range(3)]
        model, engine, launches = phase_slice(images)
        calls = capture_tile_batch(model, engine, images[0])
        captured = phase_captured(calls)
        phase_stage_times(model, engine, images[0])
        phase_small_reference()

    errs = [r["err"] for r in list(tile_rows.values()) + captured]
    kernel = {
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "deepemia_tpu_torch/kernels/csrc/roi_align_fwd.cu",
        "replaces": "deepemia_tpu/kernels/roi_align_pallas.py:351",
        "launches": launches,
        "max_abs_err": max(errs),
        # one 16-tile batch of the main path: its box-stage + mask-stage call
        "ms": sum(r["ms"] for r in captured),
        "plain_ms": sum(r["plain_ms"] for r in captured),
        "bound_ms": sum(r["bound_ms"] for r in captured),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in captured) else "operations",
        "library_ms": None,
    }
    print(f"total seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

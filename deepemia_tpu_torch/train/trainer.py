"""Training: SGD over ``maskrcnn_loss``, warmup-multistep schedule, torch
checkpoints with resume (counterpart of the JAX package's
``train/trainer.py``), on one GPU or data-parallel over several.

``train`` takes registered records, as the JAX package's does: it runs the
``TrainLoader`` (``data/loader.py``) and sizes the schedule from the record
count. ``train_on_batches`` is the loop itself, over ready batches in the
loader's format; ``train`` calls it with the loader's stream.

What carries over: the Detectron2 WarmupMultiStepLR schedule read at step
0 for the first update, SGD with momentum 0.9 and weight decay 1e-4 after
an optional global-norm clip (optax's clip -> decay -> sgd order), the
from-scratch conditioning (``zero_residual_norms``), the zoo fine-tune
overlay for ``.pth``/``.pkl`` checkpoints (``models.weights.
load_pretrained_params``), freezing of the stem, ``res2`` and every
frozen-BN affine only when fine-tuning, checkpoints every
``checkpoint_every`` steps with a resume from the newest, and the final
``model_final_{r50,r101}`` weights. Compute runs in bf16 under autocast
over float32 master weights.

Parallel (the JAX trainer's ``('data', 'model')`` mesh, ``trainer.py:
144-176, 605``): ``train_layout(GPUs, n_model_shards, ims_per_batch)``
gives (data, model), and ``data * model`` ranks train, one GPU each; rank r
is ``(d, m) = divmod(r, model)``. On a host with more than one GPU,
``train`` and ``train_on_batches`` start the ranks themselves
(``torch.multiprocessing``, NCCL), unless this process already is a rank of
a process group (``torchrun``, ``utils/device.maybe_init_distributed``),
which they then train in. Every rank makes the same global batch (the same
batches, or the loader with the same seed) and takes data block d; the
ranks of one data block (a model group) take the same block and draw the
same samples. With ``model`` above 1 the box head's fc1 is column-parallel
and its fc2 row-parallel over the model group (``models/heads.py:
BoxHead.shard``); every other parameter is whole on every rank. The
gradients are averaged before the clip and the step (a whole parameter's
over every rank, a block's over the ranks holding that block), the clip
takes the global norm of the whole parameters, so the step is the
one-process step on the global batch (the loss is the mean over images,
the blocks are equal). Each image's sampling draws are a function of
(seed, step, its index in the global batch), whichever rank holds it. Rank
0 writes the checkpoints and the final weights in the one-process format
(the blocks and their momentum gathered), between barriers, and logs;
every rank reads a resume and takes its blocks from it.

Left out, as TPU artefacts: the packed one-buffer batch transfer, the
chunked ``lax.scan`` dispatch, buffer donation and Orbax (the config keys
``roi_backend``, ``steps_per_dispatch`` and ``donate_buffers`` have no
field here). As in the JAX package no command-line flag sets
``n_model_shards``.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import socket
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from deepemia_tpu_torch import resolve_device
from deepemia_tpu_torch.data.loader import TrainLoader
from deepemia_tpu_torch.models.mask_rcnn import MaskRCNN, build_train_model
from deepemia_tpu_torch.models.weights import load_pretrained_params
from deepemia_tpu_torch.parallel import ranks as rank_ops
from deepemia_tpu_torch.parallel.mesh import local_devices, train_layout
from deepemia_tpu_torch.train.losses import Draws, GroundTruth, maskrcnn_loss

log = logging.getLogger("deepemia_tpu_torch.trainer")

_CKPT = re.compile(r"step_(\d+)\.pt$")
# (rank, world size) of the process group this process trains in, (0, 1)
# outside one; the barrier rank 0's files are written behind
process_group = rank_ops.rank_world
_barrier = rank_ops.barrier
_KEEP_CHECKPOINTS = 2


def warmup_multistep_schedule(
    base_lr: float,
    max_iter: int,
    warmup_iters: int = 1000,
    warmup_factor: float = 1e-3,
    gamma: float = 0.1,
    step_fractions=(0.6, 0.8),
):
    """Detectron2 WarmupMultiStepLR: count -> learning rate. Linear warmup
    from ``warmup_factor`` over ``warmup_iters`` steps, then x``gamma`` at
    each of the ``step_fractions`` of ``max_iter``."""
    steps = [int(f * max_iter) for f in step_fractions]

    def schedule(count: int) -> float:
        warm = warmup_factor + (1.0 - warmup_factor) * count / max(warmup_iters, 1)
        lr = base_lr * (warm if count < warmup_iters else 1.0)
        for s in steps:
            if count >= s:
                lr *= gamma
        return lr

    return schedule


def auto_max_iter(num_images: int) -> int:
    """The reference's automatic schedule: 200 steps per image below 100
    images, else 100, at least 1000."""
    per = 200 if num_images < 100 else 100
    return max(1000, per * num_images)


def _trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: trainable} for fine-tuning: the stem, ``res2`` and
    every frozen-BN affine are frozen (Detectron2 FREEZE_AT=2)."""
    frozen = ("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")
    return {
        name: not (name.startswith(frozen) or ".norm." in name)
        for name, _ in model.named_parameters()
    }


def make_optimizer(
    params: Iterable[torch.Tensor],
    base_lr: float,
    max_iter: int,
    warmup_iters: int = 1000,
    gamma: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """SGD with momentum and weight decay, and the warmup-multistep
    schedule as a ``LambdaLR`` over a base rate of 1 (so the rate is the
    schedule's value: step 0's for the first update, as optax reads it)."""
    opt = torch.optim.SGD(params, lr=1.0, momentum=momentum, weight_decay=weight_decay)
    schedule = warmup_multistep_schedule(base_lr, max_iter, warmup_iters, gamma=gamma)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


@dataclass
class RankLayout:
    """Where a training rank sits: data block ``d`` of ``data`` and box-head
    block ``m`` of ``model``; ``data_group`` holds the ranks with its box-head
    block, ``model_group`` those with its data block (None with one model
    block: the whole process group, and no model group)."""

    data: int = 1
    model: int = 1
    d: int = 0
    m: int = 0
    data_group: object = None
    model_group: object = None


def rank_layout(n_model_shards: int = 1, ims_per_batch: Optional[int] = None) -> RankLayout:
    """This process's :class:`RankLayout` in its process group (one block
    each outside one). ``ims_per_batch`` set: the group must have the
    size of ``train_layout(world, n_model_shards, ims_per_batch)``, else
    ValueError; unset: every rank is a data rank. With model blocks every
    rank makes every data and model group, in one order (``new_group`` is a
    collective)."""
    rank, world = process_group()
    if ims_per_batch is None or world == 1:
        return RankLayout(data=world, d=rank)
    data, model = train_layout(world, n_model_shards, ims_per_batch)
    if data * model != world:
        raise ValueError(
            f"ims_per_batch={ims_per_batch} with n_model_shards={n_model_shards} does not train on a process group "
            f"of {world} ranks: training takes train_layout({world}, {n_model_shards}, {ims_per_batch}) = "
            f"(data {data}, model {model}): {data * model} ranks (every data rank an equal block of the batch); "
            f"start that many (torchrun --nproc_per_node {data * model}) or raise ims_per_batch to a multiple of "
            f"{world // model}")
    d, m = divmod(rank, model)
    if model == 1:
        return RankLayout(data=data, d=d)
    data_groups = [dist.new_group([i * model + j for i in range(data)]) for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)]) for i in range(data)]
    return RankLayout(data, model, d, m, data_groups[m], model_groups[d])


def clip_gradients(params: Sequence[torch.Tensor], max_norm: float, layout: Optional[RankLayout] = None
                   ) -> torch.Tensor:
    """``clip_grad_norm_`` over the whole parameters -> the global norm.
    With model blocks, a block's squares are summed over its model group
    once and the whole parameters' counted on each rank once, so every
    rank takes the one-process norm and scales as ``clip_grad_norm_``
    does."""
    if layout is None or layout.model == 1:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    grads = [p for p in params if p.grad is not None]
    blocks = [p.grad for p in grads if getattr(p, "model_split", None) == "block"]
    whole = [p.grad for p in grads if getattr(p, "model_split", None) != "block"]

    def squares(gs):
        return torch.stack([torch.linalg.vector_norm(g.float()) ** 2 for g in gs]).sum()

    total = (squares(whole) + rank_ops.all_reduce(squares(blocks), group=layout.model_group)).sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in blocks + whole:
        g.mul_(coef.to(g.dtype))
    return total


def optimizer_step(optimizer, scheduler, grad_clip_norm: Optional[float] = None,
                   layout: Optional[RankLayout] = None) -> None:
    """Apply the gradients in ``.grad``: global-norm clip (when set), then
    SGD (decay, momentum, rate), then advance the schedule."""
    if grad_clip_norm:
        params = [p for group in optimizer.param_groups for p in group["params"]]
        clip_gradients(params, grad_clip_norm, layout)
    optimizer.step()
    scheduler.step()


@dataclass
class TrainConfig:
    backbone: str = "R50"
    base_lr: float = 0.00025
    ims_per_batch: int = 2
    max_iter: Optional[int] = None
    warmup_iters: int = 1000
    gamma: float = 0.1
    # shape every batch must have: images [ims_per_batch, S, S, 3], GT
    # padded to max_instances rows
    train_size: int = 512
    # 'fixed' (long side to train_size) or 'range' (Detectron2's shortest
    # edge schedule inside the train_size canvas, data/loader.prepare_sample)
    resize_mode: str = "fixed"
    min_size_range: Tuple[int, int] = (640, 800)
    max_size: int = 1333
    max_instances: int = 64
    # loader producer threads (the batch order is fixed by the seed for any
    # count: the consumer takes the workers' batches in turn)
    loader_workers: int = 2
    augment: bool = False
    checkpoint_every: int = 1000
    log_every: int = 20
    # bf16 autocast over float32 master weights
    use_bf16: bool = True
    seed: int = 0
    # static proposal / sample capacity overrides (small for tests)
    loss_caps: Optional[dict] = None
    # weights to fine-tune from (freezes the stem, res2 and the norms): a
    # Detectron2 .pth/.pkl or Caffe2 backbone pickle is overlaid on the
    # seeded model (class-count heads re-initialised); any other file is a
    # torch state dict of this model (as model_final_*.pt holds)
    init_checkpoint: Optional[str] = None
    # global-norm gradient clipping (advised from scratch: frozen BN does
    # not normalise activations)
    grad_clip_norm: Optional[float] = None
    # from-scratch conditioning (zero_residual_norms); ignored when
    # fine-tuning
    zero_init_residual: bool = True
    # tensor parallelism of the box head (the JAX trainer's 'model' axis):
    # its fc1 and fc2 split over this many ranks of each data block
    n_model_shards: int = 1


def zero_residual_norms(model: MaskRCNN, stem_scale: float = 1.0 / 120.0) -> None:
    """From-scratch conditioning, in place: zero every bottleneck's last
    norm scale (each residual block starts as the identity) and scale the
    stem norm by ~1/std of raw pixels, so features start near unit scale
    (frozen BN never re-normalises them)."""
    block_norm3 = re.compile(r"backbone\.bottom_up\.res\d\.\d+\.conv3\.norm\.weight$")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if block_norm3.match(name):
                p.zero_()
            elif name == "backbone.bottom_up.stem.conv1.norm.weight":
                p.mul_(stem_scale)


def unpack_mask_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., W//8] uint8 (``np.packbits`` order, bitorder 'big') -> [..., W]
    bool: the loader's bit-packed GT masks."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).bool()


def batch_to_device(batch: dict, device, cfg: TrainConfig, ims: Optional[int] = None
                    ) -> Tuple[torch.Tensor, GroundTruth]:
    """A batch in the loader's format (``image`` uint8 [B,S,S,3],
    ``gt_boxes`` float32 [B,G,4], ``gt_classes`` int [B,G], ``gt_valid``
    bool [B,G], ``gt_masks`` bool [B,G,S,S] or packbits uint8 [B,G,S,S/8];
    numpy arrays or tensors) -> (images, GroundTruth) on ``device``. B is
    ``ims`` (a rank's block), by default ``cfg.ims_per_batch``."""
    t = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    b, s, g = ims or cfg.ims_per_batch, cfg.train_size, cfg.max_instances
    if tuple(t["image"].shape) != (b, s, s, 3) or tuple(t["gt_boxes"].shape) != (b, g, 4):
        raise ValueError(
            f"batch shapes image {tuple(t['image'].shape)}, gt_boxes {tuple(t['gt_boxes'].shape)} "
            f"do not match ims_per_batch={b}, train_size={s}, max_instances={g}"
        )
    masks = t["gt_masks"]
    if masks.dtype == torch.uint8:
        masks = unpack_mask_bits(masks)
    gt = GroundTruth(
        boxes=t["gt_boxes"].float(),
        classes=t["gt_classes"].long(),
        valid=t["gt_valid"].bool(),
        masks=masks.bool(),
    )
    return t["image"], gt


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous block of a global batch (every array's
    leading axis split in ``world`` equal blocks)."""
    if world == 1:
        return batch
    n = len(batch["image"])
    if n % world:
        raise ValueError(f"a batch of {n} images does not split over {world} ranks")
    b = n // world
    return {k: v[rank * b : (rank + 1) * b] for k, v in batch.items()}


def average_gradients(params: Sequence[torch.Tensor], layout: RankLayout) -> None:
    """Replace each parameter's ``.grad`` with its mean over the data
    blocks: a whole parameter's over every rank (one all-reduce); fc1's
    bias, whose model blocks each hold a part of its gradient, summed over
    every rank and divided by the data blocks; a box-head block's over the
    ranks holding it (``layout.data_group``, a second all-reduce). A
    parameter without a gradient on some ranks counts zero there; one
    without a gradient on every rank keeps none (SGD skips it, as in one
    process)."""
    params = [p for p in params if p.requires_grad]
    world = layout.data * layout.model
    if world == 1 or not params:
        return
    split = [getattr(p, "model_split", None) for p in params]
    whole = [(p, layout.data if s == "sum" else world) for p, s in zip(params, split) if s != "block"]
    blocks = [(p, layout.data) for p, s in zip(params, split) if s == "block"]
    for part, group in ((whole, None), (blocks, layout.data_group)):
        if not part:
            continue
        dev = part[0][0].device
        has = torch.tensor([p.grad is not None for p, _ in part], dtype=torch.float32, device=dev)
        flat = rank_ops.all_reduce(torch.cat(
            [has] + [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float() for p, _ in part]),
            group=group)
        start = len(part)
        for (p, div), present in zip(part, flat[: len(part)].tolist()):
            n = p.numel()
            if present > 0:
                p.grad = (flat[start : start + n] / div).view_as(p).to(p.dtype)
            start += n


def train_step(
    model: MaskRCNN,
    optimizer,
    scheduler,
    batch: dict,
    cfg: TrainConfig,
    generators: Optional[Sequence[torch.Generator]] = None,
    draws: Optional[Sequence[Draws]] = None,
    layout: Optional[RankLayout] = None,
) -> Dict[str, float]:
    """One SGD step -> the loss components (floats, means over the global
    batch). ``batch`` is this rank's data block of it (the whole batch in
    one process); ``layout`` places the rank (by default every rank of the
    process group a data rank), and the gradients are averaged across the
    ranks before the step. Sampling draws come from ``draws`` (one per
    image of the block) or ``generators`` (one per image,
    :func:`image_generators`)."""
    dev = next(model.parameters()).device
    layout = layout or rank_layout()
    world = layout.data * layout.model
    images, gt = batch_to_device(batch, dev, cfg, ims=cfg.ims_per_batch // layout.data)
    with torch.autocast(device_type=dev.type, dtype=torch.bfloat16, enabled=cfg.use_bf16):
        losses = maskrcnn_loss(model, images, gt, generators=generators, draws=draws, **(cfg.loss_caps or {}))
    optimizer.zero_grad(set_to_none=True)
    losses["total"].backward()
    average_gradients([p for group in optimizer.param_groups for p in group["params"]], layout)
    optimizer_step(optimizer, scheduler, cfg.grad_clip_norm, layout)
    values = torch.stack([v.detach().float() for v in losses.values()])
    if world > 1:
        values = rank_ops.all_reduce(values) / world
    return dict(zip(losses, values.tolist()))


def _draw_seed(seed: int, step: int, index: int) -> int:
    """A 64-bit generator seed from (seed, step, image index)."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFF, step, index]).generate_state(2, np.uint32)
    return (int(words[0]) << 32) | int(words[1])


def image_generators(seed: int, step: int, images: Iterable[int], device) -> List[torch.Generator]:
    """The sampling generators of the ``images`` (indices in the step's
    global batch): each a function of (seed, step, index) only, so a rank
    holding image i draws what one process draws for it, and a resumed run
    what an uninterrupted one would."""
    return [torch.Generator(device=device).manual_seed(_draw_seed(seed, step, i)) for i in images]


def _checkpoints(ckpt_dir: Path):
    found = [(int(m.group(1)), p) for p in ckpt_dir.glob("step_*.pt") if (m := _CKPT.search(p.name))]
    return sorted(found)


def _model_state(obj) -> dict:
    return obj["model"] if isinstance(obj, dict) and "model" in obj else obj


def _split_params(model: MaskRCNN):
    """{state-dict key: (box head, its name there)} of the parameters split
    over a model group; empty when none is."""
    head = model.roi_heads.box_head
    if head.model_group is None:
        return {}
    return {f"roi_heads.box_head.{name}": (head, name) for name in head.SPLIT}


def full_state(model: MaskRCNN, optimizer) -> Tuple[dict, dict]:
    """(model state dict, optimizer state dict) in the one-process format:
    the box head's blocks and their momentum gathered over the model group
    (every rank of it calls this)."""
    sd, opt = model.state_dict(), optimizer.state_dict()
    split = _split_params(model)
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    params = dict(model.named_parameters())
    for key, (head, name) in split.items():
        sd[key] = head.gather(name, sd[key])
        i = index.get(id(params[key]))
        st = opt["state"].get(i)
        if st is not None and st.get("momentum_buffer") is not None:
            opt["state"][i] = {**st, "momentum_buffer": head.gather(name, st["momentum_buffer"])}
    return sd, opt


def load_full_state(model: MaskRCNN, optimizer, state: dict) -> None:
    """Load a checkpoint in the one-process format (``model`` and, when
    given, ``optimizer``); this rank takes its blocks of the split
    parameters and of their momentum."""
    split = _split_params(model)
    sd = dict(state["model"])
    for key, (head, name) in split.items():
        sd[key] = head.block_of(name, sd[key])
    model.load_state_dict(sd)
    if optimizer is None or "optimizer" not in state:
        return
    opt = state["optimizer"]
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    params = dict(model.named_parameters())
    opt = {**opt, "state": dict(opt["state"])}
    for key, (head, name) in split.items():
        i = index.get(id(params[key]))
        st = opt["state"].get(i)
        if st is not None and st.get("momentum_buffer") is not None:
            opt["state"][i] = {**st, "momentum_buffer": head.block_of(name, st["momentum_buffer"]).clone()}
    optimizer.load_state_dict(opt)


def _init_weights(model: MaskRCNN, init_checkpoint: Optional[str], cfg: TrainConfig, dev) -> None:
    """Fine-tuning weights (and freezing), or the from-scratch
    conditioning."""
    if init_checkpoint:
        path = os.path.expanduser(init_checkpoint)
        if path.endswith((".pth", ".pkl")):
            info = load_pretrained_params(path, model)
            log.info("Fine-tuning from %s (%d tensors loaded, %d head/shape re-inits)",
                     init_checkpoint, info["used"], len(info["skipped"]))
        else:
            model.load_state_dict(_model_state(torch.load(path, map_location=dev)), strict=True)
            log.info("Fine-tuning from %s", init_checkpoint)
        # fine-tuning protects the pretrained early layers; from scratch
        # everything trains (freezing would pin the zeroed residual norms)
        trainable = _trainable_mask(model)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable[name])
    elif cfg.zero_init_residual:
        zero_residual_norms(model)


def rank_devices(device, devices: Optional[Sequence], ims_per_batch: int, n_model_shards: int = 1
                 ) -> Optional[List[torch.device]]:
    """The devices of the ranks to start, one each, or None to train in this
    process (one device, or already a rank of a process group):
    ``devices`` when given (one may repeat; their count must be a
    :func:`train_layout` of itself), else on CUDA the first ``data *
    model`` local GPUs of ``train_layout(GPUs, n_model_shards,
    ims_per_batch)``."""
    if dist.is_available() and dist.is_initialized():
        return None
    if devices:
        ranks = [torch.device(d) for d in devices]
    elif resolve_device(device).type == "cuda":
        data, model = train_layout(torch.cuda.device_count(), n_model_shards, ims_per_batch)
        ranks = local_devices()[: data * model]
    else:
        return None
    if len(ranks) <= 1:
        return None
    data, model = train_layout(len(ranks), n_model_shards, ims_per_batch)
    if data * model != len(ranks):
        raise ValueError(f"ims_per_batch={ims_per_batch} with n_model_shards={n_model_shards} does not split over "
                         f"{len(ranks)} ranks: train_layout gives (data {data}, model {model})")
    return ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, devices: List[str], fn, kwargs: dict, results, level: int,
               numerics: Tuple[bool, bool, int]) -> None:
    """A started rank: its device current, the process group joined (NCCL
    when every rank has a GPU of its own, else gloo), ``fn(**kwargs)`` run
    on its device with the starting process's TF32 settings (cuDNN, matmul)
    and CPU threads; rank 0 hands the result back and logs at ``level``."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, threads = numerics
    torch.set_num_threads(threads)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    distinct = dev.type == "cuda" and len({str(d) for d in devices}) == world
    dist.init_process_group("nccl" if distinct else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        if rank == 0:
            from deepemia_tpu_torch.utils.logging_utils import setup_logging

            setup_logging(None, logging.getLevelName(level).lower())
        result = fn(**kwargs, device=dev)
        if rank == 0:
            results.put(result)
    finally:
        dist.destroy_process_group()


def start_ranks(devices: Sequence[torch.device], fn, **kwargs):
    """Run ``fn(**kwargs, device=...)`` on one started process a device
    (``torch.multiprocessing``, spawned), as ranks of one process group ->
    rank 0's result. Raises what a rank raised."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    level = logging.getLogger("deepemia_tpu_torch").getEffectiveLevel()
    names = [str(d) for d in devices]
    numerics = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())
    log.info("Training on %d ranks: %s", len(names), ", ".join(names))
    mp.start_processes(_rank_main, args=(len(names), _free_port(), names, fn, kwargs, results, level, numerics),
                       nprocs=len(names), join=True, start_method="spawn")
    return results.get()


def train_on_batches(
    batches: Iterable[dict],
    num_classes: int,
    output_dir: str,
    cfg: TrainConfig = TrainConfig(),
    init_checkpoint: Optional[str] = None,
    resume: bool = True,
    max_steps_override: Optional[int] = None,
    device=None,
    devices: Optional[Sequence] = None,
) -> Tuple[str, Dict[str, float]]:
    """Train Mask R-CNN on ``batches`` (dicts in the loader's format, see
    :func:`batch_to_device`) on ``device`` (``cuda`` unless the caller
    passes another) -> (final weights path, last step's losses).

    A list or tuple of batches is one epoch and repeats; any other iterable
    is consumed once and must hold a batch for every step. Without
    ``max_iter`` the schedule length is :func:`auto_max_iter` of the
    epoch's image count. Checkpoints go to ``output_dir/ckpts`` (the newest
    two are kept); with ``resume`` the run continues from the newest one,
    with the batch stream restarted from its start, as the JAX loader is.
    The final weights are ``output_dir/model_final_{backbone}.pt``.

    Parallel (:func:`rank_devices`): ``devices`` names the ranks'
    devices, by default every GPU of the ``train_layout``; inside a process
    group this process trains as its rank."""
    ranks = rank_devices(device, devices, cfg.ims_per_batch, cfg.n_model_shards)
    if ranks is not None:
        if not isinstance(batches, (list, tuple)):
            raise ValueError("data-parallel training on started ranks takes a list of batches")
        return start_ranks(ranks, train_on_batches, batches=list(batches), num_classes=num_classes,
                           output_dir=output_dir, cfg=cfg, init_checkpoint=init_checkpoint, resume=resume,
                           max_steps_override=max_steps_override)
    rank, world = process_group()
    layout = rank_layout(cfg.n_model_shards, cfg.ims_per_batch)
    dev = _indexed_device(device)
    out_dir = Path(output_dir)
    ckpt_dir = out_dir / "ckpts"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    max_iter = max_steps_override or cfg.max_iter or auto_max_iter(len(batches) * cfg.ims_per_batch)

    model = build_train_model(cfg.backbone, num_classes, device=dev, seed=cfg.seed)
    _init_weights(model, init_checkpoint or cfg.init_checkpoint, cfg, dev)
    if layout.model > 1:
        model.roi_heads.box_head.shard(layout.model_group, layout.m, layout.model)
    optimizer, scheduler = make_optimizer(
        [p for p in model.parameters() if p.requires_grad],
        cfg.base_lr, max_iter, cfg.warmup_iters, cfg.gamma,
    )

    start_step = 0
    found = _checkpoints(ckpt_dir)
    if resume and found:
        start_step, path = found[-1]
        state = torch.load(path, map_location=dev)
        load_full_state(model, optimizer, state)
        scheduler.load_state_dict(state["scheduler"])
        # the rate of the next step follows this run's schedule (its
        # max_iter may differ from the saved run's), as optax's count does
        for group, lr_lambda in zip(optimizer.param_groups, scheduler.lr_lambdas):
            group["lr"] = lr_lambda(start_step)
        if rank == 0:
            log.info("Resumed from step %d", start_step)

    stream = itertools.cycle(batches) if isinstance(batches, (list, tuple)) else iter(batches)
    metrics: Dict[str, float] = {}
    block = cfg.ims_per_batch // layout.data
    if rank == 0:
        log.info("Training %s on %s%s: steps %d-%d", cfg.backbone, dev,
                 f" and {world - 1} more ranks (data {layout.data} x model {layout.model})" if world > 1 else "",
                 start_step, max_iter)
    for step in range(start_step, max_iter):
        batch = next(stream, None)
        if batch is None:
            raise ValueError(f"batches ran out at step {step} of {max_iter}")
        gens = image_generators(cfg.seed, step, range(layout.d * block, (layout.d + 1) * block), dev)
        metrics = train_step(model, optimizer, scheduler, shard_batch(batch, layout.d, layout.data), cfg, gens,
                             layout=layout)
        done = step + 1
        if rank == 0 and (done % cfg.log_every == 0 or done == max_iter):
            log.info(
                "step %d/%d loss %.4f (rpn %.3f/%.3f cls %.3f box %.3f mask %.3f) lr %.3g",
                done, max_iter, metrics["total"], metrics["rpn_cls"], metrics["rpn_loc"],
                metrics["cls"], metrics["box"], metrics["mask"], scheduler.get_last_lr()[0],
            )
        if done % cfg.checkpoint_every == 0 or done == max_iter:
            model_sd, opt_sd = full_state(model, optimizer)
            if rank == 0:
                state = {
                    "step": done,
                    "model": model_sd,
                    "optimizer": opt_sd,
                    "scheduler": scheduler.state_dict(),
                }
                torch.save(state, ckpt_dir / f"step_{done:08d}.pt")
                for _, old in _checkpoints(ckpt_dir)[:-_KEEP_CHECKPOINTS]:
                    old.unlink()
            _barrier(dev)

    final = out_dir / f"model_final_{cfg.backbone.lower()}.pt"
    model_sd, _ = full_state(model, optimizer)
    if rank == 0:
        torch.save({"model": model_sd, "backbone": cfg.backbone, "num_classes": num_classes}, final)
        log.info("Final weights: %s", final)
    _barrier(dev)
    return str(final), metrics


def _indexed_device(device) -> torch.device:
    """:func:`resolve_device`, a GPU named by its index: ``cuda`` alone is the
    thread's current GPU (the one ``maybe_init_distributed`` gave a
    launcher's rank), as NCCL's barrier takes it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def train(
    records: List[dict],
    num_classes: int,
    output_dir: str,
    cfg: TrainConfig = TrainConfig(),
    init_checkpoint: Optional[str] = None,
    resume: bool = True,
    max_steps_override: Optional[int] = None,
    device=None,
    devices: Optional[Sequence] = None,
) -> Tuple[str, Dict[str, float]]:
    """Train Mask R-CNN on registered records (``data/datasets.py``) ->
    (final weights path, last step's losses): the ``TrainLoader`` of the
    config's size, augmentation and workers feeds :func:`train_on_batches`,
    and the schedule is :func:`auto_max_iter` of the record count unless
    ``max_steps_override`` or ``cfg.max_iter`` sets it. Data-parallel as
    :func:`train_on_batches` is: every rank runs the loader with the same
    seed, so the ranks' blocks make one global batch."""
    ranks = rank_devices(device, devices, cfg.ims_per_batch, cfg.n_model_shards)
    if ranks is not None:
        return start_ranks(ranks, train, records=records, num_classes=num_classes, output_dir=output_dir, cfg=cfg,
                           init_checkpoint=init_checkpoint, resume=resume, max_steps_override=max_steps_override)
    dev = _indexed_device(device)
    max_iter = max_steps_override or cfg.max_iter or auto_max_iter(len(records))
    loader = TrainLoader(
        records, cfg.ims_per_batch, cfg.train_size, cfg.max_instances, cfg.augment, cfg.seed,
        resize_mode=cfg.resize_mode, min_size_range=tuple(cfg.min_size_range), max_size=cfg.max_size,
        workers=cfg.loader_workers,
    )
    try:
        return train_on_batches(iter(loader), num_classes, output_dir, cfg, init_checkpoint, resume, max_iter, dev)
    finally:
        loader.close()

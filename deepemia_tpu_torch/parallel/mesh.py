"""Devices for the port's parallel axes (counterpart of the JAX package's
``deepemia_tpu/parallel/mesh.py``).

The JAX package builds ``jax.sharding.Mesh`` objects; the port keeps plain
lists of ``torch.device`` and runs one host thread (serving) or one process
(training) per entry:

  * ``tile``: a micrograph's tile grid split across GPUs
    (``inference/engine.py``), and ensemble members on disjoint groups of
    them (``inference/pipeline.py``);
  * ``data``: the training batch split across ranks of a process group
    (``train/trainer.py``), one GPU each.

A list may name one device more than once: two shards on one GPU run the
sharded path where only one card exists, and on the CPU the tests run k
shards as ``[cpu] * k``. Nothing here chooses that by default.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch


def local_devices() -> List[torch.device]:
    """Every CUDA device of this process, in index order (``jax.devices()``
    of one host)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def tile_devices(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a tile grid is sharded over: ``devices`` (e.g. one group of
    :func:`partition_devices` for a member-parallel ensemble), by default
    every local GPU, cut to the first ``n_devices`` when given."""
    devs = list(devices) if devices is not None else local_devices()
    if n_devices:
        devs = devs[:n_devices]
    return [torch.device(d) for d in devs]


def partition_devices(devices, k: int):
    """Split ``devices`` into ``k`` contiguous groups, sizes differing by at
    most one, earlier groups larger (never an empty group: at most one per
    device)."""
    devices = list(devices)
    n = len(devices)
    k = max(1, min(k, n))
    base, extra = divmod(n, k)
    groups, start = [], 0
    for i in range(k):
        size = base + (1 if i < extra else 0)
        groups.append(devices[start : start + size])
        start += size
    return groups


def data_world_size(n_devices: int, ims_per_batch: int) -> int:
    """Ranks of data-parallel training: the JAX trainer's data axis
    (``deepemia_tpu/train/trainer.py:make_mesh`` with one model shard): every
    device, or, when the batch holds fewer images than there are devices,
    the gcd of the two, so that every rank takes an equal block. Where the
    JAX rule would split a larger batch unevenly (6 images on 4 devices,
    which it cannot shard), the gcd too."""
    data = max(1, n_devices)
    return data if ims_per_batch % data == 0 else math.gcd(data, ims_per_batch)

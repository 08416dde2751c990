"""Devices for the port's parallel axes (counterpart of the JAX package's
``deepemia_tpu/parallel/mesh.py``).

The JAX package builds ``jax.sharding.Mesh`` objects; the port keeps plain
lists of ``torch.device`` and runs one host thread (serving) or one process
(training) per entry:

  * ``tile``: a micrograph's tile grid split across GPUs
    (``inference/engine.py``), and ensemble members on disjoint groups of
    them (``inference/pipeline.py``); inside a process group, across the
    GPUs of every rank: a list of ``(rank, device)`` pairs in rank order
    (:func:`global_devices`), so that two ranks' ``cuda:0`` stay apart;
  * ``(data, model)``: training ranks, the batch split over ``data``
    and the box head's two fully connected layers over ``model``
    (:func:`train_layout`, ``train/trainer.py``, ``models/heads.py``), one
    GPU each.

A list may name one device more than once: two shards on one GPU run the
sharded path where only one card exists, and on the CPU the tests run k
shards as ``[cpu] * k``. Nothing here chooses that by default.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import torch


def local_devices() -> List[torch.device]:
    """Every CUDA device of this process, in index order (``jax.devices()``
    of one host)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def tile_devices(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> List:
    """The devices a tile grid is sharded over: ``devices`` (e.g. one group of
    :func:`partition_devices` for a member-parallel ensemble, or
    :func:`global_devices`' pairs), by default every local GPU, cut to the
    first ``n_devices`` when given."""
    devs = list(devices) if devices is not None else local_devices()
    if n_devices:
        devs = devs[:n_devices]
    return [d if isinstance(d, tuple) else torch.device(d) for d in devs]


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


def owned_devices(local: Sequence, local_rank: Optional[int] = None, local_world: Optional[int] = None
                  ) -> List[torch.device]:
    """The devices of ``local`` (a host's GPUs) that one process of a
    launcher's group owns: group ``local_rank`` of
    ``partition_devices(local, local_world)`` (``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets them; by default one process
    a host). One process per GPU owns ``local[local_rank]``, one process a
    host every GPU; a rank past the last group (more processes than GPUs)
    owns none."""
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", 0)) if local_rank is None else local_rank
    local_world = int(env.get("LOCAL_WORLD_SIZE", 1)) if local_world is None else local_world
    groups = partition_devices(local, max(1, local_world))
    return [torch.device(d) for d in groups[local_rank]] if local_rank < len(groups) and local else []


def global_devices(mine: Sequence) -> List[Tuple[int, torch.device]]:
    """Every rank's devices, in rank order (``jax.devices()`` across
    processes), as ``(rank, device)`` pairs; ``mine`` are this rank's.
    Exchanged once, with ``all_gather_object`` over the default group."""
    import torch.distributed as dist

    names: List = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in mine])
    return [(r, torch.device(n)) for r, ns in enumerate(names) for n in ns]


def train_layout(n_devices: int, n_model: int, ims_per_batch: int) -> Tuple[int, int]:
    """(data, model): the JAX trainer's mesh shape
    (``deepemia_tpu/train/trainer.py:make_mesh(n_model, max_data=ims)`` over
    ``n_devices``). ``n_model`` is cut to the devices and lowered until it
    divides them; ``data`` is the rest, or, when the batch holds fewer
    images, the gcd of the two. Where the JAX rule would split a larger
    batch unevenly (6 images on 4 devices, which it cannot shard), the gcd
    too, so that every data rank takes an equal block. Rank ``r`` is
    ``divmod(r, model)``, as ``reshape(data, model)`` orders devices."""
    n = max(1, n_devices)
    n_model = max(1, min(n_model, n))
    while n % n_model:
        n_model -= 1
    data = n // n_model
    return (data if ims_per_batch % data == 0 else math.gcd(data, ims_per_batch)), n_model

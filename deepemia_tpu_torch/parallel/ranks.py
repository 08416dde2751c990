"""The process group, for code that runs the same on every rank of one
(``torch.distributed``, started by ``utils/device.maybe_init_distributed``
or by ``train/trainer.start_ranks``), and nothing outside one.

Collectives run on the backend's device: NCCL's on the rank's current GPU,
gloo's on the host (gloo serves ranks that share one GPU, which NCCL
refuses). A tensor that lies elsewhere is staged there and the result
copied back, so a host tensor reaches NCCL and a CUDA tensor gloo by one
rule. Every rank calls the same collectives in the same order; a rank
that fails tells the others through the collective it was due to join
(:func:`agree`), so a failure is raised on every rank instead of leaving
the rest waiting.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deepemia_tpu_torch.utils.exceptions import PipelineError


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of this process's group; (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_lead() -> bool:
    """Whether this process writes a task's files: rank 0, or no group."""
    return rank_world()[0] == 0


def barrier(dev: torch.device) -> None:
    """Every rank of the process group, if there is one, waits here (the
    files rank 0 wrote exist after it); ``dev`` is this rank's device
    (NCCL's barrier takes its GPU index, by default the current one)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device() if dev.index is None else dev.index])
    else:
        dist.barrier()


def comm_device(group=None) -> torch.device:
    """Where ``group``'s collectives run: NCCL's current GPU, else the host."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` contiguous on the backend's device (itself when it lies there)."""
    return t.to(comm_device(group)).contiguous()


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """The reduction of ``t`` over ``group`` (a new tensor on ``t``'s
    device; ``t`` is left as it was unless it was already staged)."""
    s = _staged(t, group)
    if s is t:
        s = t.clone()
    dist.all_reduce(s, op=op, group=group)
    return s.to(t.device)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (``t`` sets the shape and dtype
    elsewhere), on ``t``'s device."""
    s = _staged(t, group)
    dist.broadcast(s, src=src, group=group)
    return s.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in rank order, on
    ``t``'s device."""
    s = _staged(t, group)
    out = [torch.empty_like(s) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, s, group=group)
    return [o.to(t.device) for o in out]


def gather(t: torch.Tensor, dst: int, group=None) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (one shape on every rank), in rank order, on rank
    ``dst`` (on ``t``'s device); None elsewhere."""
    s = _staged(t, group)
    if dist.get_rank() != dst:
        dist.gather(s, None, dst=dst, group=group)
        return None
    out = [torch.empty_like(s) for _ in range(dist.get_world_size(group))]
    dist.gather(s, out, dst=dst, group=group)
    return [o.to(t.device) for o in out]


def agree(ok: bool) -> bool:
    """Whether ``ok`` holds on every rank (one all-reduce); ``ok`` outside
    a group."""
    if rank_world()[1] == 1:
        return ok
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=comm_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def same_on_every_rank(items: Sequence[str], what: str) -> None:
    """Raise ``PipelineError`` on every rank, naming the first difference,
    unless every rank holds the same ``items`` (one ``all_gather_object``)."""
    rank, world = rank_world()
    if world == 1:
        return
    lists: List = [None] * world
    dist.all_gather_object(lists, list(items))
    for r, other in enumerate(lists[1:], start=1):
        if other == lists[0]:
            continue
        i = next((i for i, (a, b) in enumerate(zip(lists[0], other)) if a != b), min(len(lists[0]), len(other)))
        first = lists[0][i] if i < len(lists[0]) else "nothing"
        theirs = other[i] if i < len(other) else "nothing"
        raise PipelineError(
            f"the ranks do not agree on {what}: rank 0 has {len(lists[0])}, rank {r} {len(other)}; at position {i} "
            f"rank 0 has {first!r} and rank {r} {theirs!r} (this is rank {rank})", stage="distributed",
        )

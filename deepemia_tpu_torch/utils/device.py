"""CUDA preflight: what the CLI checks and reports before a task.

The JAX package probes its accelerator backend in a subprocess and asks
whether to go on without one (``utils/device.py``). The port's entry points
run on CUDA unless the caller asks for the CPU, so the preflight reports
the card (name, power limit, memory, compute capability, device count) and
raises when CUDA is asked for and absent; it never falls back to the CPU.
``maybe_init_distributed`` is the JAX module's multi-host start, for
``torch.distributed``; the device lists of the parallel axes are in
``parallel/mesh.py``.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Dict

import torch

from deepemia_tpu_torch.utils.exceptions import PipelineError

log = logging.getLogger("deepemia_tpu_torch.device")


def power_limit(index: int = 0) -> str:
    """The card's power limit as ``nvidia-smi`` reports it, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({type(e).__name__})"
    return out.stdout.strip() if out.returncode == 0 else f"unknown (nvidia-smi exit {out.returncode})"


def device_info(index: int = 0) -> Dict[str, object]:
    """The CUDA device ``index`` as torch and ``nvidia-smi`` see it."""
    props = torch.cuda.get_device_properties(index)
    return {
        "platform": "cuda",
        "name": props.name,
        "power_limit": power_limit(index),
        "memory_gb": props.total_memory / 1e9,
        "capability": f"{props.major}.{props.minor}",
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def check_accelerator_availability(device: str = "cuda") -> Dict[str, object]:
    """Preflight for ``device``: the CPU is reported as asked for; CUDA must
    be present (else ``PipelineError``), and the card is reported."""
    if torch.device(device).type == "cpu":
        log.info("Running on the CPU, as asked (--device cpu)")
        return {"platform": "cpu", "count": 0}
    if not torch.cuda.is_available():
        raise PipelineError(
            "CUDA is not available: torch finds no usable NVIDIA GPU. Pass --device cpu to run on the CPU.",
            stage="preflight",
        )
    info = device_info(torch.device(device).index or 0)
    log.info(
        "CUDA device: %s, power limit %s, %.1f GB, compute capability %s, %d device(s), torch %s, CUDA %s",
        info["name"], info["power_limit"], info["memory_gb"], info["capability"], info["count"],
        info["torch"], info["cuda"],
    )
    return info


def maybe_init_distributed(device: str = "cuda") -> bool:
    """Start ``torch.distributed`` from the environment a launcher sets
    (``deepemia_tpu/utils/device.py:183-216``): ``torchrun``'s
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``, or
    ``DEEPEMIA_DISTRIBUTED=1`` beside them. NCCL on CUDA, with each rank's
    current GPU ``LOCAL_RANK`` (else the rank) modulo the GPUs; gloo on the
    CPU, and on CUDA where the host's ranks (``LOCAL_WORLD_SIZE``) outnumber
    its GPUs, since NCCL refuses two ranks on one GPU. Returns False, doing
    nothing, when nothing is set, and True when a process group runs (this
    start's or an earlier one's).

    A start that fails raises ``PipelineError``: the JAX function warns and
    runs on one host, but a run of several processes that was asked for
    must not go on quietly as one."""
    import torch.distributed as dist

    env = os.environ
    if env.get("DEEPEMIA_DISTRIBUTED") != "1" and not all(env.get(k) for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
        return False
    if dist.is_initialized():
        return True
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE") if not env.get(k)]
    if missing:
        raise PipelineError(f"torch.distributed was asked for but {', '.join(missing)} is not set", stage="distributed")
    cuda = torch.device(device).type == "cuda"
    backend = "gloo"
    try:
        if cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available")
            gpus = torch.cuda.device_count()
            torch.cuda.set_device(int(env.get("LOCAL_RANK", env["RANK"])) % gpus)
            backend = "nccl" if int(env.get("LOCAL_WORLD_SIZE", 1)) <= gpus else "gloo"
        dist.init_process_group(backend, init_method="env://")
    except Exception as e:  # noqa: BLE001 - reported with what was asked for
        raise PipelineError(
            f"torch.distributed failed to start ({backend}, rank {env['RANK']} of {env['WORLD_SIZE']} at "
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}): {e}", stage="distributed",
        ) from e
    log.info("torch.distributed started: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(), backend)
    return True

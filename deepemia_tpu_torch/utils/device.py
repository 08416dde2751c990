"""CUDA preflight: what the CLI checks and reports before a task.

The JAX package probes its accelerator backend in a subprocess and asks
whether to go on without one (``utils/device.py``). The port's entry points
run on CUDA unless the caller asks for the CPU, so the preflight reports
the card (name, power limit, memory, compute capability, device count) and
raises when CUDA is asked for and absent; it never falls back to the CPU.
The JAX module's multi-host start and mesh helpers belong to tile sharding
across GPUs (ROADMAP A8) and are not ported.
"""

from __future__ import annotations

import logging
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

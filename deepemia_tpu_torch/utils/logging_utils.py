"""Logging setup and memory telemetry (the JAX package's
``utils/logging_utils.py`` for the port).

``setup_logging`` configures the package's logger explicitly (a DEBUG file
handler in ``logs_dir`` and a console handler at the chosen level);
``log_memory_usage`` records the host's resident memory and each CUDA
device's allocated memory.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Optional

_LOGGER_NAME = "deepemia_tpu_torch"
_configured = False

system_logger = logging.getLogger(_LOGGER_NAME)

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def setup_logging(logs_dir: Optional[str] = None, console_level: str = "info") -> logging.Logger:
    """Configure the package logger: a console handler at ``console_level``
    and, the first time a ``logs_dir`` is given, a DEBUG file handler
    writing a timestamped file there."""
    global _configured
    logger = logging.getLogger(_LOGGER_NAME)
    if not _configured:
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        console._deepemia_console = True  # type: ignore[attr-defined]
        logger.addHandler(console)
        _configured = True
    set_console_log_level(console_level)
    if logs_dir and not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        path = Path(os.path.expanduser(logs_dir))
        path.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path / f"system_{time.strftime('%Y%m%d_%H%M%S')}.log")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s %(filename)s:%(lineno)d: %(message)s"))
        logger.addHandler(fh)
    return logger


def set_console_log_level(level: str) -> None:
    """Set the console handler's level at run time."""
    for h in logging.getLogger(_LOGGER_NAME).handlers:
        if getattr(h, "_deepemia_console", False):
            h.setLevel(_LEVELS.get(level.lower(), logging.INFO))


def host_rss_bytes() -> int:
    """The process's resident memory: ``psutil`` when it is installed, else
    ``/proc/self/statm`` (Linux)."""
    try:
        import psutil
    except ImportError:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return int(psutil.Process().memory_info().rss)


def log_memory_usage(tag: str = "") -> dict:
    """Log and return the host's resident memory and, per CUDA device, the
    memory torch holds allocated and its peak, in MB."""
    import torch

    stats = {"host_rss_mb": host_rss_bytes() / 1e6}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats[f"cuda{i}_allocated_mb"] = torch.cuda.memory_allocated(i) / 1e6
            stats[f"cuda{i}_peak_mb"] = torch.cuda.max_memory_allocated(i) / 1e6
    system_logger.debug("memory%s: %s", f" [{tag}]" if tag else "",
                        ", ".join(f"{k}={v:.1f}" for k, v in stats.items()))
    return stats

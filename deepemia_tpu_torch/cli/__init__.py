"""The port's command line (``main``), its interactive wizard (``wizard``),
and the command both the wizard and the web panel run a task with."""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict, List, Tuple

REPO_ROOT = str(Path(__file__).resolve().parents[2])


def task_command(argv: List[str]) -> Tuple[List[str], Dict[str, str]]:
    """``python -m deepemia_tpu_torch.cli.main *argv`` in a fresh
    interpreter, and its environment: this process's, with the checkout's
    root first on ``PYTHONPATH``, so that the child finds the package
    whatever its working directory."""
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": REPO_ROOT + (os.pathsep + path if path else "")}
    return [sys.executable, "-m", "deepemia_tpu_torch.cli.main", *argv], env

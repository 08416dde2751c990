"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and compiles,
on first use, into ``build/torch_kernels/lib<name>-<hash>.so`` at the root
of the checkout (the hash covers the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source rebuilds). Several sources build in parallel, one ``nvcc`` each.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once. Raises with the compiler's output if any
    build fails."""
    names = list(names)
    targets = {nm: _target(nm) for nm in names}
    todo = [nm for nm in names if not targets[nm].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for nm in todo:
            tmp = targets[nm].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{nm}.cu")]
            procs[nm] = (
                tmp,
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
            )
        failed = []
        for nm, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_logs[nm] = out
            if proc.returncode != 0:
                failed.append(f"{nm}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, targets[nm])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]

"""Path-traversal-guarded file operations and temporary directories (a
copy of the JAX package's ``utils/safe_ops.py``): the CLI's ``--cleanup``
removes local data only through :func:`safe_remove_files`, which refuses
any path outside its allowed bases."""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

log = logging.getLogger("deepemia_tpu_torch.safe_ops")


def validate_path_safety(path: str, allowed_bases: Sequence[str]) -> Path:
    """Resolve ``path`` and require it to live under one of ``allowed_bases``.

    Raises ValueError on traversal outside the allowlist.
    """
    resolved = Path(os.path.expanduser(path)).resolve()
    for base in allowed_bases:
        base_r = Path(os.path.expanduser(base)).resolve()
        try:
            resolved.relative_to(base_r)
            return resolved
        except ValueError:
            continue
    raise ValueError(
        f"Path {resolved} is outside allowed base directories {list(allowed_bases)}"
    )


def safe_remove_files(
    paths: Iterable[str], allowed_bases: Sequence[str]
) -> List[Path]:
    """Remove files/dirs after allowlist validation; returns removed paths."""
    removed: List[Path] = []
    for p in paths:
        try:
            rp = validate_path_safety(p, allowed_bases)
        except ValueError as e:
            log.warning("Refusing unsafe removal: %s", e)
            continue
        if rp.is_dir():
            shutil.rmtree(rp, ignore_errors=True)
            removed.append(rp)
        elif rp.exists():
            rp.unlink()
            removed.append(rp)
    return removed


def safe_copy(src: str, dst: str, allowed_bases: Sequence[str]) -> Path:
    dst_p = validate_path_safety(dst, allowed_bases)
    dst_p.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(os.path.expanduser(src), dst_p)
    return dst_p


def safe_move(src: str, dst: str, allowed_bases: Sequence[str]) -> Path:
    src_p = validate_path_safety(src, allowed_bases)
    dst_p = validate_path_safety(dst, allowed_bases)
    dst_p.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(src_p), str(dst_p))
    return dst_p


def make_temp_dir(prefix: str = "deepemia_") -> Path:
    return Path(tempfile.mkdtemp(prefix=prefix))


def cleanup_old_temp_dirs(
    max_age_hours: float = 24.0, prefix: str = "deepemia_", root: Optional[str] = None
) -> int:
    """Remove stale temp dirs older than ``max_age_hours``."""
    root_p = Path(root or tempfile.gettempdir())
    cutoff = time.time() - max_age_hours * 3600
    n = 0
    for d in root_p.glob(f"{prefix}*"):
        try:
            if d.is_dir() and d.stat().st_mtime < cutoff:
                shutil.rmtree(d, ignore_errors=True)
                n += 1
        except OSError:
            continue
    return n

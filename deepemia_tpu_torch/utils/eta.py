"""ETA tracking: JSON-persisted running averages per task (a copy of the
JAX package's ``utils/eta.py``): each new observation is folded in with
half weight, inference keeps a per-image average and a safety buffer."""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

DEFAULT_ETA: Dict[str, Any] = {
    "prepare": {"average_time": 20.0},
    "train": {"average_time": 1800.0},
    "evaluate": {"average_time": 20.0},
    "inference": {"average_time_per_image": 10.0, "buffer": 1.1},
    "download": {"average_time": 30.0},
    "upload": {"average_time": 30.0},
}

_lock = threading.Lock()


def read_eta_data(eta_file: str) -> Dict[str, Any]:
    """Load ETA store, falling back to defaults on missing/corrupt file."""
    path = Path(os.path.expanduser(eta_file))
    if not path.exists():
        return json.loads(json.dumps(DEFAULT_ETA))
    try:
        with open(path) as f:
            data = json.load(f)
    except (json.JSONDecodeError, OSError):
        return json.loads(json.dumps(DEFAULT_ETA))
    merged = json.loads(json.dumps(DEFAULT_ETA))
    for task, rec in data.items():
        if isinstance(rec, dict):
            merged.setdefault(task, {}).update(rec)
    return merged


def update_eta_data(
    eta_file: str,
    task: str,
    elapsed_seconds: float,
    num_images: Optional[int] = None,
) -> Dict[str, Any]:
    """Fold a new observation in with a half-weight running average
    (new_avg = (old + new) / 2) and write the file atomically."""
    with _lock:
        data = read_eta_data(eta_file)
        rec = data.setdefault(task, {})
        if task == "inference" and num_images:
            per_image = elapsed_seconds / max(num_images, 1)
            old = rec.get("average_time_per_image", per_image)
            rec["average_time_per_image"] = (old + per_image) / 2.0
            rec.setdefault("buffer", 1.1)
        else:
            old = rec.get("average_time", elapsed_seconds)
            rec["average_time"] = (old + elapsed_seconds) / 2.0
        path = Path(os.path.expanduser(eta_file))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
        os.replace(tmp, path)
        return data


def estimate_eta(
    eta_file: str, task: str, num_images: Optional[int] = None
) -> float:
    """Estimated seconds for a task (per-image scaled for inference)."""
    data = read_eta_data(eta_file)
    rec = data.get(task, {})
    if task == "inference" and num_images:
        return (
            rec.get("average_time_per_image", 10.0)
            * num_images
            * rec.get("buffer", 1.1)
        )
    return float(rec.get("average_time", 60.0))

"""Dataset metadata the inference pipeline reads: the category file and a
dataset's class names (the JAX package's ``read_dataset_info`` and the
class-name half of its ``register_datasets``)."""

from __future__ import annotations

import json
import os
from typing import Dict, List


def read_dataset_info(file_path: str) -> Dict[str, tuple]:
    """{dataset: (img_dir, label_dir, [class names])} from the category
    JSON."""
    with open(os.path.expanduser(file_path)) as f:
        data = json.load(f)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in data.items()}


def dataset_class_names(dataset_info: Dict[str, tuple], dataset_name: str) -> List[str]:
    """The class names of ``dataset_name``; raises ``KeyError`` for a
    dataset the category file does not list."""
    if dataset_name not in dataset_info:
        raise KeyError(f"Dataset '{dataset_name}' not found in dataset_info")
    return list(dataset_info[dataset_name][2])

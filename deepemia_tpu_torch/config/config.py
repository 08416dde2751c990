"""The built-in default configuration and the merge of overrides.

Counterpart of the JAX package's ``config/config.py`` without its YAML
store: callers hand ``InferencePipeline`` a config dict, which starts from
:func:`default_config` and takes overrides through :func:`deep_merge`.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Dict, Optional

ENV_HOME = "DEEPEMIA_TPU_HOME"


def framework_home() -> Path:
    """Root directory for configs and outputs (``DEEPEMIA_TPU_HOME``,
    default ``~/deepemia_tpu``)."""
    return Path(os.environ.get(ENV_HOME, str(Path.home() / "deepemia_tpu")))


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into ``base`` (override wins).

    Same semantics as reference config.py:21-40 but without mutating either
    input (full deep copy of the base branch being overridden).
    """
    result = dict(base)
    for key, value in override.items():
        if key in result and isinstance(result[key], dict) and isinstance(value, dict):
            result[key] = deep_merge(result[key], value)
        else:
            result[key] = copy.deepcopy(value)
    return result


def default_config(home: Optional[Path] = None) -> Dict[str, Any]:
    """The built-in default configuration (reference config/config.yaml)."""
    home = home or framework_home()
    h = str(home)
    return {
        "bucket": "",
        "paths": {
            "split_dir": f"{h}/split_dir",
            "category_json": f"{h}/dataset_info.json",
            "eta_file": f"{h}/config/eta_data.json",
            "logs_dir": f"{h}/logs",
            "output_dir": f"{h}/output",
            "local_dataset_root": h,
            "dataset_configs_dir": f"{h}/config/datasets",
        },
        "scale_bar_rois": {
            "default": {
                "x_start_factor": 0.7,
                "y_start_factor": 0.05,
                "width_factor": 1.0,
                "height_factor": 0.05,
            }
        },
        "scalebar_thresholds": {
            "intensity": 100,
            "proximity": 100,
            "merge_gap": 15,
            "min_line_length": 30,
            "edge_margin_factor": 0.1,
        },
        "measure_contrast_distribution": False,
        "rcnn_hyperparameters": {
            "default": {
                "R50": {
                    "base_lr": 0.00025,
                    "ims_per_batch": 2,
                    "warmup_iters": 1000,
                    "gamma": 0.1,
                    "batch_size_per_image": 64,
                },
                "R101": {
                    "base_lr": 0.00025,
                    "ims_per_batch": 2,
                    "warmup_iters": 1000,
                    "gamma": 0.1,
                    "batch_size_per_image": 64,
                },
            },
            "best": {"R50": {}, "R101": {}},
        },
        "inference_settings": {
            "use_class_specific_inference": True,
            "confidence_mode": "auto",
            "iterative_stopping": {
                "min_total_masks": 10,
                "min_relative_increase": 0.25,
                "max_consecutive_zero": 1,
                "min_iterations": 2,
            },
            "class_specific_settings": {
                "class_0": {
                    "confidence_threshold": 0.5,
                    "iou_threshold": 0.7,
                    "min_size": 25,
                    "min_size_factor": 0.0001,
                },
                "class_1": {
                    "confidence_threshold": 0.3,
                    "iou_threshold": 0.5,
                    "min_size": 3,
                    "min_size_factor": 0.000005,
                    "use_multiscale": True,
                },
            },
            "ensemble_settings": {
                "enabled": True,
                "small_classes_only": True,
                "weights": {"R50": 0.6, "R101": 0.4},
            },
            "multiscale_settings": {
                "baseline_scales": [0.7, 1.0, 1.5, 2.0],
                "aggressive_scales": [1.0, 1.5, 2.0, 2.5, 3.0],
                "max_scale": 3.0,
            },
            "use_tile_based_inference": True,
            "use_iterative_inference": False,
            "tile_settings": {
                "tile_size": 512,
                "overlap_ratio": 0.1,
                "upscale_factor": 2.0,
                "edge_filter_enabled": True,
                "tile_batch_size": 16,
            },
            "spatial_constraints": {"default": {"enabled": False}},
        },
        "performance": {
            "inference_batch_size": 1,
            "measurement_batch_size": 3,
            "max_worker_threads": 3,
            "enable_parallel_image_loading": True,
            "use_bf16": True,
            # int8 MXU backbone serving: none | trunk | full (SURVEY Q2
            # made real — same float checkpoint, quantized at serving time)
            "quantized_inference": "none",
            "stream_measurements_to_csv": True,
            "cleanup_individual_masks": True,
            "donate_buffers": True,
        },
    }

"""The configuration store: the built-in default, ``<home>/config/config.yaml``
validated against the schema, and each dataset's YAML merged over it
(the JAX package's ``config/config.py``).

A dataset YAML feeds ``inference_overrides`` into ``inference_settings``,
``scale_bar_roi`` into ``scale_bar_rois[<dataset>]``, ``spatial_constraints``
into ``inference_settings.spatial_constraints[<dataset>]`` and
``rcnn_hyperparameters.best_R50`` / ``best_R101`` into
``rcnn_hyperparameters.best``; any other key deep-merges under its own name.

PyYAML is imported by the functions that read or write YAML, so this module
imports without it; reading or writing a file then raises
:class:`ConfigurationError` naming the file and the missing module.
"""

from __future__ import annotations

import copy
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

from deepemia_tpu_torch.config.schema import validate_config
from deepemia_tpu_torch.utils.exceptions import ConfigurationError

log = logging.getLogger("deepemia_tpu_torch.config")

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


DATASET_TEMPLATE = """\
# Dataset-specific configuration for '{name}'
metadata:
  name: "{name}"
  description: "Describe the dataset here"

# Per-dataset scale bar region of interest (fractions of image size)
scale_bar_roi:
  x_start_factor: 0.7
  y_start_factor: 0.05
  width_factor: 1.0
  height_factor: 0.05

# Override inference settings (merged into inference_settings)
inference_overrides:
  class_specific_settings:
    class_0:
      confidence_threshold: 0.5

# Spatial constraints between detected classes
spatial_constraints:
  enabled: false
  overlap_rules: []
  containment_rules: []
"""

# dataset YAML keys with a channel of their own (the rest deep-merge directly)
_SPECIAL_KEYS = {
    "inference_overrides",
    "scale_bar_roi",
    "spatial_constraints",
    "rcnn_hyperparameters",
    "name",
    "description",
}


def _yaml(path: Path):
    """The ``yaml`` module, or a ConfigurationError naming ``path``."""
    try:
        import yaml
    except ImportError as e:
        raise ConfigurationError(
            f"Cannot read or write configuration file {path}: the module 'yaml' (PyYAML) is not installed"
        ) from e
    return yaml


class ConfigStore:
    """Loads, validates, caches and merges the global and per-dataset configs."""

    def __init__(self, home: Optional[Path] = None):
        self.home = Path(home) if home else framework_home()
        self.config_path = self.home / "config" / "config.yaml"
        self._config: Optional[Dict[str, Any]] = None
        self._dataset_configs: Dict[str, Optional[Dict[str, Any]]] = {}

    def ensure_default_config(self) -> Path:
        """Write the default config file if it does not exist."""
        if not self.config_path.exists():
            yaml = _yaml(self.config_path)
            self.config_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.config_path, "w") as f:
                yaml.safe_dump(default_config(self.home), f, sort_keys=False)
            log.info("Wrote default config to %s", self.config_path)
        return self.config_path

    def load(self, force: bool = False) -> Dict[str, Any]:
        if self._config is not None and not force:
            return self._config
        yaml = _yaml(self.config_path)
        self.ensure_default_config()
        try:
            with open(self.config_path) as f:
                raw = yaml.safe_load(f) or {}
        except yaml.YAMLError as e:
            raise ConfigurationError(f"Error parsing configuration file {self.config_path}: {e}") from e
        self._config = validate_config(raw)
        return self._config

    def save(self, config: Dict[str, Any]) -> None:
        """Write a (modified) global config back to disk."""
        yaml = _yaml(self.config_path)
        self.config_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.config_path, "w") as f:
            yaml.safe_dump(config, f, sort_keys=False)
        self._config = validate_config(config)

    @property
    def dataset_config_dir(self) -> Path:
        return Path(os.path.expanduser(self.load()["paths"]["dataset_configs_dir"]))

    def load_dataset_config(self, dataset_name: str) -> Optional[Dict[str, Any]]:
        if dataset_name in self._dataset_configs:
            return self._dataset_configs[dataset_name]
        path = self.dataset_config_dir / f"{dataset_name}.yaml"
        if not path.exists():
            self._dataset_configs[dataset_name] = None
            return None
        yaml = _yaml(path)
        try:
            with open(path) as f:
                ds_cfg = yaml.safe_load(f) or {}
        except yaml.YAMLError as e:
            log.error("Error loading dataset config for %s: %s", dataset_name, e)
            return None
        self._dataset_configs[dataset_name] = ds_cfg
        return ds_cfg

    def get(self, dataset_name: Optional[str] = None) -> Dict[str, Any]:
        """The global config, with the dataset's overrides merged when given."""
        base = self.load()
        if dataset_name is None:
            return base
        ds = self.load_dataset_config(dataset_name)
        if ds is None:
            return base
        merged = copy.deepcopy(base)
        direct = {k: v for k, v in ds.items() if k not in _SPECIAL_KEYS}
        if direct:
            merged = deep_merge(merged, direct)
        if "inference_overrides" in ds:
            merged["inference_settings"] = deep_merge(merged.get("inference_settings", {}), ds["inference_overrides"])
        if "scale_bar_roi" in ds:
            merged.setdefault("scale_bar_rois", {})[dataset_name] = ds["scale_bar_roi"]
        if "spatial_constraints" in ds:
            merged.setdefault("inference_settings", {}).setdefault("spatial_constraints", {})[dataset_name] = ds[
                "spatial_constraints"
            ]
        if "rcnn_hyperparameters" in ds:
            best = merged.setdefault("rcnn_hyperparameters", {}).setdefault("best", {})
            for key in ("best_R50", "best_R101"):
                if key in ds["rcnn_hyperparameters"]:
                    best[key.replace("best_", "")] = ds["rcnn_hyperparameters"][key]
        return merged

    def list_dataset_configs(self) -> List[str]:
        d = self.dataset_config_dir
        if not d.exists():
            return []
        return sorted(p.stem for p in d.glob("*.yaml"))

    def create_dataset_config(self, dataset_name: str, template: str = "template") -> Path:
        """A new dataset config from the built-in template or from an
        existing dataset's config."""
        d = self.dataset_config_dir
        d.mkdir(parents=True, exist_ok=True)
        target = d / f"{dataset_name}.yaml"
        if target.exists():
            log.warning("Dataset config already exists: %s", target)
            return target
        if template == "template":
            content = DATASET_TEMPLATE.format(name=dataset_name)
        else:
            src = d / f"{template}.yaml"
            if not src.exists():
                raise ConfigurationError(f"Template not found: {src}")
            content = src.read_text()
            for q in ('"', "'"):
                content = content.replace(f"name: {q}{template}{q}", f"name: {q}{dataset_name}{q}")
        target.write_text(content)
        self._dataset_configs.pop(dataset_name, None)
        log.info("Created dataset config: %s", target)
        return target

    def invalidate(self) -> None:
        self._config = None
        self._dataset_configs.clear()


# the process-wide store, made on first use and remade when the home changes
_default_store: Optional[ConfigStore] = None


def get_store() -> ConfigStore:
    global _default_store
    if _default_store is None or _default_store.home != framework_home():
        _default_store = ConfigStore()
    return _default_store


def get_config(dataset_name: Optional[str] = None) -> Dict[str, Any]:
    """The effective config of ``dataset_name`` (the global one for None)."""
    return get_store().get(dataset_name)

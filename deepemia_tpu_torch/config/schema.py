"""Declarative config schema and its validation (the JAX package's
``config/schema.py``): a recursive spec tree; unknown fields pass through
with a warning; ``*_dir`` / ``*_file`` paths get their directories.

The schema is whole, keys that only the TPU serving path reads included,
so a validated dict here equals the JAX package's key for key and every
file the JAX package accepts is accepted; the port ignores those keys.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Type, Union

from deepemia_tpu_torch.utils.exceptions import ConfigurationError

log = logging.getLogger("deepemia_tpu_torch.config")

Number = (int, float)


@dataclass
class Field:
    """One schema node: a typed leaf or a nested mapping."""

    types: Union[Type, Tuple[Type, ...], None] = None
    required: bool = False
    default: Any = None
    children: Optional[Dict[str, "Field"]] = None
    # any-key mapping whose values all follow this child spec
    wildcard_child: Optional["Field"] = None

    def is_mapping(self) -> bool:
        return self.children is not None or self.wildcard_child is not None


def _mapping(children=None, wildcard=None, required=False, default=None):
    return Field(
        types=dict,
        required=required,
        default=default if default is not None else {},
        children=children,
        wildcard_child=wildcard,
    )


_HYPERPARAMS = _mapping(
    wildcard=Field(types=Number),
)

_ROI = _mapping(
    children={
        "x_start_factor": Field(types=Number, default=0.7),
        "y_start_factor": Field(types=Number, default=0.05),
        "width_factor": Field(types=Number, default=1.0),
        "height_factor": Field(types=Number, default=0.05),
    }
)

CONFIG_SCHEMA: Dict[str, Field] = {
    "bucket": Field(types=str, default=""),
    "paths": _mapping(
        required=True,
        children={
            "split_dir": Field(types=str, required=True),
            "category_json": Field(types=str, required=True),
            "eta_file": Field(types=str, default="~/deepemia_tpu/config/eta_data.json"),
            "logs_dir": Field(types=str, default="~/logs"),
            "output_dir": Field(types=str, default="~/deepemia_tpu/output"),
            "local_dataset_root": Field(types=str, default="~"),
            "dataset_configs_dir": Field(
                types=str, default="~/deepemia_tpu/config/datasets"
            ),
        },
    ),
    "scale_bar_rois": _mapping(wildcard=_ROI),
    "scalebar_thresholds": _mapping(
        children={
            "intensity": Field(types=Number, default=100),
            "proximity": Field(types=Number, default=100),
            "merge_gap": Field(types=Number, default=15),
            "min_line_length": Field(types=Number, default=30),
            "edge_margin_factor": Field(types=Number, default=0.1),
        }
    ),
    "measure_contrast_distribution": Field(types=bool, default=False),
    "rcnn_hyperparameters": _mapping(
        children={
            "default": _mapping(wildcard=_HYPERPARAMS),
            "best": _mapping(wildcard=_HYPERPARAMS),
        }
    ),
    "inference_settings": _mapping(
        children={
            "use_class_specific_inference": Field(types=bool, default=True),
            "confidence_mode": Field(types=str, default="auto"),
            "iterative_stopping": _mapping(wildcard=Field(types=Number)),
            "class_specific_settings": _mapping(
                wildcard=_mapping(wildcard=Field(types=(int, float, bool)))
            ),
            "ensemble_settings": _mapping(
                children={
                    "enabled": Field(types=bool, default=True),
                    "small_classes_only": Field(types=bool, default=True),
                    "weights": _mapping(wildcard=Field(types=Number)),
                }
            ),
            "multiscale_settings": _mapping(wildcard=Field(types=(list, float, int))),
            "use_tile_based_inference": Field(types=bool, default=True),
            "use_iterative_inference": Field(types=bool, default=False),
            # universal morphology postprocessing (reference
            # postprocess_masks_universal, inference.py:1739-1813) + the
            # small/large size-heuristic pass (inference.py:660-668)
            "postprocessing": _mapping(
                children={
                    "enabled": Field(types=bool, default=True),
                    # 0 = auto: max(3, 5e-6*area) / max(25, 1e-4*area)
                    "min_size_small": Field(types=Number, default=0),
                    "min_size_large": Field(types=Number, default=0),
                    # images sampled for the small/large class heuristic
                    "size_heuristic_sample": Field(types=int, default=5),
                }
            ),
            # binarization threshold for RoI mask probabilities
            "mask_threshold": Field(types=Number, default=0.5),
            "tile_settings": _mapping(
                children={
                    "tile_size": Field(types=int, default=512),
                    "overlap_ratio": Field(types=Number, default=0.1),
                    "upscale_factor": Field(types=Number, default=2.0),
                    "edge_filter_enabled": Field(types=bool, default=True),
                    # restrict tile-sourced detections to these class ids;
                    # other classes keep only the full-image pass. The
                    # reference PARSES this key but never enforces it
                    # (inference.py:548 — tiling runs "for all classes");
                    # here absent/None = all classes tile, a list = enforced
                    "classes_using_tiling": Field(types=list, default=None),
                    "tile_batch_size": Field(types=int, default=16),
                    # run tiles at NATIVE resolution when the size heuristic
                    # finds no class averaging below upscale_small_area
                    # (upscale only helps small objects; skipping it
                    # quarters tile conv FLOPs)
                    "class_conditional_upscale": Field(types=bool, default=True),
                    # absolute avg-instance-area cutoff (px^2) below which a
                    # class is considered to need the tile upscale; default
                    # 32^2 = COCO's small-object bound
                    "upscale_small_area": Field(types=Number, default=1024.0),
                    # per-tile RPN/RoI heads iteration: 'map' = lax.map
                    # (sequential small programs), 'vmap' = batched heads
                    # (one FC matmul / batched top_k across tiles)
                    "heads_vectorize": Field(types=str, default="map"),
                    # whole-image pass runs native up to this long side,
                    # downscaled above it (8k+ micrographs: raise at will);
                    # 0 = tiles-only (skip the whole-image pass — for
                    # datasets where every object fits inside a tile)
                    "full_pass_max_dim": Field(types=int, default=2048),
                    # rasterized-IoU grid stride for the global dedup NMS
                    "dedup_stride": Field(types=int, default=8),
                    # padded instance capacity per image (0 = built-in
                    # StaticShapes.MAX_INSTANCES_PER_IMAGE)
                    "instance_capacity": Field(types=int, default=0),
                    # 'auto' = split two-program schedule on single-chip
                    # TPU (Pallas RoIAlign heads), fused elsewhere
                    "serving": Field(types=str, default="auto"),
                }
            ),
            # [S,S] crop size for exact host measurements; objects larger
            # than this are measured shrink-to-fit (raise for >192-px
            # objects at native scale)
            "measurement_window": Field(types=int, default=192),
            "spatial_constraints": _mapping(wildcard=Field(types=dict)),
        }
    ),
    "train": _mapping(
        children={
            # zoo/pretrained checkpoints to fine-tune from (Detectron2
            # .pth/.pkl or Caffe2 backbone pickle); the reference always
            # fine-tunes from model-zoo COCO weights (train_model.py:128-134)
            "pretrained_weights": _mapping(
                children={
                    "R50": Field(types=str, default=""),
                    "R101": Field(types=str, default=""),
                }
            ),
            "train_size": Field(types=int, default=512),
            # 'fixed': square train_size crops/resizes; 'range': Detectron2's
            # aspect-preserving min-size choice in [min, max] with max_size
            # cap (the reference's training-resize schedule)
            "resize_mode": Field(types=str, default="fixed"),
            "min_size_range": Field(types=list, default=[640, 800]),
            "max_size": Field(types=int, default=1333),
            "max_instances": Field(types=int, default=64),
            # 0 = off; global-norm gradient clipping (needed for
            # from-scratch training — FrozenBN has no normalization)
            "grad_clip_norm": Field(types=Number, default=0),
            # producer threads for the training data loader (reference
            # DATALOADER.NUM_WORKERS); 1 = fully deterministic batch order
            "loader_workers": Field(types=int, default=2),
            # RoIAlign backend for the differentiated heads: 'auto' =
            # Pallas forward + matmul backward on TPU, XLA gather elsewhere
            "roi_backend": Field(types=str, default="auto"),
            # train steps per device dispatch (lax.scan over K packed
            # batches in one transfer; identical math/random streams,
            # 1/K the host round trips). 1 = dispatch every step.
            "steps_per_dispatch": Field(types=int, default=8),
        }
    ),
    "performance": _mapping(
        children={
            # decoded images (+ in-flight device transfers) prefetched
            # ahead of the per-image loop (reference batch, inference.py:713)
            "inference_batch_size": Field(types=int, default=1),
            # accepted for reference-config compatibility; a no-op here —
            # measurements are windowed per image on device, there is no
            # host measurement batch to size (reference inference.py:1019)
            "measurement_batch_size": Field(types=int, default=3),
            "max_worker_threads": Field(types=int, default=3),
            "enable_parallel_image_loading": Field(types=bool, default=True),
            "use_bf16": Field(types=bool, default=True),
            "stream_measurements_to_csv": Field(types=bool, default=True),
            # 'host': native C++ contour kernels, cv2-exact (<1% CSV parity,
            # the BASELINE.md target — default); 'device': on-device
            # morphometric reductions (opt-in throughput path, perimeter may
            # deviate up to ~6% on threshold-ragged boundaries)
            "measurement_backend": Field(types=str, default="host"),
            # int8 MXU serving for the backbone convs (the REAL version of
            # the reference's dead qnnpack path, SURVEY Q2): 'none' (float),
            # 'trunk' (int8 ResNet, float FPN), 'full' (int8 ResNet+FPN).
            # v5e runs int8 at 2x the bf16 MXU rate; same checkpoint file
            "quantized_inference": Field(types=str, default="none"),
            # chips used for tile-sharded inference: 0 = all local devices
            "inference_chips": Field(types=int, default=0),
            # >=2 chips + >=2 ensemble members: run each member on its own
            # disjoint sub-mesh so the members execute concurrently
            "ensemble_member_parallel": Field(types=bool, default=True),
            # accepted for reference-config compatibility; a no-op here —
            # per-mask files are never written (masks stay on device until
            # the RLE/PNG export), so there is nothing to clean up
            # (reference inference.py:1317-1338)
            "cleanup_individual_masks": Field(types=bool, default=True),
            "donate_buffers": Field(types=bool, default=True),
        }
    ),
}


def _validate_node(name: str, spec: Field, value: Any, out: Dict[str, Any]) -> Any:
    if value is None:
        if spec.required:
            raise ConfigurationError(f"Missing required config field: {name}")
        if spec.is_mapping():
            value = {}  # recurse below so child defaults are filled
        else:
            return spec.default

    # bool is an int subclass: reject bools unless bool is explicitly allowed
    allowed = spec.types if isinstance(spec.types, tuple) else (spec.types,)
    if (
        isinstance(value, bool)
        and spec.types is not None
        and bool not in allowed
        and any(t in (int, float) for t in allowed)
    ):
        raise ConfigurationError(
            f"Config field {name}: expected number, got bool {value!r}"
        )
    if spec.types is not None and not isinstance(value, spec.types):
        raise ConfigurationError(
            f"Config field {name}: expected {spec.types}, got "
            f"{type(value).__name__} ({value!r})"
        )

    if not spec.is_mapping():
        return value

    result: Dict[str, Any] = {}
    children = spec.children or {}
    for key, child_spec in children.items():
        result[key] = _validate_node(f"{name}.{key}", child_spec, value.get(key), result)
    for key, val in value.items():
        if key in children:
            continue
        if spec.wildcard_child is not None:
            result[key] = _validate_node(
                f"{name}.{key}", spec.wildcard_child, val, result
            )
        else:
            # pass-through with warning (reference config_validator.py:148-154)
            log.warning("Unexpected config field %s.%s — passing through", name, key)
            result[key] = val
    return result


def validate_config(
    raw: Dict[str, Any], create_dirs: bool = True
) -> Dict[str, Any]:
    """Validate a raw config dict against CONFIG_SCHEMA.

    Returns the validated config with defaults filled. Unknown fields pass
    through with a warning. When ``create_dirs``, parent directories for any
    ``paths.*_dir`` / ``paths.*_file`` entries are created (reference
    config_validator.py:114-127).
    """
    if not isinstance(raw, dict):
        raise ConfigurationError("Config root must be a mapping")

    validated: Dict[str, Any] = {}
    for key, spec in CONFIG_SCHEMA.items():
        validated[key] = _validate_node(key, spec, raw.get(key), validated)
    for key, val in raw.items():
        if key not in CONFIG_SCHEMA:
            log.warning("Unexpected top-level config field %s — passing through", key)
            validated[key] = val

    if create_dirs:
        for key, val in validated.get("paths", {}).items():
            if not isinstance(val, str):
                continue
            p = os.path.expanduser(val)
            target = p if key.endswith("_dir") else os.path.dirname(p)
            if target:
                os.makedirs(target, exist_ok=True)

    return validated

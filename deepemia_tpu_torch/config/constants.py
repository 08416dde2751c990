"""Static capacities and tile-engine defaults (counterpart of the JAX
package's ``config/constants.py``; only what the serving path reads)."""

from __future__ import annotations


class StaticShapes:
    """Padded capacities of the serving path."""

    PRE_NMS_TOPK_TRAIN = 2000
    PRE_NMS_TOPK_TEST = 1000
    POST_NMS_TOPK_TRAIN = 1000
    POST_NMS_TOPK_TEST = 1000
    MAX_DETECTIONS = 100
    MAX_INSTANCES_PER_IMAGE = 512
    MASK_RESOLUTION = 28
    MASK_IOU_STRIDE = 4
    ROI_SAMPLING_RATIO = 2


class TileDefaults:
    """Tile engine defaults."""

    TILE_SIZE = 512
    OVERLAP_RATIO = 0.1
    UPSCALE_FACTOR = 2.0
    EDGE_FILTER_ENABLED = True
    TILE_BATCH_SIZE = 8

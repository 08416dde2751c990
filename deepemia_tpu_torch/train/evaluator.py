"""COCO-style mAP/mAR evaluation (bbox and segm) in numpy: a copy of the
JAX package's ``train/evaluator.py``, which implements pycocotools'
published semantics without it:

  * greedy score-ordered matching per (class, IoU threshold), equal-IoU ties
    resolved to the later GT in iteration order (cocoeval.py evaluateImg);
  * area-range evaluation with ignore semantics: GT outside the range is
    ignored (not counted, and a detection matched to it is neither TP nor
    FP), unmatched detections outside the range are ignored too;
  * matching prefers non-ignored GT: an ignored GT can only absorb a
    detection that has no qualifying non-ignored match;
  * 101-point interpolated AP with the monotone precision envelope,
    averaged over IoU .50:.05:.95 and the classes with GT;
  * AR@{1,10,100}: detection lists are matched once at maxDets=100 and
    truncated by rank (exact, since greedy matching of earlier detections
    never depends on later ones);
  * crowd annotations are not supported (the dataset formats have none).

Left out: nothing.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("deepemia_tpu_torch.evaluator")

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES: Dict[str, Tuple[float, float]] = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, float("inf")),
}
MAX_DETS = (1, 10, 100)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4],[M,4] XYXY -> [N,M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def mask_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,H,W],[M,H,W] bool -> [N,M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    af = a.reshape(len(a), -1).astype(np.float32)
    bf = b.reshape(len(b), -1).astype(np.float32)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def _match_image(
    iou: np.ndarray,  # [Nd, Ng] for detections sorted by -score
    gt_ignore: np.ndarray,  # [Ng] bool (area outside range)
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy per-threshold matching with ignore semantics.

    Returns (dt_matched [Nd, T] bool, dt_ignored [Nd, T] bool).
    Replicates cocoeval.evaluateImg: GT iterated non-ignored first; an
    equal-IoU tie replaces the match (later GT wins); once a non-ignored
    match is held, iteration stops at the first ignored GT.
    """
    nd, ng = iou.shape
    nt = len(IOU_THRESHOLDS)
    dt_m = np.zeros((nd, nt), bool)
    dt_ig = np.zeros((nd, nt), bool)
    g_order = np.argsort(gt_ignore, kind="stable")  # non-ignored first
    for ti, t in enumerate(IOU_THRESHOLDS):
        gt_taken = np.zeros(ng, bool)
        for di in range(nd):
            best = -1
            best_iou = min(t, 1.0 - 1e-10)
            for g in g_order:
                if gt_taken[g]:
                    continue
                if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                    break
                if iou[di, g] < best_iou:
                    continue
                best_iou = iou[di, g]
                best = g
            if best == -1:
                continue
            gt_taken[best] = True
            dt_m[di, ti] = True
            dt_ig[di, ti] = gt_ignore[best]
    return dt_m, dt_ig


class APAccumulator:
    """Per-(class, area-range) accumulation of scored matches."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        # records[(c, rng)]: list of (score, rank, tp[T], ignored[T])
        self.records: Dict[Tuple[int, str], List] = {
            (c, r): [] for c in range(num_classes) for r in AREA_RANGES
        }
        self.num_gt: Dict[Tuple[int, str], int] = {
            (c, r): 0 for c in range(num_classes) for r in AREA_RANGES
        }

    def add_image(
        self,
        pred_classes: np.ndarray,
        pred_scores: np.ndarray,
        iou: np.ndarray,  # [Npred, Ngt] for the chosen iou type
        gt_classes: np.ndarray,
        pred_areas: Optional[np.ndarray] = None,
        gt_areas: Optional[np.ndarray] = None,
        max_dets: int = 100,
    ):
        """Without areas, only the 'all' range accumulates (size-bucketed
        metrics then report NaN)."""
        ranges = (
            AREA_RANGES
            if pred_areas is not None and gt_areas is not None
            else {"all": AREA_RANGES["all"]}
        )
        for c in range(self.num_classes):
            gt_idx = np.flatnonzero(gt_classes == c)
            p_idx = np.flatnonzero(pred_classes == c)
            order = p_idx[np.argsort(-pred_scores[p_idx], kind="stable")][
                :max_dets
            ]
            sub_iou = iou[np.ix_(order, gt_idx)]
            for rng_name, (lo, hi) in ranges.items():
                if gt_areas is not None:
                    g_ig = (gt_areas[gt_idx] < lo) | (gt_areas[gt_idx] > hi)
                else:
                    g_ig = np.zeros(len(gt_idx), bool)
                self.num_gt[(c, rng_name)] += int((~g_ig).sum())
                if len(order) == 0:
                    continue
                dt_m, dt_ig = _match_image(sub_iou, g_ig)
                if pred_areas is not None:
                    d_out = (pred_areas[order] < lo) | (pred_areas[order] > hi)
                    dt_ig = dt_ig | (~dt_m & d_out[:, None])
                recs = self.records[(c, rng_name)]
                for rank, p in enumerate(order):
                    recs.append(
                        (
                            float(pred_scores[p]),
                            rank,
                            dt_m[rank] & ~dt_ig[rank],
                            dt_ig[rank],
                        )
                    )

    # -- metric computation -------------------------------------------------

    def _class_pr(self, c: int, rng: str, max_det: int):
        """(ap[T], recall[T]) for one class/range/maxDets, or None if the
        class has no (non-ignored) GT in the range."""
        npig = self.num_gt[(c, rng)]
        if npig == 0:
            return None
        recs = [r for r in self.records[(c, rng)] if r[1] < max_det]
        recs.sort(key=lambda r: -r[0])
        nt = len(IOU_THRESHOLDS)
        ap = np.zeros(nt)
        rec = np.zeros(nt)
        if not recs:
            return ap, rec
        tp_all = np.stack([r[2] for r in recs])  # [Np, T]
        ig_all = np.stack([r[3] for r in recs])
        for ti in range(nt):
            keep = ~ig_all[:, ti]
            tps = tp_all[keep, ti]
            if tps.size == 0:
                continue
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            recall = tp_cum / npig
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            prec_at = np.where(
                idx < len(precision),
                precision[np.minimum(idx, len(precision) - 1)],
                0.0,
            )
            ap[ti] = prec_at.mean()
            rec[ti] = recall[-1]
        return ap, rec

    def summarize(self) -> Dict[str, float]:
        """COCO metric row (percent): AP, AP50, AP75, APs/m/l, AR@1/10/100,
        ARs/m/l, per-class AP."""
        out: Dict[str, float] = {}

        def mean_over_classes(rng, max_det, what):
            vals = []
            for c in range(self.num_classes):
                pr = self._class_pr(c, rng, max_det)
                if pr is None:
                    continue
                vals.append(pr[0] if what == "ap" else pr[1])
            if not vals:
                return np.full(len(IOU_THRESHOLDS), np.nan)
            return np.mean(np.stack(vals), axis=0)

        ap_all = mean_over_classes("all", 100, "ap")
        out["AP"] = float(np.mean(ap_all) * 100)
        out["AP50"] = float(ap_all[0] * 100)
        out["AP75"] = float(ap_all[5] * 100)
        for rng, key in (("small", "APs"), ("medium", "APm"), ("large", "APl")):
            out[key] = float(np.mean(mean_over_classes(rng, 100, "ap")) * 100)
        for md in MAX_DETS:
            out[f"AR{md}"] = float(
                np.mean(mean_over_classes("all", md, "rec")) * 100
            )
        for rng, key in (("small", "ARs"), ("medium", "ARm"), ("large", "ARl")):
            out[key] = float(np.mean(mean_over_classes(rng, 100, "rec")) * 100)
        for c in range(self.num_classes):
            pr = self._class_pr(c, "all", 100)
            if pr is not None:
                out[f"AP-class{c}"] = float(np.mean(pr[0]) * 100)
        return out


def evaluate_predictions(
    per_image: Sequence[dict], num_classes: int
) -> Dict[str, float]:
    """per_image: dicts with pred_boxes [N,4], pred_scores [N], pred_classes
    [N], pred_masks [N,H,W] (optional), gt_boxes [G,4], gt_classes [G],
    gt_masks [G,H,W] (optional). Returns {'bbox/AP', ..., 'segm/AP', ...}.

    Areas follow COCO: the GT annotation area (mask pixel count when masks
    are present, else box area) buckets BOTH the bbox and segm evaluations;
    prediction areas use the same modality.
    """
    bbox_acc = APAccumulator(num_classes)
    has_masks = any(
        "pred_masks" in d and d["pred_masks"] is not None for d in per_image
    )
    segm_acc = APAccumulator(num_classes) if has_masks else None

    for d in per_image:
        pred_boxes = np.asarray(d["pred_boxes"], np.float32)
        gt_boxes = np.asarray(d["gt_boxes"], np.float32)
        pred_classes = np.asarray(d["pred_classes"])
        pred_scores = np.asarray(d["pred_scores"])
        gt_classes = np.asarray(d["gt_classes"])
        gm = d.get("gt_masks")
        pm = d.get("pred_masks")
        if gm is not None and len(gm):
            gt_areas = np.asarray(gm).reshape(len(gm), -1).sum(1).astype(
                np.float64
            )
        else:
            gt_areas = (
                (gt_boxes[:, 2] - gt_boxes[:, 0])
                * (gt_boxes[:, 3] - gt_boxes[:, 1])
            ).astype(np.float64) if len(gt_boxes) else np.zeros(0)
        if pm is not None and len(pm):
            pred_areas = np.asarray(pm).reshape(len(pm), -1).sum(1).astype(
                np.float64
            )
        else:
            pred_areas = (
                (pred_boxes[:, 2] - pred_boxes[:, 0])
                * (pred_boxes[:, 3] - pred_boxes[:, 1])
            ).astype(np.float64) if len(pred_boxes) else np.zeros(0)

        iou_b = box_iou_np(pred_boxes, gt_boxes)
        bbox_acc.add_image(
            pred_classes, pred_scores, iou_b, gt_classes, pred_areas, gt_areas
        )
        if segm_acc is not None and pm is not None:
            iou_m = mask_iou_np(np.asarray(pm), np.asarray(gm))
            segm_acc.add_image(
                pred_classes, pred_scores, iou_m, gt_classes, pred_areas,
                gt_areas,
            )

    out = {f"bbox/{k}": v for k, v in bbox_acc.summarize().items()}
    if segm_acc is not None:
        out.update({f"segm/{k}": v for k, v in segm_acc.summarize().items()})
    return out

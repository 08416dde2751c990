"""Stage timers: accumulating named wall-clock timers for the pipeline's
sequential stages."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

log = logging.getLogger("deepemia_tpu_torch.profiling")


class StageTimers:
    """Named wall-clock totals and call counts. On a CUDA ``device`` each
    stage synchronizes before its clock stops, so a stage that only queued
    device work is charged for that work."""

    def __init__(self, device: torch.device):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.device = torch.device(device)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1),
            }
            for k in sorted(self.totals)
        }

    def log_summary(self, prefix: str = "profile") -> None:
        for name, s in self.summary().items():
            log.info(
                "%s: %-28s %8.3fs total / %4d calls / %7.4fs mean",
                prefix, name, s["total_s"], s["count"], s["mean_s"],
            )

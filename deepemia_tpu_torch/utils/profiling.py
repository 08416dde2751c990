"""Stage timers (accumulating named wall-clock timers for the pipeline's
sequential stages) and ``trace``, the ``torch.profiler`` capture behind the
CLI's ``--profile DIR``."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
import os
from typing import Dict, Iterator, Optional

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


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when it is
    available) and write a Chrome trace, ``trace_dir/trace.json``; no-op
    when ``trace_dir`` is None. A profiler that fails to start or stop is
    logged and the block runs on; an error in the block propagates."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.expanduser(trace_dir)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = None
    try:
        os.makedirs(path, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
        log.info("Capturing a torch.profiler trace into %s", path)
    except Exception as e:  # noqa: BLE001 - profiling never kills a run
        log.warning("Profiler start failed (%s); continuing unprofiled", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(path, "trace.json"))
            except Exception as e:  # noqa: BLE001
                log.warning("Profiler stop failed: %s", e)

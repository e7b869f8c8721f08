"""Per-stage wall-clock metrics (metrics.json).

Each stage's time is read on the host clock after the device's queued work
has finished (torch.cuda.synchronize on a CUDA device), so it covers the
stage's kernels and not only their launch.
"""

from __future__ import annotations

import contextlib
import time

import torch

from fedrann_tpu_torch.device import synchronize
from fedrann_tpu_torch.logging_utils import logger


class StageMetrics:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            secs = time.perf_counter() - t0
            self._seconds[name] = self._seconds.get(name, 0.0) + secs
            logger.info("stage %s: %.3f s", name, secs)

    def summary(self) -> dict:
        out: dict = {name: {"seconds": secs}
                     for name, secs in self._seconds.items()}
        out["device"] = {
            "type": self.device.type,
            "name": (torch.cuda.get_device_name(self.device)
                     if self.device.type == "cuda" else "cpu"),
        }
        return out

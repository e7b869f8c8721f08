"""Per-stage wall-clock metrics (metrics.json) and the --mprof memory
timeline.

Each stage's time is read on the host clock after the device's queued work
has finished (torch.cuda.synchronize on a CUDA device), so it covers the
stage's kernels and not only their launch. A stage run inside another (the
lazy staging the count stage starts) is taken out of the outer one's time,
as `fedrann_tpu/metrics.py` does, so the stages are disjoint.
"""

from __future__ import annotations

import contextlib
import resource
import threading
import time

import torch

from fedrann_tpu_torch.device import synchronize
from fedrann_tpu_torch.logging_utils import logger


class StageMetrics:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._stages: dict[str, dict] = {}
        self._inner: list[float] = []  # each open stage's time in inner ones

    @contextlib.contextmanager
    def stage(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
        finally:
            synchronize(self.device)
            secs = time.perf_counter() - t0
            inner = self._inner.pop()
            if self._inner:
                self._inner[-1] += secs
            entry = self._stages.setdefault(name, {"seconds": 0.0})
            entry["seconds"] += secs - inner
            logger.info("stage %s: %.3f s", name, secs - inner)

    def add_work(self, name: str, **counters: float) -> None:
        """Add counters (h2d_bytes: bytes uploaded) to a stage's entry."""
        entry = self._stages.setdefault(name, {"seconds": 0.0})
        for key, value in counters.items():
            entry[key] = entry.get(key, 0.0) + float(value)

    def summary(self) -> dict:
        out: dict = {name: dict(entry) for name, entry in self._stages.items()}
        out["device"] = {
            "type": self.device.type,
            "name": (torch.cuda.get_device_name(self.device)
                     if self.device.type == "cuda" else "cpu"),
        }
        return out


def current_rss_mib() -> float:
    """The resident set now (not its peak), so the timeline can fall."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * resource.getpagesize() / (1024.0 * 1024.0)
    except (OSError, ValueError, IndexError):
        # ru_maxrss is KiB on Linux
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class MemorySampler:
    """A background thread sampling the process's resident memory every
    `interval` seconds, written on exit to `path` in memory_profiler's
    mprof format ("MT 1.0", then "MEM <MiB> <unix time>" lines); the
    port's copy of `fedrann_tpu/metrics.py` MemorySampler."""

    def __init__(self, path: str, interval: float = 1.0) -> None:
        self.path = path
        self.interval = interval
        self._samples: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._samples.append((current_rss_mib(), time.time()))
            self._stop.wait(self.interval)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        with open(self.path, "w") as f:
            f.write("MT 1.0\n")
            for mib, ts in self._samples:
                f.write(f"MEM {mib:.6f} {ts:.4f}\n")
        return False

"""Per-stage wall-clock metrics (metrics.json), roofline counters and the
--mprof memory timeline.

Each stage's time is read on the host clock after the device's queued work
has finished (torch.cuda.synchronize on a CUDA device), so it covers the
stage's kernels and not only their launch. A stage run inside another (the
lazy staging the count stage starts) is taken out of the outer one's time,
as `fedrann_tpu/metrics.py` does, so the stages are disjoint. Each stage
also records the process's peak resident memory when it ends.

`add_work` attaches the work a stage did (flops, hbm_bytes, h2d_bytes,
d2h_bytes); `summary` derives tflops_per_s and hbm_gb_per_s from it, and
mfu_pct and hbm_util_pct against the card's published peaks where
`device_peaks` knows the card, as the JAX package derives them.
"""

from __future__ import annotations

import contextlib
import resource
import threading
import time

import torch

from fedrann_tpu_torch.device import synchronize
from fedrann_tpu_torch.logging_utils import logger


# (dense bf16 tensor-core FLOP/s, device-memory bytes/s) by a substring of
# torch.cuda.get_device_name: NVIDIA's H100 SXM data sheet (989 TFLOP/s
# bf16 without sparsity, HBM3 at 3.35 TB/s), at its 700 W limit
_DEVICE_PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12),
}


def peak_rss_mib() -> float:
    """The process's peak resident memory (ru_maxrss is KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def device_peaks(device: torch.device) -> tuple[float, float] | None:
    """(peak bf16 FLOP/s, peak memory bytes/s) of a CUDA device by its
    name; None on the CPU and for a card not in the table, so a summary
    then has no mfu_pct or hbm_util_pct."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peaks in _DEVICE_PEAKS.items():
        if sub in name:
            return peaks
    return None


class StageMetrics:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._stages: dict[str, dict] = {}
        self._inner: list[float] = []  # each open stage's time in inner ones

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the stage `name`; under --profile its span, the closing
        synchronize included, is a "stage:<name>" range of the trace
        (record_function), so the stage's kernels run inside it."""
        synchronize(self.device)
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            with torch.profiler.record_function(f"stage:{name}"):
                try:
                    yield
                finally:
                    synchronize(self.device)
        finally:
            secs = time.perf_counter() - t0
            inner = self._inner.pop()
            if self._inner:
                self._inner[-1] += secs
            entry = self._entry(name)
            entry["seconds"] += secs - inner
            entry["peak_rss_mib"] = peak_rss_mib()
            logger.info("stage %s: %.3f s (peak RSS %.0f MiB)", name,
                        secs - inner, entry["peak_rss_mib"])

    def _entry(self, name: str) -> dict:
        return self._stages.setdefault(name, {"seconds": 0.0,
                                              "peak_rss_mib": 0.0})

    def add_work(self, name: str, *, flops: float = 0.0,
                 hbm_bytes: float = 0.0, h2d_bytes: float = 0.0,
                 d2h_bytes: float = 0.0) -> None:
        """Add a stage's work: floating-point operations, device-memory
        bytes, bytes uploaded and bytes downloaded. Counters add up over
        calls, before or after the stage ran; a zero adds no key."""
        entry = self._entry(name)
        for key, val in (("flops", flops), ("hbm_bytes", hbm_bytes),
                         ("h2d_bytes", h2d_bytes), ("d2h_bytes", d2h_bytes)):
            if val:
                entry[key] = entry.get(key, 0.0) + float(val)

    def summary(self) -> dict:
        """Each stage's entry with the rates its counters give:
        tflops_per_s and hbm_gb_per_s, and mfu_pct and hbm_util_pct (to two
        decimals) where device_peaks knows the card; then "device"."""
        peaks = device_peaks(self.device)
        out: dict = {}
        for name, entry in self._stages.items():
            e = dict(entry)
            secs = e["seconds"]
            if secs > 0:
                if e.get("flops"):
                    e["tflops_per_s"] = e["flops"] / secs / 1e12
                    if peaks:
                        e["mfu_pct"] = round(
                            100.0 * e["flops"] / secs / peaks[0], 2)
                if e.get("hbm_bytes"):
                    e["hbm_gb_per_s"] = e["hbm_bytes"] / secs / 1e9
                    if peaks:
                        e["hbm_util_pct"] = round(
                            100.0 * e["hbm_bytes"] / secs / peaks[1], 2)
            out[name] = e
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
        return peak_rss_mib()


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

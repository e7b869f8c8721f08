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

`span` and `steps` record inside a search job, and only while a torch
profiler runs: an untraced call pays one flag check a span.
"""

from __future__ import annotations

import contextlib
import resource
import threading
import time

import torch
from torch.autograd import profiler as _profiler

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


# the spans of taking and of freeing page-locked host memory (Steps.record
# reads them)
PIN, UNPIN = "fedrann.wire.pin", "fedrann.wire.unpin"
_NULL = contextlib.nullcontext()


class _Span:
    """An open span: its host seconds go into span.seconds when it closes,
    and under --profile it is a record_function range besides."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.range = None
        if span.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        secs = time.perf_counter() - self.t0
        span.seconds[self.name] = span.seconds.get(self.name, 0.0) + secs
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A span of the program (a `with` block) named `name`. With no torch
    profiler running it is one shared null context: one flag check, and
    no event, range or record. Under any profiler its host seconds add up
    in span.seconds[name]; while the profiler of --profile runs
    (span.ranges, set by pipeline) it is also a record_function range,
    which lands in the Chrome trace on the kernels' clock."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


span.seconds = {}
span.ranges = False


class _NoSteps:
    """steps() with no profiler running: every span is the null context,
    no mark records anything, and record() adds no key."""

    timed = False

    def span(self, name: str):
        return _NULL

    step = span

    def mark(self, name: str) -> None:
        pass

    def device_ms(self) -> dict:
        return {}

    def record(self) -> dict:
        return {}


NO_STEPS = _NoSteps()


class Steps(_NoSteps):
    """The spans of one search call, and with `timed` its device steps: a
    CUDA timing event on the call's stream at its start and at the end of
    each step (step, mark), read by record() once the call's own
    synchronize has passed them. A step's time is its stream's time from
    the previous mark, so it holds the step's kernels and any wait of the
    stream for the host between them."""

    # span.seconds[UNPIN] when the last timed call was recorded
    unpinned_at = 0.0

    def __init__(self, device: torch.device, timed: bool) -> None:
        self.timed = timed
        self.stream = torch.cuda.current_stream(device) if timed else None
        self.events: list = []
        self.pinned_bytes = 0  # the caller's reading after the result's take
        self.pin0 = span.seconds.get(PIN, 0.0)
        self.mark("")

    def span(self, name: str):
        return span(name)

    @contextlib.contextmanager
    def step(self, name: str):
        """The span `name`, then a mark named by its last part."""
        with span(name):
            yield
        self.mark(name.rsplit(".", 1)[-1])

    def mark(self, name: str) -> None:
        if self.timed:
            event = torch.cuda.Event(enable_timing=True)
            event.record(self.stream)
            self.events.append((name, event))

    def device_ms(self) -> dict:
        """Each step's ms on the stream, once the stream has passed its
        marks ({} untimed)."""
        ms: dict = {}
        for (_, start), (name, end) in zip(self.events, self.events[1:]):
            ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
        return ms

    def record(self) -> dict:
        """The call's record, where timed (else {}): device_ms, each
        step's ms on the stream; pin_s, host seconds taking page-locked
        memory (PIN) during the call; unpin_s, host seconds freeing it
        (UNPIN) since the last timed call was recorded; pinned_bytes."""
        if not self.timed:
            return {}
        unpinned = span.seconds.get(UNPIN, 0.0)
        out = {"device_ms": self.device_ms(),
               "pin_s": span.seconds.get(PIN, 0.0) - self.pin0,
               "unpin_s": unpinned - Steps.unpinned_at,
               "pinned_bytes": self.pinned_bytes}
        Steps.unpinned_at = unpinned
        return out


def steps(device: torch.device, timed: bool = True):
    """NO_STEPS with no torch profiler running, else a Steps of a call on
    `device`, timed on a CUDA device where `timed`."""
    if not _profiler._is_profiler_enabled:
        return NO_STEPS
    return Steps(device, timed and device.type == "cuda")


class StageMetrics:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._stages: dict[str, dict] = {}
        self._inner: list[float] = []  # each open stage's time in inner ones

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the stage `name`; under --profile its span, the closing
        synchronize included, is a "stage:<name>" range of the trace
        (span's record_function), so the stage's kernels run inside it."""
        synchronize(self.device)
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            with span(f"stage:{name}"):
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

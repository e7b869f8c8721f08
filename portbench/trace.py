"""What a traced run reads from torch.profiler: the device's kernels,
copies and sets, the harness's own spans (record_function "portbench.*"
around the window, each release of a previous result, each search call
and the harness's work after it), the
device's busy time (the union of its intervals) and idle gaps, and the
`breakdown` of the result line."""

from __future__ import annotations

import dataclasses

from portbench.work import k4_seconds

# the harness's spans: the whole window, the release of a read set's
# previous result (its page-locked block), a search call (the job, up to
# its result in host memory), the harness's work between calls
WINDOW, RELEASE, SEARCH, COLLECT = ("portbench.window", "portbench.release",
                                    "portbench.search", "portbench.collect")


@dataclasses.dataclass
class Trace:
    """Device intervals and host spans of a traced window, in seconds on
    the profiler's clock, clipped to the window [lo, hi]."""

    lo: float
    hi: float
    device: list[tuple[str, float, float]]  # (name, start, end)
    spans: list[tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device intervals, sorted."""
        merged: list[list[float]] = []
        for _, start, end in sorted(self.device, key=lambda e: e[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The window's stretches with nothing on the device."""
        gaps, at = [], self.lo
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.hi > at:
            gaps.append((at, self.hi))
        return gaps

    def kernels(self, part: str) -> list[tuple[str, float, float]]:
        """The device intervals whose name holds `part`."""
        return [e for e in self.device if part in e[0]]

    def label(self, t: float) -> str:
        """The innermost harness span at time t ("outside" for none)."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "outside"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(", 1)
    return (name[:cut] if cut > 0 else name)[:80]


def from_profiler(prof) -> Trace:
    """The Trace of a torch.profiler session holding one WINDOW span."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name.startswith("portbench."):
            # a span's device-side copy (gpu_user_annotation) is no work
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, start, end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, start, end))
    windows = [s for s in spans if s[0] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    _, lo, hi = windows[0]
    device = [(n, max(a, lo), min(b, hi)) for n, a, b in device
              if b > lo and a < hi]
    return Trace(lo, hi, device, spans)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the
    longest idle gaps with the harness span the host was in, in seconds."""
    per: dict[str, float] = {}
    for name, a, b in tr.device:
        per[short_name(name)] = per.get(short_name(name), 0.0) + (b - a)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[tr.label((a + b) / 2), b - a] for a, b in gaps]}


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader (metrics/<name>.py) gets: the
    traced window, the search's route ("exact" or "ivf", with "_ooc" or
    "_sharded" where it streams or shards), its precision, the rows a job
    searches (the queries, every one of the 2R rows), the rows' width d as
    given, k, the jobs in the window and, on an IVF route, the search's
    own counts after each job (knn_ivf.last: clusters, probes, spill,
    real_pair_scores, ...)."""

    trace: Trace
    route: str
    precision: str
    rows: int
    d: int
    k: int
    jobs: int
    ivf: list[dict]

    def k4_least(self) -> float | None:
        """The least time of the K4 launches the trace kept: 2 q c d
        operations each over the peak of its form (knn_merge_wgmma bf16,
        knn_merge_ffma float32), q every row, c every row on the exact
        route and the C centroids on the IVF route (its k-means assignments
        and its probe ranking); None on the streamed and sharded routes,
        which split the rows, or where the trace kept no launch."""
        launches = [n for n, _, _ in self.trace.device
                    if "knn_merge_wgmma" in n or "knn_merge_ffma" in n]
        if self.route == "ivf" and self.ivf:
            candidates = self.ivf[-1]["clusters"]
        elif self.route == "exact":
            candidates = self.rows
        else:
            return None
        return sum(k4_seconds(self.rows, candidates, self.d,
                              "bf16" if "wgmma" in n else "fp32")
                   for n in launches) if launches else None

"""The measured window: jobs run back to back from the moment it opens;
it closes at the end of the job that is running when `seconds` have
passed. The rate is taken over all the work and all the time of the
window, the gaps between jobs included, so a stall anywhere in it lowers
the rate."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class Window:
    opened: float                            # clock reading at the open
    jobs: list[tuple[float, float]]          # each job's (start, end)

    @property
    def closed(self) -> float:
        return self.jobs[-1][1] if self.jobs else self.opened

    @property
    def seconds(self) -> float:
        return self.closed - self.opened


def run_window(job: Callable[[int], None], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run job(0), job(1), ... until one ends `seconds` or more after the
    window opened; at least one job runs."""
    win = Window(clock(), [])
    while True:
        start = clock()
        job(len(win.jobs))
        win.jobs.append((start, clock()))
        if win.jobs[-1][1] - win.opened >= seconds:
            return win


def rate(win: Window, work_per_job: float) -> float:
    """The work of every job completed in the window over its whole wall
    time."""
    return len(win.jobs) * work_per_job / win.seconds

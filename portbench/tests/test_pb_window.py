"""The window's rate arithmetic, on a fake clock and a fake job stream."""

from portbench.window import rate, run_window


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def jobs(clock, seconds_of):
    def job(j):
        clock.now += seconds_of(j)
    return job


def test_window_closes_at_the_end_of_the_running_job():
    clock = FakeClock()
    win = run_window(jobs(clock, lambda j: 0.75), 2.0, clock)
    # 0.75, 1.5, 2.25: the third job is running when 2 s have passed
    assert len(win.jobs) == 3
    assert win.seconds == 2.25
    assert rate(win, 300) == 3 * 300 / 2.25


def test_a_stall_lowers_the_rate():
    steady_clock, stall_clock = FakeClock(), FakeClock()
    steady = run_window(jobs(steady_clock, lambda j: 1.0), 10.0,
                        steady_clock)
    stalled = run_window(jobs(stall_clock,
                              lambda j: 1.0 + (2.5 if j == 4 else 0.0)),
                         10.0, stall_clock)
    assert rate(stalled, 1000) < rate(steady, 1000)
    assert rate(steady, 1000) == 1000.0


def test_a_stall_between_jobs_counts():
    clock = FakeClock()
    calls = []

    def job(j):
        if j == 2:
            clock.now += 3.0  # the host's work between two jobs
        calls.append(j)
        clock.now += 1.0

    win = run_window(job, 5.0, clock)
    assert rate(win, 1000) < 1000.0
    assert win.seconds == len(calls) + 3.0


def test_one_long_job_still_closes_the_window():
    clock = FakeClock()
    win = run_window(jobs(clock, lambda j: 30.0), 10.0, clock)
    assert len(win.jobs) == 1 and win.seconds == 30.0

"""The measured window: a closed loop of jobs, and its statistics."""

from __future__ import annotations

import math
import time


def run_window(jobs: list, seconds: float, run_job) -> tuple[list, float]:
    """run_job(job, k) for jobs[k % len(jobs)], k = 0, 1, ... until the
    first job boundary at or after `seconds`. Returns what each call
    returned and the window's whole length in seconds."""
    t0 = time.monotonic()
    done = []
    k = 0
    while True:
        done.append(run_job(jobs[k % len(jobs)], k))
        k += 1
        if time.monotonic() - t0 >= seconds:
            return done, time.monotonic() - t0


def p95(values: list[float]) -> float:
    """95th percentile by nearest rank: the smallest value at or above
    95% of the values."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]

"""Arithmetic the per-layer metric readers share. Each reader returns
None where its run gives it nothing to read."""

from __future__ import annotations

from .trace import union_length


def idle_pct(ctx):
    """100 - the share of the traced window in which the card ran an
    operation."""
    tr = ctx.trace
    if not tr or not tr["by_name"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def counter_share(ctx, key):
    """100 x the port's counter `key` (seconds) summed over the window's
    jobs, over the jobs' summed wall."""
    jobs = ctx.jobs_done
    wall = sum(j["wall"] for j in jobs)
    if not jobs or wall <= 0 or not any(key in j["perf"] for j in jobs):
        return None
    return 100.0 * sum(j["perf"].get(key, 0.0) for j in jobs) / wall


def counter_sum(ctx, key):
    return sum(j["perf"].get(key, 0.0) for j in ctx.jobs_done)


def span_union(ctx, names):
    """Seconds covered by the spans called one of `names` (nested and
    concurrent calls once)."""
    return union_length([(a, b) for n, a, b in ctx.spans.items
                         if n in names])


def device_ms(ctx, part):
    """Device milliseconds of the traced window's operations whose name
    holds `part`; None when there is none."""
    tr = ctx.trace
    if not tr:
        return None
    ms = [s for name, s in tr["by_name"].items() if part in name]
    return 1e3 * sum(ms) if ms else None

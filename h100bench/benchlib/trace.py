"""What the traced run reads: the card's activity from torch.profiler,
and the benchmark's own spans around the calls into the port's layers.

The device-busy arithmetic is copied from chip_smoke.py's `_busy_share`
(device time of the profiler's CUDA events, by kernel name, over the
wall of the profiled run), with one change: busy time is the union of
the events' intervals, so that work overlapping on two streams is not
counted twice and busy can never pass the window.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time


class Spans:
    """Host intervals (name, start, end) in time.monotonic() seconds,
    kept in memory. With `annotate`, each span is also a
    torch.profiler.record_function range, so the trace can say what the
    host was doing while the card idled."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.items: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function

            rf = record_function(name)
        t0 = time.monotonic()
        try:
            with rf:
                yield
        finally:
            t1 = time.monotonic()
            with self._lock:
                self.items.append((name, t0, t1))


@contextlib.contextmanager
def wrapped(spans: Spans, targets):
    """Each (owner, attribute, span name) in targets replaced by a
    function that calls the original inside spans.span(name); put back
    on exit. Behaviour is unchanged."""
    saved = []
    for owner, attr, name in targets:
        orig = getattr(owner, attr)

        def make(orig=orig, name=name):
            @functools.wraps(orig)
            def call(*a, **kw):
                with spans.span(name):
                    return orig(*a, **kw)
            return call

        saved.append((owner, attr, orig))
        setattr(owner, attr, make())
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return f()
    return getattr(ev, f"{what}_us")() * 1000


def read_profile(prof, window_name: str = "window") -> dict:
    """The device's events and the host's annotated spans of a finished
    torch.profiler run, in seconds from the start of the span called
    window_name: {"device": [(name, start, end)], "spans": [(name, start,
    end)], "window": (0, length)}."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        user = ev.is_user_annotation() if hasattr(
            ev, "is_user_annotation") else False
        if ev.device_type() == DeviceType.CUDA:
            if not user:
                device.append((ev.name(), start, end))
        elif user:
            spans.append((ev.name(), start, end))
    win = [s for s in spans if s[0] == window_name]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0][1], win[0][2]

    def rel(items):
        return [(n, (a - w0) / 1e9, (b - w0) / 1e9) for n, a, b in items
                if b > w0 and a < w1]

    return {"device": rel(device),
            "spans": rel([s for s in spans if s[0] != window_name]),
            "window": (0.0, (w1 - w0) / 1e9)}


def summarize(tr: dict, top: int = 10) -> dict:
    """busy_s, the device operations that took most time and the idle
    time by the innermost span open at each gap's middle."""
    lo, hi = tr["window"]
    ivs = [(max(a, lo), min(b, hi)) for _, a, b in tr["device"]]
    busy = union_length(ivs)
    by_name: dict[str, float] = {}
    for name, a, b in tr["device"]:
        by_name[name] = by_name.get(name, 0.0) + (min(b, hi) - max(a, lo))
    gaps, at = [], lo
    for a, b in merged(ivs):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [s for s in tr["spans"] if s[1] <= mid <= s[2]]
        label = max(inner, key=lambda s: s[1])[0] if inner else "(no span)"
        idle[label] = idle.get(label, 0.0) + (b - a)
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": hi - lo, "by_name": by_name,
            "breakdown": {
                "device_ops": [[n, s] for n, s in rank],
                "idle_gaps": [[n, s] for n, s in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:top]]}}

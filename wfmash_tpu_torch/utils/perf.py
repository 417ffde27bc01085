"""Process-wide performance counters and spans.

Counters are sums under one lock: counts, and host wall seconds. None
of them is device time: `align.device_s` is the tier solver's host wall
around packing, launch, the wait and decoding, on a thread that overlaps
planning.

A span times one region of the port (`with perf.span("align.plan"):`).
At close it adds its duration to the counter `<name>_s` and its self
time, the duration less the union of its children's intervals, to
`<name>.self_s`. Spans nest through a per-thread stack. A span on
another thread names its parent (`parent=`, or `adopt(parent)` for
every span that thread opens), and then counts as that parent's child
too. While torch's profiler runs, each span is also a `record_function`
range, so the trace names the host phase on the device's clock; while a
`recording()` is attached, each closed span is kept as a record. With
neither, a span costs two clock reads and two counter additions.

WFMASH_TPU_PERF=1 prints every counter at the CLI's exit (`dump`).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time

_lock = threading.Lock()
_counters: dict[str, float] = {}
_local = threading.local()
_ids = itertools.count(1)
_recorders: list[list] = []


def add(key: str, value: float) -> None:
    with _lock:
        _counters[key] = _counters.get(key, 0.0) + value


def get(key: str) -> float:
    with _lock:
        return _counters.get(key, 0.0)


def snapshot() -> dict[str, float]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()


def dump() -> None:
    """Every counter, span totals (`<name>_s`) and self times
    (`<name>.self_s`) among them, one `[wfmash::perf] key = value` line
    each on standard error."""
    for k, v in sorted(snapshot().items()):
        print(f"[wfmash::perf] {k} = {v:.3f}", file=sys.stderr)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _profiling() -> bool:
    m = sys.modules.get("torch.autograd.profiler")
    return m is not None and getattr(m, "_is_profiler_enabled", False)


def _covered(intervals: list, lo: int, hi: int) -> int:
    """Length of the union of `intervals`, clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


_keys: dict[str, tuple[str, str]] = {}


class Span:
    """One timed region; `span(name, parent)` makes it, `with` runs it.
    `start` and `end` are time.monotonic_ns() readings; `seconds` is the
    duration once closed."""

    __slots__ = ("name", "parent", "id", "call", "start", "end", "_kids",
                 "_rf", "_stack")

    def __init__(self, name: str, parent: "Span | None" = None):
        self.name = name
        self.parent = parent
        self.start = self.end = 0
        self._kids: list = []
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "Span":
        self._stack = stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(_ids)
        self.call = self.id if self.parent is None else self.parent.call
        stack.append(self)
        if _profiling():
            self._rf = sys.modules["torch.autograd.profiler"] \
                .record_function(self.name)
            self._rf.__enter__()
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = end = time.monotonic_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._stack.pop()
        dur = end - self.start
        own = dur - _covered(self._kids, self.start, end) if self._kids \
            else dur
        if self.parent is not None:
            self.parent._kids.append((self.start, end))
        keys = _keys.get(self.name)
        if keys is None:
            keys = _keys[self.name] = (f"{self.name}_s",
                                       f"{self.name}.self_s")
        with _lock:
            for key, v in zip(keys, (dur, own)):
                _counters[key] = _counters.get(key, 0.0) + v / 1e9
            for rec in _recorders:
                rec.append({"name": self.name, "start": self.start,
                            "end": self.end, "id": self.id,
                            "parent": (None if self.parent is None
                                       else self.parent.id),
                            "thread": threading.get_ident(),
                            "call": self.call})
        return False


def span(name: str, parent: Span | None = None) -> Span:
    """A span called `name`, the child of `parent` (default: the
    innermost span open on this thread)."""
    return Span(name, parent)


class adopt:
    """Spans this thread opens, while no span of its own is open, are
    children of `parent` (a span open on another thread)."""

    def __init__(self, parent: Span | None):
        self.parent = parent

    def __enter__(self) -> None:
        if self.parent is not None:
            _stack().append(self.parent)

    def __exit__(self, *exc) -> bool:
        if self.parent is not None:
            _stack().pop()
        return False


class recording:
    """Keeps a record of every span closed while attached: a list of
    dicts (name, start and end in ns, id, the parent's id, thread, and
    call: the id of the root span, one `cli.main` a CLI call)."""

    def __enter__(self) -> list:
        self.records: list = []
        with _lock:
            _recorders.append(self.records)
        return self.records

    def __exit__(self, *exc) -> bool:
        with _lock:
            _recorders.remove(self.records)
        return False

"""Process-wide performance counters (device-busy accounting).

A run reports the perf trio (sweep Gcells/s, warm end-to-end wall,
device-busy fraction). Device time is accumulated here by every code path
that launches device work and waits for it (up to the device-to-host copy
that ends the wait), so `fraction("align.device_s", wall)` is a
device-busy lower bound.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, float] = {}


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

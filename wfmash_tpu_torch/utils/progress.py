"""Progress meter: atomic counter + updater thread with heartbeats.

Equivalent of the reference's progress_meter::ProgressMeter
(src/common/progress.hpp:16-287): work units accumulate from any
thread; a daemon thread reports to stderr — a redrawn bar on a TTY,
10-second heartbeat lines otherwise — and `finish()` prints the
phase's wall time.
"""

from __future__ import annotations

import sys
import threading
import time

# --quiet: disable the updater output entirely (reference:
# parse_args.hpp:175 sets use_progress_bar = !quiet)
QUIET = False


def set_quiet(q: bool) -> None:
    global QUIET
    QUIET = bool(q)


class ProgressMeter:
    def __init__(self, total: int, banner: str,
                 heartbeat_s: float = 10.0) -> None:
        self.total = max(int(total), 1)
        self.banner = banner
        self.count = 0
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._done = threading.Event()
        self._hb = heartbeat_s
        self._is_tty = sys.stderr.isatty()
        self._thread = threading.Thread(target=self._updater, daemon=True)
        self._thread.start()

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def _render(self) -> None:
        frac = min(self.count / self.total, 1.0)
        elapsed = time.monotonic() - self._t0
        if self._is_tty:
            width = 30
            filled = int(width * frac)
            bar = "#" * filled + "-" * (width - filled)
            sys.stderr.write(
                f"\r{self.banner} [{bar}] {frac * 100:5.1f}% "
                f"({elapsed:.0f}s)")
            sys.stderr.flush()
        else:
            sys.stderr.write(
                f"{self.banner} {frac * 100:.1f}% @ {elapsed:.0f}s\n")

    def _updater(self) -> None:
        interval = 0.5 if self._is_tty else self._hb
        while not self._done.wait(interval):
            if not QUIET:
                self._render()

    def finish(self) -> None:
        self._done.set()
        self._thread.join(timeout=1.0)
        if QUIET:
            return
        elapsed = time.monotonic() - self._t0
        if self._is_tty:
            sys.stderr.write("\n")
        sys.stderr.write(f"{self.banner} done in {elapsed:.2f}s\n")
        sys.stderr.flush()

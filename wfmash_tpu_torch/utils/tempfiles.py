"""Temp-file registry: wfmash-* files cleaned at exit unless kept.

Mirrors the reference's thread-safe registry (temp_file.hpp:1-127):
files are created as `wfmash-tpu-*` in the configured directory (`-B`,
else $TMPDIR family, else cwd), tracked, and removed by an atexit hook
unless `-Z/--keep-temp` was given (temp_file.hpp wiring:
parse_args.hpp:786-809,923).
"""

from __future__ import annotations

import atexit
import os
import tempfile
import threading

_lock = threading.Lock()
_files: list[str] = []
_dir: str | None = None
_keep = False
_registered = False


def set_dir(path: str | None) -> None:
    global _dir
    _dir = path or None


def set_keep_temp(keep: bool) -> None:
    global _keep
    _keep = bool(keep)


def _cleanup() -> None:
    if _keep:
        return
    with _lock:
        files, _files[:] = list(_files), []
    for f in files:
        try:
            os.unlink(f)
        except OSError:
            pass


def create(suffix: str = ".paf") -> str:
    """Create (and register) a temp file; returns its path."""
    global _registered
    directory = _dir
    if directory is None:
        directory = (os.environ.get("TMPDIR") or os.environ.get("TMP")
                     or os.environ.get("TEMP") or os.getcwd())
    fd, path = tempfile.mkstemp(prefix="wfmash-tpu-", suffix=suffix,
                                dir=directory)
    os.close(fd)
    with _lock:
        _files.append(path)
        if not _registered:
            atexit.register(_cleanup)
            _registered = True
    return path


def keep_temp() -> bool:
    return _keep

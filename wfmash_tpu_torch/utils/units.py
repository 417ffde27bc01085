"""Human-friendly numeric parameter parsing.

Equivalent of wfmash's `wfmash::handy_parameter` (reference:
src/common/utils.cpp): accepts plain numbers and k/m/g (case-insensitive)
decimal suffixes, e.g. "1k" -> 1000, "4G" -> 4e9, "0.5m" -> 500000.
"""

from __future__ import annotations


def is_a_number(s: str) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def handy_parameter(value: str | int | float) -> int:
    """Parse a number with an optional k/m/g suffix into an int.

    Returns -1 for unparseable input (mirrors the reference's error
    signalling, where callers treat negative values as invalid).
    """
    if isinstance(value, (int, float)):
        return int(value)
    s = value.strip()
    if not s:
        return -1
    mult = 1
    suffix = s[-1].lower()
    if suffix in ("k", "m", "g"):
        mult = {"k": 1_000, "m": 1_000_000, "g": 1_000_000_000}[suffix]
        s = s[:-1]
    if not is_a_number(s):
        return -1
    return int(float(s) * mult)

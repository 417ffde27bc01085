"""Kernel B's share of its operations roofline over the traced window:
the 32-bit operations of the lanes it counted itself (the port's counter
align.sweep.lanes, summed over the window's launches, times
benchlib/sweep_ops.py's operations a lane) at 67 Top/s, over the device
time of the events named sweep_wfa. None where the window launched it
not once, or the program does not count the lanes."""

from benchlib.readers import counter_sum, device_ms
from benchlib.sweep_ops import ops_roofline_pct


def read(ctx):
    ms = device_ms(ctx, "sweep_wfa")
    lanes = counter_sum(ctx, "align.sweep.lanes")
    if ms is None or ms <= 0 or lanes <= 0:
        return None
    return ops_roofline_pct(int(lanes), ms)

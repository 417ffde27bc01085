"""The mapping's device stages' share of the pair jobs' wall
(map/l1_device.py and map/l2_device.py's map.device_s: host wall around
each stage's torch program)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "map.device_s")

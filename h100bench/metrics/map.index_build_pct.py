"""The index's share of the pair jobs' wall (runner.py's span map.index:
the target group fetched, winnowed, filtered into its tables and copied
to the device stages)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "map.index_s")

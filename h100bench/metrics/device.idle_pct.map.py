"""Share of the map window in which the card ran nothing (torch.profiler's
CUDA events; moves mapped_mbps)."""

from benchlib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)

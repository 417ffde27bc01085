"""Kernel A's device time (csrc/seg_wfa.cu, events named seg_wfa) per
Mbp of query span the window's chunks carried."""

from benchlib.readers import device_ms


def read(ctx):
    ms = device_ms(ctx, "seg_wfa")
    mbp = sum(j["bp"] for j in ctx.jobs_done) / 1e6
    return None if ms is None or mbp <= 0 else ms / mbp

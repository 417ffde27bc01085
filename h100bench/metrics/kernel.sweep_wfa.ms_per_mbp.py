"""Kernel B's device time (csrc/sweep_wfa.cu, events named sweep_wfa)
per Mbp of query span the window's chunks carried. None where the
window launched it not once."""

from benchlib.readers import device_ms


def read(ctx):
    ms = device_ms(ctx, "sweep_wfa")
    mbp = sum(j["bp"] for j in ctx.jobs_done) / 1e6
    return None if ms is None or mbp <= 0 else ms / mbp

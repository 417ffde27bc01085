"""align_chunk_p95_s, read per layer: the nearest-rank 95th percentile
of the window's chunk walls, as the align job kind's end-to-end metric
takes it. For cells whose host clock spreads too widely for that
metric's bound (PERF.md), where it is reported but not held."""

from benchlib.window import p95


def read(ctx):
    walls = [j["wall"] for j in ctx.jobs_done if "bp" in j]
    return p95(walls) if walls else None

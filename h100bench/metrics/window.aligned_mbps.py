"""aligned_mbps, read per layer: the query span of the window's chunks
over the window's whole length, as the align job kind's end-to-end
metric takes it. For cells whose host clock spreads too widely for that
metric's bound (PERF.md), where it is reported but not held."""


def read(ctx):
    done = [j for j in ctx.jobs_done if "bp" in j]
    if not done or ctx.window_s <= 0:
        return None
    return sum(j["bp"] for j in done) / 1e6 / ctx.window_s

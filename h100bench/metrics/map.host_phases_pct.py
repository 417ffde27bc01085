"""The mapping's host phases around the device stages, as a share of the
pair jobs' wall (runner.py's spans map.sketch, map.l2_host and map.pool:
the queries sketched, the L2 walk left to the host and the filters, the
worker pool's start and stop)."""

from benchlib.readers import counter_sum

KEYS = ("map.sketch_s", "map.l2_host_s", "map.pool_s")


def read(ctx):
    jobs = ctx.jobs_done
    wall = sum(j["wall"] for j in jobs)
    if wall <= 0 or not any(k in j["perf"] for j in jobs for k in KEYS):
        return None
    return 100.0 * sum(counter_sum(ctx, k) for k in KEYS) / wall

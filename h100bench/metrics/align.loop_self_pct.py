"""The align loop's and the CLI's host work that no span of theirs
names, as a share of the chunks' wall: the self times of the spans
cli.main and align.loop (cli.py, align/engine.py). The port's own
counterpart of align.loop_uncounted_pct."""

from benchlib.readers import counter_sum

KEYS = ("cli.main.self_s", "align.loop.self_s")


def read(ctx):
    jobs = ctx.jobs_done
    wall = sum(j["wall"] for j in jobs)
    if wall <= 0 or not any(k in j["perf"] for j in jobs for k in KEYS):
        return None
    return 100.0 * sum(counter_sum(ctx, k) for k in KEYS) / wall

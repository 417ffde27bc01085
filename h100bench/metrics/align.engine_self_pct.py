"""The segmented engine's own host work's share of the chunks' wall
(align/segmented.py's span align.engine, its self time: what lies
outside planning, the solve, escalations, the inversion try and the
stitching, in the main batches and the patches' batches)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.engine.self_s")

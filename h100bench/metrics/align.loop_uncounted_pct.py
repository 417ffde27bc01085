"""Share of the chunks' wall spent outside every call into the align
engine and the patching that follows it: the align loop's own host work
(align/engine.py: the -i parse, sequence fetches, job building, record
writing) and the CLI around it.

The port's counters nest (align.patch_s holds the patches' own calls of
the engine, which add to plan_s, seg_solve_s, exact_s and inversion_s;
exact_s holds a pass that seg_solve_s holds too), so they cannot be
subtracted. The traced run wraps SegmentedEngine.align_batch and
biwfa.finish_records_batched in spans instead, and takes their union."""

from benchlib.readers import span_union


def read(ctx):
    wall = sum(j["wall"] for j in ctx.jobs_done)
    if wall <= 0:
        return None
    inside = span_union(ctx, ("align.engine_batch",
                              "align.patch_and_swizzle"))
    return 100.0 * (wall - inside) / wall

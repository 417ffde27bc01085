"""The align loop's sequence fetches' share of the chunks' wall
(align/engine.py's span align.loop.fetch: each sequence fetched from
its FASTA and normalised, on a cache miss or where the cache's budget is
spent)."""

from benchlib.readers import counter_share


def read(ctx):
    return counter_share(ctx, "align.loop.fetch_s")

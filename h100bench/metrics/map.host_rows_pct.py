"""Share of the mapping's L1 and L2 rows that the device stages left to
the native host stages (map.l1_host_rows + map.l2_host_rows over
map.l1_rows + map.l2_rows)."""

from benchlib.readers import counter_sum


def read(ctx):
    rows = counter_sum(ctx, "map.l1_rows") + counter_sum(ctx, "map.l2_rows")
    if rows <= 0:
        return None
    host = (counter_sum(ctx, "map.l1_host_rows")
            + counter_sum(ctx, "map.l2_host_rows"))
    return 100.0 * host / rows

"""loop_launch_ms: host ms a batch in the spans ``search.block``, both
searches: the search loop's blocks of iterations, in which the host
launches the device work."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "search.block")

"""loop_wait_ms: host ms a batch in the spans ``search.sync``, both searches:
the loop's "any row active" tests, in which the host waits for the device."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "search.sync")

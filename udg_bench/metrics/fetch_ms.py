"""fetch_ms: host ms a batch in the span ``exec.fetch``: ids and distances
copied back to the host, the wait for the batch's last device work
included."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "exec.fetch")

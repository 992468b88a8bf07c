"""stage_ms: host ms a batch in the span ``exec.stage``: the batch's copies
to the device (queries, states, entry points, brute ids, plans) and the
graph's serving labels."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "exec.stage")

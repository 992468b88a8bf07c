"""select_ms: host ms a batch in the span ``exec.select``: the brute scan
(B3, over padding where no row is BRUTE_VALID) and the per-row choice
between the graph, wide and brute answers."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "exec.select")

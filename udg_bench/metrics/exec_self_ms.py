"""exec_self_ms: host ms a batch in ``exec.batch`` outside its child spans:
the Python glue, state preparation, entry masking and each search's set-up
before its loop."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "exec.batch", own=True)

"""plan_record_ms: host ms a batch in the span ``exec.plan.record``: the
planner's own metrics (route counts, bound width and slack histograms)."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "exec.plan.record")

"""plan_ms: host ms a batch in the program's span ``exec.plan``
(``exec.plan.plan_queries`` from inside, over the window's untraced
batches; ``planner_ms`` times the same call from outside, over every window
batch, the traced ones included)."""
from udg_bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "exec.plan")

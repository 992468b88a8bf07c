"""planner_ms: host ms a batch in ``exec.plan.plan_queries``, timed around
the executor's call in a traced run."""


def read(ctx):
    spans = ctx["spans"].get("planner")
    return 1e3 * sum(spans) / len(spans) if spans else None

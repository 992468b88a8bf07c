"""shard_plan_ms: rank 0's host ms a batch in
``serve.distributed.plan_sharded_batch`` (its own shard's planning), timed
around the call in a traced run."""


def read(ctx):
    spans = ctx["spans"].get("shard_plan")
    return 1e3 * sum(spans) / len(spans) if spans else None

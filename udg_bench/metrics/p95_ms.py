"""p95_ms: the 95th percentile, by nearest rank, of every answered query's
latency, a query's latency being the host time from the call into
``execute_batch`` for its batch to that call's return."""
import math


def read(ctx):
    lat = sorted(ctx["latencies_s"])
    batch = ctx["batch"]
    rank = math.ceil(0.95 * len(lat) * batch)          # 1-based, over queries
    return lat[(rank - 1) // batch] * 1e3

"""scorer_ms: device ms a batch in ``filter_dist_kernel`` (B1, and B3 where
rows go brute), from the traced slice."""


def read(ctx):
    tr = ctx["trace"]
    return 1e3 * tr["scorer_s"] / tr["batches"] if tr and tr["scorer_s"] > 0 else None

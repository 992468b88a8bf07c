"""merge_ms: device ms a batch in ``beam_merge_kernel`` (B2), from the
traced slice."""


def read(ctx):
    tr = ctx["trace"]
    return 1e3 * tr["merge_s"] / tr["batches"] if tr and tr["merge_s"] > 0 else None

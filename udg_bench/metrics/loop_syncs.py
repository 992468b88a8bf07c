"""loop_syncs: the search loop's host syncs a batch, its "any row active"
tests (``search.batched.LOOP_STATS`` over the window)."""


def read(ctx):
    return ctx["counters"]["loop_syncs"] / ctx["batches"] if ctx["batches"] else None

"""loop_iterations: search-loop iterations a batch, graph and wide search
together (``search.batched.LOOP_STATS`` over the window)."""


def read(ctx):
    return ctx["counters"]["loop_iterations"] / ctx["batches"] if ctx["batches"] else None

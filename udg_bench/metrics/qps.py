"""qps: queries answered in the window over the window's seconds, gaps
between batches included (host clock)."""


def read(ctx):
    return ctx["batches"] * ctx["batch"] / ctx["window_s"]

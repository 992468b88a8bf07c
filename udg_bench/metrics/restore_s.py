"""restore_s: host seconds to load the cached index and stage it on the
device (``exec.planned_graph_from_numpy``)."""


def read(ctx):
    return ctx["setup"]["restore_s"]

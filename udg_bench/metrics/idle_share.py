"""idle_share: the share of the traced slice's wall time in which no
operation ran on the device (the union of device intervals), in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

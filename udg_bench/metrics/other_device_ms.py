"""other_device_ms: device ms a batch outside the hand-written kernels
(torch's sorts, scatters, gathers, elementwise ops and copies), from the
traced slice."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["device_s"] <= 0:
        return None
    return 1e3 * (tr["device_s"] - tr["scorer_s"] - tr["merge_s"]) / tr["batches"]

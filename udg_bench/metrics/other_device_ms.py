"""other_device_ms: device ms a batch outside the hand-written kernels and
the collectives (torch's sorts, scatters, gathers, elementwise ops and
copies), from the traced slice."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["device_s"] <= 0:
        return None
    mine = tr["scorer_s"] + tr["merge_s"] + tr.get("collective_s", 0.0)
    return 1e3 * (tr["device_s"] - mine) / tr["batches"]

"""loop_replay_share: the share of the search loop's blocks that ran as one
CUDA graph replay (span ``search.block.replay``) among all its blocks (span
``search.block``), both searches, over the window's untraced batches, in %.
``None`` where the program has no such span, no block ran, or the totals
hold other batches than the window's untraced ones (as ``spans.span_ms``)."""

REPLAY = "search.block.replay"


def read(ctx):
    try:
        from repro_torch.obs.trace import TOTALS
    except ImportError:
        return None
    traced = ctx["trace"]["batches"] if ctx["trace"] else 0
    n = ctx["batches"] - traced
    batches, _, calls = TOTALS.read()
    if n <= 0 or batches != n or REPLAY not in calls or not calls["search.block"]:
        return None
    return 100.0 * calls[REPLAY] / calls["search.block"]

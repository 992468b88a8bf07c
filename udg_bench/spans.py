"""The program's own spans (``repro_torch.obs.trace``), for the readers in
``metrics/``: means a batch over the window's batches that ran with no
profiler. The program's span totals restart at each batch that runs under
one, so after a traced window they hold the batches that followed its
traced slice, and only those: the warm-up came before the slice, and
nothing calls ``execute_batch`` after the window."""


def span_ms(ctx, span: str, *, own: bool = False):
    """Host ms a batch in ``span``; ``own``: less what its child spans
    cover. ``None`` where the program keeps no span totals, or they hold
    other batches than the window's untraced ones."""
    try:
        from repro_torch.obs.trace import PARENT, TOTALS
    except ImportError:
        return None
    traced = ctx["trace"]["batches"] if ctx["trace"] else 0
    n = ctx["batches"] - traced
    batches, seconds, _ = TOTALS.read()
    if n <= 0 or batches != n:
        return None
    s = seconds[span]
    if own:
        s -= sum(seconds[c] for c, p in PARENT.items() if p == span)
    return 1e3 * s / n

"""The port's spans on its query path (``repro_torch.obs.trace``).

Every ``execute_batch`` opens one batch span; the plan, stage, search loop,
select and fetch spans nest in it by name and carry its id; the loop's
spans are called as often as ``LOOP_STATS`` counts; with no profiler
running a span never calls ``record_function``; ``repro_span_seconds`` is
fed once a batch; ``TOTALS`` sums the unprofiled batches since the last
profiled one; ``Histogram.observe_many`` leaves the state and text that
``observe`` value by value leaves; the benchmark's span readers read the
totals.
"""
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.obs.trace as trace
from repro_torch.exec import PlannerConfig, execute_batch
from repro_torch.exec import executor
from repro_torch.obs import COUNT_BUCKETS, MetricsRegistry, capture_trace, get_registry, to_prometheus_text
from repro_torch.obs.trace import BATCH, BATCH_MARK, PARENT, SPANS, SpanTotals, trace_span
from repro_torch.search.batched import LOOP_STATS
from torch_cases import K, build_case

PLANS = ("auto", "graph", "wide", "brute")
# span names each plan opens once a batch (the loop's spans many times)
ONCE = {
    "auto": {"exec.batch", "exec.plan", "exec.plan.record", "exec.stage", "exec.select",
             "exec.fetch"},
    "graph": {"exec.batch", "exec.plan", "exec.stage", "exec.select", "exec.fetch"},
    "wide": {"exec.batch", "exec.plan", "exec.stage", "exec.select", "exec.fetch"},
    "brute": {"exec.batch", "exec.plan", "exec.stage", "exec.select", "exec.fetch"},
}
# the metrics that read the spans, and what each reads: (span, own time)
READERS = {
    "plan_ms": ("exec.plan", False),
    "plan_record_ms": ("exec.plan.record", False),
    "stage_ms": ("exec.stage", False),
    "loop_launch_ms": ("search.block", False),
    "loop_wait_ms": ("search.sync", False),
    "fetch_ms": ("exec.fetch", False),
    "select_ms": ("exec.select", False),
    "exec_self_ms": ("exec.batch", True),
}


@pytest.fixture(scope="module")
def case():
    return build_case("containment")


def run_batch(case, plan, **kw):
    _, qs, cfg, exports = case
    return execute_batch(exports["f32"][1], qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan,
                         config=PlannerConfig(**cfg), device="cpu", **kw)


def batch_calls(case, plan, **kw):
    """{span: calls} of one unprofiled batch, from ``TOTALS``."""
    n, _, before = trace.TOTALS.read()
    run_batch(case, plan, **kw)
    m, _, after = trace.TOTALS.read()
    assert m == n + 1
    return {s: after[s] - before[s] for s in SPANS}


# --- nesting, ids and calls -------------------------------------------------------------


def profiled_batch(case, plan):
    """({span: [(start, end)]}, the batch's id mark) of one batch run under
    the profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_batch(case, plan)
    ranges = {}
    for e in prof.events():
        if e.name in SPANS or e.name.startswith(BATCH_MARK):
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    (mark,) = [name for name in ranges if name.startswith(BATCH_MARK)]
    return ranges, mark


@pytest.mark.parametrize("plan", PLANS)
def test_spans_nest_by_name_in_one_batch(case, plan):
    ranges, mark = profiled_batch(case, plan)
    (batch,) = ranges.pop(BATCH)
    (at,) = ranges.pop(mark)
    assert batch[0] <= at[0] <= at[1] <= batch[1]
    for name, spans in ranges.items():
        for a, b in spans:
            parents = ranges.get(PARENT[name], [batch])
            assert any(pa <= a and b <= pb for pa, pb in parents), (name, PARENT[name])
    assert {n for n, v in ranges.items() if len(v) == 1} | {BATCH} == ONCE[plan]
    # the profiled batch restarted the totals; an unprofiled one makes the
    # same calls the profiler saw
    assert trace.TOTALS.read()[0] == 0
    calls = batch_calls(case, plan)
    assert calls == {n: len(ranges.get(n, ())) + (n == BATCH) for n in SPANS}
    _, again = profiled_batch(case, plan)
    assert int(again[len(BATCH_MARK):]) == int(mark[len(BATCH_MARK):]) + 2


@pytest.mark.parametrize("block", [1, 3])
@pytest.mark.parametrize("plan", PLANS)
def test_loop_spans_count_what_loop_stats_count(case, plan, block):
    before = dict(LOOP_STATS)
    calls = batch_calls(case, plan, block=block)
    iters = LOOP_STATS["iterations"] - before["iterations"]
    assert calls["search.sync"] == LOOP_STATS["syncs"] - before["syncs"]
    # a block follows every sync but a search's last, and runs at most
    # ``block`` iterations
    assert math.ceil(iters / block) <= calls["search.block"] <= calls["search.sync"]
    if block == 1:
        assert calls["search.block"] == iters


def test_no_profiler_no_record_function(case, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert batch_calls(case, "auto")[BATCH] == 1


def test_span_seconds_fed_once_a_batch(case):
    hist = get_registry().histogram(trace.SPAN_METRIC)
    before = {n: hist.summary(span=n)["count"] for n in SPANS}
    calls = batch_calls(case, "auto")
    assert calls["search.block"] > 1
    assert {n: hist.summary(span=n)["count"] - before[n] for n in SPANS} == {
        n: int(c > 0) for n, c in calls.items()}


@pytest.mark.parametrize("plan", ["auto", "brute"])
def test_spans_cover_the_calls_they_name(case, plan, monkeypatch):
    """Timed from outside, as the benchmark's harness times them, each call
    holds its span and the span most of the call: ``exec.batch`` in
    ``execute_batch``, ``exec.plan`` in the planner (``plan="auto"``)."""
    outside = {"execute_batch": 0.0, "plan_queries": 0.0}

    def timed(fn, name):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                outside[name] += time.perf_counter() - t0
        return call

    monkeypatch.setattr(executor, "plan_queries", timed(executor.plan_queries, "plan_queries"))
    n, before, _ = trace.TOTALS.read()
    batches = 4
    for _ in range(batches):
        timed(run_batch, "execute_batch")(case, plan)
    m, after, _ = trace.TOTALS.read()
    assert m == n + batches
    inside = {s: after[s] - before[s] for s in SPANS}
    assert 0.9 * outside["execute_batch"] <= inside[BATCH] <= outside["execute_batch"]
    if plan == "auto":
        assert 0.9 * outside["plan_queries"] <= inside["exec.plan"] <= outside["plan_queries"]
    else:
        assert outside["plan_queries"] == 0 and inside["exec.plan"] > 0
    covered = sum(inside[c] for c, p in PARENT.items() if p == BATCH)
    assert 0 < covered <= inside[BATCH]


def test_spans_outside_a_batch_count_in_none():
    """A catalog span opened outside any batch, or by another thread while
    a batch is open, adds to no batch; other names keep their histogram."""
    reg = MetricsRegistry()
    n, _, before = trace.TOTALS.read()
    with trace_span("search.block", reg):
        pass
    assert trace.TOTALS.read()[0] == n
    with trace_span(BATCH, reg):
        worker = threading.Thread(target=lambda: trace_span("search.sync").__enter__().__exit__())
        worker.start()
        worker.join()
        with trace_span("serve_step", reg):
            pass
    m, _, after = trace.TOTALS.read()
    assert m == n + 1
    assert {s: after[s] - before[s] for s in SPANS} == {s: int(s == BATCH) for s in SPANS}
    assert reg.histogram(trace.SPAN_METRIC).summary(span="serve_step")["count"] == 1
    assert reg.histogram(trace.SPAN_METRIC).summary(span="search.block")["count"] == 0


class Recording(SpanTotals):
    """``SpanTotals`` that keeps each added batch's calls."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def add(self, ns, calls, profiled):
        self.seen.append((list(calls), profiled))
        super().add(ns, calls, profiled)


def test_batches_on_many_threads_keep_their_own_spans(monkeypatch):
    """More threads than cores open batches at once, switching often: each
    closed batch holds its own thread's spans, none lost."""
    import os
    import sys

    threads, batches = 2 * (os.cpu_count() or 4), 50
    monkeypatch.setattr(trace, "TOTALS", Recording())

    def work(k):
        for _ in range(batches):
            with trace_span(BATCH):
                for _ in range(k):
                    with trace_span("search.block"):
                        pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k + 1,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    rec = trace.TOTALS
    blocks = [calls[SPANS.index("search.block")] for calls, _ in rec.seen]
    assert sorted(blocks) == sorted(k + 1 for k in range(threads) for _ in range(batches))
    assert not any(profiled for _, profiled in rec.seen)
    n, _, calls = rec.read()
    assert n == threads * batches and calls["search.block"] == sum(blocks)


def test_totals_restart_at_a_profiled_batch():
    tot = SpanTotals()
    ns = [10 ** 9 * (j + 1) for j in range(len(SPANS))]
    ones = [1] * len(SPANS)
    for _ in range(3):
        tot.add(ns, ones, profiled=False)
    n, seconds, calls = tot.read()
    assert n == 3 and seconds["exec.plan"] == pytest.approx(6.0) and calls[BATCH] == 3
    tot.add(ns, ones, profiled=True)
    assert tot.read() == (0, dict.fromkeys(SPANS, 0.0), dict.fromkeys(SPANS, 0))
    tot.add(ns, ones, profiled=False)
    assert tot.read()[0] == 1


def test_capture_trace_holds_the_spans(case, tmp_path):
    with capture_trace(tmp_path / "trace") as started:
        run_batch(case, "auto")
    assert started
    names = {e.get("name") for e in json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]}
    assert ONCE["auto"] | {"search.block", "search.sync"} <= names
    assert any(str(n).startswith(BATCH_MARK) for n in names)


# --- observe_many -----------------------------------------------------------------------

EDGES = np.asarray(COUNT_BUCKETS)


@pytest.mark.parametrize("values", [
    EDGES,                                               # every bucket edge
    EDGES[:-1] + 1,                                      # just above each edge
    np.zeros(7),                                         # zero
    np.array([2.0 ** 21, 2.0 ** 40, 1e300, 2.0 ** 20]),  # above the last bucket
    np.arange(0, 5000, 7, dtype=np.int64),               # integer widths
    np.array([0.1, 0.7, 3.3, 1e-9, 2.0 ** 20 + 0.5]),    # fractions
], ids=["edges", "above-edges", "zeros", "above-last", "ints", "fractions"])
def test_observe_many_equals_observe_one_by_one(values):
    a, b = MetricsRegistry(), MetricsRegistry()
    for part, many in ((values[::2], values[::2]), (values[1::2], list(values[1::2])),
                       (values[:0], iter(()))):
        for x in part:
            a.histogram("w", "h", buckets=COUNT_BUCKETS).observe(float(x))
            a.histogram("s", buckets=COUNT_BUCKETS).observe(float(x), bound="hi")
        b.histogram("w", "h", buckets=COUNT_BUCKETS).observe_many(many)
        b.histogram("s", buckets=COUNT_BUCKETS).observe_many((float(x) for x in part), bound="hi")
    assert to_prometheus_text(a) == to_prometheus_text(b)
    for name in ("w", "s"):
        (ka, sa), = a.histogram(name)._samples()
        (kb, sb), = b.histogram(name)._samples()
        assert ka == kb
        assert (sa.counts, sa.sum, sa.count, sa.min, sa.max) == (sb.counts, sb.sum, sb.count, sb.min, sb.max)
        assert all(type(c) is int for c in sb.counts)


def test_observe_many_of_nothing_makes_no_series():
    reg = MetricsRegistry()
    reg.histogram("w", buckets=COUNT_BUCKETS).observe_many(np.zeros(0))
    reg.histogram("w").observe_many(x for x in ())
    assert reg.histogram("w")._samples() == []


# --- the benchmark's span readers -------------------------------------------------------


def totals_with(batches):
    """Span totals of ``batches`` made-up unprofiled batches: batch i
    spends (i + 1) ms times the span's index + 1 in each span, once each."""
    tot = SpanTotals()
    for i in range(batches):
        tot.add([(i + 1) * (j + 1) * 10 ** 6 for j in range(len(SPANS))], [1] * len(SPANS),
                profiled=False)
    return tot


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader_reads_the_window(metric, monkeypatch):
    from udg_bench import spec

    monkeypatch.setattr(trace, "TOTALS", totals_with(3))
    read = spec.reader(metric)
    span, own = READERS[metric]
    idx = SPANS.index(span)
    # three untraced batches, i = 0, 1, 2, so (i + 1) averages 2
    want = 2.0 * (idx + 1)
    if own:
        want -= sum(2.0 * (SPANS.index(c) + 1) for c, p in PARENT.items() if p == span)
    traced = {"batches": 2}
    assert read({"batches": 5, "trace": traced}) == pytest.approx(want)
    assert read({"batches": 3, "trace": None}) == pytest.approx(want)
    assert read({"batches": 4, "trace": traced}) is None     # other batches than the window's
    assert read({"batches": 2, "trace": traced}) is None     # no untraced batch
    monkeypatch.delattr(trace, "TOTALS")                     # a program before the totals
    assert read({"batches": 5, "trace": traced}) is None


def test_a_traced_cpu_run_reports_the_span_metrics(tmp_path, monkeypatch):
    """The tiny benchmark cell, traced on the CPU: every span metric is on
    the line, read from the window's untraced batches, and the batch's own
    time is under half the batch."""
    from udg_bench import run, spec
    from udg_bench.conftest import make_tiny_root

    # this process holds the JAX package for the parity fixtures; the
    # harness refuses to report from such a process
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    root = make_tiny_root(tmp_path / "root")
    res = run.run_cell(spec.load_cell("tiny-cell", root), 2 ** 31 + 19, 2.0, True, device="cpu",
                       cache_dir=tmp_path / "cache")
    got = res["metrics"]
    assert set(READERS) <= set(got) and "planner_ms" in got
    assert all(got[m]["value"] >= 0 for m in READERS)
    assert got["plan_ms"]["value"] > 0 and got["loop_launch_ms"]["value"] > 0
    cell = spec.load_cell("tiny-cell", root)
    # the totals hold the window's untraced batches, and only those
    n, seconds, _ = trace.TOTALS.read()
    assert n == res["attempted"] // cell.traffic["batch"] - cell.traffic["trace_batches"] > 0
    assert got["exec_self_ms"]["value"] < 0.5 * 1e3 * seconds[BATCH] / n

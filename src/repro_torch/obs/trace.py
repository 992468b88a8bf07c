"""Profiling hooks: spans, their running totals, device trace capture.

``trace_span`` is the one span primitive host code uses, cheap enough to
stay on: with no ``torch.profiler`` running a span reads the clock twice and
adds into a slot (no ``record_function``, no NVTX push, no lock).

* The query path's spans are a fixed catalog, ``SPANS``. Every
  ``repro_torch.exec.execute_batch`` call opens the batch span
  ``exec.batch``, which takes the next batch id; each catalog span the same
  thread opens inside it adds its duration and one call to that batch's
  slot. A span's parent follows from its name (``PARENT``). When the batch
  span closes, each span name's total for the batch is observed once into
  ``repro_span_seconds{span=name}`` and the slot is added into ``TOTALS``.
  A catalog span opened outside any batch (the constructor's broad search,
  a lone ``plan_queries``) is counted in no batch.
* Any other name (``serve_step``) is timed into ``repro_span_seconds`` once
  a call, and is an NVTX range while CUDA is initialized.
* While a profiler runs (``torch.autograd._profiler_enabled``), every span
  is also a ``record_function`` range on the profiler's own timeline,
  beside the kernels. The batch span opens a zero-length range
  ``exec.batch.id=<id>`` at its start, so the spans inside a batch's range
  carry its id on the timeline.

``capture_trace`` wraps a ``torch.profiler.profile`` window (CPU and, with
a card, CUDA activity) and writes its Chrome trace into ``logdir`` when the
window closes: the spans and the kernels on one timeline. It degrades to a
timed window when the profiler cannot start, so callers never guard on
platform.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.obs.metrics import MetricsRegistry, resolve

SPAN_METRIC = "repro_span_seconds"
SPAN_HELP = "host-side span wall-clock duration"

# The query path's spans: where each sits is in docs/OBSERVABILITY.md.
SPANS = (
    "exec.batch",            # all of execute_batch
    "exec.plan",             # plan_queries, or a forced plan
    "exec.plan.record",      # the planner's metrics (_record_plan_batch)
    "exec.stage",            # copies to the device, serving_labels
    "search.block",          # one block of search-loop iterations (launches)
    "search.block.replay",   # the block as one CUDA graph replay
    "search.sync",           # the loop's "any row active" test
    "exec.select",           # the brute scan and the per-row plan select
    "exec.fetch",            # ids and distances back to the host
)
BATCH = SPANS[0]
BATCH_MARK = "exec.batch.id="


def _parent(name: str) -> str:
    """The longest dotted prefix of ``name`` in ``SPANS``, else the batch."""
    parts = name.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        if ".".join(parts[:cut]) in SPANS:
            return ".".join(parts[:cut])
    return BATCH


PARENT = {name: _parent(name) for name in SPANS[1:]}
_INDEX = {name: i for i, name in enumerate(SPANS)}
_IDS = itertools.count()
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class SpanTotals:
    """Each catalog span's summed time and calls, and the number of
    batches, over the batches that ran with no profiler since the last one
    that ran under one. A profiled batch's spans carry ``record_function``
    and time more than an unprofiled batch's, so it restarts the sums."""

    def __init__(self):
        self._lock = threading.Lock()
        self._restart()

    def _restart(self) -> None:
        self.batches = 0
        self.ns = [0] * len(SPANS)
        self.calls = [0] * len(SPANS)

    def add(self, ns, calls, profiled: bool) -> None:
        """One closed batch: each span's total ns and calls in it."""
        with self._lock:
            if profiled:
                self._restart()
                return
            self.batches += 1
            self.ns = [a + b for a, b in zip(self.ns, ns)]
            self.calls = [a + b for a, b in zip(self.calls, calls)]

    def read(self) -> Tuple[int, Dict[str, float], Dict[str, int]]:
        """(batches, seconds by span, calls by span)."""
        with self._lock:
            return (self.batches, {n: t * 1e-9 for n, t in zip(SPANS, self.ns)},
                    dict(zip(SPANS, self.calls)))


TOTALS = SpanTotals()


class _Slot:
    """The open batch of one thread."""

    __slots__ = ("id", "ns", "calls", "profiled")

    def __init__(self, batch_id: int):
        self.id = batch_id
        self.ns = [0] * len(SPANS)
        self.calls = [0] * len(SPANS)
        self.profiled = False


class _Local(threading.local):
    slot: Optional[_Slot] = None


_LOCAL = _Local()


class _Span:
    __slots__ = ("name", "index", "registry", "labels", "slot", "owner", "range", "nvtx", "t0")

    def __init__(self, name: str, registry, labels: dict):
        self.name = name
        self.index = _INDEX.get(name)
        self.registry = registry
        self.labels = labels
        self.slot = None
        self.owner = False
        self.range = None
        self.nvtx = False

    def __enter__(self):
        i = self.index
        if i == 0 and _LOCAL.slot is None:
            self.slot = _LOCAL.slot = _Slot(next(_IDS))
            self.owner = True
        elif i:             # a catalog span; a batch inside a batch counts in none
            self.slot = _LOCAL.slot
        if _profiling():
            if self.slot is not None:
                self.slot.profiled = True
            self.range = record_function(self.name)
            self.range.__enter__()
            if self.owner:
                with record_function(f"{BATCH_MARK}{self.slot.id}"):
                    pass
        if i is None:
            self.nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
            if self.nvtx:
                torch.cuda.nvtx.range_push(self.name)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        dt = _clock() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        slot = self.slot
        if self.index is None:
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            resolve(self.registry).histogram(SPAN_METRIC, SPAN_HELP).observe(
                dt * 1e-9, span=self.name, **self.labels)
        elif slot is not None:
            slot.ns[self.index] += dt
            slot.calls[self.index] += 1
            if self.owner:
                _LOCAL.slot = None
                self._close(slot)
        return False

    def _close(self, slot: _Slot) -> None:
        """Add the batch into ``TOTALS``; feed each span name's total once."""
        TOTALS.add(slot.ns, slot.calls, slot.profiled)
        hist = resolve(self.registry).histogram(SPAN_METRIC, SPAN_HELP)
        for name, ns, calls in zip(SPANS, slot.ns, slot.calls):
            if calls:
                hist.observe(ns * 1e-9, span=name, **self.labels)


def trace_span(
    name: str,
    registry: Optional[MetricsRegistry] = None,
    **labels: str,
) -> _Span:
    """A host-side span, as a context manager: a catalog name (``SPANS``)
    adds into the open batch's slot, any other is observed into
    ``repro_span_seconds{span=name,...}`` once a call (module docstring).
    ``registry`` and ``labels`` apply to those observations."""
    return _Span(name, registry, labels)


@contextlib.contextmanager
def capture_trace(
    logdir: str,
    registry: Optional[MetricsRegistry] = None,
) -> Iterator[bool]:
    """Capture a profiler trace window into ``logdir/trace.json`` (open it
    in perfetto or chrome://tracing): the spans of every batch the window
    holds beside the kernels they launched. Yields True when the profiler is
    running, False on the timing-only path. Either way the window's
    duration lands in ``repro_span_seconds{span="capture_trace"}``."""
    reg = resolve(registry)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
        started = True
    except RuntimeError:
        started = False
    t0 = time.perf_counter()
    try:
        yield started
    finally:
        if started:
            prof.stop()
            out = Path(logdir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / "trace.json"))
        reg.histogram(SPAN_METRIC, SPAN_HELP).observe(
            time.perf_counter() - t0, span="capture_trace")

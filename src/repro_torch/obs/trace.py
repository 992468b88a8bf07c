"""Profiling hooks: span annotation and device trace capture.

``trace_span`` is the one instrumentation primitive host code uses: it
names the span in a ``torch.profiler`` trace (``record_function``) and,
when CUDA is initialized, as an NVTX range, so a captured device trace
shows host phases beside the kernel launches; and it always times the span
into the ``repro_span_seconds`` histogram, so the same call sites feed
Prometheus whether or not a trace is being captured.

``capture_trace`` wraps a ``torch.profiler.profile`` window (CPU and, with
a card, CUDA activity) and writes its Chrome trace into ``logdir`` when the
window closes. It degrades to a timed window when the profiler cannot
start, so callers never guard on platform.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

from repro_torch.obs.metrics import MetricsRegistry, resolve

SPAN_METRIC = "repro_span_seconds"


@contextlib.contextmanager
def trace_span(
    name: str,
    registry: Optional[MetricsRegistry] = None,
    **labels: str,
) -> Iterator[None]:
    """Time a host-side span into ``repro_span_seconds{span=name,...}``,
    annotating the profiler timeline (and NVTX, with CUDA initialized)."""
    reg = resolve(registry)
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            if nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()
    finally:
        reg.histogram(
            SPAN_METRIC, "host-side span wall-clock duration"
        ).observe(time.perf_counter() - t0, span=name, **labels)


@contextlib.contextmanager
def capture_trace(
    logdir: str,
    registry: Optional[MetricsRegistry] = None,
) -> Iterator[bool]:
    """Capture a profiler trace window into ``logdir/trace.json`` (open it
    in perfetto or chrome://tracing). Yields True when the profiler is
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
        reg.histogram(
            SPAN_METRIC, "host-side span wall-clock duration"
        ).observe(time.perf_counter() - t0, span="capture_trace")

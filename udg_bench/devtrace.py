"""Device time from ``torch.profiler`` over a traced slice of the window.

``by_name`` sums device time and launches by kernel name, as
``chip_smoke.traced_ms`` does; ``kernel_split`` is ``chip_smoke.traced_split``'s
grouping (``filter_dist_kernel``: B1 and B3, ``beam_merge_kernel``: B2), and
NCCL's kernels (a name holding ``nccl``) are the collectives. The
idle share is measured on the slice's own wall time: the union of every
device interval (kernels, copies, sets) against the host clock from the
first traced batch's call to the last one's return. Each idle gap is named
by the innermost host range open at its middle: a profiler op, or one of
the harness's labels around the program's layers (``run.LABELS``).
"""
from __future__ import annotations

import time
from collections import defaultdict

SCORER = "filter_dist_kernel"      # B1 (packed gather) and B3 (brute, int32)
MERGE = "beam_merge_kernel"        # B2
COLLECTIVE = "nccl"                # NCCL's kernels, in any case
WINDOW_LABEL = "udg_bench.traced_window"


class Tracer:
    """Profile a block: ``with Tracer(labels) as tr: ...`` then
    ``tr.summary(batches)``. ``labels`` are the harness's own host ranges;
    the profiler mirrors them, and any user range, onto the device's
    timeline, where they are no device work and are left out."""

    def __init__(self, labels=()):
        self.labels = set(labels) | {WINDOW_LABEL}

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._torch = torch
        self._card = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._card else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._label = record_function(WINDOW_LABEL)
        self._label.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._card:
            self._torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self._label.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def summary(self, batches: int) -> dict:
        from torch.autograd import DeviceType

        dev, host, frame = [], [], None
        for e in self._prof.events():
            r = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == DeviceType.CUDA:
                if not (getattr(e, "is_user_annotation", False) or e.name in self.labels):
                    dev.append(r)
            elif e.name == WINDOW_LABEL:
                frame = r
            else:
                host.append(r)
        return summarize(dev, host, frame, self.window_s, batches)


def summarize(dev: list, host: list, frame, window_s: float, batches: int) -> dict:
    """Busy time, kernel split and the breakdown from (start_us, end_us,
    name) device and host intervals; ``frame`` is the traced window's own
    host range."""
    by_name = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        by_name[name][0] += (b - a) / 1e6
        by_name[name][1] += 1
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) / 1e6
    lo, hi = (frame[0], frame[1]) if frame else (merged[0][0] if merged else 0, merged[-1][1] if merged else 0)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(host, [(a + b) / 2 for a, b in gaps])):
        idle[name] += (b - a) / 1e6
    total = sum(t for t, _ in by_name.values())
    scorer = sum(t for n, (t, _) in by_name.items() if SCORER in n)
    merge = sum(t for n, (t, _) in by_name.items() if MERGE in n)
    collective = sum(t for n, (t, _) in by_name.items() if COLLECTIVE in n.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "batches": batches, "busy_s": busy_s, "window_s": window_s,
        "device_s": total, "scorer_s": scorer, "merge_s": merge, "collective_s": collective,
        "launches": sum(c for _, c in by_name.values()),
        "device_ops": [[n[:120], t] for n, (t, _) in top],
        "idle_gaps": [[n[:120], t] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def _innermost(host: list, points: list) -> list:
    """For each point (ascending order not required), the name of the
    latest-starting host range that contains it, or ``"untraced host work"``."""
    ev = sorted(host, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    names = [None] * len(points)
    stack, j = [], 0
    for i in order:
        p = points[i]
        while j < len(ev) and ev[j][0] <= p:
            while stack and stack[-1][1] <= ev[j][0]:
                stack.pop()
            stack.append(ev[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names[i] = stack[-1][2] if stack else "untraced host work"
    return names

"""Seeded fault-injection primitives.

The injector sits at *named points*: production code (or a test wrapper)
calls ``injector.on("wal.append")`` at the spot where a fault could
strike, and the injector decides — from its own deterministic RNG stream,
never wall clock — whether this particular visit sleeps, raises, or
passes. Faults are configured per point with independent probabilities,
so one seed fixes the entire fault schedule of a run.

Nothing in ``repro_torch`` imports this module from the serving path;
injection wraps callables from the outside (``wrap`` / ``wrap_method``),
keeping the production code free of test hooks while the chaos scenario
still exercises the real locking, retry, and recovery logic. A copy of the
JAX package's ``repro.fault.inject``: the same seed gives the same
schedule in both.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry, resolve


class InjectedFault(RuntimeError):
    """The exception raised by ``kind="error"`` faults — distinct from any
    production exception type so tests can assert the failure they caused
    is the failure they observed."""

    def __init__(self, point: str, visit: int):
        self.point = point
        self.visit = visit
        super().__init__(f"injected fault at {point!r} (visit {visit})")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault configuration attached to an injection point.

    ``kind``: ``"delay"`` sleeps ``delay_s``; ``"error"`` raises
    :class:`InjectedFault`. ``probability`` is evaluated per visit from
    the injector's seeded stream; ``max_hits`` bounds the total number of
    firings (0 = unlimited) so a scenario can model transient faults that
    heal."""

    kind: str                  # "delay" | "error"
    probability: float = 1.0
    delay_s: float = 0.0
    max_hits: int = 0

    def __post_init__(self):
        if self.kind not in ("delay", "error"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Deterministic per-point fault scheduler."""

    def __init__(
        self,
        seed: int = 0,
        *,
        registry: Optional[MetricsRegistry] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._hits: Dict[str, int] = {}
        self._visits: Dict[str, int] = {}
        self.fired: List[tuple] = []          # (point, kind, visit) log
        self._sleep = sleep
        self._reg = resolve(registry)

    def add(self, point: str, spec: FaultSpec) -> "FaultInjector":
        self._specs.setdefault(point, []).append(spec)
        return self

    def on(self, point: str) -> None:
        """Visit an injection point: maybe sleep, maybe raise."""
        visit = self._visits.get(point, 0)
        self._visits[point] = visit + 1
        for spec in self._specs.get(point, ()):
            key = (point, id(spec))
            hits = self._hits.get(key, 0)
            if spec.max_hits and hits >= spec.max_hits:
                continue
            # one draw per (visit, spec) — the schedule is a pure function
            # of the seed and the visit sequence
            if spec.probability < 1.0 and self._rng.random() >= spec.probability:
                continue
            self._hits[key] = hits + 1
            self.fired.append((point, spec.kind, visit))
            self._reg.counter(
                "repro_faults_injected_total", "faults fired by the injector"
            ).inc(point=point, kind=spec.kind)
            if spec.kind == "delay":
                self._sleep(spec.delay_s)
            else:
                raise InjectedFault(point, visit)

    def wrap(self, point: str, fn: Callable) -> Callable:
        """Return ``fn`` guarded by this injection point (fault fires
        *before* the call — models a failure on the way in)."""

        def guarded(*args, **kwargs):
            self.on(point)
            return fn(*args, **kwargs)

        guarded.__name__ = getattr(fn, "__name__", "wrapped")
        return guarded

    def wrap_method(self, obj, name: str, point: str) -> Callable[[], None]:
        """Monkey-patch ``obj.name`` with a fault-guarded version; returns
        an undo callable (use in a ``finally``)."""
        orig = getattr(obj, name)
        setattr(obj, name, self.wrap(point, orig))

        def undo():
            setattr(obj, name, orig)

        return undo

    @contextlib.contextmanager
    def injected(self, obj, name: str, point: str):
        undo = self.wrap_method(obj, name, point)
        try:
            yield self
        finally:
            undo()


# --- storage-level corruption helpers ------------------------------------------


def corrupt_byte(path: str, offset: int, *, xor: int = 0xFF) -> int:
    """Flip bits of the byte at ``offset`` (negative = from EOF). Returns
    the absolute offset corrupted. Models a latent media error inside a
    WAL segment; recovery must stop replay at the damaged record."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path}: cannot corrupt an empty file")
    off = offset % size
    with open(path, "r+b") as fh:
        fh.seek(off)
        b = fh.read(1)[0]
        fh.seek(off)
        fh.write(bytes([b ^ (xor & 0xFF)]))
        fh.flush()
        os.fsync(fh.fileno())
    return off


def truncate_file(path: str, keep_bytes: int) -> int:
    """Truncate ``path`` to ``keep_bytes`` (clamped to the file size) —
    models a torn write: the tail of the last append never hit disk.
    Returns the resulting size."""
    size = os.path.getsize(path)
    keep = max(0, min(int(keep_bytes), size))
    with open(path, "r+b") as fh:
        fh.truncate(keep)
        fh.flush()
        os.fsync(fh.fileno())
    return keep


def poison_vector(dim: int, *, kind: str = "nan", seed: int = 0) -> np.ndarray:
    """A query vector with one non-finite component at a seeded position —
    the boundary-validation tests feed these to ``submit``/``serve_batch``
    and assert rejection, not garbage top-k."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dim).astype(np.float32)
    pos = int(rng.integers(dim))
    v[pos] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[kind]
    return v

"""Bounded admission control with deadline-aware load shedding (a copy of
the JAX package's ``serve/admission.py``: host logic only).

The serving queue must never grow without bound: a queue deeper than the
deadline horizon only manufactures guaranteed-late work, which then steals
batch slots from requests that could still make their SLA (the classic
overload collapse). ``AdmissionController`` closes that loop at submit
time:

  * **bounded queue** — at most ``max_queue`` requests may wait; beyond
    that the request is shed immediately (``reason="queue_full"``);
  * **predicted-wait shedding** — an EMA of batch service time turns the
    current depth into a wait forecast
    ``ceil((depth + 1) / batch_size) * ema``; a request whose forecast
    exceeds its remaining deadline budget (scaled by ``shed_safety``) is
    shed up front (``reason="predicted_wait"``) instead of timing out in
    the queue;
  * **degradation ladder** — sustained pressure (queue occupancy) maps to
    a discrete level the server uses to trade recall for capacity while
    *keeping the same device tables and kernels*:

        level 0   normal: selectivity-aware planning ("auto")
        level 1   elevated: planner config pins wide_max_fraction=0 so no
                  query routes GRAPH_WIDE (same planned executor, narrower
                  beams)
        level 2   overload: single-strategy "graph" core (the pre-planner
                  path — it runs on the tables and kernels already loaded)

Deadlines are tracked as absolute ``time.monotonic()`` instants; requests
that expire while queued are dropped at batch-formation time by the
batcher (``reason="expired"``) so a dead request never occupies a device
slot. Every decision lands in ``repro_torch.obs``:
``repro_admission_total{outcome=}``, ``repro_requests_shed_total{reason=}``,
``repro_degrade_level``, ``repro_predicted_wait_seconds``.

All methods take the controller's internal lock and are safe to call from
any number of submitter threads. The clock is injectable for deterministic
tests (a fault injector drives it with a virtual clock).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    resolve,
)


class RequestShed(Exception):
    """Raised by ``try_admit``/``RequestBatcher.submit`` when a request is
    refused admission. ``reason`` is one of ``"queue_full"``,
    ``"predicted_wait"``; the message carries the numbers behind the
    decision so clients can log actionable rejections."""

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        super().__init__(f"request shed ({reason}): {detail}")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Tuning for the admission controller.

    ``default_deadline_s`` applies when ``submit`` passes no per-request
    deadline. ``shed_safety`` < 1 sheds slightly before the forecast says
    the deadline is lost (forecasts are noisy; late shedding is strictly
    worse than early). The degrade thresholds are queue-occupancy
    fractions with hysteresis implied by occupancy moving continuously.
    ``min_batches_for_prediction`` suppresses predicted-wait shedding
    until the EMA has seen enough batches to mean something (a cold
    server would otherwise shed on garbage estimates).
    """

    max_queue: int = 256
    default_deadline_s: float = 1.0
    ema_alpha: float = 0.2
    shed_safety: float = 0.9
    degrade_elevated: float = 0.5
    degrade_overload: float = 0.8
    min_batches_for_prediction: int = 3


class AdmissionController:
    """Thread-safe admission decisions for a fixed-shape batcher."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        *,
        batch_size: int = 8,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or AdmissionConfig()
        self.batch_size = max(int(batch_size), 1)
        self.clock = clock
        self._lock = threading.Lock()
        self._ema_batch_s: Optional[float] = None
        self._batches_seen = 0
        self.admitted = 0
        self.shed = 0
        self._reg = resolve(registry)

    # --- service-time model ---------------------------------------------------

    def observe_batch(self, service_seconds: float) -> None:
        """Fold one batch's wall-clock service time into the EMA."""
        service_seconds = float(service_seconds)
        if not math.isfinite(service_seconds) or service_seconds < 0:
            return
        with self._lock:
            if self._ema_batch_s is None:
                self._ema_batch_s = service_seconds
            else:
                a = self.config.ema_alpha
                self._ema_batch_s = (
                    a * service_seconds + (1 - a) * self._ema_batch_s
                )
            self._batches_seen += 1

    def predicted_wait(self, queue_depth: int) -> float:
        """Forecast queueing delay for a request arriving at ``queue_depth``:
        number of batches ahead of it (including its own) times the EMA
        batch service time. 0.0 while the model is cold."""
        with self._lock:
            if (self._ema_batch_s is None
                    or self._batches_seen
                    < self.config.min_batches_for_prediction):
                return 0.0
            batches_ahead = math.ceil((queue_depth + 1) / self.batch_size)
            return batches_ahead * self._ema_batch_s

    # --- admission ------------------------------------------------------------

    def try_admit(
        self, queue_depth: int, deadline_s: Optional[float] = None,
    ) -> float:
        """Admit or shed one request given the current queue depth.

        Returns the request's **absolute** deadline (monotonic clock) on
        admission; raises :class:`RequestShed` otherwise.
        """
        budget = (self.config.default_deadline_s
                  if deadline_s is None else float(deadline_s))
        adm = self._reg.counter(
            "repro_admission_total", "admission decisions by outcome"
        )
        if queue_depth >= self.config.max_queue:
            self._shed("queue_full",
                       f"queue depth {queue_depth} >= "
                       f"max_queue {self.config.max_queue}", adm)
        wait = self.predicted_wait(queue_depth)
        self._reg.histogram(
            "repro_predicted_wait_seconds",
            "forecast queueing delay at admission time",
            buckets=LATENCY_BUCKETS_S,
        ).observe(wait)
        if wait > budget * self.config.shed_safety:
            self._shed("predicted_wait",
                       f"predicted wait {wait:.4f}s exceeds "
                       f"{self.config.shed_safety:.2f} x deadline "
                       f"{budget:.4f}s", adm)
        with self._lock:
            self.admitted += 1
        adm.inc(outcome="admitted")
        return self.clock() + budget

    def _shed(self, reason: str, detail: str, adm) -> None:
        with self._lock:
            self.shed += 1
        adm.inc(outcome="shed")
        self._reg.counter(
            "repro_requests_shed_total", "requests refused or dropped, by reason"
        ).inc(reason=reason)
        raise RequestShed(reason, detail)

    def note_expired(self, n: int) -> None:
        """Account requests dropped at batch formation because their
        deadline passed while queued (the batcher's shed point)."""
        if n <= 0:
            return
        with self._lock:
            self.shed += n
        self._reg.counter(
            "repro_requests_shed_total", "requests refused or dropped, by reason"
        ).inc(n, reason="expired")

    # --- degradation ladder ---------------------------------------------------

    def level(self, queue_depth: int) -> int:
        """Map queue occupancy to the degradation level (0/1/2)."""
        occ = queue_depth / self.config.max_queue
        if occ >= self.config.degrade_overload:
            lvl = 2
        elif occ >= self.config.degrade_elevated:
            lvl = 1
        else:
            lvl = 0
        self._reg.gauge(
            "repro_degrade_level",
            "overload degradation ladder rung (0=normal, 1=no GRAPH_WIDE, "
            "2=single-strategy graph core)",
        ).set(lvl)
        return lvl


def validate_query(
    qvec: np.ndarray, s_q, t_q, *, dim: Optional[int] = None,
    what: str = "query", require_ordered: bool = True,
) -> np.ndarray:
    """Reject non-finite query vectors / interval endpoints at the serving
    boundary with an actionable error (a single NaN would otherwise poison
    every distance it touches and surface as silently-wrong top-k).
    ``require_ordered=False`` admits ``s > t`` rows — batch-level entry
    points see sentinel padding rows encoded that way on purpose."""
    q = np.asarray(qvec, dtype=np.float32)
    if dim is not None and q.shape[-1] != dim:
        raise ValueError(
            f"{what}: vector dim {q.shape[-1]} != index dim {dim}"
        )
    if not np.all(np.isfinite(q)):
        raise ValueError(f"{what}: non-finite values in query vector")
    # one request's scalar endpoints that pass are let through without the
    # array conversions (half of a submit's host time, which every admitted
    # request waits on under load); anything else takes the full check
    if (isinstance(s_q, _REAL) and isinstance(t_q, _REAL)
            and math.isfinite(s_q) and math.isfinite(t_q)
            and (s_q <= t_q or not require_ordered)):
        return q
    from repro_torch.data.synthetic import validate_intervals

    validate_intervals(
        s_q, t_q, what=f"{what} interval", require_ordered=require_ordered,
    )
    return q


_REAL = (float, int, np.floating, np.integer)

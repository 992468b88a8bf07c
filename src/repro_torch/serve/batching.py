"""Request batching + straggler mitigation for the serving path (the JAX
package's ``serve/batching.py`` on the port's streaming index and metrics).

``RequestBatcher`` packs asynchronous (vector, interval) requests into
fixed-size batches (padding with sentinel no-op queries) so the serving
step sees one shape per batch size.
A partial batch flushes immediately by default (``timeout_s=0.0``); with a
positive ``timeout_s`` it is held back until the oldest request has waited
that long (or ``force=True``), trading per-request latency for occupancy.

``SpeculativeDispatcher`` models the shard-straggler policy used at fleet
scale: each shard RPC gets a deadline; shards that miss it are speculatively
re-dispatched to their replica, and the first response wins. On a single
host this is exercised with injected delays (tests/test_fault.py); on a real
fleet the same policy object wraps the per-pod RPC layer.

``StreamingServer`` is the online-serving front end over a
``repro_torch.stream.StreamingIndex``: the same fixed-shape batcher feeding
the two-tier streaming search on the index's device, plus epoch-swapped
background compaction — epoch N keeps serving while epoch N+1 builds on a
worker thread, then the swap is atomic and shape-stable.

Every stage reports into the ``repro_torch.obs`` metrics registry (queue depth,
batch occupancy and padding waste, per-request latency, speculative
re-dispatch outcomes, compaction events, epoch age); ``StreamingServer``
can additionally thread the device-side traversal counters
(``stats=True``) into the same registry. See ``docs/OBSERVABILITY.md``
for the catalog.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.exec import default_planner_config
from repro_torch.obs.metrics import (
    COUNT_BUCKETS,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    resolve,
)
from repro_torch.obs.stats import record_search_stats
from repro_torch.obs.trace import trace_span
from repro_torch.serve.admission import AdmissionController, validate_query


@dataclasses.dataclass
class Request:
    qvec: np.ndarray
    s_q: float
    t_q: float
    req_id: int
    t_submit: float = 0.0
    deadline: float = math.inf    # absolute (monotonic); inf = no deadline


class RequestBatcher:
    """Fixed-shape batcher with sentinel padding.

    ``timeout_s=0.0`` (the default) flushes a partial batch as soon as it is
    asked for — the pre-timeout behavior. A positive ``timeout_s`` holds a
    partial batch until its oldest request has aged past the timeout (full
    batches always flush; ``next_batch(force=True)`` overrides the hold).

    ``submit`` and ``next_batch`` may race from different threads (client
    submitters vs the serving loop); every ``_pending`` access is guarded
    by one mutex. ``submit`` rejects non-finite inputs up front and, with
    an :class:`~repro_torch.serve.admission.AdmissionController` attached, may
    raise :class:`~repro_torch.serve.admission.RequestShed`; requests whose
    deadline expires while queued are dropped at batch-formation time
    (``last_expired`` holds their ids) so dead work never reaches the
    device.
    """

    def __init__(
        self,
        batch_size: int,
        dim: int,
        *,
        timeout_s: float = 0.0,
        registry: Optional[MetricsRegistry] = None,
        admission: Optional[AdmissionController] = None,
        validate: bool = True,
    ):
        self.batch_size = batch_size
        self.dim = dim
        self.timeout_s = timeout_s
        self.admission = admission
        self.validate = validate
        self._pending: List[Request] = []
        self._next_id = 0
        self._lock = threading.Lock()
        self._reg = resolve(registry)
        # submit times of the requests in the most recent batch, aligned
        # with its req_ids — read by StreamingServer for request latency
        self.last_submit_times: List[float] = []
        # req_ids dropped by the most recent next_batch (deadline expired
        # while queued) — callers answer these with a shed error
        self.last_expired: List[int] = []

    def submit(
        self, qvec: np.ndarray, s_q: float, t_q: float,
        deadline_s: Optional[float] = None,
    ) -> int:
        if self.validate:
            qvec = validate_query(qvec, s_q, t_q, dim=self.dim)
        deadline = math.inf
        if self.admission is not None:
            # may raise RequestShed — before the id is allocated, so a shed
            # request leaves no trace in the queue
            deadline = self.admission.try_admit(self.pending, deadline_s)
        elif deadline_s is not None:
            deadline = time.monotonic() + float(deadline_s)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._pending.append(Request(
                np.asarray(qvec, np.float32), float(s_q), float(t_q), rid,
                t_submit=time.monotonic(), deadline=deadline,
            ))
            depth = len(self._pending)
        self._reg.gauge(
            "repro_batcher_queue_depth", "requests waiting to be batched"
        ).set(depth)
        return rid

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def next_batch(
        self, force: bool = False,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, List[int], int]]:
        """Returns (q [B,d], s_q [B], t_q [B], req_ids, n_real) or None
        (empty queue, or a partial batch still inside its timeout window)."""
        now = time.monotonic()
        with self._lock:
            # deadline-expired requests are shed here, not served: they
            # would only waste device slots on answers nobody is waiting for
            expired = [r.req_id for r in self._pending if r.deadline < now]
            if expired:
                self._pending = [
                    r for r in self._pending if r.deadline >= now
                ]
            self.last_expired = expired
            if not self._pending:
                if expired and self.admission is not None:
                    self.admission.note_expired(len(expired))
                return None
            timed_out = False
            if len(self._pending) < self.batch_size and not force:
                age = now - self._pending[0].t_submit
                if self.timeout_s > 0 and age < self.timeout_s:
                    return None
                timed_out = self.timeout_s > 0
            take = self._pending[: self.batch_size]
            self._pending = self._pending[self.batch_size:]
        if expired and self.admission is not None:
            self.admission.note_expired(len(expired))
        n = len(take)
        B = self.batch_size
        q = np.zeros((B, self.dim), np.float32)
        s_q = np.zeros(B)
        t_q = np.full(B, -1.0)  # s_q > t_q => empty valid set => no-op row
        for i, r in enumerate(take):
            q[i] = r.qvec
            s_q[i] = r.s_q
            t_q[i] = r.t_q
        self.last_submit_times = [r.t_submit for r in take]
        self._reg.gauge(
            "repro_batcher_queue_depth", "requests waiting to be batched"
        ).set(self.pending)
        self._reg.counter(
            "repro_batches_total", "batches emitted"
        ).inc()
        self._reg.counter(
            "repro_batch_padding_rows_total", "sentinel no-op rows emitted"
        ).inc(B - n)
        if timed_out:
            self._reg.counter(
                "repro_batch_timeout_flushes_total",
                "partial batches flushed by the age timeout",
            ).inc()
        self._reg.histogram(
            "repro_batch_occupancy", "real requests per emitted batch",
            buckets=COUNT_BUCKETS,
        ).observe(n)
        wait = self._reg.histogram(
            "repro_batch_queue_wait_seconds",
            "submit-to-batch queueing delay",
            buckets=LATENCY_BUCKETS_S,
        )
        wait.observe_many(now - r.t_submit for r in take)
        return q, s_q, t_q, [r.req_id for r in take], n


class SpeculativeDispatcher:
    """Deadline-based speculative re-dispatch across shard replicas.

    Accounting: ``deadline_misses`` / ``failures`` split the re-dispatch
    cause per shard (slow vs raised), ``respeculated`` keeps the combined
    historical list; everything also lands in the metrics registry
    (``repro_speculative_dispatch_total{outcome=}`` and the per-shard call
    latency histogram)."""

    def __init__(
        self,
        primary: Sequence[Callable[..., object]],
        replicas: Sequence[Callable[..., object]],
        *,
        deadline_s: float,
        registry: Optional[MetricsRegistry] = None,
    ):
        assert len(primary) == len(replicas)
        self.primary = list(primary)
        self.replicas = list(replicas)
        self.deadline_s = deadline_s
        self.respeculated: List[int] = []
        self.deadline_misses: List[int] = []
        self.failures: List[int] = []
        self._reg = resolve(registry)

    def call_shard(self, shard: int, *args):
        disp = self._reg.counter(
            "repro_speculative_dispatch_total",
            "shard calls by outcome (primary / replica win after a "
            "deadline miss or failure)",
        )
        lat = self._reg.histogram(
            "repro_shard_call_seconds", "per-shard dispatch wall clock",
            buckets=LATENCY_BUCKETS_S,
        )
        t0 = time.perf_counter()
        failed = False
        try:
            out = self.primary[shard](*args)
            if time.perf_counter() - t0 <= self.deadline_s:
                disp.inc(outcome="primary")
                lat.observe(time.perf_counter() - t0, shard=str(shard))
                return out
        except Exception:
            failed = True
        # deadline miss or failure: speculative retry on the replica
        self.respeculated.append(shard)
        if failed:
            self.failures.append(shard)
            disp.inc(outcome="replica_win_failure")
        else:
            self.deadline_misses.append(shard)
            disp.inc(outcome="replica_win_deadline")
        out = self.replicas[shard](*args)
        lat.observe(time.perf_counter() - t0, shard=str(shard))
        return out

    def call_all(self, nshards: int, *args) -> List[object]:
        return [self.call_shard(i, *args) for i in range(nshards)]

    def call_shard_partial(self, shard: int, *args):
        """Like ``call_shard`` but bounded: when the primary misses its
        deadline (or raises) AND the replica also misses or raises, give up
        on the shard and return ``None`` instead of blocking the whole
        batch on one sick pair. The caller merges what it has
        (``repro_torch.serve.distributed.merge_partial_results``) and flags the
        response degraded."""
        disp = self._reg.counter(
            "repro_speculative_dispatch_total",
            "shard calls by outcome (primary / replica win after a "
            "deadline miss or failure)",
        )
        lat = self._reg.histogram(
            "repro_shard_call_seconds", "per-shard dispatch wall clock",
            buckets=LATENCY_BUCKETS_S,
        )
        t0 = time.perf_counter()
        failed = False
        try:
            out = self.primary[shard](*args)
            if time.perf_counter() - t0 <= self.deadline_s:
                disp.inc(outcome="primary")
                lat.observe(time.perf_counter() - t0, shard=str(shard))
                return out
        except Exception:
            failed = True
        self.respeculated.append(shard)
        if failed:
            self.failures.append(shard)
        else:
            self.deadline_misses.append(shard)
        t1 = time.perf_counter()
        try:
            out = self.replicas[shard](*args)
            replica_ok = time.perf_counter() - t1 <= self.deadline_s
        except Exception:
            out, replica_ok = None, False
        lat.observe(time.perf_counter() - t0, shard=str(shard))
        if replica_ok:
            disp.inc(outcome="replica_win_failure" if failed
                     else "replica_win_deadline")
            return out
        disp.inc(outcome="both_missed")
        self._reg.counter(
            "repro_degraded_responses_total",
            "responses served from a partial shard set",
        ).inc(shard=str(shard))
        return None

    def call_all_partial(
        self, nshards: int, *args,
    ) -> Tuple[List[object], List[int]]:
        """Dispatch every shard via ``call_shard_partial``; returns
        ``(results, missing)`` where ``results[i]`` is ``None`` for each
        shard in ``missing``."""
        results = [self.call_shard_partial(i, *args) for i in range(nshards)]
        missing = [i for i, r in enumerate(results) if r is None]
        return results, missing


class StreamingServer:
    """Batched online serving over a ``StreamingIndex`` with background
    epoch-swap compaction.

    ``step()`` drains one fixed-shape batch through the streaming search on
    the index's device. ``maybe_compact_async()`` kicks the LSM compaction
    policy: the expensive UDG rebuild runs on a worker thread against a
    snapshot while queries keep hitting the current epoch;
    ``finish_compaction`` then swaps the epoch atomically (queries in flight
    hold a consistent snapshot of exactly one epoch — the swap replaces
    whole-epoch references under the index lock).

    ``stats=True`` asks the index for the device-side ``SearchStats`` on
    every step and folds the real (non-sentinel) rows into the metrics
    registry.

    The index's searches take no kernel-selection switch (the kernels run
    on the card, their plain versions on the CPU), so neither does the
    server. Every rung of the degradation ladder searches the same epoch's
    device bundle with the same kernels: a rung changes only the plan and
    the planner config handed to ``index.search``.
    """

    def __init__(
        self,
        index,
        *,
        batch_size: int = 8,
        k: int = 10,
        beam: int = 64,
        fused: bool = True,
        plan: str = "auto",
        timeout_s: float = 0.01,
        registry: Optional[MetricsRegistry] = None,
        stats: bool = False,
        admission: Optional[AdmissionController] = None,
        compaction_backoff_s: float = 0.05,
        compaction_backoff_max_s: float = 5.0,
        compaction_backoff_seed: int = 0,
    ):
        self.index = index
        self.k = k
        self.beam = beam
        self.fused = fused
        # execution-strategy selection per query (repro_torch.exec planner):
        # "auto" = selectivity-aware, "graph" = pre-planner parity oracle
        self.plan = plan
        self.stats = stats
        self._reg = resolve(registry)
        self.admission = admission
        self.batcher = RequestBatcher(
            batch_size, index.dim, timeout_s=timeout_s, registry=registry,
            admission=admission,
        )
        # overload ladder, level 1: same planned program, but
        # wide_max_fraction=0 means no query ever routes GRAPH_WIDE — the
        # widened-beam capacity headroom is the first thing to go
        self._degraded_config = dataclasses.replace(
            default_planner_config(), wide_max_fraction=0.0
        )
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None
        self.compactions: List[object] = []
        self._epoch_seen = index.epoch
        self._epoch_swap_t = time.monotonic()
        # compaction failure handling: keep serving the old epoch (the
        # abort already restored it) and retry with exponential backoff +
        # seeded jitter rather than tearing down the serving loop
        self._backoff_base_s = compaction_backoff_s
        self._backoff_max_s = compaction_backoff_max_s
        self._backoff_rng = np.random.default_rng(compaction_backoff_seed)
        self._fail_count = 0
        self._retry_at = 0.0
        self.last_compaction_error: Optional[BaseException] = None

    # --- mutations (pass-through) --------------------------------------------

    def insert(self, vec: np.ndarray, s: float, t: float) -> int:
        return self.index.insert(vec, s, t)

    def delete(self, ext_id: int) -> bool:
        return self.index.delete(ext_id)

    # --- queries --------------------------------------------------------------

    def submit(self, qvec: np.ndarray, s_q: float, t_q: float,
               deadline_s: Optional[float] = None) -> int:
        return self.batcher.submit(qvec, s_q, t_q, deadline_s=deadline_s)

    def _observe_epoch(self) -> None:
        epoch = self.index.epoch
        if epoch != self._epoch_seen:
            self._epoch_seen = epoch
            self._epoch_swap_t = time.monotonic()
        self._reg.gauge("repro_epoch", "current serving epoch").set(epoch)
        self._reg.gauge(
            "repro_epoch_age_seconds", "time since the last epoch swap"
        ).set(time.monotonic() - self._epoch_swap_t)

    def step(self, force: bool = False) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Drain one batch; returns {req_id: (ext_ids [k], dists [k])}.
        ``force=True`` flushes a partial batch before its timeout."""
        with trace_span("serve_step", self._reg):
            # degradation ladder: pick the execution strategy from queue
            # pressure BEFORE draining (the batch about to form is part of
            # the backlog being measured). Every rung reuses the
            # already-loaded device bundle and kernel — rebuilding either at
            # peak load would be self-inflicted overload.
            plan, planner_config = self.plan, None
            if self.admission is not None and self.plan == "auto":
                lvl = self.admission.level(self.batcher.pending)
                if lvl == 1:
                    planner_config = self._degraded_config
                elif lvl == 2:
                    plan = "graph"
                if lvl:
                    self._reg.counter(
                        "repro_degraded_batches_total",
                        "batches served under an overload degradation rung",
                    ).inc(level=str(lvl))
            batch = self.batcher.next_batch(force=force)
            if batch is None:
                self._observe_epoch()
                return {}
            q, s_q, t_q, req_ids, n_real = batch
            t_exec = time.monotonic()
            out = self.index.search(
                q, s_q, t_q, k=self.k, beam=self.beam, fused=self.fused,
                plan=plan, planner_config=planner_config,
                return_stats=self.stats,
            )
            if self.admission is not None:
                # feed the shedding forecast with real batch service times
                self.admission.observe_batch(time.monotonic() - t_exec)
            if self.stats:
                ids, d, st = out
                record_search_stats(st, registry=self._reg, n_real=n_real)
            else:
                ids, d = out
            now = time.monotonic()
            lat = self._reg.histogram(
                "repro_request_latency_seconds",
                "submit-to-result latency per request",
                buckets=LATENCY_BUCKETS_S,
            )
            lat.observe_many(
                now - t for t in self.batcher.last_submit_times[:n_real]
            )
            self._observe_epoch()
            return {
                rid: (ids[i], d[i]) for i, rid in enumerate(req_ids[:n_real])
            }

    def drain(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        while self.batcher.pending:
            out.update(self.step(force=True))
        return out

    # --- background compaction ------------------------------------------------

    @property
    def compacting(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def maybe_compact_async(self) -> bool:
        """Start a background compaction if the policy says so. Returns True
        when a build was started (or is already running).

        A failed previous attempt does NOT propagate here: the epoch swap
        never happened, so the old epoch is still serving correct (if
        staler) results; the failure is recorded
        (``last_compaction_error``) and the next attempt is delayed by
        exponential backoff with seeded jitter. ``join_compaction`` keeps
        the raise-on-failure contract for callers that want it."""
        if self.compacting:
            return True
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            self.last_compaction_error = err
            self._fail_count += 1
            delay = min(
                self._backoff_base_s * (2.0 ** (self._fail_count - 1)),
                self._backoff_max_s,
            )
            # full jitter in [delay/2, delay]: desynchronizes retry storms
            # across servers while keeping the exponential envelope
            delay *= 0.5 + 0.5 * float(self._backoff_rng.random())
            self._retry_at = time.monotonic() + delay
            self._reg.counter(
                "repro_compaction_backoff_retries_total",
                "compaction attempts delayed by failure backoff",
            ).inc()
            self._reg.gauge(
                "repro_compaction_backoff_seconds",
                "current compaction retry delay",
            ).set(delay)
        if time.monotonic() < self._retry_at:
            return False
        if not self.index.should_compact():
            return False
        job = self.index.begin_compaction()
        self._reg.counter(
            "repro_compactions_total", "compaction lifecycle events"
        ).inc(event="started")
        t0 = time.monotonic()

        def run():
            try:
                self.index.build_epoch(job)
                self.compactions.append(self.index.finish_compaction(job))
                self._fail_count = 0
                self._retry_at = 0.0
                self.last_compaction_error = None
                self._reg.counter(
                    "repro_compactions_total", "compaction lifecycle events"
                ).inc(event="completed")
                self._reg.histogram(
                    "repro_compaction_seconds",
                    "background build+swap wall clock",
                    buckets=LATENCY_BUCKETS_S,
                ).observe(time.monotonic() - t0)
            except BaseException as exc:  # surfaced by join_compaction
                self._worker_err = exc
                self.index.abort_compaction()
                self._reg.counter(
                    "repro_compactions_total", "compaction lifecycle events"
                ).inc(event="aborted")

        self._worker = threading.Thread(target=run, name="udg-compaction", daemon=True)
        self._worker.start()
        return True

    def join_compaction(self) -> None:
        """Wait for an in-flight background compaction (re-raising failures)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            raise err

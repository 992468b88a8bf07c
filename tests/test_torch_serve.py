"""The port's serving front end against the JAX package's, on the CPU.

Admission control, the fixed-shape request batcher, the speculative
dispatcher, the partial-result merge and the ``StreamingServer`` are host
logic: the same inputs, on the same virtual clock, give the same decisions
(admitted / shed and why, expired ids, padded batch arrays, re-dispatch
outcomes) and byte-equal Prometheus text in both packages. The server's
answers come from each package's ``StreamingIndex`` after the same
mutations (the reference on its jnp oracles, the port on its plain
versions) and are held equal under the tie rule of
``repro_torch.data.parity``; the degradation ladder picks the same plan and
planner config at each level, and its rungs search the same device bundle.
"""
import math

import numpy as np
import pytest

import repro.obs as jobs
import repro.serve.admission as jadmission
import repro.serve.batching as jbatching
import repro.stream as jstream
import repro_torch.obs as tobs
import repro_torch.serve.admission as tadmission
import repro_torch.serve.batching as tbatching
from repro.serve.distributed import merge_partial_results as jmerge
from repro_torch.data.parity import mismatches
from repro_torch.kernels import _build
from repro_torch.serve import merge_partial_results as tmerge
from repro_torch.stream import CompactionPolicy as tpolicy
from repro_torch.stream import StreamingIndex
from torch_cases import K  # noqa: F401  (pins torch to one thread)

PKGS = {
    "jax": (jadmission, jbatching, jobs),
    "torch": (tadmission, tbatching, tobs),
}
DIM = 8


class FakeTime:
    """A ``time`` module stand-in whose clocks move only when told."""

    def __init__(self, now=1000.0):
        self.now = now

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def registries():
    return {name: pkg[2].MetricsRegistry() for name, pkg in PKGS.items()}


def prom(name, reg):
    return PKGS[name][2].to_prometheus_text(reg)


def comparable(name, reg):
    """Parsed registry without the wall-clock series (durations differ
    between two runs; their observation counts must not)."""
    out = {}
    for key, v in PKGS[name][2].parse_prometheus_text(prom(name, reg)).items():
        base = key.split("{")[0]
        if "seconds" in base and not base.endswith("_count"):
            continue
        out[key] = v
    return out


# --- admission ------------------------------------------------------------------

ADMISSION_SCRIPT = [
    ("admit", 0, None), ("admit", 3, 0.5), ("observe", 0.2), ("admit", 4, None),
    ("observe", 0.4), ("admit", 8, None), ("admit", 2, 0.05), ("expired", 3),
    ("observe", float("nan")), ("observe", -1.0), ("admit", 7, 2.0),
    ("level", 0), ("level", 4), ("level", 7), ("level", 8), ("observe", 0.3),
    ("admit", 5, 0.3), ("admit", 1, None), ("expired", 0), ("wait", 11),
]


def run_admission(name, reg, config_kw):
    adm_mod = PKGS[name][0]
    clock = FakeTime()
    adm = adm_mod.AdmissionController(
        adm_mod.AdmissionConfig(**config_kw), batch_size=4, registry=reg,
        clock=clock.monotonic)
    log = []
    for op, *args in ADMISSION_SCRIPT:
        clock.advance(0.01)
        if op == "admit":
            try:
                log.append(("deadline", adm.try_admit(args[0], args[1])))
            except adm_mod.RequestShed as exc:
                log.append(("shed", exc.reason, str(exc)))
        elif op == "observe":
            adm.observe_batch(args[0])
        elif op == "expired":
            adm.note_expired(args[0])
        elif op == "level":
            log.append(("level", adm.level(args[0])))
        else:
            log.append(("wait", adm.predicted_wait(args[0])))
    log.append(("totals", adm.admitted, adm.shed))
    return log


@pytest.mark.parametrize("config_kw", [
    dict(max_queue=8, default_deadline_s=1.0, min_batches_for_prediction=1),
    dict(max_queue=6, default_deadline_s=0.4, ema_alpha=0.5, shed_safety=0.5,
         min_batches_for_prediction=2),
    dict(),
], ids=["tight", "aggressive", "defaults"])
def test_admission_decisions_and_registry_equal(config_kw):
    regs = registries()
    logs = {name: run_admission(name, regs[name], config_kw) for name in PKGS}
    assert logs["torch"] == logs["jax"]
    assert prom("torch", regs["torch"]) == prom("jax", regs["jax"])


@pytest.mark.parametrize("args", [
    (np.ones(DIM), 1.0, 2.0, {}),
    (np.ones(DIM), 2.0, 1.0, {}),
    (np.ones(DIM), 2.0, 1.0, {"require_ordered": False}),
    (np.array([1.0, np.nan] + [0.0] * (DIM - 2)), 1.0, 2.0, {}),
    (np.ones(DIM), float("inf"), 2.0, {}),
    (np.ones(DIM + 1), 1.0, 2.0, {"dim": DIM}),
    (np.ones((3, DIM)), np.zeros(3), np.full(3, -1.0), {"require_ordered": False}),
    (np.ones(DIM), np.float32(1.5), np.int64(2), {}),
    (np.ones(DIM), 2.0, 2.0, {}),
    (np.ones(DIM), np.float64(np.nan), 2.0, {"require_ordered": False}),
], ids=["ok", "unordered", "sentinel", "nan", "inf_interval", "dim", "batch",
        "numpy_scalars", "equal_endpoints", "nan_unordered_allowed"])
def test_validate_query_equal(args):
    qv, s, t, kw = args
    out = {}
    for name in PKGS:
        try:
            q = PKGS[name][0].validate_query(qv, s, t, **kw)
            out[name] = ("ok", q.dtype.str, q.tolist())
        except ValueError as exc:
            out[name] = ("error", str(exc))
    assert out["torch"] == out["jax"]


# --- the request batcher --------------------------------------------------------

def run_batcher(name, reg, monkeypatch, *, timeout_s, with_admission):
    adm_mod, bat_mod, _ = PKGS[name]
    fake = FakeTime()
    monkeypatch.setattr(bat_mod, "time", fake)
    adm = None
    if with_admission:
        adm = adm_mod.AdmissionController(
            adm_mod.AdmissionConfig(max_queue=6, default_deadline_s=0.5,
                                    min_batches_for_prediction=1),
            batch_size=4, registry=reg, clock=fake.monotonic)
        adm.observe_batch(0.05)
    b = bat_mod.RequestBatcher(4, DIM, timeout_s=timeout_s, registry=reg,
                               admission=adm)
    rng = np.random.default_rng(0)
    log = []

    def submit(n, deadline_s=None):
        for _ in range(n):
            s, t = np.sort(rng.uniform(0, 10, 2))
            try:
                log.append(("id", b.submit(rng.standard_normal(DIM), s, t,
                                           deadline_s=deadline_s)))
            except adm_mod.RequestShed as exc:
                log.append(("shed", exc.reason))
            fake.advance(0.003)

    def drain(force=False):
        out = b.next_batch(force=force)
        log.append(("expired", list(b.last_expired), b.pending))
        if out is None:
            log.append(("none",))
        else:
            q, s_q, t_q, rids, n_real = out
            log.append(("batch", q.tolist(), s_q.tolist(), t_q.tolist(), rids,
                        n_real, list(b.last_submit_times)))

    submit(3)
    drain()
    fake.advance(0.02)
    drain()
    submit(6, deadline_s=0.01)
    fake.advance(0.05)
    submit(2, deadline_s=5.0)
    drain()
    submit(9)
    drain()
    drain(force=True)
    drain(force=True)
    fake.advance(1.0)
    drain(force=True)
    return log


@pytest.mark.parametrize("timeout_s", [0.0, 0.01], ids=["flush", "timeout"])
@pytest.mark.parametrize("with_admission", [False, True], ids=["open", "admission"])
def test_batcher_batches_and_registry_equal(timeout_s, with_admission, monkeypatch):
    regs = registries()
    logs = {name: run_batcher(name, regs[name], monkeypatch, timeout_s=timeout_s,
                              with_admission=with_admission) for name in PKGS}
    assert logs["torch"] == logs["jax"]
    assert prom("torch", regs["torch"]) == prom("jax", regs["jax"])
    # sentinel padding rows are empty intervals (s > t)
    padded = [e for e in logs["torch"] if e[0] == "batch" and e[5] < 4]
    assert padded and all(padded[0][2][i] > padded[0][3][i] for i in range(padded[0][5], 4))


def test_batcher_rejects_nonfinite_in_both():
    for name in PKGS:
        b = PKGS[name][1].RequestBatcher(4, DIM)
        with pytest.raises(ValueError):
            b.submit(np.full(DIM, np.nan), 0.0, 1.0)
        with pytest.raises(ValueError):
            b.submit(np.ones(DIM), 0.0, float("nan"))
        assert b.pending == 0


# --- speculative dispatch ---------------------------------------------------------

def run_dispatcher(name, reg, monkeypatch, scenario):
    bat_mod = PKGS[name][1]
    fake = FakeTime()
    monkeypatch.setattr(bat_mod, "time", fake)

    def shard(i, role):
        def call(x):
            kind = scenario.get((i, role), "ok")
            if kind == "raise":
                raise RuntimeError(f"{role} {i} down")
            fake.advance(0.5 if kind == "slow" else 0.01)
            return (role, i, x)
        return call

    S = 4
    disp = bat_mod.SpeculativeDispatcher(
        [shard(i, "primary") for i in range(S)], [shard(i, "replica") for i in range(S)],
        deadline_s=0.1, registry=reg)
    full = disp.call_all(S, 7) if not any(v == "raise" for k, v in scenario.items()
                                          if k[1] == "replica") else None
    partial, missing = disp.call_all_partial(S, 8)
    return (full, partial, missing, disp.respeculated, disp.deadline_misses, disp.failures)


@pytest.mark.parametrize("scenario", [
    {},
    {(1, "primary"): "slow"},
    {(2, "primary"): "raise", (0, "primary"): "slow"},
    {(3, "primary"): "slow", (3, "replica"): "slow"},
    {(1, "primary"): "raise", (1, "replica"): "raise", (2, "primary"): "slow"},
], ids=["healthy", "slow", "failed", "both_slow", "both_down"])
def test_speculative_dispatch_equal(scenario, monkeypatch):
    regs = registries()
    out = {name: run_dispatcher(name, regs[name], monkeypatch, scenario) for name in PKGS}
    assert out["torch"] == out["jax"]
    assert prom("torch", regs["torch"]) == prom("jax", regs["jax"])


# --- partial-result merge ----------------------------------------------------------

def _shard(ids, dists):
    return np.asarray(ids, np.int32)[None, :], np.asarray(dists, np.float32)[None, :]


@pytest.mark.parametrize("per_shard", [
    [_shard([3, 9, -1], [0.1, 0.5, np.inf]), _shard([7, 2, 4], [0.05, 0.3, 0.9])],
    [_shard([3, 9], [0.1, 0.5]), None],
    [None, None],
    [_shard([-1, -1], [0.0, 0.0]), _shard([5, -1], [0.7, 0.0])],
    [_shard([1, 2, 3], [0.5, 0.5, 0.5]), _shard([4, 5, 6], [0.5, 0.2, 0.5]), None,
     _shard([8, 9, 10], [-0.0, 0.0, 0.5])],
], ids=["all", "missing", "none", "padding", "ties"])
def test_merge_partial_results_equal(per_shard):
    a, b = jmerge(per_shard, k=3), tmerge(per_shard, k=3)
    np.testing.assert_array_equal(b.ids, a.ids)
    np.testing.assert_array_equal(b.dists, a.dists)
    assert (b.degraded, b.missing_shards) == (a.degraded, a.missing_shards)


# --- the streaming server ------------------------------------------------------------

CAPS = dict(node_capacity=256, delta_capacity=64, edge_capacity=32, M=8, Z=32)


def loaded_indexes(n=100, seed=0):
    """The same 100 inserts (a compaction at 64) and 5 deletes in both
    packages."""
    rng = np.random.default_rng(seed)
    jidx = jstream.StreamingIndex(DIM, "containment", **CAPS)
    tidx = StreamingIndex(DIM, "containment", device="cpu", **CAPS)
    for _ in range(n):
        s, t = np.sort(rng.uniform(0.0, 100.0, 2))
        v = rng.standard_normal(DIM).astype(np.float32)
        assert jidx.insert(v, float(s), float(t)) == tidx.insert(v, float(s), float(t))
    for e in (3, 17, 70, 71, 99):
        assert jidx.delete(e) == tidx.delete(e)
    assert jidx.epoch == tidx.epoch == 1
    return jidx, tidx


@pytest.fixture(scope="module")
def indexes():
    return loaded_indexes()


def server_queries(n, seed):
    rng = np.random.default_rng(seed)
    qv = rng.standard_normal((n, DIM)).astype(np.float32)
    lo = rng.uniform(0.0, 60.0, n)
    return qv, lo, lo + rng.uniform(5.0, 40.0, n)


@pytest.mark.parametrize("stats", [False, True], ids=["plain", "stats"])
def test_server_answers_equal(indexes, stats, monkeypatch):
    jidx, tidx = indexes
    regs = registries()
    servers = {
        "jax": jbatching.StreamingServer(jidx, batch_size=4, k=5, beam=16, timeout_s=0.0,
                                         stats=stats, registry=regs["jax"]),
        "torch": tbatching.StreamingServer(tidx, batch_size=4, k=5, beam=16, timeout_s=0.0,
                                           stats=stats, registry=regs["torch"]),
    }
    qv, s, t = server_queries(10, 1)
    answers = {}
    for name, srv in servers.items():
        monkeypatch.setattr(PKGS[name][1], "time", FakeTime())
        for i in range(10):
            assert srv.submit(qv[i], s[i], t[i]) == i
        answers[name] = srv.drain()
    assert sorted(answers["torch"]) == sorted(answers["jax"]) == list(range(10))
    ij = np.stack([answers["jax"][r][0] for r in range(10)])
    dj = np.stack([answers["jax"][r][1] for r in range(10)])
    it = np.stack([answers["torch"][r][0] for r in range(10)])
    dt = np.stack([answers["torch"][r][1] for r in range(10)])
    assert not mismatches(ij, dj, it, dt)
    # one full batch answers exactly as index.search on the same rows
    want = tidx.search(qv[:4], s[:4], t[:4], k=5, beam=16, plan="auto")
    np.testing.assert_array_equal(it[:4], want[0])
    np.testing.assert_array_equal(dt[:4].view(np.int32), want[1].view(np.int32))
    assert comparable("torch", regs["torch"]) == comparable("jax", regs["jax"])


def test_server_ladder_picks_equal_rungs_and_reuses_the_device_bundle(indexes, monkeypatch):
    seen = {}
    for name, idx in zip(PKGS, indexes):
        adm_mod, bat_mod, _ = PKGS[name]
        adm = adm_mod.AdmissionController(
            adm_mod.AdmissionConfig(max_queue=8, default_deadline_s=120.0,
                                    min_batches_for_prediction=1), batch_size=4)
        srv = bat_mod.StreamingServer(idx, batch_size=4, k=5, beam=16, timeout_s=0.0,
                                      admission=adm)
        calls = []
        real = idx.search

        def spy(*a, _real=real, _calls=calls, **kw):
            _calls.append((kw.get("plan"), kw.get("planner_config")))
            return _real(*a, **kw)

        monkeypatch.setattr(idx, "search", spy)
        qv, s, t = server_queries(14, 2)
        if name == "torch":
            bundle = idx._dg.device("cpu")
            libs = dict(_build._libs)
        out, j = [], 0
        for n in (2, 5, 7):            # depth 2 -> level 0, 5 -> 1, 7 -> 2
            for _ in range(n):
                srv.submit(qv[j], s[j], t[j])
                j += 1
            out.append(srv.step(force=True))
        seen[name] = [(p, None if c is None else c.wide_max_fraction) for p, c in calls]
        if name == "torch":
            assert idx._dg.device("cpu") is bundle     # every rung: one bundle
            assert dict(_build._libs) == libs          # and no kernel built
    assert seen["torch"] == seen["jax"] == [("auto", None), ("auto", 0.0), ("graph", None)]


def test_server_compaction_swap_and_backoff_equal(monkeypatch):
    jidx, tidx = loaded_indexes(n=90, seed=3)
    jidx.policy = jstream.CompactionPolicy(max_delta_fraction=0.1, min_mutations=8)
    tidx.policy = tpolicy(max_delta_fraction=0.1, min_mutations=8)
    regs = registries()
    out = {}
    for name, idx in (("jax", jidx), ("torch", tidx)):
        bat_mod = PKGS[name][1]
        srv = bat_mod.StreamingServer(idx, batch_size=4, k=5, beam=16, timeout_s=0.0,
                                      registry=regs[name], compaction_backoff_s=0.5)
        # a failed build keeps the old epoch serving and backs off
        real_build = idx.build_epoch

        def fail(job):
            raise RuntimeError("build failed")

        monkeypatch.setattr(idx, "build_epoch", fail)
        assert srv.maybe_compact_async()
        srv._worker.join()
        started = srv.maybe_compact_async()          # folds the failure, backs off
        err = type(srv.last_compaction_error).__name__
        monkeypatch.setattr(idx, "build_epoch", real_build)
        srv._retry_at = 0.0
        assert srv.maybe_compact_async()
        srv.join_compaction()
        qv, s, t = server_queries(4, 5)
        for i in range(4):
            srv.submit(qv[i], s[i], t[i])
        ans = srv.step(force=True)
        out[name] = (started, err, idx.epoch, idx.live_count, len(srv.compactions),
                     np.stack([ans[r][0] for r in range(4)]),
                     np.stack([ans[r][1] for r in range(4)]))
    j, t_ = out["jax"], out["torch"]
    assert t_[:5] == j[:5] == (False, "RuntimeError", 2, 86, 1)
    assert not mismatches(j[5], j[6], t_[5], t_[6])
    # the backoff delay is seeded jitter: equal, not merely present
    keys = ("repro_compactions_total", "repro_compaction_backoff")
    pick = {name: {k: v for k, v in
                   PKGS[name][2].parse_prometheus_text(prom(name, regs[name])).items()
                   if k.startswith(keys)}
            for name in PKGS}
    assert pick["torch"] == pick["jax"] and pick["torch"]
    assert math.isfinite(pick["torch"]["repro_compaction_backoff_seconds"])

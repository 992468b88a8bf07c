"""The port's observability layer against the JAX package's.

The metrics registry (a copy of the reference's) behaves as the reference's
tests pin it; the same recorded events give byte-equal Prometheus text and
the same JSON snapshot in both packages; ``record_search_stats`` and the
planner's metrics fold one search's counters and one planning result into
the registry alike; ``trace_span`` times its span and names it in a
``torch.profiler`` trace; the estimator's device twin gives the host
bounds.
"""
import json
import math
import urllib.request

import numpy as np
import pytest
import torch

import repro.exec as jexec
import repro.exec.plan as jplan
import repro.obs as jobs
import repro_torch.exec.plan as tplan
from repro_torch.exec import PlannerConfig, count_bounds_device, execute_batch, plan_queries
from repro_torch.obs import (
    COUNT_BUCKETS,
    MetricsRegistry,
    capture_trace,
    get_registry,
    json_snapshot,
    parse_prometheus_text,
    record_search_stats,
    start_metrics_server,
    to_json,
    to_prometheus_text,
    trace_span,
    write_json,
    write_prometheus,
)
from repro_torch.search.batched import prepare_states_extended
from torch_cases import K, build_case


@pytest.fixture(scope="module")
def case():
    return build_case("containment")


def record_events(obs):
    """One sequence of events into a fresh registry of package ``obs``."""
    reg = obs.MetricsRegistry()
    reg.counter("repro_queries_total", "q").inc(5)
    reg.counter("labeled_total").inc(3, plan="GRAPH", shard="0")
    reg.counter("labeled_total").inc(1.5, plan="BRUTE_VALID", shard="1")
    g = reg.gauge("repro_depth", "queue depth")
    g.set(7)
    g.dec(2)
    h = reg.histogram("repro_lat_seconds", buckets=(0.01, 0.1, 1.0))
    h.observe_many([0.005, 0.05, 0.5, 0.05, 3.0])
    h.observe(0.2, span='a "quoted"\nname')
    c = reg.histogram("repro_counts", "per-query", buckets=obs.COUNT_BUCKETS)
    c.observe_many(float(x) for x in range(0, 3000, 7))
    return reg


def without_timestamp(snapshot: str) -> str:
    d = json.loads(snapshot)
    d.pop("timestamp")
    return json.dumps(d, sort_keys=True)


# --- the registry, as the reference's tests pin it --------------------------------


def test_counter_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("x_total", "help")
    c.inc()
    c.inc(2.5)
    c.inc(1, plan="GRAPH")
    assert c.value() == 3.5
    assert c.value(plan="GRAPH") == 1.0
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(7)
    g.dec(2)
    assert g.value() == 5.0
    assert reg.counter("x_total") is c
    with pytest.raises(TypeError):
        reg.gauge("x_total")


def test_histogram_percentiles():
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0, 10.0))
    h.observe(0.42)
    s = h.summary()
    assert s["count"] == 1 and s["p50"] == pytest.approx(0.42) and s["p99"] == pytest.approx(0.42)
    h = reg.histogram("v", buckets=tuple(float(x) for x in range(1, 101)))
    h.observe_many(float(x) for x in range(1, 101))
    assert h.percentile(0.5) == pytest.approx(50.0, abs=1.0)
    assert h.percentile(0.99) == pytest.approx(99.0, abs=1.0)
    assert math.isnan(h.percentile(0.5, missing="yes"))


def test_histogram_out_of_range_lands_in_inf_bucket():
    reg = MetricsRegistry()
    reg.histogram("v", buckets=(1.0, 2.0)).observe(5.0)
    samples = parse_prometheus_text(to_prometheus_text(reg))
    assert samples['v_bucket{le="2"}'] == 0
    assert samples['v_bucket{le="+Inf"}'] == 1
    assert samples["v_count"] == 1


def test_global_registry_resolution():
    assert get_registry() is get_registry()


# --- export: the same events, the same bytes ------------------------------------------


def test_prometheus_text_is_byte_equal_to_the_reference():
    import repro_torch.obs as tobs

    want = jobs.to_prometheus_text(record_events(jobs))
    got = to_prometheus_text(record_events(tobs))
    assert got == want
    assert parse_prometheus_text(got) == jobs.parse_prometheus_text(want)
    assert parse_prometheus_text(got)['repro_lat_seconds_bucket{le="+Inf"}'] == 5


def test_json_snapshot_equals_the_reference():
    import repro_torch.obs as tobs

    want = without_timestamp(jobs.json_snapshot(record_events(jobs)))
    got = without_timestamp(json_snapshot(record_events(tobs)))
    assert got == want
    hist = {f["name"]: f for f in to_json(record_events(tobs))["metrics"]}["repro_lat_seconds"]
    assert hist["samples"][0]["count"] == 5


def test_file_writers_and_http_endpoint(tmp_path):
    import repro_torch.obs as tobs

    reg = record_events(tobs)
    p1 = write_prometheus(tmp_path / "metrics.prom", reg)
    p2 = write_json(tmp_path / "metrics.json", reg)
    assert parse_prometheus_text(p1.read_text())["repro_queries_total"] == 5
    assert json.loads(p2.read_text())["metrics"]
    with start_metrics_server(reg) as srv:
        text = urllib.request.urlopen(srv.url, timeout=5).read().decode()
        assert text == to_prometheus_text(reg)
        assert json.loads(urllib.request.urlopen(srv.url + ".json", timeout=5).read())["metrics"]


# --- search counters and the planner, folded alike --------------------------------


def test_record_search_stats_folds_alike():
    st = {
        "iters": np.array([3, 5, 0, 9]),
        "expanded": np.array([3, 5, 0, 9]),
        "cand_total": np.array([30, 50, 0, 90]),
        "cand_valid": np.array([10, 25, 0, 90]),
        "kept": np.array([9, 20, 0, 80]),
        "visited": np.array([10, 21, 0, 81]),
        "beam_occupancy": np.array([8, 8, 0, 8]),
        "hit_max_iters": np.array([False, False, False, True]),
        "delta_valid": np.array([1, 0, 0, 2]),
    }
    got, want = MetricsRegistry(), jobs.MetricsRegistry()
    record_search_stats(st, registry=got, n_real=3)
    jobs.record_search_stats(st, registry=want, n_real=3)
    assert to_prometheus_text(got) == jobs.to_prometheus_text(want)
    term = got.counter("repro_search_terminations_total")
    assert term.value(cause="beam_converged") == 2 and term.value(cause="no_entry") == 1
    assert got.histogram("repro_search_visited_per_query",
                         buckets=COUNT_BUCKETS).summary()["count"] == 3


def test_one_search_folds_into_equal_registries(case):
    """A planned batch's counters from each package (device tensors on the
    port's side) give the same Prometheus text."""
    _, qs, cfg, exports = case
    jdg, tdg = exports["f32"]
    *_, jst = jexec.execute_batch(jdg, qs.vectors, qs.s_q, qs.t_q, k=K, use_ref=True,
                                  config=jexec.PlannerConfig(**cfg), stats=True)
    from repro_torch.exec.executor import planned_exec_core, mask_entry_points

    states, ep, invalid = prepare_states_extended(tdg, qs.s_q, qs.t_q)
    pb = plan_queries(tdg.planner, states, invalid, config=PlannerConfig(**cfg))
    eg, ew = mask_entry_points(ep, pb.plans)
    di = tdg.device("cpu")
    c = PlannerConfig(**cfg)
    *_, tst = planned_exec_core(
        di.table, di.nbr, di.labels, torch.from_numpy(qs.vectors), torch.from_numpy(states),
        torch.from_numpy(eg), torch.from_numpy(ew), torch.from_numpy(pb.bf_ids),
        torch.from_numpy(pb.plans), k=K, beam=64, wide_beam=64 * c.wide_beam_scale,
        max_iters=128, wide_max_iters=128 * c.wide_beam_scale, wide_expand=c.wide_expand,
        norms=di.norms, stats=True)
    assert isinstance(tst.iters, torch.Tensor)
    got, want = MetricsRegistry(), jobs.MetricsRegistry()
    record_search_stats(tst, registry=got)
    jobs.record_search_stats(jst, registry=want)
    assert to_prometheus_text(got) == jobs.to_prometheus_text(want)
    assert got.counter("repro_search_queries_total").value() == len(qs.vectors)


@pytest.mark.parametrize("plan", ["auto", "graph", "brute"])
def test_planner_metrics_fold_alike(case, plan, monkeypatch):
    """Route counts, bound widths and slacks of one batch's planning, in
    registries substituted for each package's default one."""
    import repro_torch.obs as tobs

    _, qs, cfg, exports = case
    jdg, tdg = exports["f32"]
    got, want = tobs.MetricsRegistry(), jobs.MetricsRegistry()
    monkeypatch.setattr(tplan, "get_registry", lambda: got)
    monkeypatch.setattr(jplan, "get_registry", lambda: want)
    jexec.execute_batch(jdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan, use_ref=True,
                        config=jexec.PlannerConfig(**cfg))
    execute_batch(tdg, qs.vectors, qs.s_q, qs.t_q, k=K, plan=plan,
                  config=PlannerConfig(**cfg), device="cpu")
    assert to_prometheus_text(got) == jobs.to_prometheus_text(want)
    if plan != "auto":      # forced plans do not plan
        assert to_prometheus_text(got) == "\n"
        return
    routes = got.counter("repro_planner_routes_total")
    assert sum(routes.value(plan=p) for p in ("GRAPH", "GRAPH_WIDE", "BRUTE_VALID")) == len(qs.vectors)
    assert got.histogram("repro_planner_bound_slack").summary(bound="hi")["count"] > 0


def test_count_bounds_device_equals_the_host_bounds(case):
    import jax.numpy as jnp

    _, qs, _, exports = case
    jdg, tdg = exports["f32"]
    est = tdg.planner
    rng = np.random.default_rng(0)
    a = rng.integers(-3, est.num_x + 3, 200)
    c = rng.integers(-3, est.num_y + 3, 200)
    lo, hi = count_bounds_device(*est.device_tables("cpu"), torch.from_numpy(a), torch.from_numpy(c))
    hlo, hhi = est.count_bounds(a, c)
    np.testing.assert_array_equal(lo.numpy(), hlo)
    np.testing.assert_array_equal(hi.numpy(), hhi)
    jlo, jhi = jexec.count_bounds_device(*jdg.planner.device_tables(), jnp.asarray(a), jnp.asarray(c))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert est.device_tables("cpu")[0] is est.device_tables("cpu")[0]    # memoized


# --- tracing ----------------------------------------------------------------------------


def test_trace_span_records_a_duration_and_names_the_span():
    reg = MetricsRegistry()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_span("unit_test_span", reg, phase="x"):
            torch.ones(8).sum()
    s = reg.histogram("repro_span_seconds").summary(span="unit_test_span", phase="x")
    assert s["count"] == 1 and s["p50"] > 0
    assert any(e.name == "unit_test_span" for e in prof.events())


def test_capture_trace_writes_a_trace(tmp_path):
    reg = MetricsRegistry()
    with capture_trace(tmp_path / "trace", reg) as started:
        torch.ones(8).sum()
    assert started
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert reg.histogram("repro_span_seconds").summary(span="capture_trace")["count"] == 1

"""Observability: device-side traversal counters, host metrics,
Prometheus/JSON export and profiling spans (the JAX package's ``obs``).

  * ``repro_torch.obs.metrics``: counters, gauges and fixed-bucket
    histograms with p50/p90/p99 summaries, one process-default registry
    (a copy of the JAX package's; ``Histogram.observe_many`` takes its
    values in one numpy pass);
  * ``repro_torch.obs.stats``: the ``SearchStats`` counters the search
    cores emit with ``stats=True``, and ``record_search_stats``, which folds
    them into the registry;
  * ``repro_torch.obs.export``: Prometheus text, JSON snapshots, file
    writers and a daemon-thread HTTP endpoint (a copy, stdlib only);
  * ``repro_torch.obs.trace``: ``trace_span``, the one span primitive: on
    the query path a fixed catalog of spans (``SPANS``) that costs two
    clock reads and an add into the open batch's slot, always on, summed
    by ``TOTALS`` and fed to ``repro_span_seconds`` once a batch; a
    ``record_function`` range only while a profiler runs;
    ``capture_trace`` writes a Chrome trace with the spans beside the
    kernels.
"""
from repro_torch.obs.export import (
    MetricsServer,
    json_snapshot,
    parse_prometheus_text,
    start_metrics_server,
    to_json,
    to_prometheus_text,
    write_json,
    write_prometheus,
)
from repro_torch.obs.metrics import (
    COUNT_BUCKETS,
    FRACTION_BUCKETS,
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    resolve,
)
from repro_torch.obs.stats import (
    SearchStats,
    combine_stats,
    init_search_stats,
    per_query_dict,
    record_search_stats,
    stats_to_host,
)
from repro_torch.obs.trace import capture_trace, trace_span

__all__ = [
    "COUNT_BUCKETS",
    "FRACTION_BUCKETS",
    "LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "SearchStats",
    "capture_trace",
    "combine_stats",
    "get_registry",
    "init_search_stats",
    "json_snapshot",
    "parse_prometheus_text",
    "per_query_dict",
    "record_search_stats",
    "resolve",
    "start_metrics_server",
    "stats_to_host",
    "to_json",
    "to_prometheus_text",
    "trace_span",
    "write_json",
    "write_prometheus",
]

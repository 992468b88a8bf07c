"""Registry serialization: Prometheus text exposition, JSON, HTTP endpoint.

``to_prometheus_text`` emits the v0.0.4 text exposition format (HELP/TYPE
headers, cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count`` for
histograms) — the format every Prometheus-compatible scraper ingests.
``to_json`` / ``json_snapshot`` serialize the same state with the
interpolated p50/p90/p99 summaries attached, for dashboards and benchmark
artifacts. ``start_metrics_server`` mounts both on a daemon-thread HTTP
server (``/metrics`` text, ``/metrics.json``), and ``write_prometheus`` /
``write_json`` are the file-writer twins for scrape-by-file setups
(node-exporter textfile collector, CI artifacts).
"""
from __future__ import annotations

import http.server
import json
import math
import threading
import time
from pathlib import Path
from typing import Optional

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    resolve,
)


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt_labels(items) -> str:
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def to_prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Serialize the registry in Prometheus text exposition format."""
    reg = resolve(registry)
    out = []
    for m in reg.collect():
        if m.help:
            out.append(f"# HELP {m.name} {_escape(m.help)}")
        out.append(f"# TYPE {m.name} {m.type}")
        if isinstance(m, (Counter, Gauge)):
            for key, v in m._samples():
                out.append(f"{m.name}{_fmt_labels(key)} {_fmt_value(v)}")
        elif isinstance(m, Histogram):
            for key, s in m._samples():
                cum = 0
                for i, ub in enumerate(list(m.buckets) + [math.inf]):
                    cum += s.counts[i]
                    items = list(key) + [("le", _fmt_value(ub))]
                    out.append(
                        f"{m.name}_bucket{_fmt_labels(items)} {cum}"
                    )
                out.append(
                    f"{m.name}_sum{_fmt_labels(key)} {_fmt_value(s.sum)}"
                )
                out.append(f"{m.name}_count{_fmt_labels(key)} {s.count}")
    return "\n".join(out) + "\n"


def to_json(registry: Optional[MetricsRegistry] = None) -> dict:
    """JSON-able snapshot: every family with samples; histograms carry
    bucket counts and the interpolated p50/p90/p99 summary."""
    reg = resolve(registry)
    fams = []
    for m in reg.collect():
        fam = {"name": m.name, "type": m.type, "help": m.help, "samples": []}
        if isinstance(m, (Counter, Gauge)):
            for key, v in m._samples():
                fam["samples"].append({"labels": dict(key), "value": v})
        elif isinstance(m, Histogram):
            for key, s in m._samples():
                fam["samples"].append({
                    "labels": dict(key),
                    "buckets": {
                        _fmt_value(ub): s.counts[i]
                        for i, ub in enumerate(list(m.buckets) + [math.inf])
                    },
                    **m.summary(**dict(key)),
                })
        fams.append(fam)
    return {"timestamp": time.time(), "metrics": fams}


def json_snapshot(registry: Optional[MetricsRegistry] = None, *,
                  indent: int = 2) -> str:
    return json.dumps(to_json(registry), indent=indent, sort_keys=True)


def write_prometheus(path, registry: Optional[MetricsRegistry] = None) -> Path:
    p = Path(path)
    p.write_text(to_prometheus_text(registry))
    return p


def write_json(path, registry: Optional[MetricsRegistry] = None) -> Path:
    p = Path(path)
    p.write_text(json_snapshot(registry) + "\n")
    return p


class MetricsServer:
    """Daemon-thread HTTP exporter: ``/metrics`` (Prometheus text) and
    ``/metrics.json`` (JSON snapshot). ``port=0`` binds an ephemeral port
    (read it back from ``.port``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 host: str = "127.0.0.1", port: int = 0):
        reg = resolve(registry)

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):               # noqa: N802 (stdlib API)
                if self.path.startswith("/metrics.json"):
                    body = json_snapshot(reg).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = to_prometheus_text(reg).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):       # silence per-request stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-metrics", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(
    registry: Optional[MetricsRegistry] = None, *,
    host: str = "127.0.0.1", port: int = 0,
) -> MetricsServer:
    return MetricsServer(registry, host=host, port=port)


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser: {series_name{labels}: value}.

    Used by the CI telemetry smoke (and tests) to assert the writer emits
    scrapeable output; not a general client."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"unparseable sample line: {line!r}")
        v = float(value)            # raises on malformed values
        out[name_part] = v
    return out

"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration, traffic mix and chips, and each metric. The files:

* a configuration: ``udg_bench/configs/<config>.json`` (the ``file`` of its
  entry in ``BENCHMARK.json``);
* a traffic mix: ``udg_bench/traffic/<traffic>.json``;
* a cell's limits of ``correct``: ``udg_bench/limits/<workload>.json``
  (``check.NUMBERS``, each set from the readings its ``set_from`` gives);
* a metric: ``udg_bench/metrics/<metric>.py``, a reader with
  ``read(ctx) -> float | None`` (``None``: nothing to read in this run, and
  the metric is left out of the line).

A configuration with a ``serve`` group is served sharded: ``shards`` cards,
one process and one shard a card, through the program's ``serve_batch``
(``sharded.py``); one without it runs in one process on one card.

Adding a cell, a configuration, a mix or a metric is adding files and
entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from udg_bench import check, datagen
from udg_bench import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# A configuration's keys. Every key that sets something is read by the
# harness; a key or a value it does not know is refused, so that no file
# reports the defaults under a setting that had no effect.
CONFIG_KEYS = {"name", "deployment", "source", "n", "dim", "relation", "dtype", "data", "build",
               "search", "reduced", "assumed"}
GROUP_KEYS = {"data": {"vectors", "clusters", "spread", "intervals", "T", "data_seed"},
              "build": {"M", "Z", "K_p"},
              "search": {"plan", "k", "beam"}}
# groups a configuration may leave out; with one, every key of it is needed
OPTIONAL_GROUPS = {"serve": {"shards", "merge"}}
# the cross-shard merges of the program's serve_batch (repro_torch.serve.distributed.MERGES)
MERGES = ("all_gather", "tournament")
# the plans serve_batch takes
SERVE_PLANS = ("auto", "graph")
# the values the harness can make or pass on
CHOICES = {("dtype",): {"float32"},
           ("data", "vectors"): {"gaussian_mixture"},
           ("data", "intervals"): {"uniform_capped"},
           ("search", "plan"): {"auto", "graph", "wide"},
           ("relation",): set(datagen.RELATIONS)}


@dataclasses.dataclass
class Cell:
    root: Path                # the checkout the cell's files are read from
    name: str
    chips: int
    config_name: str
    config_file: Path
    config: dict
    traffic: dict
    limits: dict              # udg_bench/limits/<name>.json
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def validate_config(cfg: dict) -> dict:
    """``cfg``, or ValueError naming a missing or unknown key or value."""
    missing, unknown = CONFIG_KEYS - set(cfg), set(cfg) - CONFIG_KEYS - set(OPTIONAL_GROUPS)
    groups = {**GROUP_KEYS, **{g: k for g, k in OPTIONAL_GROUPS.items() if g in cfg}}
    for group, keys in groups.items():
        sub = cfg.get(group, {})
        missing |= {f"{group}.{k}" for k in keys - set(sub)}
        unknown |= {f"{group}.{k}" for k in set(sub) - keys}
    if missing or unknown:
        raise ValueError(f"configuration {cfg.get('name')!r}: missing {sorted(missing)}, "
                         f"unknown {sorted(unknown)}")
    for path, allowed in CHOICES.items():
        value = cfg
        for key in path:
            value = value[key]
        if value not in allowed:
            raise ValueError(f"configuration {cfg['name']!r}: {'.'.join(path)} = {value!r} "
                             f"is not one of {sorted(allowed)}")
    if "serve" in cfg:
        validate_serve(cfg)
    return cfg


def validate_serve(cfg: dict) -> None:
    """A sharded configuration: ``shards`` divides ``n``, ``merge`` is one
    of the program's merges, ``search.plan`` one ``serve_batch`` takes."""
    shards, merge, plan = cfg["serve"]["shards"], cfg["serve"]["merge"], cfg["search"]["plan"]
    name = cfg["name"]
    if not isinstance(shards, int) or isinstance(shards, bool) or shards < 1:
        raise ValueError(f"configuration {name!r}: serve.shards = {shards!r} is not a count")
    if cfg["n"] % shards:
        raise ValueError(f"configuration {name!r}: {shards} shards do not divide n = {cfg['n']}")
    if merge not in MERGES:
        raise ValueError(f"configuration {name!r}: serve.merge = {merge!r} is not one of {MERGES}")
    if plan not in SERVE_PLANS:
        raise ValueError(f"configuration {name!r}: search.plan = {plan!r} is not one of "
                         f"{SERVE_PLANS}, the plans a sharded batch takes")


def validate_limits(limits: dict, cell: str) -> dict:
    """A cell's limits: one for each of ``check.NUMBERS``, and the readings
    they were set from (``set_from``)."""
    missing = set(check.NUMBERS) - set(limits)
    unknown = set(limits) - set(check.NUMBERS) - {"set_from"}
    if missing or unknown:
        raise ValueError(f"limits of {cell!r}: missing {sorted(missing)}, unknown {sorted(unknown)}")
    return limits


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    root = Path(root)
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = root / configs[w["config"]]["file"]
    cfg = validate_config(json.loads(cfg_file.read_text()))
    mix = traffic_mod.validate(json.loads(
        (root / "udg_bench" / "traffic" / f"{w['traffic']}.json").read_text()))
    limits = validate_limits(json.loads(
        (root / "udg_bench" / "limits" / f"{name}.json").read_text()), name)
    shards = cfg.get("serve", {}).get("shards", 1)
    if int(w["chips"]) != shards:
        raise ValueError(f"cell {name!r} asks for {w['chips']} chips, and its configuration "
                         f"{w['config']!r} runs on {shards} (serve.shards, 1 without the group)")
    return Cell(
        root=root, name=name, chips=int(w["chips"]), config_name=w["config"], config_file=cfg_file,
        config=cfg, traffic=mix, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``udg_bench/metrics/<metric>.py``."""
    path = Path(root) / "udg_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"udg_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, ctx: dict, root: Path = ROOT) -> dict:
    """``{name: {"value", "unit"}}`` for each entry whose reader finds a value."""
    out = {}
    for m in entries:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out

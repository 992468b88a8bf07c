"""The deployment's stored index: built once per checkout, restored by every
run after it, as a serving process recovers its shard.

The first run of a configuration builds the index with the program's wave
constructor (``build_udg(..., batched=None)``) and ``export_planned_graph``,
and writes the export's arrays (``search.device_graph.GRAPH_FIELDS``) and
the planner's (``exec.estimator.STATE_FIELDS``) to
``udg_bench/cache/<config>-<key>.npz``, through a temporary file and a
rename. The key is a digest of the configuration's file and of every file
of the program's package, so a change to either builds anew. Every run,
the first included, then restores the index with
``planned_graph_from_numpy``.
"""
from __future__ import annotations

import hashlib
import os
import time
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parent / "cache"


def digest(config_file: Path, package: Path) -> str:
    h = hashlib.sha256()
    h.update(Path(config_file).read_bytes())
    for f in sorted(p for p in Path(package).rglob("*")
                    if p.is_file() and "__pycache__" not in p.parts):
        h.update(str(f.relative_to(package)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:20]


def cache_file(name: str, key: str, cache_dir: Path = CACHE_DIR) -> Path:
    return Path(cache_dir) / f"{name}-{key}.npz"


def build(cfg: dict, vectors: np.ndarray, s: np.ndarray, t: np.ndarray, device) -> tuple:
    """Build and export the index; returns (arrays, report). The report
    splits the build into the constructor's device searches and the rest
    (the host sweep), and gives the export's seconds."""
    import torch
    from repro_torch.core import build_udg
    from repro_torch.exec import export_planned_graph
    from repro_torch.exec.estimator import STATE_FIELDS
    from repro_torch.search.device_graph import GRAPH_FIELDS

    b = cfg["build"]
    t0 = time.perf_counter()
    g, rep = build_udg(vectors, s, t, cfg["relation"], M=b["M"], Z=b["Z"], K_p=b["K_p"],
                       batched=None, device=device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = export_planned_graph(g, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    arrays = {f: getattr(dg, f) for f in GRAPH_FIELDS if getattr(dg, f) is not None}
    arrays["relation"] = np.array(dg.relation)
    arrays.update({f: np.asarray(getattr(dg.planner, f)) for f in STATE_FIELDS})
    report = {"build_s": build_s, "device_search_s": rep.search_seconds,
              "host_sweep_s": build_s - rep.search_seconds, "waves": rep.waves,
              "export_s": export_s}
    return arrays, report


def save(arrays: dict, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore(path: Path, device):
    """The planned ``DeviceGraph`` from a saved export, staged on ``device``."""
    from repro_torch.exec import planned_graph_from_numpy

    with np.load(path, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    return planned_graph_from_numpy(arrays, device=device)

"""pytest settings of the benchmark's own tests (``udg_bench/tests``).

    python -m pytest -q udg_bench/tests               # here, on the CPU
    python -m pytest -q udg_bench/tests -m card       # on the card

Tests marked ``card`` need a CUDA device; the ``cuda`` fixture decides
whether one is present and skips the test when none is.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


# the tiny cell's recall floor: its sound runs read 0.99-1.0 on the CPU, the
# loop cut to one block 0.75-0.78 (tests/test_udgb_run.py, test_udgb_control.py)
TINY_RECALL = 0.9


def make_tiny_root(root: Path, *, relation: str = "containment", n: int = 2048, dim: int = 32,
                   batch: int = 128, sels=(0.1, 0.3, 0.5)) -> Path:
    """A checkout-shaped directory with one tiny cell, ``tiny-cell``
    (configuration ``tiny``, mix ``tiny``, limits those of
    ``udg768-contain-bulk`` with the floor ``TINY_RECALL``), made from copies
    of the real benchmark's files with sizes cut so a CPU run takes seconds."""
    import json
    import shutil

    bench = root / "udg_bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(ROOT / "udg_bench" / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench / "configs" / "udg768-contain.json").read_text())
    cfg.update(name="tiny", n=n, dim=dim, relation=relation)
    cfg["build"].update(M=8, Z=32, K_p=4)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "bulk.json").read_text())
    mix.update(batch=batch, selectivities=list(sels), distinct_batches=2, recall_sample=128,
               trace_batches=1)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    limits = json.loads((bench / "limits" / "udg768-contain-bulk.json").read_text())
    limits.update(recall=TINY_RECALL, set_from="the tiny cell's CPU readings")
    (bench / "limits" / "tiny-cell.json").write_text(json.dumps(limits))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="tiny", file="udg_bench/configs/tiny.json"))
    b["workloads"].append(dict(b["workloads"][0], name="tiny-cell", config="tiny",
                               traffic="tiny"))
    for m in b["per_layer"]:
        m["workloads"] = m["workloads"] + ["tiny-cell"]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def add_tiny_sharded(root: Path, shards: int, *, n: int = 4096) -> str:
    """Add to a tiny root the configuration ``tiny-shard<S>`` (the tiny
    configuration's sizes over ``n`` rows, ``shards`` shards, the
    ``all_gather`` merge) and the cell ``tiny-sharded<S>`` on ``shards``
    chips, with the tiny cell's limits; returns the cell's name."""
    import json

    bench = root / "udg_bench"
    name, cell = f"tiny-shard{shards}", f"tiny-sharded{shards}"
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg.update(name=name, n=n, serve={"shards": shards, "merge": "all_gather"})
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "limits" / f"{cell}.json").write_text((bench / "limits" / "tiny-cell.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name=name, file=f"udg_bench/configs/{name}.json"))
    b["workloads"].append(dict(b["workloads"][0], name=cell, config=name, traffic="tiny",
                               chips=shards))
    for m in b["per_layer"]:
        m["workloads"] = m["workloads"] + [cell]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return cell


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory):
    """One index cache for the session's tiny runs (built by the first)."""
    return tmp_path_factory.mktemp("cache")

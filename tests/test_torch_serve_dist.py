"""The serving step's process-group execution against its single-process one.

``torch_serve_dist_worker.py`` (run in a subprocess, as
``tests/test_distributed.py`` runs its meshes) builds a 2- or 4-shard index
with the port on the CPU, serves one batch in the single-process mesh, then
in a gloo process group of as many ranks (a file store, so parallel test
workers never race for a port), each rank holding its own shard. Held bit
for bit:

* ``all_gather``: every rank returns the single-process result (the same
  shards concatenated in the same order, the same stable sort), through
  ``serve_batch`` (plan auto and graph) and the graph and planned steps;
* ``tournament`` (``isend``/``irecv`` with partner ``rank ^ step``): rank r
  returns the single-process step's view of shard r, and rank 0's
  ``serve_batch`` answer is the single-process answer;
* the stats step's summed counters (``all_reduce``) on every rank, and the
  streaming step with its counters.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def bit_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def run(request, tmp_path_factory):
    world = request.param
    work = tmp_path_factory.mktemp(f"serve_dist{world}")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(REPO / "tests" / "torch_serve_dist_worker.py"),
                          str(work), str(world)], env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]

    def load(name):
        with np.load(work / name) as z:
            return {k: z[k] for k in z.files}

    return world, load("single.npz"), [load(f"rank{r}.npz") for r in range(world)]


def test_all_gather_is_bit_equal_on_every_rank(run):
    world, single, ranks = run
    keys = [k for k in single if "/all_gather/" in k]
    assert len(keys) == 8
    for r, got in enumerate(ranks):
        for k in keys:
            bit_equal(got[k], single[k], f"rank {r} {k}")


def test_tournament_rank_r_is_shard_r_view(run):
    world, single, ranks = run
    for r, got in enumerate(ranks):
        for name in ("graph", "planned"):
            for f in ("gids", "d"):
                bit_equal(got[f"step/{name}/tournament/{f}"], single[f"view{r}/{name}/{f}"],
                          f"rank {r} {name} {f}")
    for name in ("graph", "planned"):     # the single-process step returns shard 0's view
        for f in ("gids", "d"):
            bit_equal(single[f"step/{name}/tournament/{f}"], single[f"view0/{name}/{f}"], name)
    for k in (k for k in single if k.startswith("serve/") and "/tournament/" in k):
        bit_equal(ranks[0][k], single[k], k)


def test_summed_counters_and_streaming_step_are_bit_equal(run):
    world, single, ranks = run
    keys = [k for k in single if k.startswith(("stats/", "stream/"))]
    assert "stats/hit_max_iters" in keys and "stream/delta_valid" in keys
    for r, got in enumerate(ranks):
        for k in keys:
            bit_equal(got[k], single[k], f"rank {r} {k}")
    assert single["stats/iters"].sum() > 0 and single["stream/delta_valid"].sum() > 0

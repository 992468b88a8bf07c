"""Serving over the query axes (``data``, ``pod``) of the port's ``ShardMesh``.

``torch_serve_data_worker.py`` (run in a subprocess, as
``test_torch_serve_dist.py`` runs its groups) serves a 2-shard index in the
single-process mesh at data 1, in the layout's single-process form, and in
a gloo group of 4 ranks (a file store) at data 2 x model 2 and at pod 2 x
data 1 x model 2. Held bit for bit against the data-1 answer:

* on every rank and in the single-process form: ``serve_batch`` (plan auto
  and graph) and the graph and planned steps with the ``all_gather``
  merge, the stats step's summed counters and the streaming step;
* the tournament: the ranks of shard m return the data-1 step's view of
  shard m over the whole batch, the single-process form shard 0's view.

Against the reference: ``torch_serve_data_ref.py`` serves the
(containment, 2) case of ``torch_serve_ref.py`` on a (data 2, model 2) mesh
of four host devices; the port serves the carried shards at data 2 with
the reference's answers under the tie rule. Also the production mesh's
shapes and axis names, ``data_axes``, and an undivided batch refused.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_serve_ref as case
from repro_torch.data.parity import mismatches
from repro_torch.distributed import make_host_mesh as shard_host_mesh
from repro_torch.exec import PlannerConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.serve import make_serving_step, serve_batch, sharded_index_from_numpy
from repro_torch.serve.distributed import STACK_FIELDS
from torch_cases import K  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]


def bit_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module", params=["data2", "pod2"])
def run(request, tmp_path_factory):
    layout = request.param
    work = tmp_path_factory.mktemp(f"serve_{layout}")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(REPO / "tests" / "torch_serve_data_worker.py"),
                          str(work), layout], env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]

    def load(name):
        with np.load(work / name) as z:
            return {k: z[k] for k in z.files}

    return load("single.npz"), load("layout.npz"), [load(f"rank{r}.npz") for r in range(4)]


def test_every_rank_and_the_single_process_form_give_the_data1_answer(run):
    single, layout, ranks = run
    keys = [k for k in single if "/all_gather/" in k or k.startswith(("stats/", "stream/"))]
    assert len(keys) > 8 and "stats/hit_max_iters" in keys and "stream/delta_valid" in keys
    for who, got in [("single-process", layout)] + [(f"rank {r}", g) for r, g in enumerate(ranks)]:
        for k in keys:
            bit_equal(got[k], single[k], f"{who} {k}")
    assert single["stats/iters"].sum() > 0


def test_tournament_ranks_of_shard_m_return_its_view(run):
    single, layout, ranks = run
    for r, got in enumerate(ranks):
        for name in ("graph", "planned"):
            for f in ("gids", "d"):
                bit_equal(got[f"step/{name}/tournament/{f}"], single[f"view{r % 2}/{name}/{f}"],
                          f"rank {r} {name} {f}")
    for k in (k for k in single if "/tournament/" in k):
        bit_equal(layout[k], single[k], f"single-process {k}")
        bit_equal(ranks[0][k], single[k], f"rank 0 {k}")
        bit_equal(ranks[2][k], single[k], f"rank 2 {k}")


@pytest.fixture(scope="module")
def want(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_data_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(REPO / "tests" / "torch_serve_data_ref.py"), str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_data2_answer_equals_the_references(want):
    assert tuple(want["mesh/shape"]) == (2, 2) and tuple(want["mesh/axes"]) == ("data", "model")
    arrays = {f: want[f] for f in STACK_FIELDS}
    arrays.update(relation="containment", n_local=want["n_local"])
    states = [{f: want[f"planner{sh}/{f}"] for f in case.STATE_FIELDS} for sh in range(2)]
    idx = sharded_index_from_numpy(arrays, states, device="cpu")
    mesh = tmesh.make_host_mesh(2, data=2, device="cpu")
    assert mesh.shape == (2, 2) and tmesh.mesh_axis_names(mesh) == tuple(want["mesh/axes"])
    assert tmesh.data_axes(mesh) == tuple(want["mesh/data_axes"])
    vecs, s, t = case.dataset()
    qv, s_q, t_q = case.queries(s, t, "containment")
    cfg = PlannerConfig(**case.PLANNER)
    one = shard_host_mesh(2, device="cpu")
    for plan in ("auto", "graph"):
        for merge in case.MERGES:
            ids, d = serve_batch(idx, mesh, qv, s_q, t_q, k=case.K, beam=case.BEAM, merge=merge,
                                 plan=plan, planner_config=cfg)
            bad = mismatches(want[f"{plan}/{merge}/ids"], want[f"{plan}/{merge}/d"], ids, d)
            assert not bad, (plan, merge, bad[:5])
            ids1, d1 = serve_batch(idx, one, qv, s_q, t_q, k=case.K, beam=case.BEAM, merge=merge,
                                   plan=plan, planner_config=cfg)
            bit_equal(ids, ids1, f"{plan}/{merge} ids")
            bit_equal(d, d1, f"{plan}/{merge} d")


def test_production_mesh_and_data_axes_are_the_references():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == (16, 16) and single.axis_names == ("data", "model")
    assert multi.shape == (2, 16, 16) and multi.axis_names == ("pod", "data", "model")
    assert tmesh.data_axes(single) == ("data",)
    assert tmesh.data_axes(multi) == ("pod", "data")
    assert tmesh.mesh_axis_names(multi) == ("pod", "data", "model")
    pod = tmesh.make_host_mesh(2, data=2, pod=2, device="cpu")
    assert pod.shape == (2, 2, 2) and tmesh.data_axes(pod) == ("pod", "data")
    assert pod.queries == 4 and pod.local_queries == (0, 1, 2, 3)
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(2, data=0, device="cpu")


def test_an_undivided_batch_raises():
    import torch_serve_dist_worker as w
    from repro_torch.core.predicates import get_relation
    from repro_torch.serve import build_sharded_index

    vecs, s, t, qv, lo, hi = w.inputs(2)
    idx = build_sharded_index(vecs[:512], s[:512], t[:512], "containment", 2, M=8, Z=32,
                              device="cpu")
    mesh = tmesh.make_host_mesh(2, data=2, device="cpu")
    with pytest.raises(ValueError, match="query axes"):
        serve_batch(idx, mesh, qv[:15], lo[:15], hi[:15], k=5, beam=16)
    xq, yq = get_relation("containment").query_map(lo[:15], hi[:15])
    dev = idx.device("cpu")
    step = make_serving_step(mesh, "containment", k=5, beam=16)
    with pytest.raises(ValueError, match="query axes"):
        step(*[dev[f] for f in STACK_FIELDS], qv[:15], np.float32(xq), np.float32(yq))
    ids, d = serve_batch(idx, mesh, qv[:16], lo[:16], hi[:16], k=5, beam=16)
    assert ids.shape == (16, 5)

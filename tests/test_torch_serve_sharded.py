"""The port's sharded serving against the JAX package's, on the CPU.

The JAX package serves through ``shard_map`` over several devices, so its
side runs once for the whole module in a fresh interpreter with four host
devices (``torch_serve_ref.py``, about 30 s) and writes one ``.npz``. The
port carries the JAX-built shards across (``sharded_index_from_numpy``) and
serves the same queries on its plain versions in the single-process mesh.

Held, for (containment, 2 shards), (containment, 4) and (overlap, 4):

* ``build_sharded_index`` (the sequential build at 512 and 256 rows a
  shard) gives the reference's arrays, bit for bit but the cached norms
  (each within an f32 ulp: the port sums them in f64 and rounds once), and
  its planners' state;
* ``plan_sharded_batch``: the same plans and brute-path ids;
* ``serve_batch`` with ``plan`` auto and graph and both merges: ids and
  distances equal under the tie rule of ``repro_torch.data.parity``
  (tolerance ``1e-5·max(1, |d|)``), recall@10 equal, sentinel rows empty;
* on the first case: ``fused=False``, ``expand=2``, ``int8_vectors`` (fused
  and unfused), the ``stats`` step's per-query counters (equal as
  integers), ``id_map`` and ``return_partial``;
* ``_canonicalize_local`` on query endpoints that lie on a grid value and
  between two f64 values that round to one f32, against the reference's;
* a two-shard ``ShardedStreamingIndex`` after the same inserts and deletes:
  its host-merge ``search`` and ``serve_streaming_batch`` (and its summed
  counters) against the reference's; ``refresh_shard`` keeps the old dict.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_serve_ref as ref
from repro_torch.core.predicates import get_relation
from repro_torch.data import ground_truth, recall_at_k
from repro_torch.data.parity import mismatches
from repro_torch.data.workloads import QuerySet
from repro_torch.distributed import make_host_mesh
from repro_torch.exec import PlannerConfig
from repro_torch.serve import (
    ShardedStreamingIndex,
    build_sharded_index,
    make_serving_step,
    make_streaming_serving_step,
    plan_sharded_batch,
    serve_batch,
    serve_streaming_batch,
    sharded_index_from_numpy,
)
from repro_torch.serve.distributed import STACK_FIELDS, _canonicalize_local
from repro_torch.stream import CompactionPolicy
from torch_cases import K  # noqa: F401  (pins torch to one thread)

REPO = Path(__file__).resolve().parents[1]
CASES = [f"{rel}/{S}" for rel, S in ref.SHARDED]
CFG = PlannerConfig(**ref.PLANNER)


@pytest.fixture(scope="module")
def want(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, str(REPO / "tests" / "torch_serve_ref.py"), str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def data():
    vecs, s, t = ref.dataset()
    return vecs, s, t


def carried(want, case):
    """The port's ``ShardedIndex`` over the reference's arrays."""
    p = case + "/"
    S = int(case.split("/")[1])
    arrays = {f: want[p + f] for f in STACK_FIELDS}
    arrays.update(relation=case.split("/")[0], n_local=want[p + "n_local"])
    states = [{f: want[p + f"planner{sh}/{f}"] for f in ref.STATE_FIELDS} for sh in range(S)]
    return sharded_index_from_numpy(arrays, states, device="cpu")


@pytest.fixture(scope="module")
def indexes(want):
    return {case: carried(want, case) for case in CASES}


def case_queries(case, data):
    rel = case.split("/")[0]
    vecs, s, t = data
    qv, s_q, t_q = ref.queries(s, t, rel)
    return rel, qv, s_q, t_q


def assert_same(ids_ref, d_ref, ids, d):
    assert ids.shape == ids_ref.shape and d.shape == d_ref.shape
    bad = mismatches(ids_ref, d_ref, ids, d)
    assert not bad, bad[:5]


@pytest.mark.parametrize("case", CASES)
def test_build_sharded_index_equals_the_reference(case, want, data):
    rel, S = case.split("/")[0], int(case.split("/")[1])
    vecs, s, t = data
    idx = build_sharded_index(vecs, s, t, rel, S, M=8, Z=32, device="cpu")
    p = case + "/"
    for f in STACK_FIELDS:
        got, exp = getattr(idx, f), want[p + f]
        assert got.dtype == exp.dtype and got.shape == exp.shape, f
        if f == "norms":
            np.testing.assert_allclose(got, exp, rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(got, exp, err_msg=f)
    assert idx.n_local == int(want[p + "n_local"])
    for sh, est in enumerate(idx.planners):
        for f in ref.STATE_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(est, f)),
                                          want[p + f"planner{sh}/{f}"], err_msg=f)


@pytest.mark.parametrize("case", CASES)
def test_carried_index_plans_like_the_reference(case, want, indexes, data):
    idx = indexes[case]
    rel, qv, s_q, t_q = case_queries(case, data)
    dev = idx.device("cpu")
    for f in STACK_FIELDS:
        exp = want[case + "/" + f]
        exp = exp.view(np.int32) if exp.dtype == np.uint32 else exp
        np.testing.assert_array_equal(dev[f].numpy(), exp, err_msg=f)
    assert idx.device("cpu") is dev                     # memoized
    xq, yq = get_relation(rel).query_map(s_q, t_q)
    plans, bf = plan_sharded_batch(idx, np.float32(xq), np.float32(yq), config=CFG)
    np.testing.assert_array_equal(plans, want[case + "/plans"])
    np.testing.assert_array_equal(bf, want[case + "/bf_ids"])
    assert set(np.unique(plans)) == {0, 1, 2}            # every plan has rows


@pytest.mark.parametrize("merge", ref.MERGES)
@pytest.mark.parametrize("plan", ["auto", "graph"])
@pytest.mark.parametrize("case", CASES)
def test_serve_batch_equals_the_reference(case, plan, merge, want, indexes, data):
    idx = indexes[case]
    rel, qv, s_q, t_q = case_queries(case, data)
    mesh = make_host_mesh(idx.num_shards, device="cpu")
    ids, d = serve_batch(idx, mesh, qv, s_q, t_q, k=ref.K, beam=ref.BEAM, merge=merge,
                         plan=plan, planner_config=CFG)
    p = f"{case}/{plan}/{merge}/"
    assert ids.dtype == want[p + "ids"].dtype
    assert_same(want[p + "ids"], want[p + "d"], ids, d)
    vecs, s, t = data
    nq = ref.NQ
    qs = ground_truth(QuerySet(rel, qv[:nq], s_q[:nq], t_q[:nq], 0.0, np.zeros(nq), ref.K),
                      vecs, s, t)
    assert recall_at_k(ids[:nq], qs) == recall_at_k(want[p + "ids"][:nq], qs)
    assert recall_at_k(ids[:nq], qs) > 0.9
    assert np.all(ids[nq:] == -1) and np.all(np.isinf(d[nq:]))   # sentinel rows


@pytest.mark.parametrize("plan", ["auto", "graph"])
@pytest.mark.parametrize("case", CASES)
def test_both_merges_agree(case, plan, indexes, data):
    idx = indexes[case]
    rel, qv, s_q, t_q = case_queries(case, data)
    mesh = make_host_mesh(idx.num_shards, device="cpu")
    a = serve_batch(idx, mesh, qv, s_q, t_q, k=ref.K, beam=ref.BEAM, merge="all_gather",
                    plan=plan, planner_config=CFG)
    b = serve_batch(idx, mesh, qv, s_q, t_q, k=ref.K, beam=ref.BEAM, merge="tournament",
                    plan=plan, planner_config=CFG)
    assert_same(*a, *b)


def step_args(want, idx, case, data):
    rel, qv, s_q, t_q = case_queries(case, data)
    xq, yq = get_relation(rel).query_map(s_q, t_q)
    dev = idx.device("cpu")
    return rel, [dev[f] for f in STACK_FIELDS] + [qv, np.float32(xq), np.float32(yq)]


@pytest.mark.parametrize("name,kw", [("unfused", dict(fused=False)), ("expand2", dict(expand=2)),
                                     ("stats", dict(stats=True))])
def test_serving_step_variants_equal_the_reference(name, kw, want, indexes, data):
    case = CASES[0]
    idx = indexes[case]
    rel, args = step_args(want, idx, case, data)
    mesh = make_host_mesh(idx.num_shards, device="cpu")
    out = make_serving_step(mesh, rel, k=ref.K, beam=ref.BEAM, **kw)(*args)
    p = f"{case}/{name}/"
    assert_same(want[p + "gids"], want[p + "d"], out[0].numpy(), out[1].numpy())
    if name == "stats":
        assert set(out[2]) == {f[len(p):] for f in want if f.startswith(p)} - {"gids", "d"}
        for f, v in out[2].items():
            np.testing.assert_array_equal(v.numpy(), want[p + f], err_msg=f)
        # summed over shards: each shard's own counters add up to them
        per = [make_serving_step(make_host_mesh(1, device="cpu"), rel, k=ref.K, beam=ref.BEAM,
                                 stats=True)(*[a[sh:sh + 1] for a in args[:9]], *args[9:])[2]
               for sh in range(idx.num_shards)]
        for f, v in out[2].items():
            np.testing.assert_array_equal(v.numpy(), sum(p_[f].numpy() for p_ in per))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_int8_step_equals_the_reference(fused, want, indexes, data):
    case = CASES[0]
    idx = indexes[case]
    rel, args = step_args(want, idx, case, data)
    p = f"{case}/int8/"
    args[0] = torch.from_numpy(want[p + "vq"])
    mesh = make_host_mesh(idx.num_shards, device="cpu")
    out = make_serving_step(mesh, rel, k=ref.K, beam=ref.BEAM, int8_vectors=True,
                            fused=fused)(*args, torch.from_numpy(want[p + "scales"]))
    assert_same(want[p + f"{fused}/gids"], want[p + f"{fused}/d"], out[0].numpy(), out[1].numpy())


def test_id_map_and_partial_results_equal(want, indexes, data):
    case = CASES[0]
    idx = indexes[case]
    rel, qv, s_q, t_q = case_queries(case, data)
    mesh = make_host_mesh(idx.num_shards, device="cpu")
    p = case + "/"
    ids, d = serve_batch(idx, mesh, qv, s_q, t_q, k=ref.K, beam=ref.BEAM, planner_config=CFG,
                         id_map=want[p + "id_map"])
    assert ids.dtype == np.int64
    assert_same(want[p + "mapped/ids"], want[p + "mapped/d"], ids, d)
    pr = serve_batch(idx, mesh, qv, s_q, t_q, k=ref.K, beam=ref.BEAM, planner_config=CFG,
                     missing_shards=[1], return_partial=True)
    assert pr.degraded and pr.missing_shards == list(want[p + "partial/missing"]) == [1]
    assert_same(want[p + "partial/ids"], want[p + "partial/d"], pr.ids, pr.dists)


def test_serving_entry_points_refuse_bad_input(indexes, data):
    idx = indexes[CASES[1]]
    rel, qv, s_q, t_q = case_queries(CASES[1], data)
    mesh = make_host_mesh(idx.num_shards, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        serve_batch(idx, mesh, np.full_like(qv, np.nan), s_q, t_q)
    with pytest.raises(ValueError, match="plan"):
        serve_batch(idx, mesh, qv, s_q, t_q, plan="wide")
    with pytest.raises(ValueError, match="power-of-two"):
        make_serving_step(make_host_mesh(3, device="cpu"), rel, merge="tournament")
    with pytest.raises(ValueError, match="shards"):
        serve_batch(idx, make_host_mesh(2, device="cpu"), qv, s_q, t_q)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_host_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            idx.device()


def test_canonicalize_on_grid_values_and_f32_ties():
    """Query endpoints on a grid value, between two f64 grid values that
    round to one f32, past the last value, and a clamped ``num_y``: the
    port's snap equals the reference's, element by element."""
    import jax.numpy as jnp

    from repro.serve.distributed import _canonicalize_local as jcanon

    base = np.float32(1.0)
    up = np.nextafter(base, np.float32(2))
    ux64 = np.array([0.5, 1.0 + 1e-9, 1.0 + 2e-9, float(up), 3.0])   # two round to 1.0f
    uy64 = np.array([0.25, 1.0, 1.0 + 3e-9, 2.0, 4.0])
    UX = np.full(8, np.inf, np.float32)
    UY = np.full(8, np.inf, np.float32)
    UX[:5], UY[:5] = ux64.astype(np.float32), uy64.astype(np.float32)
    ent = np.array([3, -1, 2, 0, 4, -1, -1, -1], np.int32)
    enty = np.array([1, 0, 0, 5, 2, 2 ** 31 - 1, 2 ** 31 - 1, 2 ** 31 - 1], np.int32)
    xq = np.array([1.0 + 1.5e-9, 1.0, 0.5, 0.1, 3.0, 5.0, float(up), 2.0], np.float64)
    yq = np.array([1.0 + 1e-9, 0.2, 4.0, 9.0, 2.0, 1.0, 1.0 + 2e-9, -1.0], np.float64)
    xq32, yq32 = xq.astype(np.float32), yq.astype(np.float32)
    for num_y in (5, 3):
        want = jcanon(jnp.asarray(UX), jnp.asarray(UY), jnp.int32(num_y), jnp.asarray(ent),
                      jnp.asarray(enty), jnp.asarray(xq32), jnp.asarray(yq32))
        got = _canonicalize_local(*(torch.from_numpy(a) for a in (UX, UY)),
                                  torch.tensor(num_y, dtype=torch.int32),
                                  *(torch.from_numpy(a) for a in (ent, enty, xq32, yq32)))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


@pytest.fixture(scope="module")
def stream_index(want):
    svecs, ss, st, q = ref.stream_ops()
    sidx = ShardedStreamingIndex(ref.D, "containment", 2, device="cpu", **ref.STREAM_KW)
    np.testing.assert_array_equal(sidx.insert_batch(svecs, ss, st), want["stream/ext"])
    deleted = [sidx.delete(e) for e in ref.STREAM_DELETES]
    np.testing.assert_array_equal(deleted, want["stream/deleted"])
    np.testing.assert_array_equal([sh.epoch for sh in sidx.shards], want["stream/epochs"])
    return sidx, q


@pytest.mark.parametrize("plan", ["auto", "graph"])
def test_sharded_streaming_search_equals_the_reference(plan, want, stream_index):
    sidx, q = stream_index
    ids, d = sidx.search(*q, k=ref.K, beam=ref.BEAM, plan=plan)
    assert_same(want[f"stream/search/{plan}/ids"], want[f"stream/search/{plan}/d"], ids, d)
    assert not np.isin(ids, ref.STREAM_DELETES).any()


def test_streaming_serving_step_equals_the_reference(want, stream_index):
    sidx, q = stream_index
    mesh = make_host_mesh(2, device="cpu")
    stacked = sidx.stacked_arrays()
    ids, d = serve_streaming_batch(stacked, mesh, "containment", *q, k=ref.K, beam=ref.BEAM)
    assert_same(want["stream/step/ids"], want["stream/step/d"], ids, d)
    # the stacked step and the host merge agree in the port too
    assert_same(*sidx.search(*q, k=ref.K, beam=ref.BEAM, plan="graph"), ids, d)
    step = make_streaming_serving_step(mesh, k=ref.K, beam=ref.BEAM, stats=True)
    ids2, d2, st = serve_streaming_batch(stacked, mesh, "containment", *q, step=step,
                                         k=ref.K, beam=ref.BEAM)
    np.testing.assert_array_equal(ids2, ids)
    for f, v in st.items():
        np.testing.assert_array_equal(v, want[f"stream/stats/{f}"], err_msg=f)


def test_refresh_shard_is_copy_on_write():
    svecs, ss, st, q = ref.stream_ops()
    sidx = ShardedStreamingIndex(ref.D, "containment", 2, device="cpu", **ref.STREAM_KW)
    for shard in sidx.shards:
        shard.policy = CompactionPolicy(max_delta_fraction=0.1, min_mutations=8)
    sidx.insert_batch(svecs[:200], ss[:200], st[:200])
    old = sidx.stacked_arrays()
    keep = {k: v.copy() for k, v in old.items()}
    sidx.insert_batch(svecs[200:], ss[200:], st[200:])
    for e in range(0, 120, 3):
        sidx.delete(e)
    sh = sidx.maybe_compact_shards()
    assert sh in (0, 1)
    fresh = sidx.refresh_shard(old, sh)
    for k in old:
        np.testing.assert_array_equal(old[k], keep[k], err_msg=k)   # untouched
        assert fresh[k].shape == old[k].shape and fresh[k].dtype == old[k].dtype
    assert not np.array_equal(fresh["live"][sh], old["live"][sh])
    np.testing.assert_array_equal(fresh["live"][1 - sh], old["live"][1 - sh])
    # both shards republished: the current epoch of each, no deleted id
    full = sidx.refresh_shard(fresh, 1 - sh)
    mesh = make_host_mesh(2, device="cpu")
    ids, d = serve_streaming_batch(full, mesh, "containment", *q, k=ref.K, beam=ref.BEAM)
    want = serve_streaming_batch(sidx.stacked_arrays(), mesh, "containment", *q, k=ref.K,
                                 beam=ref.BEAM)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(d, want[1])
    assert not np.isin(ids, list(range(0, 120, 3))).any()

"""The port's serving step in its two executions, for ``test_torch_serve_dist.py``.

    python tests/torch_serve_dist_worker.py WORKDIR WORLD

builds a ``WORLD``-shard index with the port on the CPU (1024 x 16,
containment), serves one batch in the single-process mesh, then spawns
``WORLD`` ranks (``torch.multiprocessing``) joined in a gloo process group
through a file store in ``WORKDIR``; every rank serves the same batch on
its own shard. Writes ``single.npz`` and ``rank{r}.npz`` into ``WORKDIR``
for the test to compare. The tournament's per-shard views of the
single-process step are recorded too: rank r's result is shard r's view.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N, D, NQ, K, BEAM = 1024, 16, 16, 10, 24
PLANNER = dict(brute_max_valid=24, wide_max_fraction=0.3)
STREAM_KW = dict(node_capacity=256, delta_capacity=64, edge_capacity=48, M=8, Z=32)


def inputs(world):
    from repro_torch.data import make_dataset, make_queries_vectors

    vecs, s, t = make_dataset(N, D, seed=0)
    rng = np.random.default_rng(1)
    qv = make_queries_vectors(NQ, D, seed=1)
    lo = rng.uniform(s.min(), s.max(), NQ)
    hi = lo + rng.uniform(0.05, 1.0, NQ) * (t.max() - s.min())
    return vecs, s, t, qv, lo, hi


def run_all(idx, stacked, mesh, qv, lo, hi, out):
    """Every serving call of the comparison on ``mesh``; results into ``out``."""
    from repro_torch.core.predicates import get_relation
    from repro_torch.exec import PlannerConfig
    from repro_torch.serve import (
        make_planned_serving_step,
        make_serving_step,
        make_streaming_serving_step,
        plan_sharded_batch,
        serve_batch,
        serve_streaming_batch,
    )
    from repro_torch.serve.distributed import STACK_FIELDS

    cfg = PlannerConfig(**PLANNER)
    local = list(mesh.local_shards)
    dev = idx.device(mesh.device, local)
    xq, yq = get_relation(idx.relation).query_map(lo, hi)
    xq, yq = np.float32(xq), np.float32(yq)
    args = [dev[f] for f in STACK_FIELDS] + [qv, xq, yq]
    plans, bf = plan_sharded_batch(idx, xq, yq, config=cfg, shards=local)
    for merge in ("all_gather", "tournament"):
        for plan in ("auto", "graph"):
            ids, d = serve_batch(idx, mesh, qv, lo, hi, k=K, beam=BEAM, merge=merge,
                                 plan=plan, planner_config=cfg)
            out[f"serve/{plan}/{merge}/ids"], out[f"serve/{plan}/{merge}/d"] = ids, d
        steps = {
            "graph": make_serving_step(mesh, idx.relation, k=K, beam=BEAM, merge=merge)(*args),
            "planned": make_planned_serving_step(mesh, idx.relation, k=K, beam=BEAM, merge=merge,
                                                 config=cfg)(*args, plans[local], bf[local]),
        }
        for name, res in steps.items():
            out[f"step/{name}/{merge}/gids"] = res[0].numpy()
            out[f"step/{name}/{merge}/d"] = res[1].numpy()
    res = make_serving_step(mesh, idx.relation, k=K, beam=BEAM, stats=True)(*args)
    out["stats/gids"], out["stats/d"] = res[0].numpy(), res[1].numpy()
    for f, v in res[2].items():
        out[f"stats/{f}"] = v.numpy()
    step = make_streaming_serving_step(mesh, k=K, beam=BEAM, stats=True)
    ids, d, st = serve_streaming_batch(stacked, mesh, "containment", qv, lo, hi, step=step,
                                       k=K, beam=BEAM)
    out["stream/ids"], out["stream/d"] = ids, d
    for f, v in st.items():
        out[f"stream/{f}"] = v


def rank_main(rank, workdir, world):
    from repro_torch.distributed import make_process_mesh
    from repro_torch.serve import sharded_index_from_numpy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=world,
                            rank=rank)
    try:
        with np.load(os.path.join(workdir, "index.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        states = [{k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith(f"p{sh}/")}
                  for sh in range(world)]
        stacked = {k[2:]: v for k, v in arrays.items() if k.startswith("s/")}
        idx = sharded_index_from_numpy(arrays, states, device="cpu")
        mesh = make_process_mesh(device="cpu")
        assert mesh.model == world and mesh.local_shards == (rank,)
        vecs, s, t, qv, lo, hi = inputs(world)
        out = {}
        run_all(idx, stacked, mesh, qv, lo, hi, out)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def main(workdir, world):
    import repro_torch.serve.distributed as sd
    from repro_torch.distributed import make_host_mesh
    from repro_torch.exec.estimator import STATE_FIELDS
    from repro_torch.serve import ShardedStreamingIndex, build_sharded_index

    torch.set_num_threads(1)
    vecs, s, t, qv, lo, hi = inputs(world)
    idx = build_sharded_index(vecs, s, t, "containment", world, M=8, Z=32, device="cpu")
    sidx = ShardedStreamingIndex(D, "containment", world, device="cpu", **STREAM_KW)
    sidx.insert_batch(vecs[:90 * world], s[:90 * world], t[:90 * world])
    for e in range(0, 90 * world, 7):
        sidx.delete(e)
    stacked = sidx.stacked_arrays()
    arrays = {f: getattr(idx, f) for f in sd.STACK_FIELDS}
    arrays.update(relation=np.asarray(idx.relation), n_local=np.asarray(idx.n_local))
    for sh, est in enumerate(idx.planners):
        arrays.update({f"p{sh}/{f}": np.asarray(getattr(est, f)) for f in STATE_FIELDS})
    arrays.update({f"s/{k}": v for k, v in stacked.items()})
    np.savez(os.path.join(workdir, "index.npz"), **arrays)

    # the single-process form, recording the tournament's per-shard views:
    # run_all's tournament merges are serve auto, serve graph, then the
    # graph and the planned step
    views, real = [], sd.tournament_views

    def record(v, k):
        views.append(real(v, k))
        return views[-1]

    sd.tournament_views = record
    out = {}
    try:
        run_all(idx, stacked, make_host_mesh(world, device="cpu"), qv, lo, hi, out)
    finally:
        sd.tournament_views = real
    assert len(views) == 4
    for name, v in zip(("graph", "planned"), views[2:]):
        for r, (g, dd) in enumerate(v):
            out[f"view{r}/{name}/gids"], out[f"view{r}/{name}/d"] = g.numpy(), dd.numpy()
    np.savez(os.path.join(workdir, "single.npz"), **out)
    mp.spawn(rank_main, args=(workdir, world), nprocs=world, join=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))

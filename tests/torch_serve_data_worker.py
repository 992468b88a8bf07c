"""The port's serving step over the query axes, for ``test_torch_serve_data.py``.

    python tests/torch_serve_data_worker.py WORKDIR LAYOUT

``LAYOUT`` is ``data2`` (data 2 x model 2) or ``pod2`` (pod 2 x data 1 x
model 2). Builds a 2-shard index with the port on the CPU (the case of
``torch_serve_dist_worker.py``), serves it in the single-process mesh at
data 1 (recording the tournament's per-shard views) and in the layout's
single-process form, then spawns 4 ranks (``torch.multiprocessing``) joined
in a gloo process group through a file store in ``WORKDIR``: rank r holds
shard ``r % 2`` and serves query slice ``r // 2``. Writes ``single.npz``,
``layout.npz`` and ``rank{r}.npz`` into ``WORKDIR``.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_serve_dist_worker as base

SHARDS, WORLD = 2, 4
LAYOUTS = {"data2": dict(data=2, pod=1), "pod2": dict(data=1, pod=2)}


def rank_main(rank, workdir, layout):
    from repro_torch.distributed import make_process_mesh
    from repro_torch.serve import sharded_index_from_numpy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=WORLD,
                            rank=rank)
    try:
        with np.load(os.path.join(workdir, "index.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        states = [{k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith(f"p{sh}/")}
                  for sh in range(SHARDS)]
        stacked = {k[2:]: v for k, v in arrays.items() if k.startswith("s/")}
        idx = sharded_index_from_numpy(arrays, states, device="cpu")
        mesh = make_process_mesh(model=SHARDS, pod=LAYOUTS[layout]["pod"], device="cpu")
        assert (mesh.model, mesh.data, mesh.pod) == (SHARDS, LAYOUTS[layout]["data"],
                                                     LAYOUTS[layout]["pod"])
        assert mesh.local_shards == (rank % SHARDS,) and mesh.local_queries == (rank // SHARDS,)
        vecs, s, t, qv, lo, hi = base.inputs(SHARDS)
        out = {}
        base.run_all(idx, stacked, mesh, qv, lo, hi, out)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def main(workdir, layout):
    import repro_torch.serve.distributed as sd
    from repro_torch.distributed import make_host_mesh
    from repro_torch.exec.estimator import STATE_FIELDS
    from repro_torch.serve import ShardedStreamingIndex, build_sharded_index

    torch.set_num_threads(1)
    vecs, s, t, qv, lo, hi = base.inputs(SHARDS)
    assert qv.shape[0] % WORLD == 0
    idx = build_sharded_index(vecs, s, t, "containment", SHARDS, M=8, Z=32, device="cpu")
    sidx = ShardedStreamingIndex(base.D, "containment", SHARDS, device="cpu", **base.STREAM_KW)
    sidx.insert_batch(vecs[:90 * SHARDS], s[:90 * SHARDS], t[:90 * SHARDS])
    for e in range(0, 90 * SHARDS, 7):
        sidx.delete(e)
    stacked = sidx.stacked_arrays()
    arrays = {f: getattr(idx, f) for f in sd.STACK_FIELDS}
    arrays.update(relation=np.asarray(idx.relation), n_local=np.asarray(idx.n_local))
    for sh, est in enumerate(idx.planners):
        arrays.update({f"p{sh}/{f}": np.asarray(getattr(est, f)) for f in STATE_FIELDS})
    arrays.update({f"s/{k}": v for k, v in stacked.items()})
    np.savez(os.path.join(workdir, "index.npz"), **arrays)

    # data 1, recording the tournament's per-shard views of the graph and
    # the planned step (run_all's third and fourth tournament merges)
    views, real = [], sd.tournament_views

    def record(v, k):
        views.append(real(v, k))
        return views[-1]

    sd.tournament_views = record
    out = {}
    try:
        base.run_all(idx, stacked, make_host_mesh(SHARDS, device="cpu"), qv, lo, hi, out)
    finally:
        sd.tournament_views = real
    assert len(views) == 4
    for name, v in zip(("graph", "planned"), views[2:]):
        for r, (g, dd) in enumerate(v):
            out[f"view{r}/{name}/gids"], out[f"view{r}/{name}/d"] = g.numpy(), dd.numpy()
    np.savez(os.path.join(workdir, "single.npz"), **out)
    out = {}
    base.run_all(idx, stacked, make_host_mesh(SHARDS, device="cpu", **LAYOUTS[layout]),
                 qv, lo, hi, out)
    np.savez(os.path.join(workdir, "layout.npz"), **out)
    mp.spawn(rank_main, args=(workdir, layout), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

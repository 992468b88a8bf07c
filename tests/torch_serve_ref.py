"""The JAX package's sharded serving at the sizes of ``test_torch_serve_sharded.py``.

Run as a script in a fresh interpreter with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs its meshes); writes every array the
tests compare into one ``.npz``:

    python tests/torch_serve_ref.py OUT.npz

The shared case (sizes, queries, planner thresholds, mutations) is defined
here and imported by the tests, so both packages see the same inputs.
Every step runs on the jnp oracles (``use_ref_kernel=True``, the default).
"""
import sys

import numpy as np

N, D, NQ, K, BEAM = 1024, 16, 24, 10, 32
# (relation, shards) of the serve_batch cases; the extra steps run on the first
SHARDED = (("containment", 2), ("containment", 4), ("overlap", 4))
MERGES = ("all_gather", "tournament")
PLANNER = dict(brute_max_valid=32, wide_max_fraction=0.3)
STACK_FIELDS = ("vectors", "nbr", "labels", "norms", "U_X", "U_Y", "num_y",
                "entry_node", "entry_y_rank")
STATE_FIELDS = ("cum", "edges_x", "edges_y", "_ids", "_xr", "_yr", "_off",
                "n", "num_x", "num_y", "buckets")
# the streaming case: two shards, the same inserts and deletes in both packages
STREAM_KW = dict(node_capacity=512, delta_capacity=128, edge_capacity=96, M=8, Z=32)
STREAM_INSERTS, STREAM_DELETES = 330, (4, 11, 50, 51, 200, 257, 300)


def dataset():
    from repro.data import make_dataset

    return make_dataset(N, D, seed=0)


def queries(s, t, rel):
    """NQ queries at three selectivities, then two sentinel rows (s > t)."""
    from repro.data import generate_queries, make_queries_vectors

    qv = make_queries_vectors(NQ, D, seed=1)
    s_q, t_q = np.empty(NQ), np.empty(NQ)
    for j, sel in enumerate((0.02, 0.2, 0.6)):
        idx = np.arange(j, NQ, 3)
        part = generate_queries(qv[idx], s, t, rel, sel, k=K, seed=j)
        s_q[idx], t_q[idx] = part.s_q, part.t_q
    qv = np.concatenate([qv, np.zeros((2, D), np.float32)])
    return qv, np.concatenate([s_q, [0.0, 5.0]]), np.concatenate([t_q, [-1.0, 1.0]])


def quantize(vec):
    """Per-row symmetric int8 of a [S, n, d] stack (the export's rule)."""
    amax = np.maximum(np.max(np.abs(vec), axis=-1), 1e-12)
    scales = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(vec / scales[..., None]), -127, 127).astype(np.int8)
    return q, scales


def id_map(S, n_l):
    """A permuted id map with the last row of each shard a padding row."""
    m = np.random.default_rng(7).permutation(S * n_l).reshape(S, n_l).astype(np.int64)
    m[:, -1] = -1
    return m


def stream_ops():
    from repro.data import make_dataset

    vecs, s, t = make_dataset(STREAM_INSERTS, D, seed=5)
    rng = np.random.default_rng(6)
    qv = rng.standard_normal((16, D)).astype(np.float32)
    lo = rng.uniform(s.min(), s.max(), 16)
    hi = np.minimum(lo + rng.uniform(0.05, 1.0, 16) * (t.max() - s.min()), t.max() + 1.0)
    return vecs, s, t, (qv, lo, hi)


def main(out_path):
    import jax.numpy as jnp

    from repro.core import get_relation
    from repro.exec import PlannerConfig
    from repro.launch.mesh import make_host_mesh
    from repro.serve import (
        ShardedStreamingIndex,
        build_sharded_index,
        make_serving_step,
        make_streaming_serving_step,
        plan_sharded_batch,
        serve_batch,
        serve_streaming_batch,
    )

    cfg = PlannerConfig(**PLANNER)
    vecs, s, t = dataset()
    out = {}
    for ci, (rel, S) in enumerate(SHARDED):
        p = f"{rel}/{S}/"
        idx = build_sharded_index(vecs, s, t, rel, S, M=8, Z=32)
        mesh = make_host_mesh(model_parallel=S)
        for f in STACK_FIELDS:
            out[p + f] = np.asarray(getattr(idx, f))
        out[p + "n_local"] = np.asarray(idx.n_local)
        for sh, est in enumerate(idx.planners):
            for f in STATE_FIELDS:
                out[p + f"planner{sh}/{f}"] = np.asarray(getattr(est, f))
        qv, s_q, t_q = queries(s, t, rel)
        xq, yq = get_relation(rel).query_map(s_q, t_q)
        xq, yq = np.asarray(xq, np.float32), np.asarray(yq, np.float32)
        plans, bf = plan_sharded_batch(idx, xq, yq, config=cfg)
        out[p + "plans"], out[p + "bf_ids"] = plans, bf
        for plan in ("auto", "graph"):
            for merge in MERGES:
                ids, d = serve_batch(idx, mesh, qv, s_q, t_q, k=K, beam=BEAM, merge=merge,
                                     plan=plan, planner_config=cfg)
                out[p + f"{plan}/{merge}/ids"], out[p + f"{plan}/{merge}/d"] = ids, d
        if ci:
            continue
        dev = idx.device()
        args = [dev[f] for f in STACK_FIELDS] + [jnp.asarray(qv), jnp.asarray(xq), jnp.asarray(yq)]
        for name, kw in (("unfused", dict(fused=False)), ("stats", dict(stats=True)),
                         ("expand2", dict(expand=2))):
            res = make_serving_step(mesh, rel, k=K, beam=BEAM, **kw)(*args)
            out[p + f"{name}/gids"], out[p + f"{name}/d"] = np.asarray(res[0]), np.asarray(res[1])
            if name == "stats":
                for f, v in res[2].items():
                    out[p + f"stats/{f}"] = np.asarray(v)
        vq, sc = quantize(np.asarray(idx.vectors))
        out[p + "int8/vq"], out[p + "int8/scales"] = vq, sc
        for fused in (True, False):
            a8 = list(args)
            a8[0] = jnp.asarray(vq)
            res = make_serving_step(mesh, rel, k=K, beam=BEAM, int8_vectors=True,
                                    fused=fused)(*a8, jnp.asarray(sc))
            out[p + f"int8/{fused}/gids"], out[p + f"int8/{fused}/d"] = (
                np.asarray(res[0]), np.asarray(res[1]))
        im = id_map(S, idx.n_local)
        out[p + "id_map"] = im
        ids, d = serve_batch(idx, mesh, qv, s_q, t_q, k=K, beam=BEAM, planner_config=cfg,
                             id_map=im)
        out[p + "mapped/ids"], out[p + "mapped/d"] = ids, d
        pr = serve_batch(idx, mesh, qv, s_q, t_q, k=K, beam=BEAM, planner_config=cfg,
                         missing_shards=[1], return_partial=True)
        out[p + "partial/ids"], out[p + "partial/d"] = pr.ids, pr.dists
        out[p + "partial/missing"] = np.asarray(pr.missing_shards)

    # streaming: the same mutations, then the host merge and the mesh step
    svecs, ss, st, (sq, slo, shi) = stream_ops()
    sidx = ShardedStreamingIndex(D, "containment", 2, **STREAM_KW)
    out["stream/ext"] = sidx.insert_batch(svecs, ss, st)
    out["stream/deleted"] = np.asarray([sidx.delete(e) for e in STREAM_DELETES])
    out["stream/epochs"] = np.asarray([sh.epoch for sh in sidx.shards])
    mesh = make_host_mesh(model_parallel=2)
    for plan in ("auto", "graph"):
        ids, d = sidx.search(sq, slo, shi, k=K, beam=BEAM, plan=plan)
        out[f"stream/search/{plan}/ids"], out[f"stream/search/{plan}/d"] = ids, d
    stacked = sidx.stacked_arrays()
    ids, d = serve_streaming_batch(stacked, mesh, "containment", sq, slo, shi, k=K, beam=BEAM)
    out["stream/step/ids"], out["stream/step/d"] = ids, d
    step = make_streaming_serving_step(mesh, k=K, beam=BEAM, stats=True)
    ids, d, stats = serve_streaming_batch(stacked, mesh, "containment", sq, slo, shi,
                                          step=step, k=K, beam=BEAM)
    for f, v in stats.items():
        out[f"stream/stats/{f}"] = v
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])

"""Serving launcher: build a sharded UDG and serve batched interval-predicate
queries through ``serve_batch`` (the JAX package's ``launch/serve.py``).

The mesh comes from ``launch.mesh.make_host_mesh``: ``--shards`` database
shards on the ``model`` axis and ``--data`` query slices, each batch split
over them (``--batch`` must be a multiple of ``--data``).

Example (the card; ``--device cpu`` runs the plain PyTorch versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --n 4096 --dim 32 \
    --shards 4 --data 2 --relation overlap --selectivity 0.05 --queries 64
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np

from repro_torch.configs.udg_serve import CONFIG
from repro_torch.data import (
    generate_queries,
    ground_truth,
    make_dataset,
    make_queries_vectors,
    recall_at_k,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import RequestBatcher, build_sharded_index, serve_batch


def serve_requests(
    idx,
    mesh,
    batcher: RequestBatcher,
    n_requests: int,
    *,
    k: int = 10,
    beam: int = 64,
    merge: str = "all_gather",
    plan: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, List[float]]:
    """Drain ``batcher`` through ``serve_batch`` one batch at a time.

    Returns ``(ids [n_requests, k] int64, dists [n_requests, k] f32)``
    indexed by request id (-1 / +inf for requests never answered), and the
    wall seconds of each batch (``serve_batch`` returns host arrays, so
    each time includes the device work)."""
    all_ids = np.full((n_requests, k), -1, dtype=np.int64)
    all_d = np.full((n_requests, k), np.inf, dtype=np.float32)
    seconds = []
    while (b := batcher.next_batch()) is not None:
        q, s_q, t_q, rids, n_real = b
        t0 = time.perf_counter()
        ids, dists = serve_batch(
            idx, mesh, q, s_q, t_q, k=k, beam=beam, merge=merge, plan=plan,
        )
        seconds.append(time.perf_counter() - t0)
        for row, rid in enumerate(rids[:n_real]):
            all_ids[rid] = ids[row]
            all_d[rid] = dists[row]
    return all_ids, all_d, seconds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--data", type=int, default=1,
                    help="query slices of each batch (the mesh's data axis)")
    ap.add_argument("--relation", default="containment")
    ap.add_argument("--selectivity", type=float, default=0.05)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--beam", type=int, default=64)
    ap.add_argument("--merge", default=CONFIG.merge,
                    choices=["all_gather", "tournament"])
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--Z", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    args = ap.parse_args(argv)

    mesh = make_host_mesh(model_parallel=args.shards, data=args.data, device=args.device)
    print(f"building sharded UDG: n={args.n} shards={args.shards} data={args.data} "
          f"device={mesh.device} ...")
    vecs, s, t = make_dataset(args.n, args.dim, seed=args.seed)
    t0 = time.perf_counter()
    idx = build_sharded_index(
        vecs, s, t, args.relation, args.shards, M=args.M, Z=args.Z,
        device=mesh.device,
    )
    print(f"  built in {time.perf_counter()-t0:.1f}s")

    qv = make_queries_vectors(args.queries, args.dim, seed=args.seed + 1)
    qs = generate_queries(qv, s, t, args.relation, args.selectivity, k=args.k,
                          seed=args.seed + 2)
    qs = ground_truth(qs, vecs, s, t)

    batcher = RequestBatcher(args.batch, args.dim)
    for i in range(args.queries):
        batcher.submit(qv[i], qs.s_q[i], qs.t_q[i])

    t0 = time.perf_counter()
    all_ids, _, _ = serve_requests(
        idx, mesh, batcher, args.queries, k=args.k, beam=args.beam,
        merge=args.merge,
    )
    dt = time.perf_counter() - t0
    print(f"served {args.queries} queries in {dt:.2f}s "
          f"({args.queries/dt:.0f} qps incl. host loop)")
    print(f"recall@{args.k}: {recall_at_k(all_ids, qs):.4f}")


if __name__ == "__main__":
    main()

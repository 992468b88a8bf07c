"""Faults planted underneath the timed path, each of which ``correct`` has
to catch.

Each fault takes a ``pytest.MonkeyPatch`` (its ``setattr``) and patches the
program where the fault would be: a whole run through ``run.run_cell`` or
``calibrate.py --faults`` then drives the broken path and is judged as any
run is. The tests plant them on the CPU (``tests/test_udgb_run.py``);
``calibrate.py`` reads them on the card at a cell's own size. Nothing here
runs in a benchmark run.
"""
from __future__ import annotations


def unchanged_state(mp) -> None:
    """Every search returns its state unchanged: the loop runs no step."""
    from repro_torch.exec import executor

    core = executor.search_core
    mp.setattr(executor, "search_core", lambda *a, **kw: core(*a, **{**kw, "max_iters": 0}))


def half_batch(mp) -> None:
    """Half of each batch is left out: its rows come back empty. Planted
    where each path looks the executor's core up: the executor's module
    and the sharded serving step's, which imported it by name."""
    from repro_torch.exec import executor
    from repro_torch.serve import distributed

    inner = executor.planned_exec_core

    def half(table, nbr, labels, q, *rest, **kw):
        ids, d = inner(table, nbr, labels, q, *rest, **kw)
        B = q.shape[0]
        ids[B // 2:], d[B // 2:] = -1, float("inf")
        return ids, d

    mp.setattr(executor, "planned_exec_core", half)
    mp.setattr(distributed, "planned_exec_core", half)


def altered_answer(mp) -> None:
    """An answer altered where it is produced: the merge's best id moved by
    one row."""
    import torch
    from repro_torch.kernels import ops

    merge = ops.beam_merge

    def altered(*args, **kw):
        out = merge(*args, **kw)
        ids = out[0]
        ids[:, 0] = torch.where(ids[:, 0] >= 0, (ids[:, 0] + 1) % kw["n"], ids[:, 0])
        return out

    mp.setattr(ops, "beam_merge", altered)


def one_block(mp) -> None:
    """The search loop stops after its first block of iterations."""
    from repro_torch.exec import executor
    from repro_torch.search.batched import LOOP_BLOCK

    core = executor.search_core
    mp.setattr(executor, "search_core",
               lambda *a, **kw: core(*a, **{**kw, "max_iters": min(kw["max_iters"], LOOP_BLOCK)}))


def graph_only(mp) -> None:
    """The planner's routing is skipped: every row takes the plain graph
    search, whatever its selectivity (both entry points: the executor's and
    the sharded ``serve_batch``)."""
    from repro_torch.exec import executor
    from repro_torch.serve import distributed

    for mod, name in ((executor, "execute_batch"), (distributed, "serve_batch")):
        inner = getattr(mod, name)
        mp.setattr(mod, name, lambda *a, inner=inner, **kw: inner(*a, **{**kw, "plan": "graph"}))


def half_candidates(mp) -> None:
    """The merge (B2) sees only the first half of each row's candidates and
    keeps their order."""
    from repro_torch.kernels import ops

    merge = ops.beam_merge

    def dropped(beam_d, beam_ids, beam_exp, cand_d, cand_ids, **kw):
        cand_d = cand_d.clone()
        cand_d[:, cand_d.shape[1] // 2:] = float("inf")
        return merge(beam_d, beam_ids, beam_exp, cand_d, cand_ids, **kw)

    mp.setattr(ops, "beam_merge", dropped)


def shard_dropped(mp) -> None:
    """One shard's partial top-k comes back empty before the cross-shard
    merge: the last shard, on the rank that holds it (every shard is local
    to the one process of a host mesh)."""
    import torch
    from repro_torch.serve import distributed

    inner = distributed._merge_across_shards

    def dropped(mesh, views, **kw):
        last = mesh.model - 1
        views = [(torch.full_like(g, -1), torch.full_like(d, float("inf"))) if sh == last else (g, d)
                 for sh, (g, d) in zip(mesh.local_shards, views)]
        return inner(mesh, views, **kw)

    mp.setattr(distributed, "_merge_across_shards", dropped)


def exchange_skipped(mp) -> None:
    """The exchange between cards is left out: each process merges only the
    shards it holds, and answers from those."""
    from repro_torch.serve import distributed

    mp.setattr(distributed, "_merge_across_shards",
               lambda mesh, views, *, k, merge: distributed._merge_topk(views, k))


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_answer, one_block,
                                   graph_only, half_candidates, shard_dropped, exchange_skipped)}

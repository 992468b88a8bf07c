"""Sharded UDG serving over a ``ShardMesh`` (the JAX package's
``serve/distributed.py``, whose ``shard_map`` steps run here as one torch
function per shard).

Layout (classic shard-per-device vector search):
  * the database is partitioned into ``num_shards`` blocks along the
    ``model`` axis; each shard builds its OWN UDG over its block (top-k over
    a union is the merge of per-shard top-k, so per-shard indexes are exact
    w.r.t. the union);
  * shard-local arrays (graph, canonical grids, entry tables) are stacked on
    a leading shard dim; the query batch is split over the query axes
    ``("pod", "data")`` into ``pod * data`` equal slices, pod major (the
    reference's ``P(("pod", "data"))``), and every shard sees each slice;
  * canonicalization (Lemma 1) runs per shard on shard-local f32 U_X/U_Y;
  * per-shard top-k results are merged across shards: ``all_gather``
    (concatenate in shard order, one stable sort on distance) or a
    log2(shards)-round ``tournament`` in which shard i merges
    ``[own, partner i ^ step]`` (k entries move per round).

A step built by ``make_serving_step`` / ``make_planned_serving_step`` /
``make_streaming_serving_step`` runs in either execution of its mesh
(``repro_torch.distributed.mesh``):

  * single process: the arrays carry every shard on the leading axis; the
    query slices run in turn, each searching the shards in shard order on
    the mesh's device and merging there, and their answers are
    concatenated in slice order; the result is shard 0's view of the merge
    (the reference treats the merged output as replicated, and reads it
    from the first shard);
  * process group: the arrays carry this rank's shard alone and the rank
    searches its own query slice; the merge is ``dist.all_gather``, or
    ``isend``/``irecv`` with partner ``rank ^ step`` for the tournament,
    and the counters' sum ``dist.all_reduce``, all over the rank's model
    subgroup; the merged slices are then gathered over its query subgroup.
    Each rank returns its own view of the whole batch, bit-equal to the
    single-process step's view of that shard (same shards, same
    concatenation order, same stable sort).

A batch the query axes do not divide raises ``ValueError`` (the reference's
``shard_map`` refuses it too); nothing is padded. A query's answer does not
depend on the other queries of its slice: the planner plans each row alone,
and an iteration after a row has finished is a no-op for it. One
batch-level quantity does depend on a slice's composition: the search
loop's iteration count (``LOOP_STATS``), which runs until the slice's
slowest row stops; the ids, distances and per-query counters are the same.

Sort keys are ``d + 0.0`` (-0.0 ties +0.0) and every sort is stable, as
``lax.sort(num_keys=1)`` is. Nothing is compiled per shape, so the steps
are plain closures, not a cache of compiled programs. On the card the
per-shard searches launch the kernels through ``ops`` (B1, B2; B3 on
BRUTE_VALID rows and the delta tier; B4 on ``fused=False``); on CPU tensors
their plain versions run.

``segments_to_sharded_index`` stacks a segmented index
(``repro_torch.scale``) into this layout, one segment a shard, and primes
its device bundle from the segment stack already on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.build import build_udg
from repro_torch.core.entry import EntryTable
from repro_torch.core.predicates import get_relation
from repro_torch.device import resolve_device
from repro_torch.exec import (
    PlannerConfig,
    QueryPlan,
    SelectivityEstimator,
    default_planner_config,
    effective_norms,
    export_planned_graph,
    plan_queries,
    planned_exec_core,
)
from repro_torch.kernels.ref import warp_dot
from repro_torch.obs.stats import PER_QUERY_FIELDS as _PER_QUERY_STAT_FIELDS
from repro_torch.obs.stats import per_query_dict
from repro_torch.search.batched import search_core
from repro_torch.search.device_graph import unpack_labels_device
from repro_torch.serve.admission import validate_query

INF = float("inf")
# the stacked database arrays a serving step takes, in its argument order
STACK_FIELDS = ("vectors", "nbr", "labels", "norms", "U_X", "U_Y", "num_y",
                "entry_node", "entry_y_rank")
STREAM_FIELDS = ("vectors", "nbr", "labels", "norms", "live", "ext", "dvec",
                 "dlab", "dids", "dext", "U_X", "U_Y", "num_y", "entry_node",
                 "entry_y_rank")
MERGES = ("all_gather", "tournament")


def _oracle_labels(lab, fused: bool):
    """The fused paths dispatch on the label layout; the unfused parity
    baseline needs int32 rectangles, so a packed stack is unpacked on its
    device."""
    if not fused and lab.shape[-1] == 2:
        return unpack_labels_device(lab)
    return lab


def _put(a: np.ndarray, dev: torch.device, shards=None) -> torch.Tensor:
    """Host array ``a`` (leading shard axis) as a tensor on ``dev``,
    restricted to ``shards``; uint32 words travel as int32 bit patterns."""
    a = np.asarray(a)
    if shards is not None:
        a = a[list(shards)]
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _query(a, dev: torch.device, dtype=np.float32) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard UDG arrays stacked on a leading shard dimension (host
    numpy; ``device()`` stages them)."""

    vectors: np.ndarray       # [shards, n_l, d] f32
    nbr: np.ndarray           # [shards, n_l, E] int32
    labels: np.ndarray        # [shards, n_l, E, 2] uint32 bit-packed rank
                              # rectangles (the default; [.., E, 4] int32
                              # only when some shard's grid overflowed the
                              # 16-bit rank budget)
    norms: np.ndarray         # [shards, n_l] f32 cached ‖v‖² per node
    U_X: np.ndarray           # [shards, ux_max] f32, +inf padded
    U_Y: np.ndarray           # [shards, uy_max] f32, +inf padded (keeps the
                              # row sorted, so searchsorted is exact)
    num_y: np.ndarray         # [shards] int32 actual |U_Y| per shard
    entry_node: np.ndarray    # [shards, ux_max] int32
    entry_y_rank: np.ndarray  # [shards, ux_max] int32
    relation: str
    n_local: int
    # per-shard repro_torch.exec.SelectivityEstimator (host planning state)
    planners: list | None = None
    _cache: dict | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_shards(self) -> int:
        return int(self.vectors.shape[0])

    def device(self, device=None, shards: Sequence[int] | None = None) -> dict:
        """Memoized tensors of the stacked arrays (``STACK_FIELDS``) on
        ``device`` (``None`` = the card), restricted to ``shards`` (``None``
        = all, in shard order): staged once per index and mesh, not once
        per ``serve_batch`` call."""
        dev = resolve_device(device)
        sel = None if shards is None else tuple(int(s) for s in shards)
        if sel == tuple(range(self.num_shards)):
            sel = None
        cache = self._cache if self._cache is not None else {}
        key = ("device", str(dev), sel)
        out = cache.get(key)
        if out is None:
            out = cache[key] = {
                name: _put(getattr(self, name), dev, sel) for name in STACK_FIELDS
            }
            self._cache = cache
        return out

    def invalidate_device(self) -> None:
        self._cache = None


def _padE(a, e, fill):
    out = np.full(a.shape[:1] + (e,) + a.shape[2:], fill, dtype=a.dtype)
    out[:, : a.shape[1]] = a
    return out


def build_sharded_index(
    vectors: np.ndarray,
    s: np.ndarray,
    t: np.ndarray,
    relation: str,
    num_shards: int,
    *,
    M: int = 16,
    Z: int = 128,
    K_p: int = 8,
    build_kwargs: dict | None = None,
    device=None,
) -> ShardedIndex:
    """Partition the database round-robin and build one UDG per shard.

    ``build_kwargs`` forwards extra ``build_udg`` options — pass
    ``UdgServeConfig.build_kwargs(pad_nodes=...)`` to select the wave
    constructor with shard-capacity padding. The wave constructor's
    searches run on ``device`` (``None`` = the card); the shards' exports
    stay on the host until ``ShardedIndex.device()`` stages them.
    """
    n = vectors.shape[0]
    assert n % num_shards == 0, (n, num_shards)
    n_l = n // num_shards
    parts = [np.arange(sh, n, num_shards) for sh in range(num_shards)]
    kw = dict(device=device)
    kw.update(build_kwargs or {})
    dgs = []
    for ids in parts:
        g, _ = build_udg(vectors[ids], s[ids], t[ids], relation, M=M, Z=Z,
                         K_p=K_p, **kw)
        dgs.append(export_planned_graph(g, EntryTable(g), device="cpu"))
    planners = [dg.planner for dg in dgs]
    E = max(dg.max_degree for dg in dgs)
    ux = max(dg.U_X.shape[0] for dg in dgs)
    uy = max(dg.U_Y.shape[0] for dg in dgs)

    vec = np.stack([dg.vectors for dg in dgs])
    nbr = np.stack([_padE(dg.nbr, E, -1) for dg in dgs])
    # every shard packs under the same 16-bit rank budget (shard grids are
    # <= n_l values); one overflowing shard demotes the whole stack to the
    # int32 layout so the serving step sees a single label shape
    if all(dg.plabels is not None for dg in dgs):
        lab = np.stack([_padE(dg.plabels, E, 0) for dg in dgs])
    else:
        lab = np.stack([_padE(dg.labels_i32(), E, 0) for dg in dgs])
    nrm = np.stack([dg.norms for dg in dgs])
    UX = np.full((num_shards, ux), np.inf, np.float32)
    UY = np.full((num_shards, uy), np.inf, np.float32)
    ent = np.full((num_shards, ux), -1, np.int32)
    enty = np.full((num_shards, ux), np.iinfo(np.int32).max, np.int32)
    num_y = np.zeros(num_shards, np.int32)
    for i, dg in enumerate(dgs):
        kx = dg.U_X.shape[0]
        UX[i, :kx] = dg.U_X.astype(np.float32)
        UY[i, : dg.U_Y.shape[0]] = dg.U_Y.astype(np.float32)
        num_y[i] = dg.U_Y.shape[0]
        ent[i, :kx] = dg.entry_node
        enty[i, :kx] = dg.entry_y_rank
    return ShardedIndex(
        vectors=vec, nbr=nbr, labels=lab, norms=nrm, U_X=UX, U_Y=UY,
        num_y=num_y, entry_node=ent, entry_y_rank=enty, relation=relation,
        n_local=n_l, planners=planners,
    )


def segments_to_sharded_index(segidx) -> tuple:
    """Stack a ``repro_torch.scale.SegmentedIndex`` into the sharded serving
    layout, one segment a shard. Returns ``(sharded, id_map)``.

    The segments share one ``node_capacity``/``edge_capacity``/label layout
    (the segmented build's uniform export), so the stack needs no re-padding
    beyond the canonical grids. Two differences from
    ``build_sharded_index``'s round-robin partition:

    * membership is dominance-driven, so the serving step's synthetic ids
      (``shard · n_l + local``) are not object ids: ``id_map [S, n_l]``
      int64 (-1 on padding rows) and ``remap_shard_ids`` recover them;
    * int8-resident segments stack their *f32* rows (``ShardedIndex``
      carries no scales), with norms recomputed from those rows. The port
      sums them in the scorers' f64 lane order (``ref.warp_dot``), as its
      export does, where the reference takes an f32 einsum.

    Quarantined segments serve as provably empty shards: no entry points,
    an n = 0 estimator (every count bound is 0) and a -1 ``id_map`` row.
    The device bundle is primed from the index's segment stack
    (``_prime_device_from_stack``), on the index's device."""
    dgs = [seg.dg for seg in segidx.segments]
    S = len(dgs)
    n_l = int(segidx.node_capacity)
    E = max(dg.max_degree for dg in dgs)
    ux = max(dg.U_X.shape[0] for dg in dgs)
    uy = max(dg.U_Y.shape[0] for dg in dgs)
    vec = np.stack([np.asarray(dg.vectors, np.float32) for dg in dgs])
    nbr = np.stack([_padE(dg.nbr, E, -1) for dg in dgs])
    if all(dg.plabels is not None for dg in dgs):
        lab = np.stack([_padE(dg.plabels, E, 0) for dg in dgs])
    else:
        lab = np.stack([_padE(dg.labels_i32(), E, 0) for dg in dgs])
    rows = torch.from_numpy(vec)
    nrm = warp_dot(rows, rows).numpy()
    UX = np.full((S, ux), np.inf, np.float32)
    UY = np.full((S, uy), np.inf, np.float32)
    ent = np.full((S, ux), -1, np.int32)
    enty = np.full((S, ux), np.iinfo(np.int32).max, np.int32)
    num_y = np.zeros(S, np.int32)
    id_map = np.full((S, n_l), -1, np.int64)
    for i, dg in enumerate(dgs):
        kx = dg.U_X.shape[0]
        UX[i, :kx] = dg.U_X.astype(np.float32)
        UY[i, : dg.U_Y.shape[0]] = dg.U_Y.astype(np.float32)
        num_y[i] = dg.U_Y.shape[0]
        ent[i, :kx] = dg.entry_node
        enty[i, :kx] = dg.entry_y_rank
        ids = segidx.segments[i].ids
        id_map[i, : ids.shape[0]] = ids
    planners = [dg.planner for dg in dgs]
    for si in sorted(segidx.quarantined):
        ent[si, :] = -1
        enty[si, :] = np.iinfo(np.int32).max
        id_map[si, :] = -1
        p = planners[si]
        if p is not None:
            planners[si] = SelectivityEstimator(
                np.empty(0, np.int64), np.empty(0, np.int64),
                p.num_x, p.num_y, buckets=p.buckets)
    sharded = ShardedIndex(
        vectors=vec, nbr=nbr, labels=lab, norms=nrm, U_X=UX, U_Y=UY,
        num_y=num_y, entry_node=ent, entry_y_rank=enty,
        relation=segidx.relation.name, n_local=n_l, planners=planners,
    )
    _prime_device_from_stack(sharded, segidx, E=E, lab_shape=lab.shape)
    return sharded, id_map


def _prime_device_from_stack(sharded: ShardedIndex, segidx, *, E, lab_shape) -> None:
    """Put the sharded device bundle in ``sharded``'s cache, under the key
    ``ShardedIndex.device(segidx.device)`` reads, with the adjacency and the
    label table (the two largest components) DERIVED on the device from the
    segment stack's flat tensors (the adjacency un-offset per shard) instead
    of staged again from the host. Vectors and norms are staged from the
    host stack: the sharded form is f32 rows and their norms, which an int8
    stack does not carry. Skipped when the stack's layout differs from the
    stacked host arrays (never for a uniform segmented export)."""
    stack = segidx.device_stack()
    S, ncap = stack.num_segments, stack.node_capacity
    if stack.edge_capacity != E or S != sharded.num_shards or ncap != sharded.n_local:
        return
    flat_lab = stack.flat("labels")
    if flat_lab.shape[-1] != lab_shape[-1]:
        return
    dev = stack.device
    base = (torch.arange(S, dtype=torch.int32, device=dev) * ncap)[:, None, None]
    nbr = stack.flat("nbr").reshape(S, ncap, E)
    bundle = {
        "nbr": torch.where(nbr >= 0, nbr - base, -1).to(torch.int32),
        "labels": flat_lab.reshape(lab_shape),
    }
    for name in STACK_FIELDS:
        if name not in bundle:
            bundle[name] = _put(getattr(sharded, name), dev)
    sharded._cache = {("device", str(dev), None): {f: bundle[f] for f in STACK_FIELDS}}


def sharded_index_from_numpy(arrays: dict, planner_states=None, *, device=None) -> ShardedIndex:
    """A ``ShardedIndex`` over another build's arrays, taken unchanged (the
    ``ShardedIndex`` fields, e.g. the JAX package's), with each shard's
    planner rebuilt by ``SelectivityEstimator.from_state`` from
    ``planner_states[i]`` (``estimator.STATE_FIELDS``; ``None``: no
    planners). The stack is staged on ``device`` (``None`` = the card)."""
    fields = {f: np.array(arrays[f]) for f in STACK_FIELDS}
    if fields["labels"].shape[-1] == 2:
        fields["labels"] = fields["labels"].view(np.uint32)
    planners = None
    if planner_states is not None:
        planners = [SelectivityEstimator.from_state(st) for st in planner_states]
    idx = ShardedIndex(relation=str(arrays["relation"]), n_local=int(arrays["n_local"]),
                       planners=planners, **fields)
    idx.device(device)
    return idx


def remap_shard_ids(id_map: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """Translate serving-step synthetic ids (``shard · n_l + local``) back
    to true object ids via an ``id_map [S, n_l]`` (-1 on padding rows);
    -1 passes through."""
    S, n_l = id_map.shape
    g = np.asarray(gids, dtype=np.int64)
    safe = np.clip(g, 0, S * n_l - 1)
    out = id_map.reshape(-1)[safe]
    return np.where(g >= 0, out, np.int64(-1))


def _canonicalize_local(UX, UY, num_y, ent, enty, xq, yq):
    """Lemma 1 snap onto shard-local canonical grids, on their device.

    Both grids are f32, padded with trailing +inf, which keeps each row
    sorted so ``searchsorted`` is exact (the queries are f32 too), and
    guarantees ``c <= num_y - 1`` for finite queries (the clamp is a
    belt-and-braces no-op)."""
    a = torch.searchsorted(UX, xq, side="left").to(torch.int32)
    c = (torch.searchsorted(UY, yq, side="right") - 1).to(torch.int32)
    num_x = UX.shape[0]
    c = torch.minimum(c, num_y - 1)
    invalid = (a >= num_x) | (c < 0)
    a_cl = a.clamp(0, num_x - 1)
    ep = ent[a_cl.long()]
    ep = torch.where(invalid | (ep < 0) | (enty[a_cl.long()] > c), -1, ep)
    return torch.stack([a_cl, c.clamp(min=0)], dim=1), ep


def plan_sharded_batch(
    idx: ShardedIndex,
    xq: np.ndarray,
    yq: np.ndarray,
    *,
    config: PlannerConfig,
    shards: Sequence[int] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side per-shard planning for one query batch.

    Mirrors ``_canonicalize_local`` (f32 grids, +inf padding) so the rank
    states the planner counts with are exactly the states the device search
    will run with, then consults each shard's rank-space histogram.
    Returns (plans [S, B] int32, bf_ids [S, B, V] int32 — *shard-local*
    brute-path valid ids, -1 padded). ``shards`` plans only those (a
    process-group rank plans its own); the others keep GRAPH and no ids.
    """
    if idx.planners is None:
        raise ValueError("ShardedIndex has no planner state (planners=None)")
    S = idx.num_shards
    xq = np.asarray(xq, np.float32)
    yq = np.asarray(yq, np.float32)
    B = xq.shape[0]
    plans = np.full((S, B), int(QueryPlan.GRAPH), dtype=np.int32)
    bf_ids = np.full((S, B, config.brute_max_valid), -1, dtype=np.int32)
    for sh in (range(S) if shards is None else shards):
        est = idx.planners[sh]
        a = np.searchsorted(idx.U_X[sh], xq, side="left")
        c = np.searchsorted(idx.U_Y[sh], yq, side="right") - 1
        c = np.minimum(c, int(idx.num_y[sh]) - 1)
        invalid = (a >= est.num_x) | (c < 0)
        states = np.stack(
            [np.clip(a, 0, est.num_x - 1), np.maximum(c, 0)], axis=1
        ).astype(np.int32)
        pb = plan_queries(est, states, invalid, config=config)
        plans[sh] = pb.plans
        bf_ids[sh] = pb.bf_ids
    return plans, bf_ids


# --- the cross-shard merge -----------------------------------------------------


def _merge_topk(views, k: int):
    """Stable top-k of the ``(ids [B, *], d [B, *])`` in ``views``,
    concatenated in order, by distance alone (earlier views first on
    ties): the ``all_gather`` merge over every shard in shard order, and
    one tournament round over ``[own, partner]``."""
    cat_i = torch.cat([v[0] for v in views], dim=1)
    cat_d = torch.cat([v[1] for v in views], dim=1)
    order = torch.sort(cat_d + 0.0, dim=1, stable=True).indices[:, :k]
    return torch.gather(cat_i, 1, order), torch.gather(cat_d, 1, order)


def tournament_views(views, k: int) -> list:
    """Every shard's view after the log2(S)-round tournament: in round
    ``step`` shard i merges ``[own, partner i ^ step]``. ``views`` are the
    shards' ``(gids, d)`` in shard order; S must be a power of two."""
    S = len(views)
    step = 1
    while step < S:
        views = [_merge_topk((views[i], views[i ^ step]), k) for i in range(S)]
        step *= 2
    return views


def _check_merge(merge: str, num_shards: int) -> None:
    if merge not in MERGES:
        raise ValueError(f"merge={merge!r} not in {MERGES}")
    if merge == "tournament" and num_shards & (num_shards - 1):
        raise ValueError(f"the tournament needs a power-of-two shard count, got {num_shards}")


def _merge_across_shards(mesh, views, *, k: int, merge: str):
    """Cross-shard top-k merge of the local shards' ``(gids, d)``."""
    if mesh.group is None:
        if merge == "tournament":
            return tournament_views(views, k)[0]
        return _merge_topk(views, k)
    (gids, d), = views
    g, r, S = mesh.group, mesh.rank, mesh.model
    if merge == "tournament":
        step = 1
        while step < S:
            peer = dist.get_global_rank(g, r ^ step)
            o_i, o_d = torch.empty_like(gids), torch.empty_like(d)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, gids, peer, g), dist.P2POp(dist.isend, d, peer, g),
                dist.P2POp(dist.irecv, o_i, peer, g), dist.P2POp(dist.irecv, o_d, peer, g),
            ])
            for req in reqs:
                req.wait()
            gids, d = _merge_topk(((gids, d), (o_i, o_d)), k)
            step *= 2
        return gids, d
    all_i = [torch.empty_like(gids) for _ in range(S)]
    all_d = [torch.empty_like(d) for _ in range(S)]
    dist.all_gather(all_i, gids.contiguous(), group=g)
    dist.all_gather(all_d, d.contiguous(), group=g)
    return _merge_topk(list(zip(all_i, all_d)), k)


def _sum_across_shards(mesh, per_shard: list) -> dict:
    """Per-query counters summed over every shard (the reference's psum)."""
    out = {}
    for name in _PER_QUERY_STAT_FIELDS:
        acc = per_shard[0][name].clone()
        for st in per_shard[1:]:
            acc += st[name]
        if mesh.group is not None:
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.group)
        out[name] = acc
    return out


def _run_shards(mesh, shard_fn, *, k: int, merge: str, stats: bool):
    """``shard_fn(j, shard)`` for each local shard (j its position on the
    leading axis, ``shard`` its global index), then the merge."""
    outs = [shard_fn(j, sh) for j, sh in enumerate(mesh.local_shards)]
    merged = _merge_across_shards(mesh, [o[:2] for o in outs], k=k, merge=merge)
    if stats:
        return merged + (_sum_across_shards(mesh, [o[2] for o in outs]),)
    return merged


def _tree_map(fn, outs: list):
    """``fn`` over the list of tensors at each position of the step outputs
    ``outs`` (tuples of tensors and of ``{field: tensor}`` dicts)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return fn(outs)
    if isinstance(first, dict):
        return {key: _tree_map(fn, [o[key] for o in outs]) for key in first}
    return tuple(_tree_map(fn, [o[i] for o in outs]) for i in range(len(first)))


def _query_slices(mesh, B: int) -> List[slice]:
    """The batch rows of this process's query slices; raises when the query
    axes do not divide the batch."""
    Q = mesh.queries
    if B % Q:
        raise ValueError(f"a batch of {B} queries does not split over the query axes "
                         f"(pod {mesh.pod} x data {mesh.data} = {Q} slices)")
    n = B // Q
    return [slice(i * n, (i + 1) * n) for i in mesh.local_queries]


def _gather_slices(ts: list, group, slices: int) -> torch.Tensor:
    t = ts[0].contiguous()
    parts = [torch.empty_like(t) for _ in range(slices)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def _run_queries(mesh, B: int, run):
    """``run(rows)`` for each local query slice, the answers concatenated in
    slice order, then gathered over the query subgroup in the process-group
    form: every rank returns the whole batch."""
    outs = [run(sl) for sl in _query_slices(mesh, B)]
    out = outs[0] if len(outs) == 1 else _tree_map(lambda ts: torch.cat(ts, dim=0), outs)
    if mesh.query_group is not None:
        out = _tree_map(lambda ts: _gather_slices(ts, mesh.query_group, mesh.queries), [out])
    return out


def _global_ids(ids_l, d_l, shard: int, n_l: int):
    gids = torch.where(ids_l >= 0, ids_l + shard * n_l, -1)
    return gids, torch.where(ids_l >= 0, d_l, INF)


def make_serving_step(
    mesh,
    relation: str,
    *,
    k: int = 10,
    beam: int = 64,
    max_iters: int | None = None,
    merge: str = "all_gather",     # all_gather | tournament
    int8_vectors: bool = False,
    fused: bool = True,
    expand: int = 1,
    stats: bool = False,
):
    """The serving step for ``mesh``.

    Signature of the returned fn:
      (vectors, nbr, labels, norms, U_X, U_Y, num_y, entry_node,
       entry_y_rank, q, xq, yq[, scales]) -> (global_ids [B, k], dists [B, k])
    with the database arrays carrying the leading shard dim (the mesh's
    local shards). With ``int8_vectors`` the database is int8 + per-vector
    f32 scales; the stacked norms are of the f32 rows, so they are dropped
    and each shard's dequantized norms recomputed. ``fused`` selects the
    gather-fused beam expansion (``fused=False``: the dense pre-gather, B4,
    on int32 rectangles unpacked from a packed stack); ``expand`` widens
    each iteration to the best M unexpanded beam entries.

    ``stats=True`` appends a third output: {field: [B] int32} per-query
    traversal counters summed over every shard (``hit_max_iters`` becomes
    the *count of shards* that hit the cap).
    """
    _check_merge(merge, mesh.model)
    max_iters = max_iters if max_iters is not None else 2 * beam
    dev = mesh.device

    def step(vec, nbr, lab, nrm, UX, UY, num_y, ent, enty, q, xq, yq, scales=None):
        if int8_vectors and scales is None:
            raise ValueError("int8_vectors=True needs scales")
        q, xq, yq = _query(q, dev), _query(xq, dev), _query(yq, dev)

        def run(rows):
            def shard_fn(j, sh):
                states, ep = _canonicalize_local(UX[j], UY[j], num_y[j], ent[j], enty[j],
                                                 xq[rows], yq[rows])
                sc = scales[j] if scales is not None else None
                norms = effective_norms(vec[j], sc) if int8_vectors else nrm[j]
                out = search_core(
                    vec[j], nbr[j], _oracle_labels(lab[j], fused), q[rows], states, ep,
                    k=k, beam=beam, max_iters=max_iters, expand=expand,
                    norms=norms, scales=sc, fused=fused, stats=stats,
                )
                gids, d_l = _global_ids(out[0], out[1], sh, vec.shape[1])
                return (gids, d_l, per_query_dict(out[2])) if stats else (gids, d_l)

            return _run_shards(mesh, shard_fn, k=k, merge=merge, stats=stats)

        return _run_queries(mesh, q.shape[0], run)

    return step


def make_planned_serving_step(
    mesh,
    relation: str,
    *,
    k: int = 10,
    beam: int = 64,
    max_iters: int | None = None,
    merge: str = "all_gather",     # all_gather | tournament
    fused: bool = True,
    expand: int = 1,
    config: PlannerConfig | None = None,
):
    """Planner-routed variant of :func:`make_serving_step`.

    Two extra inputs carry the host planning result (``plan_sharded_batch``,
    restricted to the mesh's local shards): per-shard plans ``[S, B]`` and
    shard-local brute-path valid ids ``[S, B, V]``, split along B like the
    queries (the reference's ``P("model", ("pod", "data"))``). Each shard
    runs the three-way executor (``repro_torch.exec.planned_exec_core``) and
    the usual cross-shard top-k merge.

    Signature of the returned fn:
      (vectors, nbr, labels, norms, U_X, U_Y, num_y, entry_node,
       entry_y_rank, q, xq, yq, plans, bf_ids) -> (global_ids, dists)
    """
    _check_merge(merge, mesh.model)
    config = config or default_planner_config()
    max_iters = max_iters if max_iters is not None else 2 * beam
    wide_beam = max(beam * config.wide_beam_scale, beam)
    wide_expand = config.wide_expand if fused else 1
    dev = mesh.device

    def step(vec, nbr, lab, nrm, UX, UY, num_y, ent, enty, q, xq, yq, plans, bf_ids):
        q, xq, yq = _query(q, dev), _query(xq, dev), _query(yq, dev)
        plans = _query(plans, dev, np.int32)
        bf_ids = _query(bf_ids, dev, np.int32)

        def run(rows):
            def shard_fn(j, sh):
                states, ep = _canonicalize_local(UX[j], UY[j], num_y[j], ent[j], enty[j],
                                                 xq[rows], yq[rows])
                pl = plans[j, rows]
                ep_graph = torch.where(pl == int(QueryPlan.GRAPH), ep, -1)
                ep_wide = torch.where(pl == int(QueryPlan.GRAPH_WIDE), ep, -1)
                ids_l, d_l = planned_exec_core(
                    vec[j], nbr[j], _oracle_labels(lab[j], fused), q[rows], states,
                    ep_graph, ep_wide, bf_ids[j, rows], pl,
                    k=k, beam=beam, wide_beam=wide_beam, max_iters=max_iters,
                    wide_max_iters=max_iters * config.wide_beam_scale,
                    expand=expand, wide_expand=wide_expand, norms=nrm[j],
                    fused=fused,
                )
                return _global_ids(ids_l, d_l, sh, vec.shape[1])

            return _run_shards(mesh, shard_fn, k=k, merge=merge, stats=False)

        return _run_queries(mesh, q.shape[0], run)

    return step


def serve_batch(
    idx: ShardedIndex,
    mesh,
    q: np.ndarray,
    s_q: np.ndarray,
    t_q: np.ndarray,
    *,
    k: int = 10,
    beam: int = 64,
    merge: str = "all_gather",
    plan: str = "auto",
    planner_config: PlannerConfig | None = None,
    id_map: np.ndarray | None = None,
    missing_shards: Sequence[int] | None = None,
    return_partial: bool = False,
):
    """Host entry point: run one sharded batch end-to-end on ``mesh``.

    ``plan="auto"`` plans each (query, shard) pair from the shard's
    rank-space histogram and serves through the planned step; ``"graph"``
    is the pre-planner single-strategy path (parity oracle; also the
    fallback for indexes without planner state). Returned ids are
    ROUND-ROBIN global: original_id = local_id*shards+shard is inverted
    here so callers see dataset ids — unless ``id_map`` (``[S, n_l]``, -1
    on padding rows) is given, in which case ids are translated through
    :func:`remap_shard_ids` instead.

    ``return_partial=True`` wraps the answer in a :class:`PartialResult`
    whose ``missing_shards`` comes from the caller, so clients see a correct
    top-k over the surviving shards explicitly flagged as degraded."""
    if plan not in ("auto", "graph"):
        raise ValueError(f"plan={plan!r} not in ('auto', 'graph')")
    # boundary hardening: a NaN/Inf anywhere in the batch silently poisons
    # the shared distance computations, so reject before touching devices.
    # Sentinel padding rows (s > t = empty valid set) are legitimate here.
    q = validate_query(
        q, s_q, t_q, what="serve_batch", require_ordered=False,
    )
    if mesh.model != idx.num_shards:
        raise ValueError(f"mesh has {mesh.model} shards, the index {idx.num_shards}")
    _query_slices(mesh, q.shape[0])      # refuse an undivided batch before planning it
    rel = get_relation(idx.relation)
    xq, yq = rel.query_map(
        np.asarray(s_q, np.float64), np.asarray(t_q, np.float64)
    )
    xq = np.asarray(xq, np.float32)
    yq = np.asarray(yq, np.float32)
    local = list(mesh.local_shards)
    dev = idx.device(mesh.device, local)
    arrays = [dev[name] for name in STACK_FIELDS]
    if plan == "auto" and idx.planners is not None:
        config = planner_config or default_planner_config()
        plans, bf_ids = plan_sharded_batch(idx, xq, yq, config=config, shards=local)
        step = make_planned_serving_step(
            mesh, idx.relation, k=k, beam=beam, merge=merge, config=config)
        gids, d = step(*arrays, q, xq, yq, plans[local], bf_ids[local])
    else:
        step = make_serving_step(mesh, idx.relation, k=k, beam=beam, merge=merge)
        gids, d = step(*arrays, q, xq, yq)
    gids = gids.cpu().numpy()
    d = d.cpu().numpy()
    if id_map is not None:
        ids = remap_shard_ids(id_map, gids)
    else:
        shard = gids // idx.n_local
        local_ids = gids % idx.n_local
        ids = np.where(gids >= 0, local_ids * idx.num_shards + shard, -1)
    if return_partial:
        missing = sorted(int(s) for s in (missing_shards or ()))
        d = np.where(ids >= 0, d, np.inf).astype(np.float32)
        return PartialResult(
            ids=ids, dists=d, degraded=bool(missing),
            missing_shards=missing,
        )
    return ids, d


# --- partial-result merge (degraded responses under shard loss) ----------------


@dataclasses.dataclass
class PartialResult:
    """Merged top-k over the shards that answered. ``degraded=True`` (one
    or more shards contributed nothing — both the primary and its
    speculative replica missed the deadline or raised) means the result is
    a correct top-k over a *subset* of the database; ``missing_shards``
    names the gaps so callers can retry or annotate."""

    ids: np.ndarray        # [B, k] global ids, -1 padded
    dists: np.ndarray      # [B, k] squared distances, +inf padded
    degraded: bool
    missing_shards: List[int]


def merge_partial_results(
    per_shard: Sequence[Optional[Tuple[np.ndarray, np.ndarray]]],
    *,
    k: int,
) -> PartialResult:
    """Host-side top-k merge across shard responses where some entries may
    be ``None`` (shard + replica both missed — the output of
    ``SpeculativeDispatcher.call_all_partial``).

    Top-k over a union is the merge of per-shard top-k, so dropping a
    shard degrades coverage, never correctness of the surviving
    candidates: every returned (id, dist) pair is exact. An all-``None``
    input yields the fully-padded empty result rather than raising —
    total shard loss is an operational event the caller flags, not a
    crash."""
    missing = [i for i, r in enumerate(per_shard) if r is None]
    avail = [r for r in per_shard if r is not None]
    if not avail:
        return PartialResult(
            ids=np.full((0, k), -1, np.int32),
            dists=np.full((0, k), np.inf, np.float32),
            degraded=True, missing_shards=missing,
        )
    ids = np.concatenate([np.asarray(r[0]) for r in avail], axis=1)
    dists = np.concatenate(
        [np.asarray(r[1], np.float32) for r in avail], axis=1
    )
    # -1 padding rows carry +inf so they sort last regardless of the
    # distance the shard reported for them
    dists = np.where(ids >= 0, dists, np.inf)
    order = np.argsort(dists, axis=1, kind="stable")[:, :k]
    return PartialResult(
        ids=np.take_along_axis(ids, order, axis=1),
        dists=np.take_along_axis(dists, order, axis=1),
        degraded=bool(missing), missing_shards=missing,
    )


# --- streaming (online mutations + per-shard epoch swap) -----------------------


class ShardedStreamingIndex:
    """One ``StreamingIndex`` per shard with round-robin insert routing.

    External ids are globally unique (shard s uses ids ≡ s mod S), so
    ``delete`` and result merging need no translation tables. Compaction is
    *per shard*: ``maybe_compact_shards`` rebuilds at most one shard per
    call, so at any instant at most one shard is paused in its epoch swap
    while the rest keep serving.

    Every shard shares one serving shape (same capacities), so the stacked
    arrays of ``stacked_arrays`` keep their shapes across every per-shard
    swap. ``kwargs`` go to each ``StreamingIndex`` (``device=`` included).
    """

    def __init__(
        self,
        dim: int,
        relation: str,
        num_shards: int,
        **kwargs,
    ):
        from repro_torch.stream import StreamingIndex

        self.dim = dim
        self.relation = relation
        self.num_shards = num_shards
        self.shards = [
            StreamingIndex(
                dim, relation, id_start=sh, id_stride=num_shards, **kwargs
            )
            for sh in range(num_shards)
        ]
        self._rr = 0

    # --- mutations ------------------------------------------------------------

    def insert(self, vec: np.ndarray, s: float, t: float) -> int:
        sh = self._rr
        self._rr = (self._rr + 1) % self.num_shards
        return self.shards[sh].insert(vec, s, t)

    def insert_batch(self, vecs, s, t) -> np.ndarray:
        return np.array(
            [self.insert(vecs[i], s[i], t[i]) for i in range(len(vecs))],
            dtype=np.int64,
        )

    def delete(self, ext_id: int) -> bool:
        return self.shards[int(ext_id) % self.num_shards].delete(ext_id)

    @property
    def live_count(self) -> int:
        return sum(sh.live_count for sh in self.shards)

    def maybe_compact_shards(self) -> int:
        """Compact the single most-mutated shard over threshold (staggered
        swaps). Returns the shard index, or -1 if none qualified."""
        cand = [
            (sh.delta_fraction, i)
            for i, sh in enumerate(self.shards)
            if sh.should_compact()
        ]
        if not cand:
            return -1
        _, i = max(cand)
        self.shards[i].compact()
        return i

    # --- host-merge query path ------------------------------------------------

    def search(
        self, q, s_q, t_q, *, k: int = 10, beam: int = 64,
        fused: bool = True, plan: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Query every shard and merge per-shard top-k by distance. Top-k
        over a union = merge of per-shard top-k. Each shard plans its own
        queries (selectivity differs per shard); ``plan="graph"`` forces
        the pre-planner path everywhere."""
        per = [
            sh.search(q, s_q, t_q, k=k, beam=beam, fused=fused, plan=plan)
            for sh in self.shards
        ]
        all_ids = np.concatenate([p[0] for p in per], axis=1)
        all_d = np.concatenate([p[1] for p in per], axis=1)
        all_d = np.where(all_ids >= 0, all_d, np.inf)
        order = np.argsort(all_d, axis=1, kind="stable")[:, :k]
        return (
            np.take_along_axis(all_ids, order, 1),
            np.take_along_axis(all_d, order, 1),
        )

    # --- stacked (mesh) query path ----------------------------------------------

    def stacked_arrays(self) -> dict:
        """Stack every shard's epoch + delta arrays on a leading shard dim
        (host numpy, ``STREAM_FIELDS``).

        All dims are capacity-static: refreshing a shard after its epoch
        swap (``refresh_shard``) republishes one slice copy-on-write and
        the serving step sees the same shapes.
        """
        S = self.num_shards
        sh0 = self.shards[0]
        ncap, dcap = sh0.node_capacity, sh0.delta_capacity
        ecap, dim = sh0.edge_capacity, sh0.dim
        # every shard shares one construction-time label layout (see
        # StreamingIndex._packed_labels), so the stack — and the serving
        # step's label shape — is fixed for the fleet's lifetime
        if sh0._packed_labels:
            lab_stack = np.zeros((S, ncap, ecap, 2), np.uint32)
        else:
            lab_stack = np.zeros((S, ncap, ecap, 4), np.int32)
        out = {
            "vectors": np.zeros((S, ncap, dim), np.float32),
            "nbr": np.full((S, ncap, ecap), -1, np.int32),
            "labels": lab_stack,
            "norms": np.zeros((S, ncap), np.float32),
            "live": np.zeros((S, ncap), bool),
            "ext": np.full((S, ncap), -1, np.int32),
            "dvec": np.zeros((S, dcap, dim), np.float32),
            "dlab": np.zeros((S, dcap, 4), np.int32),
            "dids": np.full((S, dcap), -1, np.int32),
            "dext": np.full((S, dcap), -1, np.int32),
            "U_X": np.full((S, ncap), np.inf, np.float32),
            "U_Y": np.full((S, ncap), np.inf, np.float32),
            "num_y": np.zeros(S, np.int32),
            "entry_node": np.full((S, ncap), -1, np.int32),
            "entry_y_rank": np.full((S, ncap), np.iinfo(np.int32).max, np.int32),
        }
        for i in range(S):
            self._write_shard(out, i)
        return out

    def refresh_shard(self, stacked: dict, i: int) -> dict:
        """Per-shard epoch swap in the stacked path: republish shard i's
        current epoch (a consistent snapshot taken under the shard's lock).

        Copy-on-write: returns a NEW dict with fresh arrays; the caller
        swaps its reference atomically, so a serving thread holding the old
        dict keeps a complete epoch-N view and can never observe a torn
        (half-rewritten) shard."""
        fresh = {key: a.copy() for key, a in stacked.items()}
        self._write_shard(fresh, i)
        return fresh

    def _write_shard(self, stacked: dict, i: int) -> None:
        sh = self.shards[i]
        with sh._lock:
            dg = sh._dg
            live = sh._graph_live.copy()
            ext = np.where(live, sh._graph_ext, -1).astype(np.int32)
            seg = sh._delta.device_segment()
        stacked["vectors"][i] = dg.vectors
        stacked["nbr"][i] = dg.nbr
        stacked["labels"][i] = (
            dg.plabels if stacked["labels"].dtype == np.uint32
            else dg.labels_i32()
        )
        stacked["norms"][i] = dg.norms
        stacked["live"][i] = live
        stacked["ext"][i] = ext
        stacked["dvec"][i] = seg.vectors
        stacked["dlab"][i] = seg.labels
        stacked["dids"][i] = seg.slot_ids
        stacked["dext"][i] = seg.ext_ids
        kx, ky = dg.U_X.shape[0], dg.U_Y.shape[0]
        stacked["U_X"][i] = np.inf
        stacked["U_X"][i, :kx] = dg.U_X.astype(np.float32)
        stacked["U_Y"][i] = np.inf
        stacked["U_Y"][i, :ky] = dg.U_Y.astype(np.float32)
        stacked["num_y"][i] = ky
        stacked["entry_node"][i] = -1
        stacked["entry_node"][i, :kx] = dg.entry_node
        stacked["entry_y_rank"][i] = np.iinfo(np.int32).max
        stacked["entry_y_rank"][i, :kx] = dg.entry_y_rank


def make_streaming_serving_step(
    mesh,
    *,
    k: int = 10,
    beam: int = 64,
    max_iters: int | None = None,
    fused: bool = True,
    expand: int = 1,
    stats: bool = False,
):
    """Streaming serving step: two-tier search per shard (tombstone-masked
    graph beam + the delta scan on B3, B4 unfused) then the ``all_gather``
    cross-shard top-k merge. Results are *external* ids, so no round-robin
    inversion. All shapes are capacity-fixed, so per-shard epoch swaps
    change none.

    Signature of the returned fn (leading shard dim on database arrays):
      (vectors, nbr, labels, norms, live, ext, dvec, dlab, dids, dext,
       U_X, U_Y, num_y, entry_node, entry_y_rank,
       q, xq, yq, dstate) -> (ext_ids [B, k], dists [B, k])

    ``stats=True`` appends a third output: {field: [B] int32} per-query
    counters summed over every shard — graph-tier traversal totals plus
    ``delta_valid`` (delta-tier candidates passing the filter, all shards).
    """
    from repro_torch.stream.search import two_tier_merge

    max_iters = max_iters if max_iters is not None else 2 * beam
    dev = mesh.device

    def step(vec, nbr, lab, nrm, live, ext, dvec, dlab, dids, dext,
             UX, UY, num_y, ent, enty, q, xq, yq, dstate):
        q, xq, yq = _query(q, dev), _query(xq, dev), _query(yq, dev)
        dstate = _query(dstate, dev, np.int32)

        def run(rows):
            def shard_fn(j, sh):
                states, ep = _canonicalize_local(UX[j], UY[j], num_y[j], ent[j], enty[j],
                                                 xq[rows], yq[rows])
                core = search_core(
                    vec[j], nbr[j], _oracle_labels(lab[j], fused), q[rows], states, ep,
                    k=beam, beam=beam, max_iters=max_iters, expand=expand,
                    norms=nrm[j], fused=fused, stats=stats,
                )
                merged = two_tier_merge(
                    core[0], core[1], live[j], ext[j], q[rows], dvec[j], dlab[j],
                    dids[j], dext[j], dstate[rows], k=k, fused=fused,
                    st=core[2] if stats else None,
                )
                if stats:
                    return merged[0], merged[1], per_query_dict(merged[2])
                return merged

            return _run_shards(mesh, shard_fn, k=k, merge="all_gather", stats=stats)

        return _run_queries(mesh, q.shape[0], run)

    return step


def serve_streaming_batch(
    stacked: dict,
    mesh,
    relation: str,
    q: np.ndarray,
    s_q: np.ndarray,
    t_q: np.ndarray,
    *,
    step=None,
    k: int = 10,
    beam: int = 64,
) -> Tuple[np.ndarray, ...]:
    """Host entry point for the stacked streaming path: ``stacked`` (from
    ``ShardedStreamingIndex.stacked_arrays()``) is staged on the mesh's
    device, its local shards only, on every call. Pass a prebuilt ``step``
    (from ``make_streaming_serving_step``) for other options, e.g.
    ``stats``."""
    from repro_torch.stream.delta import query_key_state

    rel = get_relation(relation)
    s_q = np.asarray(s_q, np.float64)
    t_q = np.asarray(t_q, np.float64)
    xq, yq = rel.query_map(s_q, t_q)
    dstate = query_key_state(rel, s_q, t_q)
    if step is None:
        step = make_streaming_serving_step(mesh, k=k, beam=beam)
    local = None if mesh.group is None else list(mesh.local_shards)
    out = step(
        *(_put(stacked[name], mesh.device, local) for name in STREAM_FIELDS),
        np.asarray(q, np.float32),
        np.asarray(xq, np.float32),
        np.asarray(yq, np.float32),
        dstate,
    )
    ids, d = out[0].cpu().numpy(), out[1].cpu().numpy()
    if len(out) == 3:   # a step built with stats=True: per-query counters
        return ids, d, {name: v.cpu().numpy() for name, v in out[2].items()}
    return ids, d

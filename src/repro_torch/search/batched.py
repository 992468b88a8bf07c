"""Batched lockstep UDG search (Alg. 2) on torch tensors.

Every query in the batch advances one step per iteration; finished queries
no-op until the whole batch terminates. ``search_core`` runs one of three
branches, chosen by the label layout and ``fused``, as the reference's
``_batched_search_core`` does:

* packed ``[n, E, 2]`` labels, fused (the serving path). Per iteration:
  1. select the best ``expand`` (M >= 1) unexpanded beam entries (lower
     beam index first on exact ties, as ``argmin`` / ``lax.top_k`` in the
     reference);
  2. read their padded neighbor ids ``[B, M·E]``;
  3. score them with the packed-label kernel (``ops.filter_dist_gather_packed``):
     label rows read in-kernel, dominance + visited tests, cached-norm
     distance ``‖c‖² − 2·q·c + ‖q‖²``, +inf where masked;
  4. dedup + top-L merge with ``ops.beam_merge``, which also sets the kept
     candidates' bits in the ``[B, ceil(n/32)]`` int32 visited bitmap (the
     reference's scatter-add, ``ref.set_bits``; kept candidates are deduped
     and unvisited, so each bit lands at most once and the add is an or).
* int32 ``[n, E, 4]`` labels, fused (``batched.py:251-295``), or no labels
  at all (the constructor's broad search, all-zero rectangles and state):
  steps 1-2, then the expanded nodes' rectangles are gathered here and the
  gather scorer (``ops.filter_dist_gather``) scores; dedup by a stable
  argsort of the id key; the bitmap update (``ref.set_bits``); a stable
  merge on distance.
* ``fused=False`` (``batched.py:297-350``, int32 labels, M = 1): a dense
  ``[B, n]`` visited table, the candidate rows pre-gathered into
  ``[B, E, D]`` here, the dense scorer (``ops.filter_dist``, norms
  recomputed), then the seen/duplicate masks and the same stable merge.

Every sort and argsort is stable (torch's default promises no tie order),
so ties resolve as ``jnp.argsort`` and ``lax.sort(is_stable=True)`` do;
sort keys are ``d + 0.0`` (-0.0 ties +0.0, as the reference's comparator).

The reference runs this body in an on-device ``lax.while_loop`` whose
condition is "some row still has an unexpanded finite beam entry". Here
that test is a host sync, so the body runs in blocks of ``block``
iterations between tests, never more than ``max_iters`` in total. An
iteration after a row has finished is a no-op for it (no live entry → all
neighbor ids -1 → all-inf candidates → unchanged beam, no bitmap bits), so
results do not depend on ``block``. ``LOOP_STATS`` counts the tests (host
syncs) and iterations; inside ``repro_torch.exec.execute_batch`` each test
is a ``search.sync`` span and each block a ``search.block`` span
(``repro_torch.obs.trace``).

On the card, the packed fused branch without ``stats`` runs as CUDA graphs
once its key (``graph_key``: device, shapes, dtypes, loop sizes, the index's
addresses, the kernel libraries) has been seen before: the search's set-up
and one block of ``block`` iterations are captured (``LoopGraphs``) and then
replayed each call, with the same "any row active" test between two blocks;
a last block shorter than ``block`` runs eagerly. The same ops run in the
same order on the same stream, so the answers are the eager loop's bit for
bit. Each block replay is a ``search.block.replay`` span inside its
``search.block`` span. A key seen once, CPU tensors, ``stats=True`` and the
other branches run eagerly. ``GraphCache`` keeps the captured searches of
the process.

``stats=True`` also returns a ``repro_torch.obs.SearchStats`` of traversal
counters, tallied on the device from each iteration's live mask, candidate
ids, scorer distances and the merge's keep mask (four reductions an
iteration, no extra host sync; a no-op iteration adds zeros). With
``stats=False`` the loop runs exactly the launches it runs without the
counters.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.predicates import get_relation
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import set_bits, warp_dot
from repro_torch.obs.stats import (
    accumulate_iteration,
    finalize_stats,
    init_tally,
    stats_to_host,
)
from repro_torch.obs.trace import trace_span
from repro_torch.search.device_graph import DeviceGraph

INF = float("inf")
LOOP_BLOCK = 8          # iterations between two "any row active" tests
LOOP_STATS = {"syncs": 0, "iterations": 0}
LOOP_GRAPHS = 8         # captured searches kept: both searches of four indexes
LOOP_SIGHTINGS = 64     # keys remembered after their first sighting


def prepare_states_extended(
    dg: DeviceGraph, s_q: np.ndarray, t_q: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map + canonicalize a batch of query intervals (Lemma 1, vectorized).

    Returns (states [B, 2] int32 rank pairs, ep [B] int32 entry ids; ep=-1
    marks an empty valid set / no entry, invalid [B] bool — True where
    canonicalization itself failed, i.e. the valid set is provably empty
    and the clipped state rows are meaningless)."""
    rel = get_relation(dg.relation)
    s_q = np.asarray(s_q, dtype=np.float64)
    t_q = np.asarray(t_q, dtype=np.float64)
    x_q, y_q = rel.query_map(s_q, t_q)
    a = np.searchsorted(dg.U_X, x_q, side="left")
    c = np.searchsorted(dg.U_Y, y_q, side="right") - 1
    num_x = dg.U_X.shape[0]
    invalid = (a >= num_x) | (c < 0)
    a_cl = np.clip(a, 0, max(num_x - 1, 0))
    ep = dg.entry_node[a_cl].astype(np.int64)
    ep_y = dg.entry_y_rank[a_cl].astype(np.int64)
    ep = np.where(invalid | (ep < 0) | (ep_y > c), -1, ep)
    states = np.stack([a_cl, np.maximum(c, 0)], axis=1).astype(np.int32)
    return states, ep.astype(np.int32), invalid


def prepare_states(
    dg: DeviceGraph, s_q: np.ndarray, t_q: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Two-tuple form of :func:`prepare_states_extended`."""
    states, ep, _ = prepare_states_extended(dg, s_q, t_q)
    return states, ep


def _select(beam_ids, beam_d, beam_exp, M):
    """Step 1: the best M unexpanded entries per query. Returns (live
    [B, M], cur_safe [B, M] int32, beam_exp with the live ones marked)."""
    cand_d = torch.where(beam_exp, INF, beam_d)
    if M == 1:
        j = torch.argmin(cand_d, dim=1, keepdim=True)          # [B, 1]
    else:
        j = torch.sort(cand_d, dim=1, stable=True).indices[:, :M]
    live = torch.gather(cand_d, 1, j) < INF                      # [B, M]
    cur = torch.gather(beam_ids, 1, j)
    cur_safe = torch.where(live, cur, 0)
    beam_exp = beam_exp.scatter(1, j, torch.gather(beam_exp, 1, j) | live)
    return live, cur_safe, beam_exp


def graph_key(table, nbr, labels, norms, scales, q, states, ep, *, beam, expand,
              max_iters, block) -> tuple:
    """What a captured search bakes in: the device, every shape and dtype
    (``q`` is f32 by then), the loop's sizes, the addresses of the index's
    tensors and the kernel libraries its launches call."""
    return (q.device, tuple(q.shape), states.dtype, ep.dtype, tuple(table.shape),
            table.dtype, tuple(nbr.shape), tuple(labels.shape), beam, expand, max_iters, block,
            tuple(None if t is None else t.data_ptr() for t in (table, nbr, labels, norms, scales)),
            tuple(_build.loaded(name) for name in ("filter_dist", "beam_merge")))


def _capture(fn, stream, pool):
    """``fn``'s device work as a CUDA graph captured on ``stream`` (into
    ``pool``, else a pool of its own), and the kernel launches it counted in
    ``ops.LAUNCHES``: a capture launches nothing, so they are taken back
    out here and added at each replay."""
    graph = torch.cuda.CUDAGraph()
    before = dict(ops.LAUNCHES)
    with torch.cuda.stream(stream):
        graph.capture_begin(*(() if pool is None else (pool,)),
                            capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    launches = {name: c - before[name] for name, c in ops.LAUNCHES.items() if c != before[name]}
    for name, c in launches.items():
        ops.LAUNCHES[name] -= c
    return graph, launches


class LoopGraphs:
    """One search captured as two CUDA graphs sharing a memory pool: its
    set-up (entry distances, beam, visited bitmap) and one block of loop
    iterations. Both read the static inputs ``q``, ``states``, ``ep``; the
    set-up writes the beam and bitmap into ``state``, the block starts from
    ``state`` and writes its last iteration's beam back (B2 sets the bitmap
    in place). Holds the tensors whose addresses the graphs bake in
    (``pinned``), so no address is reused under it. A call holds ``lock``
    while it uses the entry, and releases it on leaving ``with``."""

    def __init__(self, pinned, q, states, ep, beam: int, words: int):
        self.pinned = pinned
        self.lock = threading.Lock()
        self.q, self.states, self.ep = (torch.empty_like(t) for t in (q, states, ep))
        B, dev = q.shape[0], q.device
        self.state = (torch.empty((B, beam), dtype=torch.int32, device=dev),
                      torch.empty((B, beam), dtype=torch.float32, device=dev),
                      torch.empty((B, beam), dtype=torch.bool, device=dev),
                      torch.empty((B, words), dtype=torch.int32, device=dev))
        self.setup = self.block = None      # (graph, {kernel: launches a replay adds})

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.lock.release()
        return False

    def load(self, q, states, ep):
        """Copy one call's inputs into the static inputs; returns those."""
        for dst, src in zip((self.q, self.states, self.ep), (q, states, ep)):
            dst.copy_(src)
        return self.q, self.states, self.ep

    def capture(self, init, body, block: int) -> None:
        """Capture ``init()`` and ``block`` calls of ``body``; both must
        read the static inputs."""
        stream = torch.cuda.Stream(self.q.device)
        stream.wait_stream(torch.cuda.current_stream(self.q.device))

        def set_up():
            for dst, src in zip(self.state, init()):
                dst.copy_(src)

        def iterate():
            s = self.state
            for _ in range(block):
                s = body(*s)[:4]
            for dst, src in zip(self.state[:3], s[:3]):
                dst.copy_(src)

        setup = _capture(set_up, stream, None)
        self.setup, self.block = setup, _capture(iterate, stream, setup[0].pool())

    @staticmethod
    def replay(piece) -> None:
        graph, launches = piece
        graph.replay()
        for name, c in launches.items():
            ops.LAUNCHES[name] += c


class GraphCache:
    """The process's captured searches by ``graph_key``: at most ``size``,
    the least recently used evicted first (its graphs, memory pool and
    buffers are freed with the last reference). A key gets an entry on its
    second sighting, so a shape seen once (a streaming step's odd batch, a
    segmented worklist) runs eagerly and pays no capture."""

    def __init__(self, size: int = LOOP_GRAPHS, sightings: int = LOOP_SIGHTINGS):
        self.size, self.sightings = size, sightings
        self._lock = threading.Lock()
        self._seen: OrderedDict = OrderedDict()
        self._entries: OrderedDict = OrderedDict()

    def take(self, key, make):
        """The entry of ``key`` with its lock held for the caller, made by
        ``make()`` at the key's second sighting; ``None`` at its first, or
        while another call holds the entry."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            elif key not in self._seen:
                self._seen[key] = None
                if len(self._seen) > self.sightings:
                    self._seen.popitem(last=False)
                return None
            else:
                del self._seen[key]
                entry = self._entries[key] = make()
                if len(self._entries) > self.size:
                    self._entries.popitem(last=False)
        return entry if entry.lock.acquire(blocking=False) else None


_GRAPHS = GraphCache()


def _graph_entry(key, make):
    """The captured search of ``key`` for this call, or ``None``: run eagerly."""
    return _GRAPHS.take(key, make)


def _dedup(nb, d_new, n):
    """Intra-iteration duplicate suppression by a stable argsort of the id
    key (``batched.py:261-269``). Returns (ids_s, d_s, keep) in key order."""
    id_key = torch.where(torch.isfinite(d_new), nb, n)
    order = torch.argsort(id_key, dim=1, stable=True)
    ids_s = torch.gather(nb, 1, order)
    d_s = torch.gather(d_new, 1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    d_s = torch.where(dup, INF, d_s)
    return ids_s, d_s, torch.isfinite(d_s)


def _merge(beam_ids, beam_d, beam_exp, ids_s, d_s, keep, L):
    """Stable merge of the beam and the candidates; keep the best L."""
    all_d = torch.cat([beam_d, d_s], dim=1)
    all_ids = torch.cat([beam_ids, ids_s], dim=1)
    all_exp = torch.cat([beam_exp, ~keep], dim=1)
    order = torch.sort(all_d + 0.0, dim=1, stable=True).indices[:, :L]
    return (torch.gather(all_ids, 1, order), torch.gather(all_d, 1, order),
            torch.gather(all_exp, 1, order))


def search_core(
    table: torch.Tensor,    # [n, D] f32 (or int8 with scales)
    nbr: torch.Tensor,      # [n, E] int32
    labels: torch.Tensor | None,  # [n, E, 2] packed words, [n, E, 4] int32,
                                  # or None: label-ignoring (broad) search
    q: torch.Tensor,        # [B, D] f32
    states: torch.Tensor,   # [B, 2] int32
    ep: torch.Tensor,       # [B] int32 (-1 = no entry: the row does nothing)
    *,
    k: int,
    beam: int,
    max_iters: int,
    expand: int = 1,
    norms: torch.Tensor | None = None,   # [n] f32 cached ‖c‖² of the scored
                                         # rows (required by the fused branches)
    scales: torch.Tensor | None = None,  # [n] f32: int8-quantized table
    fused: bool = True,
    block: int = LOOP_BLOCK,
    stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The lockstep search loop on whatever device the tensors lie on.
    Returns (ids [B, k] int32, squared distances [B, k] f32), ascending,
    and with ``stats`` the ``SearchStats`` (on the same device)."""
    packed = labels is not None and labels.shape[-1] == 2
    if not fused and expand != 1:
        raise ValueError("multi-expand (expand > 1) requires fused=True")
    if not 1 <= expand <= beam:
        raise ValueError(f"expand={expand} must be in [1, beam={beam}]")
    if not fused and packed:
        raise ValueError("the unfused branch needs the int32 [n, E, 4] labels "
                         "(DeviceGraph.serving_labels(fused=False))")
    n = table.shape[0]
    B = q.shape[0]
    E = nbr.shape[1]
    L, M = beam, expand
    ME = M * E
    dev = q.device
    q = q.float()
    if fused and norms is None:
        raise ValueError("the fused branches score with cached norms: pass norms")
    graphs = None
    if packed and fused and not stats and B and dev.type == "cuda":
        graphs = _graph_entry(
            graph_key(table, nbr, labels, norms, scales, q, states, ep, beam=L, expand=M,
                      max_iters=max_iters, block=block),
            lambda: LoopGraphs((table, nbr, labels, norms, scales), q, states, ep, L,
                               (n + 31) // 32))

    def deq(idx):
        """Rows ``idx`` of the table in f32 (dequantizing int8 storage)."""
        out = table[idx].float()
        return out if scales is None else out * scales[idx][..., None]

    def init():
        """The beam holding each row's entry, and the visited set."""
        has_ep = ep >= 0
        ep_safe = torch.where(has_ep, ep, torch.zeros_like(ep)).long()
        # summed in f64 in one order, rounded once: the card and the CPU agree
        diff = q - deq(ep_safe)
        d_ep = warp_dot(diff, diff)

        beam_ids = torch.full((B, L), -1, dtype=torch.int32, device=dev)
        beam_d = torch.full((B, L), INF, dtype=torch.float32, device=dev)
        beam_exp = torch.zeros((B, L), dtype=torch.bool, device=dev)
        beam_ids[:, 0] = torch.where(has_ep, ep, -1)
        beam_d[:, 0] = torch.where(has_ep, d_ep, INF)
        if fused:
            visited = torch.zeros((B, (n + 31) // 32), dtype=torch.int32, device=dev)
            ep_bit = torch.where(has_ep, 1 << (ep_safe & 31), 0).to(torch.int32)
            visited.scatter_add_(1, (ep_safe >> 5)[:, None], ep_bit[:, None])
        else:
            visited = torch.zeros((B, n), dtype=torch.uint8, device=dev)
            visited[torch.arange(B, device=dev), ep_safe] = has_ep.to(torch.uint8)
        return beam_ids, beam_d, beam_exp, visited

    if labels is None:      # broad: every tuple passes the all-zero test
        zero_lab = torch.zeros((B, ME, 4), dtype=torch.int32, device=dev)

    def packed_body(beam_ids, beam_d, beam_exp, visited):
        live, cur_safe, beam_exp = _select(beam_ids, beam_d, beam_exp, M)
        nb = torch.where(live[:, :, None], nbr[cur_safe.long()], -1).reshape(B, ME)
        d_new = ops.filter_dist_gather_packed(
            table, labels, norms, q, cur_safe, nb, states, visited,
            scales=scales,
        )
        # dedup + top-L merge, the kept candidates' bits set in the same call
        beam_ids, beam_d, beam_exp, keep = ops.beam_merge(
            beam_d, beam_ids, beam_exp, d_new, nb, n=n, visited=visited)
        return beam_ids, beam_d, beam_exp, visited, (live, nb, d_new, keep)

    def int32_body(beam_ids, beam_d, beam_exp, visited):
        live, cur_safe, beam_exp = _select(beam_ids, beam_d, beam_exp, M)
        nb = torch.where(live[:, :, None], nbr[cur_safe.long()], -1).reshape(B, ME)
        lb = zero_lab if labels is None else labels[cur_safe.long()].reshape(B, ME, 4)
        d_new = ops.filter_dist_gather(
            table, norms, q, nb, lb, states, visited, scales=scales)
        ids_s, d_s, keep = _dedup(nb, d_new, n)
        set_bits(visited, ids_s, keep, n)
        beam_ids, beam_d, beam_exp = _merge(
            beam_ids, beam_d, beam_exp, ids_s, d_s, keep, L)
        return beam_ids, beam_d, beam_exp, visited, (live, nb, d_new, keep)

    def unfused_body(beam_ids, beam_d, beam_exp, visited):
        live, cur_safe, beam_exp = _select(beam_ids, beam_d, beam_exp, 1)
        cur_safe = cur_safe[:, 0].long()
        nb = torch.where(live, nbr[cur_safe], -1)                   # [B, E]
        lb = zero_lab if labels is None else labels[cur_safe]       # [B, E, 4]
        nb_safe = nb.clamp(0, n - 1).long()
        # the reference's XLA gather of the dense candidate tensor
        d_new = ops.filter_dist(q, deq(nb_safe), lb, states, nb)
        seen = torch.gather(visited, 1, nb_safe) > 0
        d_new = torch.where(seen | (nb < 0), INF, d_new)
        ids_s, d_s, keep = _dedup(nb, d_new, n)
        # the reference's ``.at[rows, ids].max(keep)``: clipped duplicates
        # carry keep = False, so an amax (order-free) keeps their bytes
        visited.scatter_reduce_(1, ids_s.clamp(0, n - 1).long(),
                                keep.to(torch.uint8), reduce="amax")
        beam_ids, beam_d, beam_exp = _merge(
            beam_ids, beam_d, beam_exp, ids_s, d_s, keep, L)
        return beam_ids, beam_d, beam_exp, visited, (live, nb, d_new, keep)

    body = unfused_body if not fused else packed_body if packed else int32_body
    with graphs if graphs is not None else contextlib.nullcontext():
        if graphs is None:
            beam_ids, beam_d, beam_exp, visited = init()
        else:       # from here on the closures read the entry's static inputs
            q, states, ep = graphs.load(q, states, ep)
            if graphs.setup is None:
                graphs.capture(init, body, block)
            graphs.replay(graphs.setup)
            beam_ids, beam_d, beam_exp, visited = graphs.state
        tally = init_tally(B, max_iters, dev) if stats else None
        it = 0
        while it < max_iters:
            LOOP_STATS["syncs"] += 1
            with trace_span("search.sync"):
                active = bool(torch.any(~beam_exp & torch.isfinite(beam_d)))
            if not active:
                break
            with trace_span("search.block"):
                if graphs is not None and max_iters - it >= block:
                    with trace_span("search.block.replay"):
                        graphs.replay(graphs.block)
                    it += block
                    continue
                for _ in range(min(block, max_iters - it)):
                    beam_ids, beam_d, beam_exp, visited, masks = body(
                        beam_ids, beam_d, beam_exp, visited)
                    if stats:
                        live, nb, d_new, keep = masks
                        accumulate_iteration(tally, live=live, nb=nb, d_new=d_new,
                                             keep=keep, it=it)
                    it += 1
        LOOP_STATS["iterations"] += it
        if stats:
            st = finalize_stats(tally, beam_d=beam_d, beam_exp=beam_exp, visited=visited)
            return beam_ids[:, :k], beam_d[:, :k], st
        if graphs is not None:      # the next call overwrites the graphs' buffers
            return beam_ids[:, :k].clone(), beam_d[:, :k].clone()
        return beam_ids[:, :k], beam_d[:, :k]


def batched_udg_search(
    dg: DeviceGraph,
    q: np.ndarray,
    s_q: np.ndarray,
    t_q: np.ndarray,
    *,
    k: int = 10,
    beam: int = 64,
    max_iters: int | None = None,
    expand: int = 1,
    fused: bool = True,
    plan: str = "graph",
    packed: bool | None = None,
    stats: bool = False,
    device=None,
    block: int = LOOP_BLOCK,
) -> Tuple[np.ndarray, ...]:
    """End-to-end batched query: canonicalize on the host, search on
    ``device`` (``None`` = the card) over the graph's memoized device
    bundle. ``packed`` picks the label layout (``DeviceGraph.serving_labels``:
    ``None`` the packed words when exported, ``False`` the int32 rectangles,
    ``True`` requires packed words); ``fused=False`` runs the unfused branch.
    ``plan="graph"`` is the pure beam search; ``"auto"`` / ``"wide"`` /
    ``"brute"`` route through ``repro_torch.exec.execute_batch``.
    Returns numpy ``(ids [B, k], dists [B, k])``, and with ``stats`` a host
    ``SearchStats`` after them."""
    if plan != "graph":
        from repro_torch.exec.executor import execute_batch

        return execute_batch(
            dg, q, s_q, t_q, k=k, beam=beam, max_iters=max_iters,
            expand=expand, fused=fused, plan=plan, packed=packed, stats=stats,
            device=device, block=block,
        )
    dev = resolve_device(device)
    states, ep = prepare_states(dg, s_q, t_q)
    labels = dg.serving_labels(fused=fused, packed=packed, device=dev)
    di = dg.device(dev)
    out = search_core(
        di.table, di.nbr, labels,
        torch.as_tensor(np.asarray(q, dtype=np.float32), device=dev),
        torch.as_tensor(states, device=dev), torch.as_tensor(ep, device=dev),
        k=k, beam=beam,
        max_iters=max_iters if max_iters is not None else 2 * beam,
        expand=expand, norms=di.norms, scales=di.scales, fused=fused,
        block=block, stats=stats,
    )
    ret = (out[0].cpu().numpy(), out[1].cpu().numpy())
    return ret + (stats_to_host(out[2]),) if stats else ret


def broad_batched_search(
    table: torch.Tensor,     # [n_pad, D] f32 full vector table
    norms: torch.Tensor,     # [n_pad] f32 cached ‖v‖²
    nbr: torch.Tensor,       # [n_pad, E] int32 broad adjacency (-1 padded)
    q: torch.Tensor,         # [B, D] f32 wave of inserted objects
    ep: torch.Tensor,        # [B] int32 entry ids (-1 = masked/padding query)
    *,
    k: int,
    beam: int | None = None,
    max_iters: int | None = None,
    fused: bool = True,
    expand: int = 1,
    block: int = LOOP_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label-ignoring batched beam search — the constructor's broad search
    (``udg_search(..., ignore_labels=True)`` for a whole insertion wave)
    over a broad adjacency (``device_graph.BroadExport``): no labels, the
    all-zero rectangles and state pass every tuple. Returns tensors on the
    inputs' device (ids [B, k] int32 with -1 padding, squared dists [B, k]
    f32, ascending)."""
    L = beam if beam is not None else k
    states = torch.zeros((q.shape[0], 2), dtype=torch.int32, device=q.device)
    return search_core(
        table, nbr, None, q, states, ep, k=k, beam=L,
        max_iters=max_iters if max_iters is not None else 2 * L,
        expand=expand, norms=norms, fused=fused, block=block,
    )

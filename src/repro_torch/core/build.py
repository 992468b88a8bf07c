"""UDG construction (paper §IV-B exact + §V-A practical).

``build_udg_exact``     Algorithm 3 under the Accurate Search Assumption
                        (construction-time searches are exact); this is the
                        variant covered by the Theorem 1 lossless guarantee
                        and tested against dedicated per-state graphs.
``build_udg``           the practical constructor: one broad label-ignoring
                        search per insertion (pool size Z), threshold sweep
                        over the shared candidate pool, conservative /
                        MaxLeap leap policies, and §V-B patch edges. Two
                        execution strategies share this entry point —
                        ``batched=False`` is the sequential host loop (the
                        parity oracle), ``batched=True`` the wave-pipelined
                        constructor (``repro_torch.core.build_batched``,
                        its searches on a torch device), and the default
                        ``batched=None`` picks batched at or above
                        ``BATCHED_AUTO_MIN_N`` objects, as the reference.
``build_dedicated_reference``
                        the per-state reference constructor used by the
                        Theorem 1 test.

Unit conventions, everywhere in this module: ``a`` / ``c`` / ``x_R`` /
``x_leap`` and all label rectangle fields are canonical *ranks* (indices
into ``U_X`` / ``U_Y``, see ``LabeledGraph``), never raw interval floats;
distances are squared L2 over raw embedding vectors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.entry import ConstructionEntry, EntryTable
from repro_torch.core.graph import LabeledGraph
from repro_torch.core.patch import PATCH_VARIANTS, add_patch_edges
from repro_torch.core.prune import prune, squared_dists
from repro_torch.core.search import udg_search

LEAP_POLICIES = ("conservative", "maxleap")

# build_udg(batched=None) auto-selects the wave-pipelined constructor at or
# above this many objects; below it, per-wave launch overhead beats the
# host loop's simplicity.
BATCHED_AUTO_MIN_N = 4096


@dataclass
class BuildReport:
    """Construction cost accounting (consumed by ``BENCH_build.json``).

    ``seconds`` is one wall-clock window around the entire build (graph
    allocation through the last patch edge) — there is deliberately no
    per-insert timer accumulation, which under the batched path would both
    distort the total (waves interleave device and host work) and add
    syscall overhead per object. ``index_bytes`` comes from
    ``LabeledGraph.stats()`` *after* patching, so it is exact for either
    strategy. ``broad_searches`` counts host searches under the sequential
    strategy but device launches under the batched one; ``waves`` is 0 for
    sequential/exact builds and the number of insertion waves otherwise.
    """

    n: int
    seconds: float
    num_tuples: int
    num_patch_tuples: int
    sweep_rounds: int
    broad_searches: int
    index_bytes: int
    waves: int = 0
    search_seconds: float = 0.0   # batched: time in the wave device searches


def _exact_candidates(
    g: LabeledGraph,
    vj: int,
    ins_ids: np.ndarray,
    ins_x: np.ndarray,
    a_rank: int,
    M: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """ASA oracle: exact M nearest previously inserted objects with X>=a."""
    cand = ins_ids[ins_x >= a_rank]
    if cand.size == 0:
        return cand.astype(np.int32), np.empty(0, dtype=np.float32)
    d = squared_dists(g.vectors, g.vectors[vj], cand)
    order = np.lexsort((cand, d))[:M]
    return cand[order].astype(np.int32), d[order]


def build_udg_exact(
    vectors: np.ndarray,
    s: np.ndarray,
    t: np.ndarray,
    relation: str,
    M: int = 16,
    *,
    use_graph_search: bool = False,
) -> Tuple[LabeledGraph, BuildReport]:
    """Algorithm 3 (paper §IV-B), the exact single-index constructor.

    With ``use_graph_search=False`` construction searches are exact (the
    Accurate Search Assumption) — the setting of Theorem 1's lossless
    guarantee. With True, each state-specific search runs UDGSearch on the
    partially built index (paper line 9). The threshold sweep walks
    canonical X *ranks* ``i`` (indices into ``U_X``); all emitted label
    rectangles are rank-space. Always sequential — this is the correctness
    anchor, not a throughput path (no ``batched`` strategy)."""
    t0 = time.perf_counter()
    g = LabeledGraph(vectors, s, t, relation)
    order = g.insert_order
    n = g.n
    y_max = g.num_y - 1
    ins_ids = np.empty(n, dtype=np.int64)
    ins_x = np.empty(n, dtype=np.int64)
    cnt = 0
    centry = ConstructionEntry()
    rounds = 0

    for j in range(n):
        vj = int(order[j])
        xj = int(g.x_rank[vj])
        yj = int(g.y_rank[vj])
        if j > 0:
            c_prev = int(g.y_rank[int(order[j - 1])])
            i = 0  # canonical X threshold rank x_L
            while i < g.num_x:
                if i > xj:
                    break
                ep = centry.entry(i)
                if ep is None:
                    break
                rounds += 1
                if use_graph_search:
                    ann, ann_d = udg_search(g, g.vectors[vj], i, c_prev, ep, M)
                else:
                    ann, ann_d = _exact_candidates(g, vj, ins_ids[:cnt], ins_x[:cnt], i, M)
                if ann.size == 0:
                    break
                x_R = int(min(xj, int(g.x_rank[ann].min())))
                nbrs = prune(g.vectors, vj, ann, ann_d, M)
                for u in nbrs:
                    g.add_bidirectional(vj, int(u), i, x_R, yj, y_max)
                i = x_R + 1
        ins_ids[cnt] = vj
        ins_x[cnt] = xj
        cnt += 1
        centry.insert(vj, xj)

    rep = BuildReport(
        n=n,
        seconds=time.perf_counter() - t0,
        num_tuples=g.num_tuples,
        num_patch_tuples=g.num_patch_tuples,
        sweep_rounds=rounds,
        broad_searches=0,
        index_bytes=g.stats().index_bytes,
    )
    return g, rep


def build_udg(
    vectors: np.ndarray,
    s: np.ndarray,
    t: np.ndarray,
    relation: str,
    M: int = 16,
    Z: int = 128,
    K_p: int = 8,
    *,
    leap: str = "maxleap",
    patch: str = "full",
    batched: bool | None = None,
    wave: int = 256,
    pad_nodes: int | None = None,
    use_ref: bool = True,
    device=None,
) -> Tuple[LabeledGraph, BuildReport]:
    """Practical UDG constructor (paper §V-A + §V-B).

    Arguments (units): ``M`` max kept neighbors per PRUNE, ``Z`` broad-pool
    size, ``K_p`` patch-pool multiplier (pool cap = M*K_p) — all counts;
    the interval columns ``s``/``t`` are raw floats, mapped to canonical
    rank space internally.

    Batched-vs-sequential contract: both strategies insert in the same
    §IV-B order, emit labels by the same leap/patch rules, and satisfy
    Lemma 2 exactly; they differ only in how the §V-A broad candidate pool
    is found (host best-first search per object vs one device beam-search
    launch per ``wave`` objects, intra-wave candidates by exact brute
    force), so the graphs are near-identical but not bit-identical —
    parity is pinned by ``tests/test_batched_build.py`` and quantified in
    ``BENCH_build.json``. ``batched=None`` auto-selects: batched at
    n >= ``BATCHED_AUTO_MIN_N``, sequential below. ``wave``/``pad_nodes``/
    ``device`` configure the batched path (see
    ``repro_torch.core.build_batched.build_udg_batched``; ``device=None`` is
    the card) and are ignored by the sequential one. ``use_ref`` is accepted
    for signature parity with the reference and ignored.
    """
    if leap not in LEAP_POLICIES:
        raise ValueError(f"leap must be one of {LEAP_POLICIES}")
    if patch not in PATCH_VARIANTS:
        raise ValueError(f"patch must be one of {PATCH_VARIANTS}")
    n_obj = int(np.asarray(vectors).shape[0])
    if batched is None:
        batched = n_obj >= BATCHED_AUTO_MIN_N
    if batched:
        from repro_torch.core.build_batched import build_udg_batched

        return build_udg_batched(
            vectors, s, t, relation, M=M, Z=Z, K_p=K_p,
            leap=leap, patch=patch, wave=wave, pad_nodes=pad_nodes,
            device=device,
        )
    t0 = time.perf_counter()
    g = LabeledGraph(vectors, s, t, relation)
    order = g.insert_order
    n = g.n
    y_max = g.num_y - 1
    ins_ids = np.empty(n, dtype=np.int64)
    ins_x = np.empty(n, dtype=np.int64)
    cnt = 0
    rounds = 0
    broad = 0
    global_ep = int(order[0])

    for j in range(n):
        vj = int(order[j])
        xj = int(g.x_rank[vj])
        yj = int(g.y_rank[vj])
        if j > 0:
            # One broad, label-ignoring search reused across the whole sweep.
            broad += 1
            ann, ann_d = udg_search(
                g, g.vectors[vj], 0, y_max, global_ep, Z, ignore_labels=True
            )
            ann_x = g.x_rank[ann].astype(np.int64)
            i = 0
            uncovered_from: Optional[int] = None
            while i <= xj:
                live = ann_x >= i
                if not np.any(live):
                    uncovered_from = i
                    break
                rounds += 1
                cand, cand_d = ann[live], ann_d[live]
                N = prune(g.vectors, vj, cand, cand_d, M)
                nx = g.x_rank[N].astype(np.int64)
                if leap == "conservative":
                    x_R = int(min(xj, int(nx.min())))
                    for u in N:
                        g.add_bidirectional(vj, int(u), i, x_R, yj, y_max)
                    i = x_R + 1
                else:  # maxleap: per-edge right boundary min{X_v, X_u, x_leap}
                    x_leap = int(nx.max())
                    for u, xu in zip(N, nx):
                        r = int(min(xj, int(xu)))
                        g.add_bidirectional(vj, int(u), i, r, yj, y_max)
                    i = min(xj, x_leap) + 1
            if uncovered_from is not None and patch != "none":
                add_patch_edges(
                    g, vj, uncovered_from, xj, ins_ids[:cnt], ins_x[:cnt], M, K_p, patch
                )
        ins_ids[cnt] = vj
        ins_x[cnt] = xj
        cnt += 1

    rep = BuildReport(
        n=n,
        seconds=time.perf_counter() - t0,
        num_tuples=g.num_tuples,
        num_patch_tuples=g.num_patch_tuples,
        sweep_rounds=rounds,
        broad_searches=broad,
        index_bytes=g.stats().index_bytes,
    )
    return g, rep


def build_index(
    vectors: np.ndarray,
    s: np.ndarray,
    t: np.ndarray,
    relation: str,
    **kwargs,
) -> Tuple[LabeledGraph, EntryTable, BuildReport]:
    """Convenience wrapper: practical build + query-time entry table.

    Forwards ``**kwargs`` to :func:`build_udg` unchanged, including the
    ``batched``/``wave``/``pad_nodes``/``device`` strategy knobs."""
    g, rep = build_udg(vectors, s, t, relation, **kwargs)
    return g, EntryTable(g), rep


def build_dedicated_reference(
    vectors: np.ndarray,
    subset_ids: np.ndarray,
    y_order_key: np.ndarray,
    M: int,
) -> set:
    """The per-state reference constructor of Theorem 1.

    Builds the insertion-only proximity graph directly on ``subset_ids``
    (= V(a, c)) using the same (Y, id)-lexicographic insertion order, exact
    construction-time candidate search, and the deterministic PRUNE rule.
    Returns the set of directed edges (u, v) over original ids.
    """
    subset_ids = np.asarray(subset_ids, dtype=np.int64)
    if subset_ids.size == 0:
        return set()
    order = subset_ids[np.lexsort((subset_ids, y_order_key[subset_ids]))]
    edges: set = set()
    inserted: list[int] = []
    for vj in order:
        vj = int(vj)
        if inserted:
            cand = np.asarray(inserted, dtype=np.int64)
            d = squared_dists(vectors, vectors[vj], cand)
            sel = np.lexsort((cand, d))[:M]
            ann, ann_d = cand[sel], d[sel]
            for u in prune(vectors, vj, ann, ann_d, M):
                edges.add((vj, int(u)))
                edges.add((int(u), vj))
        inserted.append(vj)
    return edges

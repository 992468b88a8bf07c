"""Batched UDG construction (paper §V-A/§V-B, wave form) on a torch device.

The port's copy of the JAX package's wave constructor
(``core/build_batched.py``), with the same host algorithm and its broad
search on torch (``search.batched.broad_batched_search``, the gather scorer
over all-zero rectangles):

1.  Objects are inserted in ascending transformed-Y order (the §IV-B order
    that Theorem 1's induction needs), ``wave`` of them at a time.
2.  The broad label-ignoring construction search (§V-A) for a whole wave
    runs as ONE ``broad_batched_search`` against the partially built index:
    the full vector table lives on the device from the start (un-inserted
    rows are unreachable), and the adjacency is a ``BroadExport`` folded in
    edge by edge on the host and uploaded once per wave. Rows are capped at
    ``max(Z, 2M, 32)`` neighbors (earliest kept).
3.  Earlier members of the same wave are not in the device graph yet, so a
    member's candidate pool merges its device results with exact distances
    to its intra-wave predecessors (one ``[W, W]`` Gram matrix per wave):
    the pool is ``np.lexsort((ids, d))[:Z]`` of the two.
4.  The threshold sweep, PRUNE and patch edges run on the host, vectorized
    (``prune_precomputed`` over one pool distance matrix per insertion,
    ``LabeledGraph.add_bidirectional_batch``).

``_WaveBuildState`` keeps the reference's ``dispatch`` (the wave's device
search) / ``process`` (the host sweep) split, so ``build_graphs_concurrent``
can interleave several graphs. The port's search syncs with the host, so
``dispatch`` returns after its search has finished; the interleave still
gives every graph exactly the build ``build_udg_batched`` gives it alone.

The labels are emitted by the same leap/patch rules as the sequential
constructor, so Lemma 2 validity holds; only the candidate pools differ
(device beam search vs host best-first search), which moves recall by well
under the 0.5 pt the tests allow. All ``a``/``c``/``x_R`` values are canonical
*ranks*; distances are squared L2 on raw vectors.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import LabeledGraph
from repro_torch.core.patch import add_patch_edges
from repro_torch.core.prune import pool_distance_matrix, prune_precomputed
from repro_torch.device import resolve_device

_NODE_BUCKET = 256  # table rows padded to a multiple of this, as the reference


def _bucket(n: int) -> int:
    return max(((n + _NODE_BUCKET - 1) // _NODE_BUCKET) * _NODE_BUCKET, _NODE_BUCKET)


class _WaveBuildState:
    """Resumable wave build of one ``LabeledGraph``: :meth:`dispatch` runs
    the next wave's broad device search, :meth:`process` the host sweep of
    its members (mutating the graph and the ``BroadExport`` for the next
    dispatch). Within one graph the two strictly alternate."""

    def __init__(
        self,
        vectors: np.ndarray,
        s: np.ndarray,
        t: np.ndarray,
        relation: str,
        *,
        M: int = 16,
        Z: int = 128,
        K_p: int = 8,
        leap: str = "maxleap",
        patch: str = "full",
        wave: int = 256,
        pad_nodes: int | None = None,
        device=None,
    ):
        # imported here: the search layer imports core
        from repro_torch.search.device_graph import BroadExport

        self.t0 = time.perf_counter()
        self.dev = resolve_device(device)
        self.M = int(M)
        self.Z = int(Z)
        self.K_p = int(K_p)
        self.leap = leap
        self.patch = patch

        g = LabeledGraph(vectors, s, t, relation)
        self.g = g
        self.order = g.insert_order
        self.n = g.n
        self.y_max = g.num_y - 1
        self.x_rank = g.x_rank
        self.y_rank = g.y_rank

        n_pad = max(_bucket(self.n), pad_nodes or 0)
        table = np.zeros((n_pad, g.dim), dtype=np.float32)
        table[: self.n] = g.vectors
        self.table = table
        self.dev_table = torch.from_numpy(table).to(self.dev)
        self.dev_norms = torch.from_numpy(
            np.einsum("ij,ij->i", table, table).astype(np.float32)).to(self.dev)

        # Broad rows capped near the pool size: pool recall is flat down to
        # width ~ Z while wave-search iteration cost is linear in width.
        broad_cap = max(self.Z, 2 * self.M, 32)
        self.broadx = BroadExport(n_pad, init_degree=broad_cap, max_width=broad_cap)
        self.W = max(1, min(int(wave), self.n))
        self.global_ep = int(self.order[0])

        self.ins_ids = np.empty(self.n, dtype=np.int64)
        self.ins_x = np.empty(self.n, dtype=np.int64)
        self.cnt = 0
        self.rounds = 0
        self.launches = 0
        self.n_waves = 0
        self.search_s = 0.0   # seconds in the wave searches (dispatch)
        self.w0 = 0  # start index (into insertion order) of the next wave
        self._pending: tuple | None = None

    @property
    def done(self) -> bool:
        return self._pending is None and self.w0 >= self.n

    def dispatch(self) -> None:
        """Run the next wave's broad device search."""
        assert self._pending is None and self.w0 < self.n
        from repro_torch.search.batched import broad_batched_search

        w0 = self.w0
        ids_w = self.order[w0 : w0 + self.W].astype(np.int64)
        Wn = int(ids_w.size)
        self.n_waves += 1
        wv = self.table[ids_w]  # [Wn, D] f32

        if w0 > 0:
            # one broad label-ignoring device search for the whole wave
            t0 = time.perf_counter()
            q_pad = np.zeros((self.W, self.g.dim), dtype=np.float32)
            q_pad[:Wn] = wv
            ep = np.full(self.W, -1, dtype=np.int32)
            ep[:Wn] = self.global_ep

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

            dev_ids, dev_d = broad_batched_search(
                self.dev_table, self.dev_norms, put(self.broadx.view()),
                put(q_pad), put(ep), k=self.Z, beam=self.Z,
                expand=min(4, self.Z),  # multi-expand amortizes loop overhead
            )
            dev_ids, dev_d = dev_ids.cpu().numpy(), dev_d.cpu().numpy()
            self.search_s += time.perf_counter() - t0
            self.launches += 1
        else:
            dev_ids = dev_d = None

        # exact intra-wave distances (earlier wave members are inserted
        # before this member is processed, so they belong in its pool)
        intra = pool_distance_matrix(self.table, ids_w)
        self._pending = (ids_w, Wn, dev_ids, dev_d, intra)
        self.w0 = w0 + self.W

    def process(self) -> None:
        """Run the host sweep of the pending wave's members."""
        assert self._pending is not None
        ids_w, Wn, dev_ids, dev_d, intra = self._pending
        self._pending = None
        g = self.g
        x_rank, y_rank = self.x_rank, self.y_rank
        M, Z = self.M, self.Z
        if dev_ids is not None:
            pool_ids = dev_ids[:Wn]
            pool_d = dev_d[:Wn]
        else:
            pool_ids = np.full((Wn, 1), -1, dtype=np.int32)
            pool_d = np.full((Wn, 1), np.inf, dtype=np.float32)

        for wi in range(Wn):
            vj = int(ids_w[wi])
            xj = int(x_rank[vj])
            yj = int(y_rank[vj])
            if self.cnt > 0:
                dev_row = pool_ids[wi]
                keep = (dev_row >= 0) & np.isfinite(pool_d[wi])
                cids = np.concatenate(
                    [dev_row[keep].astype(np.int64), ids_w[:wi]]
                )
                cds = np.concatenate(
                    [pool_d[wi][keep], intra[wi, :wi]]
                ).astype(np.float32)
                sel = np.lexsort((cids, cds))[:Z]
                ann = cids[sel]
                ann_d = cds[sel]
                uncovered_from = None
                if ann.size == 0:
                    uncovered_from = 0
                else:
                    # vectorized sweep: one pool matrix reused per round
                    dmat = pool_distance_matrix(g.vectors, ann)
                    ann_x = x_rank[ann].astype(np.int64)
                    idx_all = np.arange(ann.size)
                    i = 0
                    while i <= xj:
                        live = ann_x >= i
                        if not live.any():
                            uncovered_from = i
                            break
                        self.rounds += 1
                        li = idx_all[live]
                        N = prune_precomputed(
                            ann[li], ann_d[li], dmat[np.ix_(li, li)], M
                        )
                        nx = x_rank[N].astype(np.int64)
                        if self.leap == "conservative":
                            x_R = int(min(xj, int(nx.min())))
                            added = g.add_bidirectional_batch(
                                vj, N, i, x_R, yj, self.y_max
                            )
                            i = x_R + 1
                        else:  # maxleap
                            x_leap = int(nx.max())
                            r_arr = np.minimum(xj, nx)
                            added = g.add_bidirectional_batch(
                                vj, N, i, r_arr, yj, self.y_max
                            )
                            i = min(xj, x_leap) + 1
                        self.broadx.add_edges(vj, added)
                if uncovered_from is not None and self.patch != "none":
                    sel_patch = add_patch_edges(
                        g, vj, uncovered_from, xj,
                        self.ins_ids[: self.cnt], self.ins_x[: self.cnt],
                        M, self.K_p, self.patch,
                    )
                    self.broadx.add_edges(vj, sel_patch)
            self.ins_ids[self.cnt] = vj
            self.ins_x[self.cnt] = xj
            self.cnt += 1

    def finish(self) -> Tuple[LabeledGraph, "BuildReport"]:
        """Return ``(graph, report)``; the state must be :attr:`done`.
        ``seconds`` is the window from this state's construction (under
        ``build_graphs_concurrent`` the windows overlap)."""
        assert self.done
        from repro_torch.core.build import BuildReport

        return self.g, BuildReport(
            n=self.n,
            seconds=time.perf_counter() - self.t0,
            num_tuples=self.g.num_tuples,
            num_patch_tuples=self.g.num_patch_tuples,
            sweep_rounds=self.rounds,
            broad_searches=self.launches,
            index_bytes=self.g.stats().index_bytes,
            waves=self.n_waves,
            search_seconds=self.search_s,
        )


def build_udg_batched(
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
    wave: int = 256,
    pad_nodes: int | None = None,
    device=None,
) -> Tuple[LabeledGraph, "BuildReport"]:
    """Wave-pipelined practical constructor; same contract as ``build_udg``.

    ``wave`` is the insertion-wave width (1 degenerates to per-object device
    searches). ``pad_nodes`` pads the device table to a fixed row count.
    ``device`` runs the wave searches (``None`` = the card; ``"cpu"`` runs
    the kernels' plain versions). The report's ``waves`` counts insertion
    waves, ``broad_searches`` device search launches (one per wave after the
    first) and ``search_seconds`` the time in them (upload, search,
    download); the rest of ``seconds`` is host work (the sweep, PRUNE,
    patches and the intra-wave distances).
    """
    st = _WaveBuildState(
        vectors, s, t, relation, M=M, Z=Z, K_p=K_p,
        leap=leap, patch=patch, wave=wave, pad_nodes=pad_nodes, device=device,
    )
    while not st.done:
        st.dispatch()
        st.process()
    return st.finish()


def build_graphs_concurrent(
    datasets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    relation: str,
    M: int = 16,
    Z: int = 128,
    K_p: int = 8,
    *,
    leap: str = "maxleap",
    patch: str = "full",
    wave: int = 256,
    pad_nodes: int | None = None,
    device=None,
) -> List[Tuple[LabeledGraph, "BuildReport"]]:
    """Build several UDGs through one wave pipeline: each ``(vectors, s, t)``
    triple gets its own :class:`_WaveBuildState`, and the loop runs every
    unfinished graph's ``dispatch`` and then every one's ``process``, in a
    fixed order, so each graph is identical to what ``build_udg_batched``
    builds for it alone. Pass one shared ``pad_nodes`` (>= the largest
    dataset) so every state pads its table to the same row count."""
    states = [
        _WaveBuildState(
            v, s, t, relation, M=M, Z=Z, K_p=K_p,
            leap=leap, patch=patch, wave=wave, pad_nodes=pad_nodes,
            device=device,
        )
        for (v, s, t) in datasets
    ]
    while True:
        live = [st for st in states if not st.done]
        if not live:
            break
        for st in live:
            st.dispatch()
        for st in live:
            st.process()
    return [st.finish() for st in states]
